// Paged decode attention for Hopper (sm_90a), split over the context
// ("flash-decoding").
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py::
// paged_attention_decode_kernel (Pallas body _decode_kernel_body): one
// query token per sequence attends over its KV context, which lives in
// fixed-size pages of a shared pool [KVH, pages, page, DH] addressed by a
// per-sequence block table. fp32 online softmax; GQA heads grouped by kv
// head; a length-0 row (an idle serving slot) returns 0, never NaN.
//
// What bounds it on the H100: bytes. Each K/V element read is used for
// 2 * G FLOPs (G = q heads per kv head, at most 8 here), far below the
// ~20 FLOPs per HBM byte that fp32 FMAs supply, so the tensor cores would
// add nothing: the floor is the K and V rows the lengths cover,
// 2 * KVH * sum(len) * DH * itemsize, over 3.35 TB/s.
//
// Design. The TPU kernel ran a sequential grid over pages; one block per
// (sequence, kv head) walking its pages left all but a few SMs idle behind
// the longest row, with no load in flight while it computed. Here the
// context is cut into splits of `split` tokens (a page or half a page,
// chosen by the wrapper's _split_plan from shapes only). The grid is as
// many blocks as fit the SMs at once; each block reads the lengths and
// lists the splits that hold rows, and the work items (such a split, block
// of up to HEADS q heads of one kv head) go round-robin over the blocks,
// so a long row spreads over many SMs and no block waits on a split past
// its row's length. The lengths stay on the device; the launch never waits
// on the host.
//
// Loads in flight: a block streams its split's K and V rows through a
// ring of kPdStages stages of `stage_rows` rows in shared memory (32 KB,
// 16-row stages at D 128 bf16; five blocks share an SM), with 16-byte
// cp.async copies up to kPdStages - 1 stages ahead of the stage it
// computes; the split's page ids are read once into shared memory first.
// (On the H100, 8 warps a block, a 64 KB ring, and smaller blocks held to
// fewer registers were all slower.)
//
// Compute: the block's q heads live in fp32 registers; each row is read
// from shared memory by `lanes` lanes (16 bytes, VPL times, a lane; 16
// lanes at D 128 bf16, so a warp takes two rows at once), the scores are
// summed by xor shuffles within those lanes, and every group of lanes
// keeps its own online-softmax state (m, l, acc) in registers, two rows a
// step. At the end of the split the groups merge by shuffles within the
// warp, and the warps through shared memory (aliased over the drained
// ring).
//
// Merge across splits. A row that fits one split writes its output
// directly (a decode row of up to a page, every suffix-prefill row of up
// to a page). Otherwise each split writes fp32 partials (m, l, acc) to a
// workspace, and the last block of its (sequence, head block) to arrive,
// found by __threadfence and an atomicAdd on a per-(sequence, head block)
// counter that it then resets to 0, merges the partials in split order:
// one launch per call, and the same bits on every call. Workspace and
// counters are the wrapper's, kept per device and stream.
#include <limits.h>

#include "flash_mma.cuh"

constexpr int kPdWarps = 4;
constexpr int kPdThreads = kPdWarps * 32;
constexpr int kPdStages = 4;  // ring stages of a block's K/V rows
constexpr int kPdRowsPerStep = 2;  // rows a lane group takes at once

// 16 bytes of T as fp32 values
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[8], __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[8], __half) {
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __half22float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// The VPL 16-byte vectors lane `sl` of a `lanes`-lane group owns in a row
// of nv vectors (vector sl + lanes * i), as fp32; zeros where a vector is
// past the row or `ok` is false.
template <typename T, int VPL>
__device__ __forceinline__ void load_row(const T* row, int sl, int lanes, int nv, bool ok,
                                         float (&f)[VPL * 16 / sizeof(T)]) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int j = sl + lanes * i;
    float v[VEC];
    if (ok && j < nv) {
      const uint4 u = *reinterpret_cast<const uint4*>(row + j * VEC);
      if constexpr (VEC == 4) {
        unpack16(u, v);
      } else {
        unpack16(u, v, T());
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[i * VEC + e] = v[e];
  }
}

// Bytes of a block's shared memory: the ring (K then V rows of each stage),
// or the warps' (m, l, acc) aliased over it, rounded to 16; then the page
// ids of one split. paged_attention.py::_split_plan mirrors it.
__host__ __device__ inline size_t paged_region_bytes(int dh, int itemsize, int stage_rows,
                                                     int heads) {
  const size_t ring = (size_t)kPdStages * 2 * stage_rows * dh * itemsize;
  const size_t merge = sizeof(float) * (size_t)kPdWarps * heads * (dh + 2);
  return ((ring > merge ? ring : merge) + 15) / 16 * 16;
}

__host__ __device__ inline int paged_max_pages(int split, int page) { return split / page + 2; }

// Each block first counts the splits of every sequence (a sequence of
// length 0 counts one: its split 0 writes the zeros) and takes their
// exclusive prefix in shared memory. Work item k = hb + head blocks *
// (the k-th split in sequence order): only splits with rows in them are
// items, so no block waits on an empty one, and blocks that run at once
// read different kv heads (rows sharing one table, as in the suffix
// prefill, would otherwise all read the same lines of one head). A head
// block is HEADS q heads of one kv head; block i takes items i, i +
// gridDim.x, ...
template <typename T, int VPL, int HEADS>
__global__ void __launch_bounds__(kPdThreads)
paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                          const T* __restrict__ v_pages, const int* __restrict__ lengths,
                          const int* __restrict__ tables, T* __restrict__ out,
                          float* __restrict__ ws, int* __restrict__ counters, int B, int nh,
                          int kvh, int dh, int num_pages, int page, int pps, int split,
                          int n_splits, int stage_rows, int lanes, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int E = VPL * VEC;  // elements of a row a lane holds
  constexpr int RPS = kPdRowsPerStep;
  const int group = nh / kvh;
  const int n_hb = (group + HEADS - 1) / HEADS;  // head blocks per kv head
  const int hbs = kvh * n_hb;                     // head blocks per sequence
  const int nv = dh / VEC;                        // 16-byte vectors per row
  const int rpw = 32 / lanes;                     // rows a warp takes at once
  const int n_workers = kPdWarps * rpw;           // lane groups of the block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / lanes, sl = lane - sub * lanes;
  const int worker = warp * rpw + sub;
  const int max_len = pps * page;
  const long long page_elems = (long long)page * dh;
  const int part_len = HEADS * (dh + 2);  // one split's partials: m, l, acc
  const size_t stage_elems = (size_t)stage_rows * dh;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // [stage][K rows, V rows][dh]
  int* pages_s = reinterpret_cast<int*>(
      smem + paged_region_bytes(dh, (int)sizeof(T), stage_rows, HEADS));
  int* first_s = pages_s + paged_max_pages(split, page);  // [B + 1] first split of each sequence
  // the warps' states, aliased over the ring once it is drained
  float* m_w = reinterpret_cast<float*>(smem);  // [warps][HEADS]
  float* l_w = m_w + kPdWarps * HEADS;          // [warps][HEADS]
  float* acc_w = l_w + kPdWarps * HEADS;        // [warps][HEADS][dh]
  __shared__ int last_s, warp_s[kPdWarps];

  {  // first_s: exclusive prefix of the splits per sequence, a run of rows a thread
    const int per = (B + kPdThreads - 1) / kPdThreads;
    const int lo = min(B, tid * per), hi = min(B, lo + per);
    int sum = 0;
    for (int i = lo; i < hi; ++i) {
      const int len = max(0, min(lengths[i], max_len));
      first_s[i] = max(1, (len + split - 1) / split);
      sum += first_s[i];
    }
    int x = sum;  // inclusive scan over the warp, then over the warps
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_s[warp] = x;
    __syncthreads();
    int run = x - sum;
    for (int w = 0; w < warp; ++w) run += warp_s[w];
    for (int i = lo; i < hi; ++i) {
      const int n_i = first_s[i];
      first_s[i] = run;
      run += n_i;
    }
    if (tid == kPdThreads - 1) first_s[B] = run;
    __syncthreads();
  }
  const int items = first_s[B] * hbs;

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int k = item / hbs, hb = item - k * hbs;
    int b = 0, b_hi = B;  // the sequence: first_s[b] <= k < first_s[b + 1]
    while (b_hi - b > 1) {
      const int mid = (b + b_hi) >> 1;
      if (first_s[mid] <= k) b = mid; else b_hi = mid;
    }
    const int s = k - first_s[b], ns = first_s[b + 1] - first_s[b];
    const int kh = hb / n_hb, g0 = (hb - kh * n_hb) * HEADS;
    const int gc = min(HEADS, group - g0);  // q heads of this block
    T* ob = out + ((long long)b * nh + (long long)kh * group + g0) * dh;

    // the length, the page ids the split can touch and q (fp32 registers;
    // the repeat layout: q heads kh * group .. kh * group + group - 1 read
    // kv head kh), all in flight at once
    const int row0 = s * split;
    const int p0 = row0 / page, n_pg = min(pps - 1, (row0 + split - 1) / page) - p0 + 1;
    for (int i = tid; i < n_pg; i += kPdThreads) pages_s[i] = tables[(long long)b * pps + p0 + i];
    const int len = max(0, min(lengths[b], max_len));
    const T* qb = q + ((long long)b * nh + (long long)kh * group + g0) * dh;
    float qr[HEADS][E], acc[HEADS][E], m[HEADS], l[HEADS];
#pragma unroll
    for (int g = 0; g < HEADS; ++g) {
      load_row<T, VPL>(qb + (long long)g * dh, sl, lanes, nv, g < gc && len > 0, qr[g]);
      m[g] = -INFINITY;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
    }
    __syncthreads();
    if (len == 0) {  // an idle slot
      for (int i = tid; i < gc * dh; i += kPdThreads) ob[i] = from_f32<T>(0.f);
      continue;
    }
    const int n = min(split, len - row0);

    // stage st: rows [st * stage_rows, ...) of the split into ring slot
    // st % kPdStages, each lane group copying the rows it will read
    const T* k_head = k_pages + (long long)kh * num_pages * page_elems;
    const T* v_head = v_pages + (long long)kh * num_pages * page_elems;
    const int n_st = (n + stage_rows - 1) / stage_rows;
    auto issue = [&](int st) {
      T* ks = ring + (size_t)(st % kPdStages) * 2 * stage_elems;
      const int lo = st * stage_rows, hi = min(n, lo + stage_rows);
      for (int r = lo + worker; r < hi; r += n_workers) {
        const int t = row0 + r, pi = t / page;
        const long long src =
            (long long)pages_s[pi - p0] * page_elems + (long long)(t - pi * page) * dh;
        T* dst = ks + (size_t)(r - lo) * dh;
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
          const int j = sl + lanes * i;
          if (j < nv) {
            cp_async16(dst + j * VEC, k_head + src + j * VEC, true);
            cp_async16(dst + stage_elems + j * VEC, v_head + src + j * VEC, true);
          }
        }
      }
    };
#pragma unroll
    for (int st = 0; st < kPdStages; ++st) {
      if (st < n_st) issue(st);
      cp_async_commit();  // empty groups too: every thread counts kPdStages
    }

    for (int st = 0; st < n_st; ++st) {
      cp_async_wait<kPdStages - 1>();
      __syncthreads();  // stage st has landed for every thread's copies
      const T* ks = ring + (size_t)(st % kPdStages) * 2 * stage_elems;
      const int lo = st * stage_rows, hi = min(n, lo + stage_rows);
      // a lane group takes RPS rows a step, r, r + n_workers, ...: their dot
      // products and shuffle sums interleave, and one rescale serves them
      for (int base = lo + warp * rpw; base < hi; base += RPS * n_workers) {
        bool ok[RPS];
        float kf[RPS][E], vf[RPS][E];
#pragma unroll
        for (int u = 0; u < RPS; ++u) {
          const int r = base + sub + u * n_workers;
          ok[u] = r < hi;
          const T* kr = ks + (size_t)(r - lo) * dh;
          load_row<T, VPL>(kr, sl, lanes, nv, ok[u], kf[u]);
          load_row<T, VPL>(kr + stage_elems, sl, lanes, nv, ok[u], vf[u]);
        }
        // every head's dot products, then their shuffle sums side by side
        // (heads past gc have q = 0 and are never written)
        float d[HEADS][RPS];
#pragma unroll
        for (int g = 0; g < HEADS; ++g) {
#pragma unroll
          for (int u = 0; u < RPS; ++u) {
            d[g][u] = 0.f;
#pragma unroll
            for (int e = 0; e < E; ++e) d[g][u] += qr[g][e] * kf[u][e];
          }
        }
        for (int o = lanes >> 1; o > 0; o >>= 1) {
#pragma unroll
          for (int g = 0; g < HEADS; ++g) {
#pragma unroll
            for (int u = 0; u < RPS; ++u) d[g][u] += __shfl_xor_sync(0xffffffffu, d[g][u], o);
          }
        }
#pragma unroll
        for (int g = 0; g < HEADS; ++g) {
          // a row past the stage's end scores -inf and weighs 0
          float x[RPS], m_new = m[g];
#pragma unroll
          for (int u = 0; u < RPS; ++u) {
            x[u] = ok[u] ? d[g][u] * scale : -INFINITY;
            m_new = fmaxf(m_new, x[u]);
          }
          if (m_new != -INFINITY) {
            const float alpha = expf(m[g] - m_new);  // exp(-inf) = 0 on the first row
            float p[RPS], ls = l[g] * alpha;
#pragma unroll
            for (int u = 0; u < RPS; ++u) {
              p[u] = expf(x[u] - m_new);
              ls += p[u];
            }
            l[g] = ls;
#pragma unroll
            for (int e = 0; e < E; ++e) {
              float a = acc[g][e] * alpha;
#pragma unroll
              for (int u = 0; u < RPS; ++u) a += p[u] * vf[u][e];
              acc[g][e] = a;
            }
            m[g] = m_new;
          }
        }
      }
      __syncthreads();  // every warp is done with the slot before it refills
      if (st + kPdStages < n_st) issue(st + kPdStages);
      cp_async_commit();
    }

    // the warp's lane groups merge by shuffles; a group that took no row
    // has m = -inf and weighs 0 (never exp(-inf + inf))
    for (int o = lanes; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < HEADS; ++g) {
        if (g >= gc) break;
        const float m_o = __shfl_xor_sync(0xffffffffu, m[g], o);
        const float l_o = __shfl_xor_sync(0xffffffffu, l[g], o);
        const float m_n = fmaxf(m[g], m_o);
        const float a = m[g] == -INFINITY ? 0.f : expf(m[g] - m_n);
        const float a_o = m_o == -INFINITY ? 0.f : expf(m_o - m_n);
        l[g] = l[g] * a + l_o * a_o;
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[g][e] = acc[g][e] * a + __shfl_xor_sync(0xffffffffu, acc[g][e], o) * a_o;
        m[g] = m_n;
      }
    }
    if (sub == 0) {  // the ring is drained (the last stage's barrier)
#pragma unroll
      for (int g = 0; g < HEADS; ++g) {
        if (g >= gc) break;
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
          const int j = sl + lanes * i;
          if (j < nv) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc_w[(warp * HEADS + g) * dh + j * VEC + e] = acc[g][i * VEC + e];
          }
        }
        if (sl == 0) {
          m_w[warp * HEADS + g] = m[g];
          l_w[warp * HEADS + g] = l[g];
        }
      }
    }
    __syncthreads();

    // the warps in order: (M, L, acc) of the split per (head, column)
    const bool single = ns == 1;
    const long long hb_base = ((long long)b * kvh * n_hb + hb) * n_splits;
    float* part = ws + (hb_base + s) * part_len;  // unused when single
    for (int i = tid; i < gc * dh; i += kPdThreads) {
      const int g = i / dh, col = i - g * dh;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kPdWarps; ++w) mx = fmaxf(mx, m_w[w * HEADS + g]);
      float L = 0.f, A = 0.f;
#pragma unroll
      for (int w = 0; w < kPdWarps; ++w) {
        const float mw = m_w[w * HEADS + g];
        const float f = mw == -INFINITY ? 0.f : expf(mw - mx);
        L += l_w[w * HEADS + g] * f;
        A += acc_w[(w * HEADS + g) * dh + col] * f;
      }
      if (single) {
        ob[i] = from_f32<T>(L > 0.f ? A / L : 0.f);
      } else {
        __stcg(part + 2 * HEADS + i, A);
        if (col == 0) {
          __stcg(part + g, mx);
          __stcg(part + HEADS + g, L);
        }
      }
    }

    if (!single) {
      __threadfence();  // this block's partials are visible device-wide
      __syncthreads();
      if (tid == 0) {
        int* cnt = counters + (long long)b * kvh * n_hb + hb;
        last_s = atomicAdd(cnt, 1) == ns - 1;
        if (last_s) *cnt = 0;  // ready for the next call
      }
      __syncthreads();
      if (last_s) {
        __threadfence();
        // merge the splits' partials in split order (read past L1)
        const float* first = ws + hb_base * part_len;
        for (int i = tid; i < gc * dh; i += kPdThreads) {
          const int g = i / dh;
          float mx = -INFINITY;
          for (int sp = 0; sp < ns; ++sp) mx = fmaxf(mx, __ldcg(first + sp * part_len + g));
          float L = 0.f, A = 0.f;
          for (int sp = 0; sp < ns; ++sp) {
            const float* p = first + sp * part_len;
            const float mw = __ldcg(p + g);
            const float f = mw == -INFINITY ? 0.f : expf(mw - mx);
            L += __ldcg(p + HEADS + g) * f;
            A += __ldcg(p + 2 * HEADS + i) * f;
          }
          ob[i] = from_f32<T>(L > 0.f ? A / L : 0.f);
        }
      }
    }
    __syncthreads();  // shared memory and last_s are free for the next item
  }
}

// Lanes that read one row: the row's nv 16-byte vectors rounded up to a
// power of two, at most 32; and the vectors a lane takes (VPL), a power of
// two with lanes * VPL >= nv.
static int row_lanes(int nv) {
  int lanes = 1;
  while (lanes < nv && lanes < 32) lanes <<= 1;
  return lanes;
}

static int row_vpl(int nv, int lanes) {
  int vpl = 1;
  while (vpl * lanes < nv) vpl <<= 1;
  return vpl;
}

// What a launch takes (the kernel's arguments, the SM count and stream).
struct PagedArgs {
  const void *q, *k_pages, *v_pages;
  const int *lengths, *tables;
  void* out;
  float* ws;
  int* counters;
  int b, nh, kvh, dh, num_pages, page, pps, split, n_splits, stage_rows, lanes, items, sms;
  float scale;
  cudaStream_t stream;
};

// As many blocks as fit the SMs at once, and no more than the items could
// be (every sequence at its full length).
template <typename T, int VPL, int HEADS>
static int launch_paged(const PagedArgs& a) {
  auto kernel = paged_decode_split_kernel<T, VPL, HEADS>;
  const size_t smem = paged_region_bytes(a.dh, (int)sizeof(T), a.stage_rows, HEADS) +
                      sizeof(int) * (paged_max_pages(a.split, a.page) + a.b + 1);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kPdThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long fit = (long long)per_sm * a.sms;
  kernel<<<(int)(fit < a.items ? fit : a.items), kPdThreads, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k_pages, (const T*)a.v_pages, a.lengths, a.tables, (T*)a.out,
      a.ws, a.counters, a.b, a.nh, a.kvh, a.dh, a.num_pages, a.page, a.pps, a.split, a.n_splits,
      a.stage_rows, a.lanes, a.scale);
  return (int)cudaGetLastError();
}

// The instantiated (VPL, HEADS): VPL 1, 2, 4 or 8 vectors a lane, and
// HEADS 1, 2, 4 or 8 with HEADS * VPL * (16 / itemsize) <= 64 fp32 values of
// q (and as many of acc) a lane; another pair returns cudaErrorInvalidValue.
template <typename T, int VPL>
static int dispatch_heads(int heads, const PagedArgs& a) {
  constexpr int E = VPL * 16 / (int)sizeof(T);
  switch (heads) {
    case 1: return launch_paged<T, VPL, 1>(a);
    case 2: if constexpr (2 * E <= 64) return launch_paged<T, VPL, 2>(a); break;
    case 4: if constexpr (4 * E <= 64) return launch_paged<T, VPL, 4>(a); break;
    case 8: if constexpr (8 * E <= 64) return launch_paged<T, VPL, 8>(a); break;
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int dispatch_vpl(int vpl, int heads, const PagedArgs& a) {
  switch (vpl) {
    case 1: return dispatch_heads<T, 1>(heads, a);
    case 2: return dispatch_heads<T, 2>(heads, a);
    case 4: return dispatch_heads<T, 4>(heads, a);
    case 8: return dispatch_heads<T, 8>(heads, a);
  }
  return (int)cudaErrorInvalidValue;
}

// q [b, nh, dh], pools [kvh, num_pages, page, dh], out [b, nh, dh], all
// contiguous and 16-byte aligned with dh * itemsize a multiple of 16;
// lengths [b] and tables [b, pps] int32. ws: fp32, b * kvh * ceil(group /
// heads) * n_splits * heads * (dh + 2) entries (unused when a row never
// spans two splits); counters: int32, b * kvh * ceil(group / heads), all 0
// (every launch leaves them 0). `split` tokens per split, `stage_rows`
// rows per ring stage and `heads` q heads per block come from the
// wrapper's _split_plan; `sms` is the card's SM count.
extern "C" int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                            const int* lengths, const int* tables, void* out, float* ws,
                            int* counters, int b, int nh, int kvh, int dh, int num_pages, int page,
                            int pps, int split, int stage_rows, int heads, int sms, float scale,
                            int dtype, void* stream) {
  if (b <= 0 || kvh <= 0 || nh % kvh != 0 || dh <= 0 || page <= 0 || pps <= 0 || split <= 0 ||
      stage_rows <= 0 || heads <= 0 || sms <= 0 || !aligned16({q, k_pages, v_pages, out}))
    return (int)cudaErrorInvalidValue;
  const long long n_splits = ((long long)pps * page + split - 1) / split;
  const long long items = n_splits * b * kvh * ((nh / kvh + heads - 1) / heads);
  if (items > INT_MAX) return (int)cudaErrorInvalidValue;
  PagedArgs a{q,     k_pages, v_pages,         lengths,    tables, out, ws, counters,
              b,     nh,      kvh,             dh,         num_pages, page, pps, split,
              (int)n_splits, stage_rows, 0, (int)items, sms, scale, (cudaStream_t)stream};
  DISPATCH_DTYPE(dtype, T, {
    constexpr int VEC = 16 / sizeof(T);
    if (dh % VEC) return (int)cudaErrorInvalidValue;
    a.lanes = row_lanes(dh / VEC);
    return dispatch_vpl<T>(row_vpl(dh / VEC, a.lanes), heads, a);
  })
  return (int)cudaErrorInvalidValue;
}
