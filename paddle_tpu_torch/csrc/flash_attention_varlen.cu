// Varlen (packed-sequence) flash attention, forward and backward, for Hopper
// (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention_varlen.py::_vflash_fwd
// (Pallas body _vfwd_kernel) and ::_vflash_bwd (bodies _vbwd_dq_kernel and
// _vbwd_dkv_kernel). Several sequences are packed into one token axis:
// q [Tq, H, D], k/v [Tk, Hkv, D], with cu_seqlens giving each segment's
// start. The wrapper turns cu_seqlens into per-token int32 vectors on the
// device (ops/cuda/flash_attention_varlen.py::_seg_vectors): seg_q [Tq] and
// seg_k [Tk] (a token's segment; tokens past cu[-1] carry the sentinels
// n_seqs and n_seqs + 1, which never match) and bound [Tq], the last key a q
// row may see under causal masking, bottom-right aligned per segment. Key
// `col` is visible to row `row` iff seg_q[row] == seg_k[col] and, when
// causal, col <= bound[row]. A row that sees no key gives out 0 and lse
// -inf, and gradients 0. Dropout applies the dense kernels' counter hash
// (flash_common.cuh) on (q head, packed row, packed col) to P.V only.
//
// Routes up to D 256, fixed by the dtype in the C entry points vflash_fwd,
// vflash_bwd_dq and vflash_bwd_dkv: bf16 and fp16 take the tensor-core
// kernels (vflash_fwd_tc_kernel, vflash_bwd_dq_tc_kernel,
// vflash_bwd_dkv_tc_kernel; second part of this file); fp32 takes the
// CUDA-core kernels (vflash_fwd_kernel, vflash_bwd_dq_kernel,
// vflash_bwd_dkv_kernel), since TF32's 10-bit mantissa cannot hold the fp32
// outputs to 1e-4. No kernel is instantiated for a dtype outside its route.
//
// Head dims: each kernel named above is instantiated for each multiple of 32
// from 32 to 256 (with_head_dim). Above 256 every dtype takes the wide
// kernels (vflash_fwd_wide_kernel, vflash_bwd_dq_wide_kernel,
// vflash_bwd_dkv_wide_kernel; before the C entry points), which take D at
// run time, any multiple of 32 (above kWideMaxD = 1536 in column ranges
// across blocks). The wrapper zero-pads any other D to the next multiple
// of 32.
//
// What bounds it on the H100: operations, 4 * D * H * sum_i len_q,i * len_k,i
// FLOPs forward (about half of that causal) and 2.5 times that backward (five
// products), over the 989 TFLOP/s bf16 tensor-core peak. The CUDA-core
// kernels do their math in fp32 (67 TFLOP/s peak), far from that bound.
//
// CUDA-core design: the dense kernels' tiles (32 q rows x 32 keys, 4 warps
// of 8 rows, fp32 in shared memory), reading the packed tensors in place at
// their token stride: there is no transpose to [H, T, D] and no padding of
// T. Where the TPU visits every (q block, k block) pair and skips those whose
// segment ranges are disjoint, here a q tile loops only over the keys of its
// own segments, [cu_k[first segment], cu_k[last segment + 1]), cut under
// causal at its largest row bound; a key tile of the dk/dv kernel loops only
// over the q rows of its segments, from the first row that sees its first
// key. The work so stays about sum_i len_i^2 rather than T^2; a tile that
// straddles a segment boundary pays for both segments' keys. The element
// mask is the segment test above. GQA reads kv head h / (H / Hkv); the dk/dv
// kernel loops over the group's q heads and keeps dk and dv in fp32
// registers, cast once.
#include <limits.h>

#include <type_traits>

#include "flash_mma.cuh"

__device__ __forceinline__ int warp_min_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_max_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The keys [begin, end) that the q rows [q0, q0 + ROWS) may see: those of
// their segments, and under causal none past their largest bound. `seg` is
// the rows' one segment when every row lies in the same segment (then the
// keys [begin, end) are all of that segment), else -1; `min_bound` is the
// smallest bound of the rows that lie in a segment. Called by a whole warp;
// lane i looks at rows q0 + i, q0 + 32 + i, ...
struct QTileKeys {
  int begin, end, seg, min_bound;
};

template <int ROWS>
__device__ QTileKeys q_tile_keys(const int* __restrict__ seg_q, const int* __restrict__ bound,
                                 const int* __restrict__ cu_k, int q0, int Tq, int Tk,
                                 int n_seqs, int causal, int lane) {
  static_assert(ROWS % 32 == 0, "whole warps of rows");
  int lo = INT_MAX, hi = -1, last = -1, first = INT_MAX;
  bool all_in = true;
#pragma unroll
  for (int r = 0; r < ROWS / 32; ++r) {
    const int row = q0 + 32 * r + lane;
    const int s = row < Tq ? seg_q[row] : n_seqs;
    if (s < n_seqs) {  // rows past cu_q[-1] carry the sentinel n_seqs
      lo = min(lo, s);
      hi = max(hi, s);
      const int b = bound[row];
      last = max(last, b);
      first = min(first, b);
    } else {
      all_in = false;
    }
  }
  lo = warp_min_i(lo);
  hi = warp_max_i(hi);
  last = warp_max_i(last);
  first = warp_min_i(first);
  all_in = __all_sync(0xffffffffu, all_in);
  if (hi < 0) return {0, 0, -1, -1};
  const int begin = max(cu_k[lo], 0);
  int end = min(cu_k[hi + 1], Tk);
  if (causal) end = min(end, last + 1);
  return {begin, max(begin, end), all_in && lo == hi ? lo : -1, first};
}

// The q rows [begin, end) that may see a key of [k0, k0 + KEYS): those of
// the keys' segments and, under causal, none before the first row of the
// first segment whose bound reaches the tile's first key. `seg` is the keys'
// one segment when every key lies in the same segment, else -1. Called by a
// whole warp; lane i looks at keys k0 + i, k0 + 32 + i, ...
struct KTileRows {
  int begin, end, seg;
};

template <int KEYS>
__device__ KTileRows k_tile_rows(const int* __restrict__ seg_k, const int* __restrict__ cu_q,
                                 const int* __restrict__ cu_k, int k0, int Tq, int Tk,
                                 int n_seqs, int causal, int lane) {
  static_assert(KEYS % 32 == 0, "whole warps of keys");
  int lo = INT_MAX, hi = -1, first = INT_MAX;
  bool all_in = true;
#pragma unroll
  for (int r = 0; r < KEYS / 32; ++r) {
    const int key = k0 + 32 * r + lane;
    const int s = key < Tk ? seg_k[key] : n_seqs + 1;
    if (s < n_seqs) {  // keys past cu_k[-1] carry the sentinel n_seqs + 1
      lo = min(lo, s);
      hi = max(hi, s);
      first = min(first, key);
    } else {
      all_in = false;
    }
  }
  lo = warp_min_i(lo);
  hi = warp_max_i(hi);
  first = warp_min_i(first);
  all_in = __all_sync(0xffffffffu, all_in);
  if (hi < 0) return {0, 0, -1};
  int begin = cu_q[lo];
  if (causal) {
    // bound[row] = cu_k[lo] + (row - cu_q[lo]) + len_k - len_q >= first
    const int len_q = cu_q[lo + 1] - cu_q[lo], len_k = cu_k[lo + 1] - cu_k[lo];
    begin += min(len_q, max(0, first - cu_k[lo] - len_k + len_q));
  }
  begin = max(begin, 0);
  const int end = min(cu_q[hi + 1], Tq);
  return {begin, max(begin, end), all_in && lo == hi ? lo : -1};
}

template <int D>
static constexpr size_t vflash_fwd_smem_bytes() {
  return sizeof(float) * ((size_t)kFaBQ * D + (size_t)kFaBK * (D + 1) + (size_t)kFaBK * D +
                          (size_t)kFaBQ * kFaBK);
}

// One block per (32-row q tile, q head): out [Tq, H, D] (contiguous), lse [H, Tq].
template <typename T, int D>
__global__ void __launch_bounds__(kFaThreads)
vflash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  long long q_stride, long long k_stride, long long v_stride,
                  const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                  const int* __restrict__ bound, const int* __restrict__ cu_k,
                  const int* __restrict__ seed_ptr, T* __restrict__ out, float* __restrict__ lse,
                  int Tq, int Tk, int H, int Hkv, int n_seqs, float scale, int causal,
                  int dropout, uint32_t thresh, float inv_keep) {
  constexpr int NC = D / 32;  // output columns per lane
  const int q0 = blockIdx.x * kFaBQ, h = blockIdx.y;
  const int hk = h / (H / Hkv);

  extern __shared__ __align__(16) float sm[];
  float* q_s = sm;                           // [BQ][D]
  float* k_s = q_s + kFaBQ * D;              // [BK][D + 1]
  float* v_s = k_s + kFaBK * (D + 1);        // [BK][D]
  float* p_s = v_s + kFaBK * D;              // [BQ][BK]
  __shared__ int2 keys_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp == 0) {
    const QTileKeys r = q_tile_keys<kFaBQ>(seg_q, bound, cu_k, q0, Tq, Tk, n_seqs, causal, lane);
    if (lane == 0) keys_s = make_int2(r.begin, r.end);
  }
  for (int i = tid; i < kFaBQ * D; i += kFaThreads) {
    const int r = i / D, c = i - r * D;
    const int row = q0 + r;
    q_s[i] = row < Tq ? to_f32(q[(long long)row * q_stride + h * D + c]) : 0.f;
  }
  int seg_r[kFaRows], bound_r[kFaRows];
#pragma unroll
  for (int r = 0; r < kFaRows; ++r) {
    const int row = q0 + warp * kFaRows + r;
    seg_r[r] = row < Tq ? seg_q[row] : -1;  // -1 matches no key
    bound_r[r] = row < Tq ? bound[row] : -1;
  }
  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;
  __syncthreads();
  const int k_begin = keys_s.x, k_end = keys_s.y;

  float m[kFaRows], l[kFaRows], acc[kFaRows][NC];
#pragma unroll
  for (int r = 0; r < kFaRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kFaBK) {
    __syncthreads();  // the previous tile's K/V/P reads are done
    for (int i = tid; i < kFaBK * D; i += kFaThreads) {
      const int r = i / D, c = i - r * D;
      const int key = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (key < k_end) {
        kv = to_f32(k[(long long)key * k_stride + hk * D + c]);
        vv = to_f32(v[(long long)key * v_stride + hk * D + c]);
      }
      k_s[r * (D + 1) + c] = kv;
      v_s[r * D + c] = vv;
    }
    __syncthreads();

    // scores: lane owns key col = k0 + lane for the warp's 8 rows
    float s[kFaRows];
#pragma unroll
    for (int r = 0; r < kFaRows; ++r) s[r] = 0.f;
    for (int d0 = 0; d0 < D; d0 += 32) {
      float kr[32];
#pragma unroll
      for (int dd = 0; dd < 32; ++dd) kr[dd] = k_s[lane * (D + 1) + d0 + dd];
#pragma unroll
      for (int r = 0; r < kFaRows; ++r) {
        const float* qr = q_s + (warp * kFaRows + r) * D + d0;
        float a = s[r];
#pragma unroll
        for (int dd = 0; dd < 32; ++dd) a += qr[dd] * kr[dd];
        s[r] = a;
      }
    }

    const int col = k0 + lane;
    const int seg_c = col < k_end ? seg_k[col] : -2;  // -2 matches no row
#pragma unroll
    for (int r = 0; r < kFaRows; ++r) {
      const int row = q0 + warp * kFaRows + r;
      float x = s[r] * scale;
      if (seg_r[r] != seg_c || (causal && col > bound_r[r])) x = -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(x));
      // a row may still see no key: keep exp arguments finite so it stays
      // exactly 0 instead of NaN (the TPU kernel's m_eff)
      const float m_eff = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[r] - m_eff);
      const float p = expf(x - m_eff);
      l[r] = l[r] * alpha + p;  // lane-partial row sum, undropped
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
      float pu = p;
      if (dropout) {
        pu = dropout_keep(seed, (uint32_t)h, (uint32_t)row, (uint32_t)col, thresh) ? p * inv_keep
                                                                                 : 0.f;
      }
      p_s[(warp * kFaRows + r) * kFaBK + lane] = pu;
    }
    __syncwarp();

    // acc[r, lane + 32c] += sum_t P[r, t] * V[t, lane + 32c]
    for (int t = 0; t < kFaBK; ++t) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = v_s[t * D + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kFaRows; ++r) {
        const float p = p_s[(warp * kFaRows + r) * kFaBK + t];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] += p * vv[c];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kFaRows; ++r) {
    const float lt = warp_sum(l[r]);
    const int row = q0 + warp * kFaRows + r;
    if (row < Tq) {
      const float ls = lt == 0.f ? 1.f : lt;
      T* orow = out + ((long long)row * H + h) * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) orow[lane + 32 * c] = from_f32<T>(acc[r][c] / ls);
      if (lane == 0) lse[(long long)h * Tq + row] = lt == 0.f ? -INFINITY : m[r] + logf(ls);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward. From the saved lse and delta = rowsum(dO * O) (fp32 [H, Tq], by
// the wrapper), with P = exp(S * scale - lse) under the forward's mask:
//   dV = (keep * c * P)^T dO,  dS = P * (keep * c * (dO V^T) - delta) * scale,
//   dQ = dS K,  dK = dS^T Q
// (keep: the forward's dropout bit, c = 1 / (1 - rate)). lse -inf is read as
// 0, so a row that saw no key has P = 0 and gradients 0, never NaN. The two
// CUDA-core kernels below are fp32's route; bf16 and fp16 take the
// tensor-core backward at the end of this file.
//
// Resources of the CUDA-core kernels (ptxas -v for sm_90a, fp32, as
// chip_smoke.py's [build] phase prints them; spill stores / loads) and
// dynamic shared memory, D 64 / 128 / 256:
//   vflash_fwd_kernel      96 (spill 20 / 20 B) / 147 / 168 (16 / 16 B)
//                          registers; 28.1 / 52.1 / 100.1 KB
//   vflash_bwd_dq_kernel   128 (12 / 16 B) / 147 / 180; 36.3 / 68.3 / 132.3 KB
//   vflash_bwd_dkv_kernel  142 / 144 / 246; 40.8 / 72.8 / 136.8 KB

template <int D>
static constexpr size_t vflash_dq_smem_bytes() {
  return sizeof(float) * (2 * (size_t)kFaBQ * D + 2 * (size_t)kFaBK * (D + 1) +
                          (size_t)kFaBQ * kFaBK);
}

// One block per (32-row q tile, q head), over the same keys as the forward:
// dq [Tq, H, D] (contiguous).
template <typename T, int D>
__global__ void __launch_bounds__(kFaThreads)
vflash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     long long q_stride, long long k_stride, long long v_stride,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ seg_q,
                     const int* __restrict__ seg_k, const int* __restrict__ bound,
                     const int* __restrict__ cu_k, const int* __restrict__ seed_ptr,
                     T* __restrict__ dq, int Tq, int Tk, int H, int Hkv, int n_seqs, float scale,
                     int causal, int dropout, uint32_t thresh, float inv_keep) {
  constexpr int NC = D / 32;
  const int q0 = blockIdx.x * kFaBQ, h = blockIdx.y;
  const int hk = h / (H / Hkv);

  extern __shared__ __align__(16) float sm[];
  float* q_s = sm;                            // [BQ][D]
  float* do_s = q_s + kFaBQ * D;              // [BQ][D]
  float* k_s = do_s + kFaBQ * D;              // [BK][D + 1]
  float* v_s = k_s + kFaBK * (D + 1);         // [BK][D + 1]
  float* ds_s = v_s + kFaBK * (D + 1);        // [BQ][BK]
  __shared__ int2 keys_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp == 0) {
    const QTileKeys r = q_tile_keys<kFaBQ>(seg_q, bound, cu_k, q0, Tq, Tk, n_seqs, causal, lane);
    if (lane == 0) keys_s = make_int2(r.begin, r.end);
  }
  for (int i = tid; i < kFaBQ * D; i += kFaThreads) {
    const int r = i / D, c = i - r * D;
    const int row = q0 + r;
    const bool ok = row < Tq;
    q_s[i] = ok ? to_f32(q[(long long)row * q_stride + h * D + c]) : 0.f;
    do_s[i] = ok ? to_f32(dout[((long long)row * H + h) * D + c]) : 0.f;
  }
  int seg_r[kFaRows], bound_r[kFaRows];
  float lse_r[kFaRows], delta_r[kFaRows];
#pragma unroll
  for (int r = 0; r < kFaRows; ++r) {
    const int row = q0 + warp * kFaRows + r;
    const bool ok = row < Tq;
    seg_r[r] = ok ? seg_q[row] : -1;
    bound_r[r] = ok ? bound[row] : -1;
    const float l = ok ? lse[(long long)h * Tq + row] : 0.f;
    lse_r[r] = l == -INFINITY ? 0.f : l;
    delta_r[r] = ok ? delta[(long long)h * Tq + row] : 0.f;
  }
  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;
  __syncthreads();
  const int k_begin = keys_s.x, k_end = keys_s.y;

  float acc[kFaRows][NC];
#pragma unroll
  for (int r = 0; r < kFaRows; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kFaBK) {
    __syncthreads();  // the previous tile's K/V/dS reads are done
    for (int i = tid; i < kFaBK * D; i += kFaThreads) {
      const int r = i / D, c = i - r * D;
      const int key = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (key < k_end) {
        kv = to_f32(k[(long long)key * k_stride + hk * D + c]);
        vv = to_f32(v[(long long)key * v_stride + hk * D + c]);
      }
      k_s[r * (D + 1) + c] = kv;
      v_s[r * (D + 1) + c] = vv;
    }
    __syncthreads();

    // s = Q K^T and dp = dO V^T: lane owns key col = k0 + lane
    float s[kFaRows], dp[kFaRows];
#pragma unroll
    for (int r = 0; r < kFaRows; ++r) {
      s[r] = 0.f;
      dp[r] = 0.f;
    }
    for (int d0 = 0; d0 < D; d0 += 32) {
      float kr[32];
#pragma unroll
      for (int dd = 0; dd < 32; ++dd) kr[dd] = k_s[lane * (D + 1) + d0 + dd];
#pragma unroll
      for (int r = 0; r < kFaRows; ++r) {
        const float* qr = q_s + (warp * kFaRows + r) * D + d0;
        float a = s[r];
#pragma unroll
        for (int dd = 0; dd < 32; ++dd) a += qr[dd] * kr[dd];
        s[r] = a;
      }
#pragma unroll
      for (int dd = 0; dd < 32; ++dd) kr[dd] = v_s[lane * (D + 1) + d0 + dd];
#pragma unroll
      for (int r = 0; r < kFaRows; ++r) {
        const float* dr = do_s + (warp * kFaRows + r) * D + d0;
        float a = dp[r];
#pragma unroll
        for (int dd = 0; dd < 32; ++dd) a += dr[dd] * kr[dd];
        dp[r] = a;
      }
    }

    const int col = k0 + lane;
    const int seg_c = col < k_end ? seg_k[col] : -2;
#pragma unroll
    for (int r = 0; r < kFaRows; ++r) {
      const int row = q0 + warp * kFaRows + r;
      const bool masked = seg_r[r] != seg_c || (causal && col > bound_r[r]);
      const float p = masked ? 0.f : expf(s[r] * scale - lse_r[r]);
      float d = dp[r];
      if (dropout) {
        d = dropout_keep(seed, (uint32_t)h, (uint32_t)row, (uint32_t)col, thresh) ? d * inv_keep
                                                                                : 0.f;
      }
      ds_s[(warp * kFaRows + r) * kFaBK + lane] = p * (d - delta_r[r]) * scale;
    }
    __syncwarp();

    // acc[r, lane + 32c] += sum_t dS[r, t] * K[t, lane + 32c]
    for (int t = 0; t < kFaBK; ++t) {
      float kv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = k_s[t * (D + 1) + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kFaRows; ++r) {
        const float ds = ds_s[(warp * kFaRows + r) * kFaBK + t];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] += ds * kv[c];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kFaRows; ++r) {
    const int row = q0 + warp * kFaRows + r;
    if (row < Tq) {
      T* orow = dq + ((long long)row * H + h) * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) orow[lane + 32 * c] = from_f32<T>(acc[r][c]);
    }
  }
}

template <int D>
static constexpr size_t vflash_dkv_smem_bytes() {
  return sizeof(float) * (2 * (size_t)kFaBK * D + 2 * (size_t)kFaBQ * (D + 1) +
                          2 * (size_t)kFaBK * kFaBQ + 2 * (size_t)kFaBQ) +
         sizeof(int) * 2 * (size_t)kFaBQ;
}

// One block per (32-key tile, kv head), looping over the GQA group's q heads
// and the q rows that can see the tile: dk, dv [Tk, Hkv, D] (contiguous).
template <typename T, int D>
__global__ void __launch_bounds__(kFaThreads)
vflash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      long long q_stride, long long k_stride, long long v_stride,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, const int* __restrict__ seg_q,
                      const int* __restrict__ seg_k, const int* __restrict__ bound,
                      const int* __restrict__ cu_q, const int* __restrict__ cu_k,
                      const int* __restrict__ seed_ptr, T* __restrict__ dk, T* __restrict__ dv,
                      int Tq, int Tk, int H, int Hkv, int n_seqs, float scale, int causal,
                      int dropout, uint32_t thresh, float inv_keep) {
  constexpr int NC = D / 32;
  const int k0 = blockIdx.x * kFaBK, hk = blockIdx.y;
  const int G = H / Hkv;

  extern __shared__ __align__(16) float sm[];
  float* k_s = sm;                            // [BK][D]
  float* v_s = k_s + kFaBK * D;               // [BK][D]
  float* q_s = v_s + kFaBK * D;               // [BQ][D + 1]
  float* do_s = q_s + kFaBQ * (D + 1);        // [BQ][D + 1]
  float* p_s = do_s + kFaBQ * (D + 1);        // [BK][BQ] dropped P^T
  float* ds_s = p_s + kFaBK * kFaBQ;          // [BK][BQ] dS^T
  float* lse_s = ds_s + kFaBK * kFaBQ;        // [BQ]
  float* dl_s = lse_s + kFaBQ;                // [BQ]
  int* segq_s = (int*)(dl_s + kFaBQ);         // [BQ]
  int* bound_s = segq_s + kFaBQ;              // [BQ]
  __shared__ int2 rows_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp == 0) {
    const KTileRows r = k_tile_rows<kFaBK>(seg_k, cu_q, cu_k, k0, Tq, Tk, n_seqs, causal, lane);
    if (lane == 0) rows_s = make_int2(r.begin, r.end);
  }
  for (int i = tid; i < kFaBK * D; i += kFaThreads) {
    const int r = i / D, c = i - r * D;
    const int key = k0 + r;
    const bool ok = key < Tk;
    k_s[i] = ok ? to_f32(k[(long long)key * k_stride + hk * D + c]) : 0.f;
    v_s[i] = ok ? to_f32(v[(long long)key * v_stride + hk * D + c]) : 0.f;
  }
  int seg_r[kFaRows];
#pragma unroll
  for (int r = 0; r < kFaRows; ++r) {
    const int key = k0 + warp * kFaRows + r;
    seg_r[r] = key < Tk ? seg_k[key] : -2;  // -2 matches no row
  }
  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;
  __syncthreads();
  const int q_begin = rows_s.x, q_end = rows_s.y;

  float acc_k[kFaRows][NC], acc_v[kFaRows][NC];
#pragma unroll
  for (int r = 0; r < kFaRows; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc_k[r][c] = 0.f;
      acc_v[r][c] = 0.f;
    }

  for (int hh = 0; hh < G; ++hh) {
    const int h = hk * G + hh;
    for (int q0 = q_begin; q0 < q_end; q0 += kFaBQ) {
      __syncthreads();  // the previous tile's Q/dO/P/dS reads are done
      for (int i = tid; i < kFaBQ * D; i += kFaThreads) {
        const int r = i / D, c = i - r * D;
        const int row = q0 + r;
        const bool ok = row < q_end;
        q_s[r * (D + 1) + c] = ok ? to_f32(q[(long long)row * q_stride + h * D + c]) : 0.f;
        do_s[r * (D + 1) + c] = ok ? to_f32(dout[((long long)row * H + h) * D + c]) : 0.f;
      }
      if (tid < kFaBQ) {
        const int row = q0 + tid;
        const bool ok = row < q_end;
        const float l = ok ? lse[(long long)h * Tq + row] : 0.f;
        lse_s[tid] = l == -INFINITY ? 0.f : l;
        dl_s[tid] = ok ? delta[(long long)h * Tq + row] : 0.f;
        segq_s[tid] = ok ? seg_q[row] : -1;
        bound_s[tid] = ok ? bound[row] : -1;
      }
      __syncthreads();

      // transposed tiles: warp row r is key k0 + 8 warp + r, lane is q row
      // q0 + lane; s = K Q^T, dp = V dO^T
      float s[kFaRows], dp[kFaRows];
#pragma unroll
      for (int r = 0; r < kFaRows; ++r) {
        s[r] = 0.f;
        dp[r] = 0.f;
      }
      for (int d0 = 0; d0 < D; d0 += 32) {
        float qr[32];
#pragma unroll
        for (int dd = 0; dd < 32; ++dd) qr[dd] = q_s[lane * (D + 1) + d0 + dd];
#pragma unroll
        for (int r = 0; r < kFaRows; ++r) {
          const float* kr = k_s + (warp * kFaRows + r) * D + d0;
          float a = s[r];
#pragma unroll
          for (int dd = 0; dd < 32; ++dd) a += kr[dd] * qr[dd];
          s[r] = a;
        }
#pragma unroll
        for (int dd = 0; dd < 32; ++dd) qr[dd] = do_s[lane * (D + 1) + d0 + dd];
#pragma unroll
        for (int r = 0; r < kFaRows; ++r) {
          const float* vr = v_s + (warp * kFaRows + r) * D + d0;
          float a = dp[r];
#pragma unroll
          for (int dd = 0; dd < 32; ++dd) a += vr[dd] * qr[dd];
          dp[r] = a;
        }
      }

      const int row = q0 + lane;
      const int seg_row = segq_s[lane], bd = bound_s[lane];
      const float ls = lse_s[lane], dl = dl_s[lane];
#pragma unroll
      for (int r = 0; r < kFaRows; ++r) {
        const int key = k0 + warp * kFaRows + r;
        const bool masked = seg_row != seg_r[r] || (causal && key > bd);
        const float p = masked ? 0.f : expf(s[r] * scale - ls);
        float pd = p, d = dp[r];
        if (dropout) {
          const bool keep = dropout_keep(seed, (uint32_t)h, (uint32_t)row, (uint32_t)key, thresh);
          pd = keep ? p * inv_keep : 0.f;
          d = keep ? d * inv_keep : 0.f;
        }
        p_s[(warp * kFaRows + r) * kFaBQ + lane] = pd;
        ds_s[(warp * kFaRows + r) * kFaBQ + lane] = p * (d - dl) * scale;
      }
      __syncwarp();

      // acc_v[r, lane + 32c] += sum_t P^T[r, t] dO[t, lane + 32c]
      // acc_k[r, lane + 32c] += sum_t dS^T[r, t] Q[t, lane + 32c]
      for (int t = 0; t < kFaBQ; ++t) {
        float dov[NC], qv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dov[c] = do_s[t * (D + 1) + lane + 32 * c];
          qv[c] = q_s[t * (D + 1) + lane + 32 * c];
        }
#pragma unroll
        for (int r = 0; r < kFaRows; ++r) {
          const float pv = p_s[(warp * kFaRows + r) * kFaBQ + t];
          const float dsv = ds_s[(warp * kFaRows + r) * kFaBQ + t];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            acc_v[r][c] += pv * dov[c];
            acc_k[r][c] += dsv * qv[c];
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kFaRows; ++r) {
    const int key = k0 + warp * kFaRows + r;
    if (key < Tk) {
      const long long o = ((long long)key * Hkv + hk) * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        dk[o + lane + 32 * c] = from_f32<T>(acc_k[r][c]);
        dv[o + lane + 32 * c] = from_f32<T>(acc_v[r][c]);
      }
    }
  }
}

// ===========================================================================
// Tensor-core forward (bf16, fp16): vflash_fwd_tc_kernel computes what
// vflash_fwd_kernel computes and is held to the same plain version
// (_vflash_fwd_reference) at the same tolerance.
//
// What bounds it on the H100: operations, 4 * D * H * (visible pairs) FLOPs
// over the 989 TFLOP/s bf16/fp16 tensor-core peak. At the full-width case
// (8192 tokens packed from 8 documents, 16 heads of 128, causal) that is
// 48.0 GFLOP, 0.0486 ms; the bytes (q, k, v, out once) take 0.040 ms.
//
// What the design does about it: it is the dense flash_fwd_tc_kernel
// (flash_attention.cu) over packed segments. Every product runs on the
// tensor cores (mma.sync m16n8k16, fp32 accumulation, flash_mma.cuh); a
// block of 4 warps takes 64 q rows of one q head, Q stays in registers as
// A fragments, and K and V tiles of 64 keys are double-buffered with
// cp.async in the input type (padded rows, ldmatrix), read in place at the
// packed tensors' token strides (load_rows). The block loops only over the
// keys of its rows' segments, [k_begin, k_end) from q_tile_keys<64>:
// k_begin is a segment start, so key tiles are not 64-aligned; each tile
// row is a token addressed on its own, so that costs nothing. Softmax,
// masks and dropout run on the accumulator fragments in registers, and
// the element mask is evaluated only on tiles that need it: a tile needs
// none when all 64 rows lie in one segment (its keys are then that
// segment's), the tile is whole (k0 + 64 <= k_end), and under causal its
// last key is at most the rows' smallest bound. Every other tile tests
// col < k_end, seg_k[col] == seg_q[row] (seg_k of the tile is copied to
// shared memory beside K and V) and col <= bound[row] per element; a q
// tile that straddles a segment boundary always takes that path.
//
// Why P is split: P is fp32 and the tensor cores take it only as 16-bit
// inputs. In a CPU model of the dense kernels' rounding, P rounded once to
// bf16 misses chip_smoke.py's tolerance(dtype, 1e-4) by 12.1x; split as
// hi = T(p), lo = T(p - hi) with both products summed in fp32 it reaches
// 0.48 of it (tests/test_torch_flash_tc_numerics.py, which models this
// kernel's packed tiling too). So P.V takes two MMAs, and the row sum l
// comes from the fp32 p, undropped.
//
// Head dims above 128: the output tile o[D/8][4] alone takes D / 2 fp32
// registers a thread (128 at D 256), so Q's fragments, which take D / 4
// more, are re-read from shared memory at each key tile (as the dq kernels
// read Q and dO) instead of held in registers; and the shared memory,
// 5 x 64 x (D + 8) 16-bit values (165.5 KB at D 256), leaves room for one
// block per SM from D 192 up.
//
// Resources (ptxas -v for sm_90a, bf16 / fp16, as chip_smoke.py's [build]
// phase prints them; spill stores / loads) and dynamic shared memory:
//   vflash_fwd_tc_kernel  D 64: 158 / 157 registers, 45.5 KB;
//                         D 128: 218 / 218, 85.5 KB;
//                         D 256: 255 / 255 (spill 24 / 16 B each), 165.5 KB
//                         (D 224 spills most: 136 / 100 and 224 / 188 B)
// Up to D 128 registers and shared memory allow two blocks (8 warps) per
// SM.

template <int D>
static constexpr size_t vflash_fwd_tc_smem_bytes() {  // Q, 2 stages of K, V and seg_k
  return sizeof(uint16_t) * 5 * (size_t)kTcBlk * (D + kTcPad) + sizeof(int) * 2 * kTcBlk;
}

// blocks per SM the tensor-core kernels are compiled for: two up to D 128,
// one above (the register and shared-memory footprints grow with D)
__host__ __device__ constexpr int tc_min_blocks(int D) { return D <= 128 ? 2 : 1; }

// One block of 4 warps per (q head, 64-row q tile): warp w owns q rows
// q0 + 16w .. q0 + 16w + 15 and loops over 64-key tiles from k_begin.
// Grid (H, q tiles), heads fastest and the q tiles from the last: the
// blocks in flight read every head of one stretch of tokens (whole token
// rows of k and v), and within a segment the later rows, which see more
// keys, start first. out [Tq, H, D] (contiguous), lse [H, Tq].
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, tc_min_blocks(D))
vflash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     long long q_stride, long long k_stride, long long v_stride,
                     const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                     const int* __restrict__ bound, const int* __restrict__ cu_k,
                     const int* __restrict__ seed_ptr, T* __restrict__ out,
                     float* __restrict__ lse, int Tq, int Tk, int H, int Hkv, int n_seqs,
                     float scale, int causal, int dropout, uint32_t thresh, float inv_keep) {
  constexpr int LD = D + kTcPad;
  constexpr int KS = D / 16;      // k-steps of Q K^T
  constexpr int NT = kTcBlk / 8;  // score n-tiles (8 keys each)
  constexpr int DT = D / 8;       // output n-tiles
  constexpr bool kQInRegs = D <= 128;
  const int h = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * kTcBlk;
  const int hk = h / (H / Hkv);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);                    // [64][LD]
  T* k_s = q_s + kTcBlk * LD;                                 // [2][64][LD]
  T* v_s = k_s + 2 * kTcBlk * LD;                             // [2][64][LD]
  int* sk_s = reinterpret_cast<int*>(v_s + 2 * kTcBlk * LD);  // [2][64] seg_k
  __shared__ QTileKeys keys_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const T* kh = k + hk * D;
  const T* vh = v + hk * D;

  load_rows<T, kTcBlk, D>(q_s, q + h * D, q_stride, q0, Tq, tid);
  cp_async_commit();
  if (warp == 0) {
    const QTileKeys r = q_tile_keys<kTcBlk>(seg_q, bound, cu_k, q0, Tq, Tk, n_seqs, causal, lane);
    if (lane == 0) keys_s = r;
  }
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  int seg_r[2], bound_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    seg_r[i] = row < Tq ? seg_q[row] : -1;  // -1 matches no key
    bound_r[i] = row < Tq ? bound[row] : -1;
  }
  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;
  __syncthreads();
  const QTileKeys keys = keys_s;
  const int k_begin = keys.begin, k_end = keys.end;
  const int n_tiles = (k_end - k_begin + kTcBlk - 1) / kTcBlk;

  // keys [k0, k0 + 64) into stage st; keys at or past k_end zero-filled
  auto load_kv = [&](int st, int k0) {
    load_rows<T, kTcBlk, D>(k_s + st * kTcBlk * LD, kh, k_stride, k0, k_end, tid);
    load_rows<T, kTcBlk, D>(v_s + st * kTcBlk * LD, vh, v_stride, k0, k_end, tid);
    if (tid < kTcBlk) {
      const bool ok = k0 + tid < k_end;
      cp_async4(sk_s + st * kTcBlk + tid, ok ? seg_k + k0 + tid : seg_k, ok);
    }
  };
  if (n_tiles > 0) load_kv(0, k_begin);
  cp_async_commit();

  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t qf[kQInRegs ? KS : 1][4];  // Q's A fragments, where D <= 128

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_begin + j * kTcBlk;
    if (j + 1 < n_tiles) {
      load_kv((j + 1) & 1, k0 + kTcBlk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQInRegs) {
      if (j == 0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          ldsm_x4(qf[ks], frag_a<LD>(q_s, warp * 16, ks * 16, lane));
      }
    }
    const T* kt = k_s + (j & 1) * kTcBlk * LD;
    const T* vt = v_s + (j & 1) * kTcBlk * LD;
    const int* skt = sk_s + (j & 1) * kTcBlk;

    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = qf[ks][r];
      } else {
        ldsm_x4(a, frag_a<LD>(q_s, warp * 16, ks * 16, lane));
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, frag_b_nk<LD>(kt, np * 16, ks * 16, lane));
        mma16816<T>(s[2 * np], a, kb[0], kb[1]);
        mma16816<T>(s[2 * np + 1], a, kb[2], kb[3]);
      }
    }

    // logits; the element mask only where the tile needs it (a uniform
    // branch: every thread of the block takes the same side)
    const bool no_mask = keys.seg >= 0 && k0 + kTcBlk <= k_end &&
                         (!causal || k0 + kTcBlk - 1 <= keys.min_bound);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t4 + (e & 1);
        const int i = e >> 1;
        float x = s[nt][e] * scale;
        if (!no_mask) {
          const int col = k0 + c;
          const bool vis = col < k_end && skt[c] == seg_r[i] && (!causal || col <= bound_r[i]);
          if (!vis) x = -INFINITY;
        }
        s[nt][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    float alpha[2], mel[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = quad_max(mx[i]);
      // a row may still see no key: keep exp arguments finite so it stays
      // exactly 0 instead of NaN (the TPU kernel's m_eff)
      const float m_eff = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = exp2f((m[i] - m_eff) * kLog2e);
      mel[i] = m_eff * kLog2e;
      m[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[nt][e], kLog2e, -mel[e >> 1]));
        rs[e >> 1] += p;  // the denominator: fp32 p, undropped
        if (dropout) {
          const int col = k0 + nt * 8 + 2 * t4 + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          p = dropout_keep(seed, (uint32_t)h, (uint32_t)row, (uint32_t)col, thresh) ? p * inv_keep
                                                                                   : 0.f;
        }
        s[nt][e] = p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // o += P V, P as hi + lo
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t ah[4], al[4];
      acc_to_a<T>(s[2 * kk], s[2 * kk + 1], ah, al);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, frag_b_kn<LD>(vt, kk * 16, dp * 16, lane));
        mma16816<T>(o[2 * dp], al, vb[0], vb[1]);
        mma16816<T>(o[2 * dp], ah, vb[0], vb[1]);
        mma16816<T>(o[2 * dp + 1], al, vb[2], vb[3]);
        mma16816<T>(o[2 * dp + 1], ah, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is reloaded by the next iteration's copy
  }
  cp_async_wait<0>();  // a block with no key tile still has Q's copy in flight

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lt = quad_sum(l[i]);
    const int row = row0 + i * 8;
    if (row < Tq) {
      const float ls = lt == 0.f ? 1.f : lt;
      T* orow = out + ((long long)row * H + h) * D + 2 * t4;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<uint32_t*>(orow + dt * 8) =
            pack2<T>(o[dt][2 * i] / ls, o[dt][2 * i + 1] / ls);
      if (t4 == 0) lse[(long long)h * Tq + row] = lt == 0.f ? -INFINITY : m[i] + logf(ls);
    }
  }
}

// ===========================================================================
// Tensor-core backward (bf16, fp16): vflash_bwd_dq_tc_kernel and
// vflash_bwd_dkv_tc_kernel compute what vflash_bwd_dq_kernel and
// vflash_bwd_dkv_kernel compute and are held to the same plain version
// (_vflash_bwd_reference) at the same tolerance.
//
// What bounds them on the H100: operations, 5 products of 2 * D * H *
// (visible pairs) FLOPs over the 989 TFLOP/s bf16/fp16 tensor-core peak. At
// the full-width case (8192 tokens packed from 8 documents, 16 heads of
// 128, causal) that is 120.1 GFLOP, 0.1214 ms.
//
// What the design does about it: it is the dense flash_bwd_dq_tc_kernel and
// flash_bwd_dkv_tc_kernel (flash_attention.cu) over packed segments, with
// the varlen forward's key ranges and mask rule. Every product runs on the
// tensor cores (mma.sync m16n8k16, fp32 accumulation); tiles stay in the
// input type in shared memory, read in place at the packed tensors' token
// strides (load_rows), and the streamed tiles are double-buffered with
// cp.async.
//   dq: one block of 4 warps per (q head, 64-row q tile), grid order as the
//   forward's. It loops over the 64-key tiles of q_tile_keys<64> from
//   k_begin (a segment start), S = Q K^T and dP = dO V^T from Q and dO
//   re-read from shared memory, dS = P * (dP - delta) * scale in registers,
//   dQ += dS K.
//   dk/dv: one block per (kv head, 64-key tile); warp w owns keys
//   k0 + 16w .. k0 + 16w + 15. It loops over the GQA group's q heads and,
//   for each, over the q rows [begin, end) of k_tile_rows<64> in steps of
//   32 rows (Q, dO, lse, delta, seg_q and bound of a step double-buffered),
//   computes the transposed tiles S^T = K Q^T and dP^T = V dO^T, then
//   dV += (keep * c * P)^T dO and dK += dS^T Q. The group sum stays in fp32
//   registers and is cast once: deterministic, no atomics.
// The element mask is evaluated only on tiles that need it. A dq tile needs
// none by the forward's rule (all 64 rows in one segment, the key tile
// whole, under causal its last key at most the rows' smallest bound). A
// dk/dv step needs none when all 64 keys lie in one segment s, the step's
// 32 rows all lie in s (seg_q of its first and last row is s; seg_q does
// not decrease along the rows), and under causal the tile's last key is at
// most the first row's bound (bound grows along a segment's rows).
//
// Why P and dS are split: as in the dense kernels (flash_attention.cu),
// a single bf16 rounding of dS before dS K misses chip_smoke.py's
// tolerance (tests/test_torch_flash_varlen_tc_backward.py models this
// kernel's tiling and rounding), so dS K, P^T dO and dS^T Q each take
// hi = T(x) and lo = T(x - hi), two MMAs summed in fp32.
//
// Head dims above 128. dq: the fp32 dQ tile takes D / 2 registers a
// thread (128 at D 256), so the score and dP tiles are taken 32 keys at a
// time (16 registers each) instead of 64. dk/dv: per-warp fp32 dK and dV
// take D registers a thread (256 at D 256), so the block makes two passes
// over the q rows, each accumulating and writing half of dK's and dV's
// columns (S^T and dP^T are computed in both passes: 8 MMA products where
// one pass does 6).
//
// Resources (ptxas -v for sm_90a, bf16 / fp16, as chip_smoke.py's [build]
// phase prints them; spill stores / loads) and dynamic shared memory,
// D 64 / 128 / 256:
//   vflash_bwd_dq_tc_kernel   202 / 202, 236 / 236, 255 / 255 registers (D 256
//                             spills 4 / 4 B each; D 224 128 / 192 and
//                             208 / 292 B); 54.5 / 102.5 / 198.5 KB
//   vflash_bwd_dkv_tc_kernel  166 / 166, 242 / 252, 255 / 247 registers (D 256
//                             bf16 spills 20 / 28 B); 37.0 / 69.0 / 133.0 KB
// Up to D 128 two blocks (8 warps) fit an SM; above, one. Being right
// above D 128 is what this design asks; the spills there are left as they
// are (PERF.md has the times by head dim).

// q rows per step of the dk/dv kernel: with 16 keys of dK and dV per warp
// in fp32 registers, a 32-row step keeps the score and dP tiles at 16
// registers each (the dense kernel's kTcDkvRows)
constexpr int kTcDkvRows = 32;

// keys per score step of the dq kernel
__host__ __device__ constexpr int dq_sub_keys(int D) { return D <= 128 ? kTcBlk : kTcBlk / 2; }
// dK/dV columns per pass of the dk/dv kernel
__host__ __device__ constexpr int dkv_pass_cols(int D) { return D <= 128 ? D : D / 2; }

template <int D>
static constexpr size_t vflash_dq_tc_smem_bytes() {  // Q, dO, 2 stages of K, V and seg_k
  return sizeof(uint16_t) * 6 * (size_t)kTcBlk * (D + kTcPad) + sizeof(int) * 2 * kTcBlk;
}

// dq [Tq, H, D] (contiguous); dout [Tq, H, D] (contiguous); lse, delta [H, Tq].
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, tc_min_blocks(D))
vflash_bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, long long q_stride, long long k_stride,
                        long long v_stride, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                        const int* __restrict__ bound, const int* __restrict__ cu_k,
                        const int* __restrict__ seed_ptr, T* __restrict__ dq, int Tq, int Tk,
                        int H, int Hkv, int n_seqs, float scale, int causal, int dropout,
                        uint32_t thresh, float inv_keep) {
  constexpr int LD = D + kTcPad;
  constexpr int KS = D / 16;              // k-steps of Q K^T and dO V^T
  constexpr int KSUB = dq_sub_keys(D);    // keys per score step
  constexpr int NT = KSUB / 8;            // score n-tiles per step
  constexpr int DT = D / 8;               // dQ n-tiles
  const int h = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * kTcBlk;
  const int hk = h / (H / Hkv);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);                    // [64][LD]
  T* do_s = q_s + kTcBlk * LD;                                // [64][LD]
  T* k_s = do_s + kTcBlk * LD;                                // [2][64][LD]
  T* v_s = k_s + 2 * kTcBlk * LD;                             // [2][64][LD]
  int* sk_s = reinterpret_cast<int*>(v_s + 2 * kTcBlk * LD);  // [2][64] seg_k
  __shared__ QTileKeys keys_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const T* kh = k + hk * D;
  const T* vh = v + hk * D;

  load_rows<T, kTcBlk, D>(q_s, q + h * D, q_stride, q0, Tq, tid);
  load_rows<T, kTcBlk, D>(do_s, dout + h * D, (long long)H * D, q0, Tq, tid);
  cp_async_commit();
  if (warp == 0) {
    const QTileKeys r = q_tile_keys<kTcBlk>(seg_q, bound, cu_k, q0, Tq, Tk, n_seqs, causal, lane);
    if (lane == 0) keys_s = r;
  }
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  int seg_r[2], bound_r[2];
  float lse_l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    const bool ok = row < Tq;
    seg_r[i] = ok ? seg_q[row] : -1;  // -1 matches no key
    bound_r[i] = ok ? bound[row] : -1;
    const float lv = ok ? lse[(long long)h * Tq + row] : 0.f;
    lse_l2[i] = (lv == -INFINITY ? 0.f : lv) * kLog2e;  // a row that saw no key: P = 0
    dl[i] = ok ? delta[(long long)h * Tq + row] : 0.f;
  }
  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;
  __syncthreads();
  const QTileKeys keys = keys_s;
  const int k_begin = keys.begin, k_end = keys.end;
  const int n_tiles = (k_end - k_begin + kTcBlk - 1) / kTcBlk;

  // keys [k0, k0 + 64) into stage st; keys at or past k_end zero-filled
  auto load_kv = [&](int st, int k0) {
    load_rows<T, kTcBlk, D>(k_s + st * kTcBlk * LD, kh, k_stride, k0, k_end, tid);
    load_rows<T, kTcBlk, D>(v_s + st * kTcBlk * LD, vh, v_stride, k0, k_end, tid);
    if (tid < kTcBlk) {
      const bool ok = k0 + tid < k_end;
      cp_async4(sk_s + st * kTcBlk + tid, ok ? seg_k + k0 + tid : seg_k, ok);
    }
  };
  if (n_tiles > 0) load_kv(0, k_begin);
  cp_async_commit();

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_begin + j * kTcBlk;
    if (j + 1 < n_tiles) {
      load_kv((j + 1) & 1, k0 + kTcBlk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kt = k_s + (j & 1) * kTcBlk * LD;
    const T* vt = v_s + (j & 1) * kTcBlk * LD;
    const int* skt = sk_s + (j & 1) * kTcBlk;
    // the forward's rule (a uniform branch)
    const bool no_mask = keys.seg >= 0 && k0 + kTcBlk <= k_end &&
                         (!causal || k0 + kTcBlk - 1 <= keys.min_bound);

#pragma unroll
    for (int c0 = 0; c0 < kTcBlk; c0 += KSUB) {
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[i][e] = 0.f;
          dp[i][e] = 0.f;
        }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, frag_a<LD>(q_s, warp * 16, ks * 16, lane));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t kb[4];
          ldsm_x4(kb, frag_b_nk<LD>(kt, c0 + np * 16, ks * 16, lane));
          mma16816<T>(s[2 * np], a, kb[0], kb[1]);
          mma16816<T>(s[2 * np + 1], a, kb[2], kb[3]);
        }
        ldsm_x4(a, frag_a<LD>(do_s, warp * 16, ks * 16, lane));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t vb[4];
          ldsm_x4(vb, frag_b_nk<LD>(vt, c0 + np * 16, ks * 16, lane));
          mma16816<T>(dp[2 * np], a, vb[0], vb[1]);
          mma16816<T>(dp[2 * np + 1], a, vb[2], vb[3]);
        }
      }

#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + nt * 8 + 2 * t4 + (e & 1);
          const int i = e >> 1;
          const int col = k0 + c;
          const bool vis = no_mask || (col < k_end && skt[c] == seg_r[i] &&
                                       (!causal || col <= bound_r[i]));
          const float p = vis ? exp2f(fmaf(s[nt][e] * scale, kLog2e, -lse_l2[i])) : 0.f;
          float d = dp[nt][e];
          if (dropout) {
            const int row = row0 + i * 8;
            d = dropout_keep(seed, (uint32_t)h, (uint32_t)row, (uint32_t)col, thresh)
                    ? d * inv_keep
                    : 0.f;
          }
          s[nt][e] = p * (d - dl[i]) * scale;  // dS
        }

      // dQ += dS K, dS as hi + lo; K read as [key][d] = [k][n]
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        uint32_t ah[4], al[4];
        acc_to_a<T>(s[2 * kk], s[2 * kk + 1], ah, al);
#pragma unroll
        for (int dp2 = 0; dp2 < DT / 2; ++dp2) {
          uint32_t kb[4];
          ldsm_x4_trans(kb, frag_b_kn<LD>(kt, c0 + kk * 16, dp2 * 16, lane));
          mma16816<T>(acc[2 * dp2], al, kb[0], kb[1]);
          mma16816<T>(acc[2 * dp2], ah, kb[0], kb[1]);
          mma16816<T>(acc[2 * dp2 + 1], al, kb[2], kb[3]);
          mma16816<T>(acc[2 * dp2 + 1], ah, kb[2], kb[3]);
        }
      }
    }
    __syncthreads();  // this stage is reloaded by the next iteration's copy
  }
  cp_async_wait<0>();  // a block with no key tile still has Q's and dO's copies in flight

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row < Tq) {
      T* orow = dq + ((long long)row * H + h) * D + 2 * t4;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<uint32_t*>(orow + dt * 8) = pack2<T>(acc[dt][2 * i], acc[dt][2 * i + 1]);
    }
  }
}

template <int D>
static constexpr size_t vflash_dkv_tc_smem_bytes() {
  // K, V; 2 stages of Q and dO; 2 stages of lse, delta, seg_q and bound
  return sizeof(uint16_t) * (2 * (size_t)kTcBlk + 4 * (size_t)kTcDkvRows) * (D + kTcPad) +
         sizeof(float) * 8 * kTcDkvRows;
}

// dk, dv [Tk, Hkv, D] (contiguous). Grid (Hkv, key tiles), heads fastest.
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, tc_min_blocks(D))
vflash_bwd_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, long long q_stride, long long k_stride,
                         long long v_stride, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                         const int* __restrict__ bound, const int* __restrict__ cu_q,
                         const int* __restrict__ cu_k, const int* __restrict__ seed_ptr,
                         T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk, int H, int Hkv,
                         int n_seqs, float scale, int causal, int dropout, uint32_t thresh,
                         float inv_keep) {
  constexpr int LD = D + kTcPad;
  constexpr int KS = D / 16;
  constexpr int BQ = kTcDkvRows;
  constexpr int NQ = BQ / 8;              // n-tiles of q rows
  constexpr int DC = dkv_pass_cols(D);    // dK/dV columns per pass
  constexpr int DT = DC / 8;
  static_assert(BQ == 32, "one warp stages each per-row vector of a step");
  const int hk = blockIdx.x, k0 = blockIdx.y * kTcBlk;
  const int G = H / Hkv;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);                      // [64][LD]
  T* v_s = k_s + kTcBlk * LD;                                   // [64][LD]
  T* q_s = v_s + kTcBlk * LD;                                   // [2][32][LD]
  T* do_s = q_s + 2 * BQ * LD;                                  // [2][32][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BQ * LD);  // [2][32]
  float* dl_s = lse_s + 2 * BQ;                                 // [2][32]
  int* sq_s = reinterpret_cast<int*>(dl_s + 2 * BQ);            // [2][32] seg_q
  int* bd_s = sq_s + 2 * BQ;                                    // [2][32] bound
  __shared__ KTileRows rows_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;

  load_rows<T, kTcBlk, D>(k_s, k + hk * D, k_stride, k0, Tk, tid);
  load_rows<T, kTcBlk, D>(v_s, v + hk * D, v_stride, k0, Tk, tid);
  cp_async_commit();
  if (warp == 0) {
    const KTileRows r = k_tile_rows<kTcBlk>(seg_k, cu_q, cu_k, k0, Tq, Tk, n_seqs, causal, lane);
    if (lane == 0) rows_s = r;
  }
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  int segk_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    segk_r[i] = key < Tk ? seg_k[key] : -2;  // -2 matches no row
  }
  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;
  __syncthreads();
  const KTileRows rows = rows_s;
  const int q_begin = rows.begin, q_end = rows.end;
  const int n_qt = (q_end - q_begin + BQ - 1) / BQ;
  const int n_it = G * n_qt;

  // step it (q head hk * G + it / n_qt, rows from q_begin + (it % n_qt) * 32)
  // into stage st; rows at or past q_end zero-filled
  auto load_step = [&](int it, int st) {
    const int hh = it / n_qt;
    const int q0 = q_begin + (it - hh * n_qt) * BQ;
    const int h = hk * G + hh;
    load_rows<T, BQ, D>(q_s + st * BQ * LD, q + h * D, q_stride, q0, q_end, tid);
    load_rows<T, BQ, D>(do_s + st * BQ * LD, dout + h * D, (long long)H * D, q0, q_end, tid);
    const int r = tid & (BQ - 1), row = q0 + r;
    const bool ok = row < q_end;
    switch (tid / BQ) {  // warp w stages one per-row vector
      case 0:
        cp_async4(lse_s + st * BQ + r, ok ? lse + (long long)h * Tq + row : lse, ok);
        break;
      case 1:
        cp_async4(dl_s + st * BQ + r, ok ? delta + (long long)h * Tq + row : delta, ok);
        break;
      case 2:
        cp_async4(sq_s + st * BQ + r, ok ? seg_q + row : seg_q, ok);
        break;
      default:
        cp_async4(bd_s + st * BQ + r, ok ? bound + row : bound, ok);
    }
  };

  for (int c0 = 0; c0 < D; c0 += DC) {  // one pass up to D 128, two above
    if (n_it > 0) load_step(0, 0);
    cp_async_commit();

    float acc_k[DT][4], acc_v[DT][4];
#pragma unroll
    for (int i = 0; i < DT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_k[i][e] = 0.f;
        acc_v[i][e] = 0.f;
      }

    for (int it = 0; it < n_it; ++it) {
      if (it + 1 < n_it) {
        load_step(it + 1, (it + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int hh = it / n_qt;
      const int q0 = q_begin + (it - hh * n_qt) * BQ;
      const int h = hk * G + hh;
      const int st = it & 1;
      const T* qt = q_s + st * BQ * LD;
      const T* dot = do_s + st * BQ * LD;
      const float* ls = lse_s + st * BQ;
      const float* dls = dl_s + st * BQ;
      const int* sqs = sq_s + st * BQ;
      const int* bds = bd_s + st * BQ;

      // transposed tiles: rows are this warp's 16 keys, columns 32 q rows
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int i = 0; i < NQ; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[i][e] = 0.f;
          dp[i][e] = 0.f;
        }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, frag_a<LD>(k_s, warp * 16, ks * 16, lane));
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t qb[4];
          ldsm_x4(qb, frag_b_nk<LD>(qt, np * 16, ks * 16, lane));
          mma16816<T>(s[2 * np], a, qb[0], qb[1]);
          mma16816<T>(s[2 * np + 1], a, qb[2], qb[3]);
        }
        ldsm_x4(a, frag_a<LD>(v_s, warp * 16, ks * 16, lane));
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t ob[4];
          ldsm_x4(ob, frag_b_nk<LD>(dot, np * 16, ks * 16, lane));
          mma16816<T>(dp[2 * np], a, ob[0], ob[1]);
          mma16816<T>(dp[2 * np + 1], a, ob[2], ob[3]);
        }
      }

      // the step needs no mask when keys and rows lie in one segment and,
      // under causal, the first row sees the tile's last key (uniform)
      const bool no_mask = rows.seg >= 0 && q0 + BQ <= q_end && sqs[0] == rows.seg &&
                           sqs[BQ - 1] == rows.seg && (!causal || k0 + kTcBlk - 1 <= bds[0]);
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + 2 * t4 + (e & 1);
          const int row = q0 + c;
          const int key = key0 + (e >> 1) * 8;
          const bool vis = no_mask || (row < q_end && sqs[c] == segk_r[e >> 1] &&
                                       (!causal || key <= bds[c]));
          const float lv = ls[c];
          const float p =
              vis ? exp2f(fmaf(s[nt][e] * scale, kLog2e, -(lv == -INFINITY ? 0.f : lv) * kLog2e))
                  : 0.f;
          float pd = p, d = dp[nt][e];
          if (dropout) {
            const bool keep = dropout_keep(seed, (uint32_t)h, (uint32_t)row, (uint32_t)key, thresh);
            pd = keep ? p * inv_keep : 0.f;
            d = keep ? d * inv_keep : 0.f;
          }
          s[nt][e] = pd;                         // dropped P^T
          dp[nt][e] = p * (d - dls[c]) * scale;  // dS^T
        }

      // dV += P^T dO and dK += dS^T Q over this step's 32 q rows (2
      // k-steps), columns [c0, c0 + DC); dO and Q read as [row][d] = [k][n]
#pragma unroll
      for (int kk = 0; kk < NQ / 2; ++kk) {
        uint32_t ph[4], pl[4], dh[4], dlo[4];
        acc_to_a<T>(s[2 * kk], s[2 * kk + 1], ph, pl);
        acc_to_a<T>(dp[2 * kk], dp[2 * kk + 1], dh, dlo);
#pragma unroll
        for (int dp2 = 0; dp2 < DT / 2; ++dp2) {
          uint32_t bo[4], bq[4];
          ldsm_x4_trans(bo, frag_b_kn<LD>(dot, kk * 16, c0 + dp2 * 16, lane));
          mma16816<T>(acc_v[2 * dp2], pl, bo[0], bo[1]);
          mma16816<T>(acc_v[2 * dp2], ph, bo[0], bo[1]);
          mma16816<T>(acc_v[2 * dp2 + 1], pl, bo[2], bo[3]);
          mma16816<T>(acc_v[2 * dp2 + 1], ph, bo[2], bo[3]);
          ldsm_x4_trans(bq, frag_b_kn<LD>(qt, kk * 16, c0 + dp2 * 16, lane));
          mma16816<T>(acc_k[2 * dp2], dlo, bq[0], bq[1]);
          mma16816<T>(acc_k[2 * dp2], dh, bq[0], bq[1]);
          mma16816<T>(acc_k[2 * dp2 + 1], dlo, bq[2], bq[3]);
          mma16816<T>(acc_k[2 * dp2 + 1], dh, bq[2], bq[3]);
        }
      }
      __syncthreads();  // this stage is reloaded by a later copy
    }
    cp_async_wait<0>();  // a tile no row sees still has K's and V's copies in flight

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key0 + i * 8;
      if (key < Tk) {
        const long long o = ((long long)key * Hkv + hk) * D + c0 + 2 * t4;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          *reinterpret_cast<uint32_t*>(dk + o + dt * 8) =
              pack2<T>(acc_k[dt][2 * i], acc_k[dt][2 * i + 1]);
          *reinterpret_cast<uint32_t*>(dv + o + dt * 8) =
              pack2<T>(acc_v[dt][2 * i], acc_v[dt][2 * i + 1]);
        }
      }
    }
  }
}

// ===========================================================================
// Wide route (fp32, bf16, fp16; D > 256): vflash_fwd_wide_kernel,
// vflash_bwd_dq_wide_kernel and vflash_bwd_dkv_wide_kernel compute what the
// kernels above compute and are held to the same plain versions at the same
// tolerance. D is a run-time argument, a multiple of 32 (the wrapper pads
// as for the compiled head dims).
//
// What bounds them on the H100: the operations, as above. No model in either
// package has heads this wide; the aim is a right result on the CUDA cores,
// all math in fp32.
//
// Design: the CUDA-core kernels' tiles (32 q rows x 32 keys, 4 warps of 8
// rows, the same key and row ranges from q_tile_keys / k_tile_rows, the same
// masks, dropout hash, lse and GQA), with two changes that let D grow past
// what registers hold. The fp32 row accumulator (O, dQ; dK or dV) lives in
// shared memory, [32][D], each entry read and written by one thread only
// (row r by warp r / 8, column c by lane c % 32), so it needs no barrier.
// And the products over D are taken 32 columns at a time: Q K^T (and dO V^T)
// from 32-column chunks of both operands staged in shared memory, and
// P V, dS K, P^T dO, dS^T Q 32 output columns at a time, the second operand
// read from global memory (its 32 columns are one coalesced row segment,
// shared by the block's 4 warps through L1). The dk/dv kernel makes two
// passes over its rows, dV then dK, so that one [32][D] accumulator is
// enough. Shared memory: 128 Dc + 12.1 KB (forward), 128 Dc + 20.3 KB (dq),
// 128 Dc + 20.8 KB (dk/dv), where Dc <= kWideMaxD is the accumulator's
// width: 212.8 KB at kWideMaxD, under the 227 KB a block may use.
//
// Above kWideMaxD the accumulator's columns are split across blocks: D is
// cut into n = ceil(D / kWideMaxD) column ranges [c0, c0 + Dc), Dc =
// ceil(D / n) rounded up to 32 (wide_range_cols; the last range may be
// narrower), one per blockIdx.z. Every block still takes the products
// over the full D, 32 columns at a time (S = Q K^T, and dP = dO V^T in the
// backward), and accumulates only its own columns of O, dQ, dK or dV; the
// range at c0 = 0 writes the lse, which every range computes alike, and
// the dropout hash reads only the global row and column, so every range
// draws the same bits. With one range (D <= kWideMaxD) the launch takes the
// kernels' kRanges = false instances, whose column bounds are compile-time
// 0 and D: the code, launches and bits of the kernels before the split.
constexpr int kWideMaxD = 1536;
constexpr int kWideChunk = 32;  // columns of D per staged chunk

// Columns of one range of the wide kernels' accumulator for head dim D.
static int wide_range_cols(int D) {
  const int n = (D + kWideMaxD - 1) / kWideMaxD;
  return ((D + n - 1) / n + kWideChunk - 1) / kWideChunk * kWideChunk;
}

// Shared memory of the wide kernels for an accumulator of Dc columns.
static size_t vflash_fwd_wide_smem_bytes(int Dc) {  // O, Q chunk, K chunk, P
  return sizeof(float) * ((size_t)kFaBQ * Dc + kFaBQ * kWideChunk + kFaBK * (kWideChunk + 1) +
                          kFaBQ * kFaBK);
}

static size_t vflash_dq_wide_smem_bytes(int Dc) {  // dQ, Q / dO chunks, K / V chunks, dS
  return sizeof(float) * ((size_t)kFaBQ * Dc + 2 * kFaBQ * kWideChunk +
                          2 * kFaBK * (kWideChunk + 1) + kFaBQ * kFaBK);
}

static size_t vflash_dkv_wide_smem_bytes(int Dc) {  // dV / dK, K / V chunks, Q / dO chunks, P / dS, rows
  return sizeof(float) * ((size_t)kFaBK * Dc + 2 * kFaBK * kWideChunk +
                          2 * kFaBQ * (kWideChunk + 1) + kFaBK * kFaBQ + 2 * kFaBQ) +
         sizeof(int) * 2 * kFaBQ;
}

// One block per (32-row q tile, q head, column range): out [Tq, H, D]
// (contiguous), lse [H, Tq].
template <typename T, bool kRanges>
__global__ void __launch_bounds__(kFaThreads)
vflash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       long long q_stride, long long k_stride, long long v_stride,
                       const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                       const int* __restrict__ bound, const int* __restrict__ cu_k,
                       const int* __restrict__ seed_ptr, T* __restrict__ out,
                       float* __restrict__ lse, int Tq, int Tk, int H, int Hkv, int D, int Dc,
                       int n_seqs, float scale, int causal, int dropout, uint32_t thresh,
                       float inv_keep) {
  constexpr int C = kWideChunk;
  const int q0 = blockIdx.x * kFaBQ, h = blockIdx.y;
  const int hk = h / (H / Hkv);
  const long long q_off = (long long)h * D, kv_off = (long long)hk * D;
  // this block's columns of O: [c_lo, c_lo + Dw), at column c of o_s and c_lo + c of v, out
  // (one range, !kRanges: all of D, compiled as the kernel was before ranges)
  const int Dc_ = kRanges ? Dc : D;
  const int c_lo = kRanges ? blockIdx.z * Dc_ : 0, Dw = kRanges ? min(Dc_, D - c_lo) : D;

  extern __shared__ __align__(16) float sm[];
  float* o_s = sm;                  // [BQ][Dc] fp32 output accumulator
  float* q_c = o_s + kFaBQ * Dc_;    // [BQ][C]
  float* k_c = q_c + kFaBQ * C;     // [BK][C + 1]
  float* p_s = k_c + kFaBK * (C + 1);  // [BQ][BK]
  __shared__ int2 keys_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp == 0) {
    const QTileKeys r = q_tile_keys<kFaBQ>(seg_q, bound, cu_k, q0, Tq, Tk, n_seqs, causal, lane);
    if (lane == 0) keys_s = make_int2(r.begin, r.end);
  }
  int seg_r[kFaRows], bound_r[kFaRows];
#pragma unroll
  for (int r = 0; r < kFaRows; ++r) {
    const int row = q0 + warp * kFaRows + r;
    seg_r[r] = row < Tq ? seg_q[row] : -1;  // -1 matches no key
    bound_r[r] = row < Tq ? bound[row] : -1;
    for (int c0 = 0; c0 < Dw; c0 += C) o_s[(warp * kFaRows + r) * Dc_ + c0 + lane] = 0.f;
  }
  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;
  __syncthreads();
  const int k_begin = keys_s.x, k_end = keys_s.y;
  const T* v_cols = v + c_lo;

  float m[kFaRows], l[kFaRows];
#pragma unroll
  for (int r = 0; r < kFaRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kFaBK) {
    // scores: lane owns key col = k0 + lane for the warp's 8 rows
    float s[kFaRows];
#pragma unroll
    for (int r = 0; r < kFaRows; ++r) s[r] = 0.f;
    for (int d0 = 0; d0 < D; d0 += C) {
      __syncthreads();  // the previous chunk's reads are done
      for (int i = tid; i < kFaBQ * C; i += kFaThreads) {
        const int r = i / C, c = i - r * C;
        const int row = q0 + r, key = k0 + r;
        q_c[i] = row < Tq ? to_f32(q[(long long)row * q_stride + q_off + d0 + c]) : 0.f;
        k_c[r * (C + 1) + c] =
            key < k_end ? to_f32(k[(long long)key * k_stride + kv_off + d0 + c]) : 0.f;
      }
      __syncthreads();
      float kr[C];
#pragma unroll
      for (int dd = 0; dd < C; ++dd) kr[dd] = k_c[lane * (C + 1) + dd];
#pragma unroll
      for (int r = 0; r < kFaRows; ++r) {
        const float* qr = q_c + (warp * kFaRows + r) * C;
        float a = s[r];
#pragma unroll
        for (int dd = 0; dd < C; ++dd) a += qr[dd] * kr[dd];
        s[r] = a;
      }
    }

    const int col = k0 + lane;
    const int seg_c = col < k_end ? seg_k[col] : -2;  // -2 matches no row
    float alpha[kFaRows];
#pragma unroll
    for (int r = 0; r < kFaRows; ++r) {
      const int row = q0 + warp * kFaRows + r;
      float x = s[r] * scale;
      if (seg_r[r] != seg_c || (causal && col > bound_r[r])) x = -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float m_eff = m_new == -INFINITY ? 0.f : m_new;  // a row may see no key
      alpha[r] = expf(m[r] - m_eff);
      const float p = expf(x - m_eff);
      l[r] = l[r] * alpha[r] + p;  // lane-partial row sum, undropped
      m[r] = m_new;
      float pu = p;
      if (dropout) {
        pu = dropout_keep(seed, (uint32_t)h, (uint32_t)row, (uint32_t)col, thresh) ? p * inv_keep
                                                                                 : 0.f;
      }
      p_s[(warp * kFaRows + r) * kFaBK + lane] = pu;
    }
    __syncwarp();

    // o[r, c] = alpha[r] * o[r, c] + sum_t P[r, t] V[t, c], 32 columns at a time
    const int n_t = min(kFaBK, k_end - k0);
    for (int c0 = 0; c0 < Dw; c0 += C) {
      float acc[kFaRows];
#pragma unroll
      for (int r = 0; r < kFaRows; ++r)
        acc[r] = o_s[(warp * kFaRows + r) * Dc_ + c0 + lane] * alpha[r];
      for (int t = 0; t < n_t; ++t) {
        const float vv = to_f32(v_cols[(long long)(k0 + t) * v_stride + kv_off + c0 + lane]);
#pragma unroll
        for (int r = 0; r < kFaRows; ++r) acc[r] += p_s[(warp * kFaRows + r) * kFaBK + t] * vv;
      }
#pragma unroll
      for (int r = 0; r < kFaRows; ++r) o_s[(warp * kFaRows + r) * Dc_ + c0 + lane] = acc[r];
    }
  }

#pragma unroll
  for (int r = 0; r < kFaRows; ++r) {
    const float lt = warp_sum(l[r]);
    const int row = q0 + warp * kFaRows + r;
    if (row < Tq) {
      const float ls = lt == 0.f ? 1.f : lt;
      T* orow = out + ((long long)row * H + h) * D + c_lo;
      for (int c0 = 0; c0 < Dw; c0 += C)
        orow[c0 + lane] = from_f32<T>(o_s[(warp * kFaRows + r) * Dc_ + c0 + lane] / ls);
      if (lane == 0 && c_lo == 0)
        lse[(long long)h * Tq + row] = lt == 0.f ? -INFINITY : m[r] + logf(ls);
    }
  }
}

// One block per (32-row q tile, q head, column range), over the same keys
// as the forward: dq [Tq, H, D] (contiguous).
template <typename T, bool kRanges>
__global__ void __launch_bounds__(kFaThreads)
vflash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, long long q_stride, long long k_stride,
                          long long v_stride, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                          const int* __restrict__ bound, const int* __restrict__ cu_k,
                          const int* __restrict__ seed_ptr, T* __restrict__ dq, int Tq, int Tk,
                          int H, int Hkv, int D, int Dc, int n_seqs, float scale, int causal,
                          int dropout, uint32_t thresh, float inv_keep) {
  constexpr int C = kWideChunk;
  const int q0 = blockIdx.x * kFaBQ, h = blockIdx.y;
  const int hk = h / (H / Hkv);
  const long long q_off = (long long)h * D, kv_off = (long long)hk * D;
  // this block's columns of dQ: [c_lo, c_lo + Dw), at column c of dq_s and c_lo + c of k, dq
  const int Dc_ = kRanges ? Dc : D;
  const int c_lo = kRanges ? blockIdx.z * Dc_ : 0, Dw = kRanges ? min(Dc_, D - c_lo) : D;

  extern __shared__ __align__(16) float sm[];
  float* dq_s = sm;                     // [BQ][Dc] fp32 dQ accumulator
  float* q_c = dq_s + kFaBQ * Dc_;       // [BQ][C]
  float* do_c = q_c + kFaBQ * C;        // [BQ][C]
  float* k_c = do_c + kFaBQ * C;        // [BK][C + 1]
  float* v_c = k_c + kFaBK * (C + 1);   // [BK][C + 1]
  float* ds_s = v_c + kFaBK * (C + 1);  // [BQ][BK]
  __shared__ int2 keys_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp == 0) {
    const QTileKeys r = q_tile_keys<kFaBQ>(seg_q, bound, cu_k, q0, Tq, Tk, n_seqs, causal, lane);
    if (lane == 0) keys_s = make_int2(r.begin, r.end);
  }
  int seg_r[kFaRows], bound_r[kFaRows];
  float lse_r[kFaRows], delta_r[kFaRows];
#pragma unroll
  for (int r = 0; r < kFaRows; ++r) {
    const int row = q0 + warp * kFaRows + r;
    const bool ok = row < Tq;
    seg_r[r] = ok ? seg_q[row] : -1;
    bound_r[r] = ok ? bound[row] : -1;
    const float l = ok ? lse[(long long)h * Tq + row] : 0.f;
    lse_r[r] = l == -INFINITY ? 0.f : l;
    delta_r[r] = ok ? delta[(long long)h * Tq + row] : 0.f;
    for (int c0 = 0; c0 < Dw; c0 += C) dq_s[(warp * kFaRows + r) * Dc_ + c0 + lane] = 0.f;
  }
  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;
  __syncthreads();
  const int k_begin = keys_s.x, k_end = keys_s.y;

  for (int k0 = k_begin; k0 < k_end; k0 += kFaBK) {
    // s = Q K^T and dp = dO V^T: lane owns key col = k0 + lane
    float s[kFaRows], dp[kFaRows];
#pragma unroll
    for (int r = 0; r < kFaRows; ++r) {
      s[r] = 0.f;
      dp[r] = 0.f;
    }
    for (int d0 = 0; d0 < D; d0 += C) {
      __syncthreads();  // the previous chunk's reads are done
      for (int i = tid; i < kFaBQ * C; i += kFaThreads) {
        const int r = i / C, c = i - r * C;
        const int row = q0 + r, key = k0 + r;
        const bool ok = row < Tq, kok = key < k_end;
        q_c[i] = ok ? to_f32(q[(long long)row * q_stride + q_off + d0 + c]) : 0.f;
        do_c[i] = ok ? to_f32(dout[((long long)row * H + h) * D + d0 + c]) : 0.f;
        k_c[r * (C + 1) + c] = kok ? to_f32(k[(long long)key * k_stride + kv_off + d0 + c]) : 0.f;
        v_c[r * (C + 1) + c] = kok ? to_f32(v[(long long)key * v_stride + kv_off + d0 + c]) : 0.f;
      }
      __syncthreads();
      float kr[C];
#pragma unroll
      for (int dd = 0; dd < C; ++dd) kr[dd] = k_c[lane * (C + 1) + dd];
#pragma unroll
      for (int r = 0; r < kFaRows; ++r) {
        const float* qr = q_c + (warp * kFaRows + r) * C;
        float a = s[r];
#pragma unroll
        for (int dd = 0; dd < C; ++dd) a += qr[dd] * kr[dd];
        s[r] = a;
      }
#pragma unroll
      for (int dd = 0; dd < C; ++dd) kr[dd] = v_c[lane * (C + 1) + dd];
#pragma unroll
      for (int r = 0; r < kFaRows; ++r) {
        const float* dr = do_c + (warp * kFaRows + r) * C;
        float a = dp[r];
#pragma unroll
        for (int dd = 0; dd < C; ++dd) a += dr[dd] * kr[dd];
        dp[r] = a;
      }
    }

    const int col = k0 + lane;
    const int seg_c = col < k_end ? seg_k[col] : -2;
#pragma unroll
    for (int r = 0; r < kFaRows; ++r) {
      const int row = q0 + warp * kFaRows + r;
      const bool masked = seg_r[r] != seg_c || (causal && col > bound_r[r]);
      const float p = masked ? 0.f : expf(s[r] * scale - lse_r[r]);
      float d = dp[r];
      if (dropout) {
        d = dropout_keep(seed, (uint32_t)h, (uint32_t)row, (uint32_t)col, thresh) ? d * inv_keep
                                                                                : 0.f;
      }
      ds_s[(warp * kFaRows + r) * kFaBK + lane] = p * (d - delta_r[r]) * scale;
    }
    __syncwarp();

    // dq[r, c] += sum_t dS[r, t] K[t, c], 32 columns at a time
    const int n_t = min(kFaBK, k_end - k0);
    const T* k_cols = k + c_lo;
    for (int c0 = 0; c0 < Dw; c0 += C) {
      float acc[kFaRows];
#pragma unroll
      for (int r = 0; r < kFaRows; ++r) acc[r] = dq_s[(warp * kFaRows + r) * Dc_ + c0 + lane];
      for (int t = 0; t < n_t; ++t) {
        const float kv = to_f32(k_cols[(long long)(k0 + t) * k_stride + kv_off + c0 + lane]);
#pragma unroll
        for (int r = 0; r < kFaRows; ++r) acc[r] += ds_s[(warp * kFaRows + r) * kFaBK + t] * kv;
      }
#pragma unroll
      for (int r = 0; r < kFaRows; ++r) dq_s[(warp * kFaRows + r) * Dc_ + c0 + lane] = acc[r];
    }
  }

#pragma unroll
  for (int r = 0; r < kFaRows; ++r) {
    const int row = q0 + warp * kFaRows + r;
    if (row < Tq) {
      T* orow = dq + ((long long)row * H + h) * D + c_lo;
      for (int c0 = 0; c0 < Dw; c0 += C)
        orow[c0 + lane] = from_f32<T>(dq_s[(warp * kFaRows + r) * Dc_ + c0 + lane]);
    }
  }
}

// One block per (32-key tile, kv head, column range), looping over the GQA
// group's q heads and the q rows that can see the tile, twice: pass 0 sums
// dV, pass 1 dK. dk, dv [Tk, Hkv, D] (contiguous).
template <typename T, bool kRanges>
__global__ void __launch_bounds__(kFaThreads)
vflash_bwd_dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, long long q_stride, long long k_stride,
                           long long v_stride, const T* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                           const int* __restrict__ bound, const int* __restrict__ cu_q,
                           const int* __restrict__ cu_k, const int* __restrict__ seed_ptr,
                           T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk, int H,
                           int Hkv, int D, int Dc, int n_seqs, float scale, int causal,
                           int dropout, uint32_t thresh, float inv_keep) {
  constexpr int C = kWideChunk;
  const int k0 = blockIdx.x * kFaBK, hk = blockIdx.y;
  const int G = H / Hkv;
  const long long kv_off = (long long)hk * D;
  // this block's columns of dK, dV: [c_lo, c_lo + Dw), at column c of acc_s and c_lo + c of
  // dout, q, dk, dv
  const int Dc_ = kRanges ? Dc : D;
  const int c_lo = kRanges ? blockIdx.z * Dc_ : 0, Dw = kRanges ? min(Dc_, D - c_lo) : D;

  extern __shared__ __align__(16) float sm[];
  float* acc_s = sm;                      // [BK][Dc] fp32 dV (pass 0) or dK (pass 1)
  float* k_c = acc_s + kFaBK * Dc_;        // [BK][C]
  float* v_c = k_c + kFaBK * C;           // [BK][C]
  float* q_c = v_c + kFaBK * C;           // [BQ][C + 1]
  float* do_c = q_c + kFaBQ * (C + 1);    // [BQ][C + 1]
  float* pd_s = do_c + kFaBQ * (C + 1);   // [BK][BQ] dropped P^T (pass 0) or dS^T (pass 1)
  float* lse_s = pd_s + kFaBK * kFaBQ;    // [BQ]
  float* dl_s = lse_s + kFaBQ;            // [BQ]
  int* segq_s = (int*)(dl_s + kFaBQ);     // [BQ]
  int* bound_s = segq_s + kFaBQ;          // [BQ]
  __shared__ int2 rows_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp == 0) {
    const KTileRows r = k_tile_rows<kFaBK>(seg_k, cu_q, cu_k, k0, Tq, Tk, n_seqs, causal, lane);
    if (lane == 0) rows_s = make_int2(r.begin, r.end);
  }
  int seg_r[kFaRows];
#pragma unroll
  for (int r = 0; r < kFaRows; ++r) {
    const int key = k0 + warp * kFaRows + r;
    seg_r[r] = key < Tk ? seg_k[key] : -2;  // -2 matches no row
  }
  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;
  __syncthreads();
  const int q_begin = rows_s.x, q_end = rows_s.y;

  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int r = 0; r < kFaRows; ++r)
      for (int c0 = 0; c0 < Dw; c0 += C) acc_s[(warp * kFaRows + r) * Dc_ + c0 + lane] = 0.f;

    for (int hh = 0; hh < G; ++hh) {
      const int h = hk * G + hh;
      const long long q_off = (long long)h * D;
      for (int q0 = q_begin; q0 < q_end; q0 += kFaBQ) {
        __syncthreads();  // the previous tile's row vectors and P / dS reads are done
        if (tid < kFaBQ) {
          const int row = q0 + tid;
          const bool ok = row < q_end;
          const float l = ok ? lse[(long long)h * Tq + row] : 0.f;
          lse_s[tid] = l == -INFINITY ? 0.f : l;
          dl_s[tid] = ok ? delta[(long long)h * Tq + row] : 0.f;
          segq_s[tid] = ok ? seg_q[row] : -1;
          bound_s[tid] = ok ? bound[row] : -1;
        }

        // transposed tiles: warp row r is key k0 + 8 warp + r, lane is q row
        // q0 + lane; s = K Q^T and (pass 1) dp = V dO^T
        float s[kFaRows], dp[kFaRows];
#pragma unroll
        for (int r = 0; r < kFaRows; ++r) {
          s[r] = 0.f;
          dp[r] = 0.f;
        }
        for (int d0 = 0; d0 < D; d0 += C) {
          __syncthreads();  // the previous chunk's reads are done
          for (int i = tid; i < kFaBK * C; i += kFaThreads) {
            const int r = i / C, c = i - r * C;
            const int key = k0 + r, row = q0 + r;
            const bool kok = key < Tk, ok = row < q_end;
            k_c[i] = kok ? to_f32(k[(long long)key * k_stride + kv_off + d0 + c]) : 0.f;
            q_c[r * (C + 1) + c] = ok ? to_f32(q[(long long)row * q_stride + q_off + d0 + c]) : 0.f;
            if (pass == 1) {
              v_c[i] = kok ? to_f32(v[(long long)key * v_stride + kv_off + d0 + c]) : 0.f;
              do_c[r * (C + 1) + c] = ok ? to_f32(dout[((long long)row * H + h) * D + d0 + c]) : 0.f;
            }
          }
          __syncthreads();
          float qr[C];
#pragma unroll
          for (int dd = 0; dd < C; ++dd) qr[dd] = q_c[lane * (C + 1) + dd];
#pragma unroll
          for (int r = 0; r < kFaRows; ++r) {
            const float* kr = k_c + (warp * kFaRows + r) * C;
            float a = s[r];
#pragma unroll
            for (int dd = 0; dd < C; ++dd) a += kr[dd] * qr[dd];
            s[r] = a;
          }
          if (pass == 1) {
#pragma unroll
            for (int dd = 0; dd < C; ++dd) qr[dd] = do_c[lane * (C + 1) + dd];
#pragma unroll
            for (int r = 0; r < kFaRows; ++r) {
              const float* vr = v_c + (warp * kFaRows + r) * C;
              float a = dp[r];
#pragma unroll
              for (int dd = 0; dd < C; ++dd) a += vr[dd] * qr[dd];
              dp[r] = a;
            }
          }
        }

        const int row = q0 + lane;
        const int seg_row = segq_s[lane], bd = bound_s[lane];
        const float ls = lse_s[lane], dl = dl_s[lane];
#pragma unroll
        for (int r = 0; r < kFaRows; ++r) {
          const int key = k0 + warp * kFaRows + r;
          const bool masked = seg_row != seg_r[r] || (causal && key > bd);
          const float p = masked ? 0.f : expf(s[r] * scale - ls);
          float pd = p, d = dp[r];
          if (dropout) {
            const bool keep = dropout_keep(seed, (uint32_t)h, (uint32_t)row, (uint32_t)key, thresh);
            pd = keep ? p * inv_keep : 0.f;
            d = keep ? d * inv_keep : 0.f;
          }
          pd_s[(warp * kFaRows + r) * kFaBQ + lane] = pass == 0 ? pd : p * (d - dl) * scale;
        }
        __syncwarp();

        // pass 0: dv[r, c] += sum_t P^T[r, t] dO[t, c]; pass 1: dk[r, c] +=
        // sum_t dS^T[r, t] Q[t, c]; 32 columns at a time
        const int n_t = min(kFaBQ, q_end - q0);
        const T* do_cols = dout + c_lo;
        const T* q_cols = q + c_lo;
        for (int c0 = 0; c0 < Dw; c0 += C) {
          float acc[kFaRows];
#pragma unroll
          for (int r = 0; r < kFaRows; ++r) acc[r] = acc_s[(warp * kFaRows + r) * Dc_ + c0 + lane];
          for (int t = 0; t < n_t; ++t) {
            const float src =
                pass == 0 ? to_f32(do_cols[((long long)(q0 + t) * H + h) * D + c0 + lane])
                          : to_f32(q_cols[(long long)(q0 + t) * q_stride + q_off + c0 + lane]);
#pragma unroll
            for (int r = 0; r < kFaRows; ++r)
              acc[r] += pd_s[(warp * kFaRows + r) * kFaBQ + t] * src;
          }
#pragma unroll
          for (int r = 0; r < kFaRows; ++r) acc_s[(warp * kFaRows + r) * Dc_ + c0 + lane] = acc[r];
        }
      }
    }

    T* dst = pass == 0 ? dv : dk;
#pragma unroll
    for (int r = 0; r < kFaRows; ++r) {
      const int key = k0 + warp * kFaRows + r;
      if (key < Tk) {
        const long long o = ((long long)key * Hkv + hk) * D + c_lo;
        for (int c0 = 0; c0 < Dw; c0 += C)
          dst[o + c0 + lane] = from_f32<T>(acc_s[(warp * kFaRows + r) * Dc_ + c0 + lane]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// C entry points. q/k/v are read at a token stride in elements (a token's
// heads and head dims contiguous); dout, out and the gradients are
// contiguous. seg_q, seg_k, bound, cu_q, cu_k, seed: int32 on the device.
// Routing: D <= 256 takes the kernels compiled for D (with_head_dim), fp32
// on the CUDA cores and bf16/fp16 on the tensor cores; D > 256, a multiple
// of 32, takes the wide kernels in every dtype (in column ranges above
// kWideMaxD). Any other D returns cudaErrorInvalidValue.

template <typename K>
static cudaError_t opt_in_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

static bool bad_shape(int Tq, int Tk, int H, int Hkv, int n_seqs) {
  return Tq <= 0 || Tk <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || n_seqs <= 0;
}

// The tensor-core kernels copy each token's head in 16-byte pieces: every
// tensor on a 16-byte boundary, token strides multiples of 8 elements.
static bool tc_unaligned(int dtype, std::initializer_list<const void*> ptrs, long long q_stride,
                         long long k_stride, long long v_stride) {
  return dtype != kF32 && (!aligned16(ptrs) || q_stride % 8 || k_stride % 8 || v_stride % 8);
}

// Calls f(std::integral_constant<int, D>) for an instantiated head dim:
// every multiple of 32 from 32 to 256. Another D returns
// cudaErrorInvalidValue (the wrapper pads D up to one of these).
template <typename F>
static int with_head_dim(int D, F&& f) {
  switch (D) {
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 96: return f(std::integral_constant<int, 96>());
    case 128: return f(std::integral_constant<int, 128>());
    case 160: return f(std::integral_constant<int, 160>());
    case 192: return f(std::integral_constant<int, 192>());
    case 224: return f(std::integral_constant<int, 224>());
    case 256: return f(std::integral_constant<int, 256>());
    default: return (int)cudaErrorInvalidValue;
  }
}

// What the launches share.
struct VArgs {
  const void *q, *k, *v;
  long long q_stride, k_stride, v_stride;
  const void* dout;
  const float *lse_in, *delta;
  const int *seg_q, *seg_k, *bound, *cu_q, *cu_k, *seed;
  void *out, *dq, *dk, *dv;
  float* lse;
  int Tq, Tk, H, Hkv, n_seqs;
  float scale;
  int causal, dropout;
  uint32_t thresh;
  float inv_keep;
};

// The route is the dtype's: fp32 -> the CUDA-core kernels, bf16/fp16 ->
// the tensor-core kernels. No fallback between them.
template <typename T, int D>
static int launch_vflash_fwd(const VArgs& a, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    constexpr size_t smem = vflash_fwd_smem_bytes<D>();
    const cudaError_t e = opt_in_smem(vflash_fwd_kernel<T, D>, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((a.Tq + kFaBQ - 1) / kFaBQ, a.H);
    vflash_fwd_kernel<T, D><<<grid, kFaThreads, smem, s>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, a.q_stride, a.k_stride, a.v_stride,
        a.seg_q, a.seg_k, a.bound, a.cu_k, a.seed, (T*)a.out, a.lse, a.Tq, a.Tk, a.H, a.Hkv,
        a.n_seqs, a.scale, a.causal, a.dropout, a.thresh, a.inv_keep);
  } else {
    constexpr size_t smem = vflash_fwd_tc_smem_bytes<D>();
    const cudaError_t e = opt_in_smem(vflash_fwd_tc_kernel<T, D>, smem);
    if (e != cudaSuccess) return (int)e;
    const int q_tiles = (a.Tq + kTcBlk - 1) / kTcBlk;
    if (q_tiles > 65535) return (int)cudaErrorInvalidValue;  // gridDim.y
    const dim3 grid(a.H, q_tiles);
    vflash_fwd_tc_kernel<T, D><<<grid, kTcThreads, smem, s>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, a.q_stride, a.k_stride, a.v_stride,
        a.seg_q, a.seg_k, a.bound, a.cu_k, a.seed, (T*)a.out, a.lse, a.Tq, a.Tk, a.H, a.Hkv,
        a.n_seqs, a.scale, a.causal, a.dropout, a.thresh, a.inv_keep);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int launch_vflash_bwd_dq(const VArgs& a, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    constexpr size_t smem = vflash_dq_smem_bytes<D>();
    const cudaError_t e = opt_in_smem(vflash_bwd_dq_kernel<T, D>, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((a.Tq + kFaBQ - 1) / kFaBQ, a.H);
    vflash_bwd_dq_kernel<T, D><<<grid, kFaThreads, smem, s>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, a.q_stride, a.k_stride, a.v_stride,
        (const T*)a.dout, a.lse_in, a.delta, a.seg_q, a.seg_k, a.bound, a.cu_k, a.seed,
        (T*)a.dq, a.Tq, a.Tk, a.H, a.Hkv, a.n_seqs, a.scale, a.causal, a.dropout, a.thresh,
        a.inv_keep);
  } else {
    constexpr size_t smem = vflash_dq_tc_smem_bytes<D>();
    const cudaError_t e = opt_in_smem(vflash_bwd_dq_tc_kernel<T, D>, smem);
    if (e != cudaSuccess) return (int)e;
    const int q_tiles = (a.Tq + kTcBlk - 1) / kTcBlk;
    if (q_tiles > 65535) return (int)cudaErrorInvalidValue;  // gridDim.y
    const dim3 grid(a.H, q_tiles);
    vflash_bwd_dq_tc_kernel<T, D><<<grid, kTcThreads, smem, s>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, a.q_stride, a.k_stride, a.v_stride,
        (const T*)a.dout, a.lse_in, a.delta, a.seg_q, a.seg_k, a.bound, a.cu_k, a.seed,
        (T*)a.dq, a.Tq, a.Tk, a.H, a.Hkv, a.n_seqs, a.scale, a.causal, a.dropout, a.thresh,
        a.inv_keep);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int launch_vflash_bwd_dkv(const VArgs& a, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    constexpr size_t smem = vflash_dkv_smem_bytes<D>();
    const cudaError_t e = opt_in_smem(vflash_bwd_dkv_kernel<T, D>, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((a.Tk + kFaBK - 1) / kFaBK, a.Hkv);
    vflash_bwd_dkv_kernel<T, D><<<grid, kFaThreads, smem, s>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, a.q_stride, a.k_stride, a.v_stride,
        (const T*)a.dout, a.lse_in, a.delta, a.seg_q, a.seg_k, a.bound, a.cu_q, a.cu_k, a.seed,
        (T*)a.dk, (T*)a.dv, a.Tq, a.Tk, a.H, a.Hkv, a.n_seqs, a.scale, a.causal, a.dropout,
        a.thresh, a.inv_keep);
  } else {
    constexpr size_t smem = vflash_dkv_tc_smem_bytes<D>();
    const cudaError_t e = opt_in_smem(vflash_bwd_dkv_tc_kernel<T, D>, smem);
    if (e != cudaSuccess) return (int)e;
    const int k_tiles = (a.Tk + kTcBlk - 1) / kTcBlk;
    if (k_tiles > 65535) return (int)cudaErrorInvalidValue;  // gridDim.y
    const dim3 grid(a.Hkv, k_tiles);
    vflash_bwd_dkv_tc_kernel<T, D><<<grid, kTcThreads, smem, s>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, a.q_stride, a.k_stride, a.v_stride,
        (const T*)a.dout, a.lse_in, a.delta, a.seg_q, a.seg_k, a.bound, a.cu_q, a.cu_k, a.seed,
        (T*)a.dk, (T*)a.dv, a.Tq, a.Tk, a.H, a.Hkv, a.n_seqs, a.scale, a.causal, a.dropout,
        a.thresh, a.inv_keep);
  }
  return (int)cudaGetLastError();
}

// The wide route: any dtype, D > 256 a multiple of 32; grid z over the
// column ranges of wide_range_cols (one range up to kWideMaxD).
static bool bad_wide_dim(int D) { return D <= 256 || D % kWideChunk; }

static dim3 wide_grid(int tiles, int heads, int D) {
  const int Dc = wide_range_cols(D);
  return dim3(tiles, heads, (D + Dc - 1) / Dc);
}

template <typename T>
static int launch_vflash_fwd_wide(const VArgs& a, int D, cudaStream_t s) {
  if (bad_wide_dim(D)) return (int)cudaErrorInvalidValue;
  const int Dc = wide_range_cols(D);
  const size_t smem = vflash_fwd_wide_smem_bytes(Dc);
  const dim3 grid = wide_grid((a.Tq + kFaBQ - 1) / kFaBQ, a.H, D);
  const auto kernel = grid.z > 1 ? vflash_fwd_wide_kernel<T, true>
                                 : vflash_fwd_wide_kernel<T, false>;
  const cudaError_t e = opt_in_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kFaThreads, smem, s>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.q_stride, a.k_stride, a.v_stride, a.seg_q,
      a.seg_k, a.bound, a.cu_k, a.seed, (T*)a.out, a.lse, a.Tq, a.Tk, a.H, a.Hkv, D, Dc,
      a.n_seqs, a.scale, a.causal, a.dropout, a.thresh, a.inv_keep);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_vflash_bwd_dq_wide(const VArgs& a, int D, cudaStream_t s) {
  if (bad_wide_dim(D)) return (int)cudaErrorInvalidValue;
  const int Dc = wide_range_cols(D);
  const size_t smem = vflash_dq_wide_smem_bytes(Dc);
  const dim3 grid = wide_grid((a.Tq + kFaBQ - 1) / kFaBQ, a.H, D);
  const auto kernel = grid.z > 1 ? vflash_bwd_dq_wide_kernel<T, true>
                                 : vflash_bwd_dq_wide_kernel<T, false>;
  const cudaError_t e = opt_in_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kFaThreads, smem, s>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.q_stride, a.k_stride, a.v_stride,
      (const T*)a.dout, a.lse_in, a.delta, a.seg_q, a.seg_k, a.bound, a.cu_k, a.seed, (T*)a.dq,
      a.Tq, a.Tk, a.H, a.Hkv, D, Dc, a.n_seqs, a.scale, a.causal, a.dropout, a.thresh,
      a.inv_keep);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_vflash_bwd_dkv_wide(const VArgs& a, int D, cudaStream_t s) {
  if (bad_wide_dim(D)) return (int)cudaErrorInvalidValue;
  const int Dc = wide_range_cols(D);
  const size_t smem = vflash_dkv_wide_smem_bytes(Dc);
  const dim3 grid = wide_grid((a.Tk + kFaBK - 1) / kFaBK, a.Hkv, D);
  const auto kernel = grid.z > 1 ? vflash_bwd_dkv_wide_kernel<T, true>
                                 : vflash_bwd_dkv_wide_kernel<T, false>;
  const cudaError_t e = opt_in_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kFaThreads, smem, s>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.q_stride, a.k_stride, a.v_stride,
      (const T*)a.dout, a.lse_in, a.delta, a.seg_q, a.seg_k, a.bound, a.cu_q, a.cu_k, a.seed,
      (T*)a.dk, (T*)a.dv, a.Tq, a.Tk, a.H, a.Hkv, D, Dc, a.n_seqs, a.scale, a.causal,
      a.dropout, a.thresh, a.inv_keep);
  return (int)cudaGetLastError();
}

// What every launch takes: the inputs, the segment vectors and the
// attention's parameters (the outputs are set by each entry point).
static VArgs base_args(const void* q, const void* k, const void* v, long long q_stride,
                       long long k_stride, long long v_stride, const int* seg_q,
                       const int* seg_k, const int* bound, const int* cu_k, const int* seed,
                       int Tq, int Tk, int H, int Hkv, int n_seqs, float scale, int causal,
                       int dropout, unsigned int thresh, float inv_keep) {
  VArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.q_stride = q_stride;
  a.k_stride = k_stride;
  a.v_stride = v_stride;
  a.seg_q = seg_q;
  a.seg_k = seg_k;
  a.bound = bound;
  a.cu_k = cu_k;
  a.seed = seed;
  a.Tq = Tq;
  a.Tk = Tk;
  a.H = H;
  a.Hkv = Hkv;
  a.n_seqs = n_seqs;
  a.scale = scale;
  a.causal = causal;
  a.dropout = dropout;
  a.thresh = thresh;
  a.inv_keep = inv_keep;
  return a;
}

extern "C" int vflash_fwd(const void* q, const void* k, const void* v, long long q_stride,
                          long long k_stride, long long v_stride, const int* seg_q,
                          const int* seg_k, const int* bound, const int* cu_k, const int* seed,
                          void* out, float* lse, int Tq, int Tk, int H, int Hkv, int D,
                          int n_seqs, float scale, int causal, int dropout, unsigned int thresh,
                          float inv_keep, int dtype, void* stream) {
  if (bad_shape(Tq, Tk, H, Hkv, n_seqs)) return (int)cudaErrorInvalidValue;
  if (D <= 256 && tc_unaligned(dtype, {q, k, v, out}, q_stride, k_stride, v_stride))
    return (int)cudaErrorMisalignedAddress;
  VArgs a = base_args(q, k, v, q_stride, k_stride, v_stride, seg_q, seg_k, bound, cu_k, seed, Tq,
                      Tk, H, Hkv, n_seqs, scale, causal, dropout, thresh, inv_keep);
  a.out = out;
  a.lse = lse;
  cudaStream_t s = (cudaStream_t)stream;
  DISPATCH_DTYPE(dtype, T, {
    if (D > 256) return launch_vflash_fwd_wide<T>(a, D, s);
    return with_head_dim(D, [&](auto d) { return launch_vflash_fwd<T, decltype(d)::value>(a, s); });
  })
  return (int)cudaErrorInvalidValue;
}

// The backward takes the forward's lse and delta = rowsum(dO * O), both
// fp32 [H, Tq], and dout [Tq, H, D].
extern "C" int vflash_bwd_dq(const void* q, const void* k, const void* v, long long q_stride,
                             long long k_stride, long long v_stride, const void* dout,
                             const float* lse, const float* delta, const int* seg_q,
                             const int* seg_k, const int* bound, const int* cu_k,
                             const int* seed, void* dq, int Tq, int Tk, int H, int Hkv, int D,
                             int n_seqs, float scale, int causal, int dropout,
                             unsigned int thresh, float inv_keep, int dtype, void* stream) {
  if (bad_shape(Tq, Tk, H, Hkv, n_seqs)) return (int)cudaErrorInvalidValue;
  if (D <= 256 && tc_unaligned(dtype, {q, k, v, dout, dq}, q_stride, k_stride, v_stride))
    return (int)cudaErrorMisalignedAddress;
  VArgs a = base_args(q, k, v, q_stride, k_stride, v_stride, seg_q, seg_k, bound, cu_k, seed, Tq,
                      Tk, H, Hkv, n_seqs, scale, causal, dropout, thresh, inv_keep);
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.dq = dq;
  cudaStream_t s = (cudaStream_t)stream;
  DISPATCH_DTYPE(dtype, T, {
    if (D > 256) return launch_vflash_bwd_dq_wide<T>(a, D, s);
    return with_head_dim(D,
                         [&](auto d) { return launch_vflash_bwd_dq<T, decltype(d)::value>(a, s); });
  })
  return (int)cudaErrorInvalidValue;
}

extern "C" int vflash_bwd_dkv(const void* q, const void* k, const void* v, long long q_stride,
                              long long k_stride, long long v_stride, const void* dout,
                              const float* lse, const float* delta, const int* seg_q,
                              const int* seg_k, const int* bound, const int* cu_q,
                              const int* cu_k, const int* seed, void* dk, void* dv, int Tq,
                              int Tk, int H, int Hkv, int D, int n_seqs, float scale, int causal,
                              int dropout, unsigned int thresh, float inv_keep, int dtype,
                              void* stream) {
  if (bad_shape(Tq, Tk, H, Hkv, n_seqs)) return (int)cudaErrorInvalidValue;
  if (D <= 256 && tc_unaligned(dtype, {q, k, v, dout, dk, dv}, q_stride, k_stride, v_stride))
    return (int)cudaErrorMisalignedAddress;
  VArgs a = base_args(q, k, v, q_stride, k_stride, v_stride, seg_q, seg_k, bound, cu_k, seed, Tq,
                      Tk, H, Hkv, n_seqs, scale, causal, dropout, thresh, inv_keep);
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.cu_q = cu_q;
  a.dk = dk;
  a.dv = dv;
  cudaStream_t s = (cudaStream_t)stream;
  DISPATCH_DTYPE(dtype, T, {
    if (D > 256) return launch_vflash_bwd_dkv_wide<T>(a, D, s);
    return with_head_dim(
        D, [&](auto d) { return launch_vflash_bwd_dkv<T, decltype(d)::value>(a, s); });
  })
  return (int)cudaErrorInvalidValue;
}
