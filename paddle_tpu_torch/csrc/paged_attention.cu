// Paged decode attention for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py::
// paged_attention_decode_kernel (Pallas body _decode_kernel_body): one
// query token per sequence attends over its KV context, which lives in
// fixed-size pages of a shared pool [KVH, pages, page, DH] addressed by a
// per-sequence block table. fp32 online softmax; GQA heads grouped by kv
// head; a length-0 row (an idle serving slot) returns 0, never NaN.
//
// What bounds it on the H100: bytes. Each K/V element read is used for
// 2 * G FLOPs (G = q heads per kv head), so the floor is the K and V pages
// the lengths actually cover, 2 * KVH * sum(len) * DH * itemsize, over
// 3.35 TB/s.
//
// Design: one block per (sequence, kv head). The TPU kernel ran a
// sequential grid over pages and carried (m, l, acc) in VMEM scratch; here
// a loop inside the block walks only the ceil(len / page) valid pages, so a
// short sequence costs its own pages and never reads a block-table entry
// past its length (the TPU clamped such pages to the last valid one). Each
// chunk of up to 32 rows of one page is staged into shared memory with
// 16-byte copies and reused by the group's G query heads, so every K/V
// byte crosses HBM once per step. Scores are warp dot products, the
// softmax state per head lives in shared memory, and each thread owns a
// fixed set of output elements, so the accumulators need no atomics. At
// the serving shape (8 slots x 16 kv heads) this is 128 blocks on 132 SMs;
// splitting long contexts across blocks is left for a later tuning pass.
#include "common.cuh"

constexpr int kPaThreads = 128;
constexpr int kPaChunk = 32;

template <typename T>
__global__ void __launch_bounds__(kPaThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ lengths,
                    const int* __restrict__ tables, T* __restrict__ out, int nh, int kvh,
                    int dh, int num_pages, int page, int pps, float scale) {
  const int b = blockIdx.x, kh = blockIdx.y;
  const int group = nh / kvh;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);                  // [chunk, dh]
  T* v_s = k_s + kPaChunk * dh;                         // [chunk, dh]
  float* q_s = reinterpret_cast<float*>(v_s + kPaChunk * dh);  // [group, dh]
  float* acc_s = q_s + group * dh;                      // [group, dh]
  float* s_s = acc_s + group * dh;                      // [group, chunk]
  float* m_s = s_s + group * kPaChunk;                  // [group]
  float* l_s = m_s + group;                             // [group]
  float* a_s = l_s + group;                             // [group]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  // q heads kh*group .. kh*group+group-1 read kv head kh (the repeat layout)
  const T* qb = q + ((long long)b * nh + (long long)kh * group) * dh;
  for (int i = tid; i < group * dh; i += blockDim.x) {
    q_s[i] = to_f32(qb[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < group; g += blockDim.x) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  const int len = max(0, min(lengths[b], pps * page));
  const int* tbl = tables + (long long)b * pps;
  const long long page_elems = (long long)page * dh;
  const T* k_head = k_pages + (long long)kh * num_pages * page_elems;
  const T* v_head = v_pages + (long long)kh * num_pages * page_elems;
  __syncthreads();

  int pos = 0;
  while (pos < len) {
    const int pi = pos / page, off = pos - pi * page;
    const int n = min(min(kPaChunk, page - off), len - pos);
    const long long base = (long long)tbl[pi] * page_elems + (long long)off * dh;
    // rows [off, off + n) of one page are contiguous: copy them as uint4s
    const int nvec = (int)((long long)n * dh * sizeof(T) / 16);
    const uint4* ksrc = reinterpret_cast<const uint4*>(k_head + base);
    const uint4* vsrc = reinterpret_cast<const uint4*>(v_head + base);
    for (int i = tid; i < nvec; i += blockDim.x) {
      reinterpret_cast<uint4*>(k_s)[i] = ksrc[i];
      reinterpret_cast<uint4*>(v_s)[i] = vsrc[i];
    }
    __syncthreads();

    // scores s[g, t] = q[g] . k[t] * scale, one warp per (g, t) pair
    for (int pr = warp; pr < group * n; pr += nwarps) {
      const int g = pr / n, t = pr - g * n;
      const float* qr = q_s + g * dh;
      const T* kr = k_s + t * dh;
      float d = 0.f;
      for (int e = lane; e < dh; e += 32) d += qr[e] * to_f32(kr[e]);
      d = warp_sum(d);
      if (lane == 0) s_s[g * kPaChunk + t] = d * scale;
    }
    __syncthreads();

    // online softmax per head: every row processed here is inside the
    // length, so no lane is masked and m_new is finite
    for (int g = warp; g < group; g += nwarps) {
      float* sg = s_s + g * kPaChunk;
      float mx = -INFINITY;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, sg[t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);  // exp(-inf) = 0 on the first chunk
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float p = expf(sg[t] - m_new);
        sg[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + sum;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc[g, e] = acc[g, e] * alpha[g] + sum_t p[g, t] * v[t, e]
    for (int i = tid; i < group * dh; i += blockDim.x) {
      const int g = i / dh, e = i - g * dh;
      const float* pg = s_s + g * kPaChunk;
      float a = acc_s[i] * a_s[g];
      for (int t = 0; t < n; ++t) a += pg[t] * to_f32(v_s[t * dh + e]);
      acc_s[i] = a;
    }
    __syncthreads();
    pos += n;
  }

  T* ob = out + ((long long)b * nh + (long long)kh * group) * dh;
  for (int i = tid; i < group * dh; i += blockDim.x) {
    const float l = l_s[i / dh];
    ob[i] = from_f32<T>(l > 0.f ? acc_s[i] / l : 0.f);
  }
}

static size_t paged_smem_bytes(int group, int dh, size_t itemsize) {
  return 2 * (size_t)kPaChunk * dh * itemsize +
         ((size_t)2 * group * dh + (size_t)group * kPaChunk + 3 * (size_t)group) * sizeof(float);
}

// Shared memory the kernel needs for this shape (the wrapper checks it
// against the card's per-block limit before launching).
extern "C" long long paged_decode_smem_bytes(int group, int dh, int itemsize) {
  return (long long)paged_smem_bytes(group, dh, (size_t)itemsize);
}

extern "C" int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                            const int* lengths, const int* tables, void* out, int b, int nh,
                            int kvh, int dh, int num_pages, int page, int pps, float scale,
                            int dtype, void* stream) {
  if (b <= 0 || kvh <= 0 || nh % kvh != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(b, kvh);
  DISPATCH_DTYPE(dtype, T, {
    const size_t smem = paged_smem_bytes(nh / kvh, dh, sizeof(T));
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    paged_decode_kernel<T><<<grid, kPaThreads, smem, s>>>(
        (const T*)q, (const T*)k_pages, (const T*)v_pages, lengths, tables, (T*)out, nh, kvh,
        dh, num_pages, page, pps, scale);
  })
  return (int)cudaGetLastError();
}
