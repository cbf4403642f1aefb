// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py::_flash_fwd_bhsd
// (Pallas body _fwd_kernel): online-softmax attention
// q [B,H,Sq,D], k/v [B,Hkv,Sk,D] -> out [B,H,Sq,D] (q's dtype) and
// lse [B,H,Sq] (fp32). Causal masking is bottom-right aligned (query i sees
// keys <= i + Sk - Sq), GQA reads kv head h / (H / Hkv), an optional fp32
// key bias [B|1, Sk] is added before the mask, and dropout applies the
// counter hash of _dropout_keep (bit for bit) to P.V only, the softmax
// denominator staying undropped. A fully masked row gives out 0, lse -inf.
//
// What bounds it on the H100: operations at prefill sizes,
// 4 * B * H * Sq * Sk * D FLOPs (half of them when causal) over the
// 989 TFLOP/s bf16 tensor-core peak. This first version does its math on
// the CUDA cores in fp32 (67 TFLOP/s peak), so it sits far from that
// bound; a wgmma/TMA pipeline is the tuning PR's work.
//
// Design: a block takes a 32-row q tile of one (b, h) and loops over
// 32-key tiles, the loop taking the place of the TPU's sequential k-block
// grid axis; tiles wholly above the causal diagonal are never visited.
// Each of the 4 warps owns 8 q rows; in the score product lane j owns key
// j (K staged in fp32 shared memory with a padded row stride, so the
// column reads are free of bank conflicts, q rows read as broadcasts),
// and in P.V lane j owns output columns j, j+32, ... with P passed
// through shared memory. Row max is a warp reduction per tile; the row
// sum stays lane-partial until the end. Any Sq and Sk are accepted
// (ragged tiles are masked); D is 64 or 128.
#include "common.cuh"

constexpr int kFaWarps = 4;
constexpr int kFaRows = 8;  // q rows per warp
constexpr int kFaBQ = kFaWarps * kFaRows;
constexpr int kFaBK = 32;
constexpr int kFaThreads = kFaWarps * 32;

// flash_attention.py::_dropout_keep on one (row, col): murmur3-style
// mixing in wrapping 32-bit arithmetic with logical shifts.
__device__ __forceinline__ bool dropout_keep(uint32_t seed, uint32_t bh, uint32_t row,
                                             uint32_t col, uint32_t thresh) {
  uint32_t x = (row * 0x9E3779B1u) ^ (col * 0x85EBCA77u);
  x = x ^ (bh * 0xC2B2AE3Du) ^ seed;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return (x & 0x7FFFFFFFu) >= thresh;
}

template <int D>
static constexpr size_t flash_smem_bytes() {
  return sizeof(float) * ((size_t)kFaBQ * D + (size_t)kFaBK * (D + 1) + (size_t)kFaBK * D +
                          (size_t)kFaBQ * kFaBK);
}

template <typename T, int D>
__global__ void __launch_bounds__(kFaThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, long long bias_batch_stride,
                 const int* __restrict__ seed_ptr, T* __restrict__ out, float* __restrict__ lse,
                 int H, int Hkv, int Sq, int Sk, float scale, int causal, int dropout,
                 uint32_t thresh, float inv_keep) {
  constexpr int NC = D / 32;  // output columns per lane
  const int qblk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = qblk * kFaBQ;

  extern __shared__ __align__(16) float sm[];
  float* q_s = sm;                           // [BQ][D]
  float* k_s = q_s + kFaBQ * D;              // [BK][D + 1]
  float* v_s = k_s + kFaBK * (D + 1);        // [BK][D]
  float* p_s = v_s + kFaBK * D;              // [BQ][BK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long qbase = (long long)(b * H + h) * Sq * D;
  const long long kbase = (long long)(b * Hkv + hk) * Sk * D;

  for (int i = tid; i < kFaBQ * D; i += kFaThreads) {
    const int r = i / D, c = i - r * D;
    const int row = q0 + r;
    q_s[i] = row < Sq ? to_f32(q[qbase + (long long)row * D + c]) : 0.f;
  }

  const int offset = Sk - Sq;
  const int q_last = min(q0 + kFaBQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + offset + 1) : Sk;
  const float* brow = bias ? bias + (long long)b * bias_batch_stride : nullptr;
  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;
  const uint32_t bh = (uint32_t)(b * H + h);

  float m[kFaRows], l[kFaRows], acc[kFaRows][NC];
#pragma unroll
  for (int r = 0; r < kFaRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < k_end; k0 += kFaBK) {
    __syncthreads();  // the previous tile's K/V/P reads are done
    for (int i = tid; i < kFaBK * D; i += kFaThreads) {
      const int r = i / D, c = i - r * D;
      const int key = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (key < Sk) {
        kv = to_f32(k[kbase + (long long)key * D + c]);
        vv = to_f32(v[kbase + (long long)key * D + c]);
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
    const bool col_ok = col < Sk;
    const float bcol = (brow != nullptr && col_ok) ? brow[col] : 0.f;
#pragma unroll
    for (int r = 0; r < kFaRows; ++r) {
      const int row = q0 + warp * kFaRows + r;
      float x = s[r] * scale + bcol;
      if (!col_ok || (causal && row + offset < col)) x = -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(x));
      // a row may still be fully masked: keep exp arguments finite so it
      // stays exactly 0 instead of NaN (the TPU kernel's m_eff)
      const float m_eff = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[r] - m_eff);
      const float p = expf(x - m_eff);
      l[r] = l[r] * alpha + p;  // lane-partial row sum, undropped
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
      float pu = p;
      if (dropout) {
        pu = dropout_keep(seed, bh, (uint32_t)row, (uint32_t)col, thresh) ? p * inv_keep : 0.f;
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
    if (row < Sq) {
      const float ls = lt == 0.f ? 1.f : lt;
      T* orow = out + qbase + (long long)row * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) orow[lane + 32 * c] = from_f32<T>(acc[r][c] / ls);
      if (lane == 0) lse[(long long)(b * H + h) * Sq + row] = lt == 0.f ? -INFINITY : m[r] + logf(ls);
    }
  }
}

template <typename T, int D>
static int launch_flash(const void* q, const void* k, const void* v, const float* bias,
                        long long bias_batch_stride, const int* seed, void* out, float* lse,
                        int B, int H, int Hkv, int Sq, int Sk, float scale, int causal,
                        int dropout, uint32_t thresh, float inv_keep, cudaStream_t s) {
  constexpr size_t smem = flash_smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Sq + kFaBQ - 1) / kFaBQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kFaThreads, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, bias_batch_stride, seed, (T*)out, lse, H,
      Hkv, Sq, Sk, scale, causal, dropout, thresh, inv_keep);
  return (int)cudaGetLastError();
}

extern "C" int flash_fwd(const void* q, const void* k, const void* v, const float* bias,
                         long long bias_batch_stride, const int* seed, void* out, float* lse,
                         int B, int H, int Hkv, int Sq, int Sk, int D, float scale, int causal,
                         int dropout, unsigned int thresh, float inv_keep, int dtype,
                         void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  DISPATCH_DTYPE(dtype, T, {
    if (D == 64)
      return launch_flash<T, 64>(q, k, v, bias, bias_batch_stride, seed, out, lse, B, H, Hkv,
                                 Sq, Sk, scale, causal, dropout, thresh, inv_keep, s);
    if (D == 128)
      return launch_flash<T, 128>(q, k, v, bias, bias_batch_stride, seed, out, lse, B, H, Hkv,
                                  Sq, Sk, scale, causal, dropout, thresh, inv_keep, s);
    return (int)cudaErrorInvalidValue;
  })
  return (int)cudaErrorInvalidValue;
}
