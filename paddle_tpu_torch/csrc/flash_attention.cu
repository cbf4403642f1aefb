// Flash-attention forward and backward for Hopper (sm_90a).
//
// Forward. Replaces: paddle_tpu/ops/pallas/flash_attention.py::_flash_fwd_bhsd
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
#include "flash_common.cuh"

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

// ---------------------------------------------------------------------------
// Backward. Replaces: paddle_tpu/ops/pallas/flash_attention.py::_flash_bwd_bhsd
// (Pallas bodies _bwd_dq_kernel and _bwd_dkv_kernel). From the saved lse
// and delta = rowsum(dO * O) (fp32, computed by the wrapper), with
// P = exp(S * scale + bias - lse) under the forward's masks:
//   dV = (keep * c * P)^T dO
//   dS = P * (keep * c * (dO V^T) - delta) * scale
//   dQ = dS K,  dK = dS^T Q
// where keep is the forward's dropout_keep bit (the same counter hash on
// global (row, col), so any tiling regenerates it) and c = 1 / (1 - rate).
// A fully masked row (lse = -inf) uses lse 0, so its P is exactly 0 and
// its gradients 0, never NaN (the reference's lse_safe).
//
// What bounds it on the H100: operations, 5 products of
// 2 * B * H * Sq * Sk * D FLOPs (half of them when causal) over the
// 989 TFLOP/s bf16 tensor-core peak. Like the forward, this first version
// does its math on the CUDA cores in fp32; wgmma and TMA are the tuning
// PR's work.
//
// Design: two kernels, each a loop inside the block in place of the TPU's
// sequential grid axis.
// - dq: one block per (b, h, 32-row q tile), looping over 32-key tiles
//   (tiles wholly above the causal diagonal are never visited). Scores and
//   dO V^T are computed with lane j owning key j (K and V staged with a
//   padded row stride), dS goes through shared memory, and lane j owns dq
//   columns j, j+32, ... in the dS K product.
// - dkv: one block per (b, kv head, 32-key tile), looping over the GQA
//   group's q heads and, for each, over the q tiles at or below the causal
//   diagonal. Each warp owns 8 keys; lane j owns q row j in the transposed
//   score tile and dk/dv columns j, j+32, ... in the accumulation. The
//   group sum stays in fp32 registers and is cast once at the end, so no
//   per-q-head [B, H, Sk, D] intermediate and no second reduction pass
//   are needed, and the result is deterministic.
// Shared memory at D = 128: dq 70 KB, dkv 74 KB (fp32 tiles of 32 rows).

template <int D>
static constexpr size_t flash_dq_smem_bytes() {
  return sizeof(float) * (2 * (size_t)kFaBQ * D + 2 * (size_t)kFaBK * (D + 1) +
                          (size_t)kFaBQ * kFaBK);
}

template <typename T, int D>
__global__ void __launch_bounds__(kFaThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const float* __restrict__ bias,
                    long long bias_batch_stride, const int* __restrict__ seed_ptr,
                    T* __restrict__ dq, int H, int Hkv, int Sq, int Sk, float scale, int causal,
                    int dropout, uint32_t thresh, float inv_keep) {
  constexpr int NC = D / 32;
  const int qblk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = qblk * kFaBQ;

  extern __shared__ __align__(16) float sm[];
  float* q_s = sm;                            // [BQ][D]
  float* do_s = q_s + kFaBQ * D;              // [BQ][D]
  float* k_s = do_s + kFaBQ * D;              // [BK][D + 1]
  float* v_s = k_s + kFaBK * (D + 1);         // [BK][D + 1]
  float* ds_s = v_s + kFaBK * (D + 1);        // [BQ][BK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long qbase = (long long)(b * H + h) * Sq * D;
  const long long kbase = (long long)(b * Hkv + hk) * Sk * D;
  const long long rbase = (long long)(b * H + h) * Sq;

  for (int i = tid; i < kFaBQ * D; i += kFaThreads) {
    const int r = i / D, c = i - r * D;
    const int row = q0 + r;
    const bool ok = row < Sq;
    q_s[i] = ok ? to_f32(q[qbase + (long long)row * D + c]) : 0.f;
    do_s[i] = ok ? to_f32(dout[qbase + (long long)row * D + c]) : 0.f;
  }
  float lse_r[kFaRows], delta_r[kFaRows];
#pragma unroll
  for (int r = 0; r < kFaRows; ++r) {
    const int row = q0 + warp * kFaRows + r;
    const float l = row < Sq ? lse[rbase + row] : 0.f;
    lse_r[r] = l == -INFINITY ? 0.f : l;
    delta_r[r] = row < Sq ? delta[rbase + row] : 0.f;
  }

  const int offset = Sk - Sq;
  const int q_last = min(q0 + kFaBQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + offset + 1) : Sk;
  const float* brow = bias ? bias + (long long)b * bias_batch_stride : nullptr;
  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;
  const uint32_t bh = (uint32_t)(b * H + h);

  float acc[kFaRows][NC];
#pragma unroll
  for (int r = 0; r < kFaRows; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += kFaBK) {
    __syncthreads();  // the previous tile's K/V/dS reads are done
    for (int i = tid; i < kFaBK * D; i += kFaThreads) {
      const int r = i / D, c = i - r * D;
      const int key = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (key < Sk) {
        kv = to_f32(k[kbase + (long long)key * D + c]);
        vv = to_f32(v[kbase + (long long)key * D + c]);
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
    const bool col_ok = col < Sk;
    const float bcol = (brow != nullptr && col_ok) ? brow[col] : 0.f;
#pragma unroll
    for (int r = 0; r < kFaRows; ++r) {
      const int row = q0 + warp * kFaRows + r;
      const bool masked = !col_ok || row >= Sq || (causal && row + offset < col);
      const float p = masked ? 0.f : expf(s[r] * scale + bcol - lse_r[r]);
      float d = dp[r];
      if (dropout) {
        d = dropout_keep(seed, bh, (uint32_t)row, (uint32_t)col, thresh) ? d * inv_keep : 0.f;
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
    if (row < Sq) {
      T* orow = dq + qbase + (long long)row * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) orow[lane + 32 * c] = from_f32<T>(acc[r][c]);
    }
  }
}

template <int D>
static constexpr size_t flash_dkv_smem_bytes() {
  return sizeof(float) * (2 * (size_t)kFaBK * D + 2 * (size_t)kFaBQ * (D + 1) +
                          2 * (size_t)kFaBK * kFaBQ + 2 * (size_t)kFaBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kFaThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, const float* __restrict__ bias,
                     long long bias_batch_stride, const int* __restrict__ seed_ptr,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int Hkv, int Sq, int Sk,
                     float scale, int causal, int dropout, uint32_t thresh, float inv_keep) {
  constexpr int NC = D / 32;
  const int kblk = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int k0 = kblk * kFaBK;

  extern __shared__ __align__(16) float sm[];
  float* k_s = sm;                            // [BK][D]
  float* v_s = k_s + kFaBK * D;               // [BK][D]
  float* q_s = v_s + kFaBK * D;               // [BQ][D + 1]
  float* do_s = q_s + kFaBQ * (D + 1);        // [BQ][D + 1]
  float* p_s = do_s + kFaBQ * (D + 1);        // [BK][BQ] dropped P^T
  float* ds_s = p_s + kFaBK * kFaBQ;          // [BK][BQ] dS^T
  float* lse_s = ds_s + kFaBK * kFaBQ;        // [BQ]
  float* dl_s = lse_s + kFaBQ;                // [BQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long kbase = (long long)(b * Hkv + hk) * Sk * D;
  for (int i = tid; i < kFaBK * D; i += kFaThreads) {
    const int r = i / D, c = i - r * D;
    const int key = k0 + r;
    const bool ok = key < Sk;
    k_s[i] = ok ? to_f32(k[kbase + (long long)key * D + c]) : 0.f;
    v_s[i] = ok ? to_f32(v[kbase + (long long)key * D + c]) : 0.f;
  }
  const float* brow = bias ? bias + (long long)b * bias_batch_stride : nullptr;
  float bk[kFaRows];
#pragma unroll
  for (int r = 0; r < kFaRows; ++r) {
    const int key = k0 + warp * kFaRows + r;
    bk[r] = (brow != nullptr && key < Sk) ? brow[key] : 0.f;
  }

  const int offset = Sk - Sq;
  // the first q row that sees any key of this tile, rounded down to a tile
  const int q_begin = causal ? (max(0, k0 - offset) / kFaBQ) * kFaBQ : 0;
  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;

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
    const long long qbase = (long long)(b * H + h) * Sq * D;
    const long long rbase = (long long)(b * H + h) * Sq;
    const uint32_t bh = (uint32_t)(b * H + h);
    for (int q0 = q_begin; q0 < Sq; q0 += kFaBQ) {
      __syncthreads();  // the previous tile's Q/dO/P/dS reads are done
      for (int i = tid; i < kFaBQ * D; i += kFaThreads) {
        const int r = i / D, c = i - r * D;
        const int row = q0 + r;
        const bool ok = row < Sq;
        q_s[r * (D + 1) + c] = ok ? to_f32(q[qbase + (long long)row * D + c]) : 0.f;
        do_s[r * (D + 1) + c] = ok ? to_f32(dout[qbase + (long long)row * D + c]) : 0.f;
      }
      if (tid < kFaBQ) {
        const int row = q0 + tid;
        const float l = row < Sq ? lse[rbase + row] : 0.f;
        lse_s[tid] = l == -INFINITY ? 0.f : l;
        dl_s[tid] = row < Sq ? delta[rbase + row] : 0.f;
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
      const bool row_ok = row < Sq;
      const float ls = lse_s[lane], dl = dl_s[lane];
#pragma unroll
      for (int r = 0; r < kFaRows; ++r) {
        const int key = k0 + warp * kFaRows + r;
        const bool masked = !row_ok || key >= Sk || (causal && row + offset < key);
        const float p = masked ? 0.f : expf(s[r] * scale + bk[r] - ls);
        float pd = p, d = dp[r];
        if (dropout) {
          const bool keep = dropout_keep(seed, bh, (uint32_t)row, (uint32_t)key, thresh);
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
    if (key < Sk) {
      T* krow = dk + kbase + (long long)key * D;
      T* vrow = dv + kbase + (long long)key * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        krow[lane + 32 * c] = from_f32<T>(acc_k[r][c]);
        vrow[lane + 32 * c] = from_f32<T>(acc_v[r][c]);
      }
    }
  }
}

template <typename T, int D>
static int launch_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, const float* bias,
                            long long bias_batch_stride, const int* seed, void* dq, void* dk,
                            void* dv, int B, int H, int Hkv, int Sq, int Sk, float scale,
                            int causal, int dropout, uint32_t thresh, float inv_keep,
                            cudaStream_t s) {
  constexpr size_t smem_dq = flash_dq_smem_bytes<D>();
  constexpr size_t smem_dkv = flash_dkv_smem_bytes<D>();
  cudaError_t e;
  if (smem_dq > 48 * 1024) {
    e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
    if (e != cudaSuccess) return (int)e;
  }
  if (smem_dkv > 48 * 1024) {
    e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid_dq((Sq + kFaBQ - 1) / kFaBQ, H, B);
  flash_bwd_dq_kernel<T, D><<<grid_dq, kFaThreads, smem_dq, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, bias,
      bias_batch_stride, seed, (T*)dq, H, Hkv, Sq, Sk, scale, causal, dropout, thresh,
      inv_keep);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_dkv((Sk + kFaBK - 1) / kFaBK, Hkv, B);
  flash_bwd_dkv_kernel<T, D><<<grid_dkv, kFaThreads, smem_dkv, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, bias,
      bias_batch_stride, seed, (T*)dk, (T*)dv, H, Hkv, Sq, Sk, scale, causal, dropout, thresh,
      inv_keep);
  return (int)cudaGetLastError();
}

// q, dout, dq: [B,H,Sq,D]; k, v, dk, dv: [B,Hkv,Sk,D] (one dtype); lse,
// delta: [B,H,Sq] fp32. Launches the dq kernel, then the dk/dv kernel.
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, const float* bias,
                         long long bias_batch_stride, const int* seed, void* dq, void* dk,
                         void* dv, int B, int H, int Hkv, int Sq, int Sk, int D, float scale,
                         int causal, int dropout, unsigned int thresh, float inv_keep, int dtype,
                         void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  DISPATCH_DTYPE(dtype, T, {
    if (D == 64)
      return launch_flash_bwd<T, 64>(q, k, v, dout, lse, delta, bias, bias_batch_stride, seed, dq,
                                     dk, dv, B, H, Hkv, Sq, Sk, scale, causal, dropout, thresh,
                                     inv_keep, s);
    if (D == 128)
      return launch_flash_bwd<T, 128>(q, k, v, dout, lse, delta, bias, bias_batch_stride, seed,
                                      dq, dk, dv, B, H, Hkv, Sq, Sk, scale, causal, dropout,
                                      thresh, inv_keep, s);
    return (int)cudaErrorInvalidValue;
  })
  return (int)cudaErrorInvalidValue;
}
