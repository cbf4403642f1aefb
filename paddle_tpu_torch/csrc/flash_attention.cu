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
// Routes, fixed by the dtype in the C entry points flash_fwd / flash_bwd
// (launch_flash, launch_flash_bwd): fp32 takes the CUDA-core kernels of
// this first part (flash_fwd_kernel, flash_bwd_dq_kernel,
// flash_bwd_dkv_kernel); bf16 and fp16 take the tensor-core kernels of the
// second part (flash_fwd_tc_kernel, flash_bwd_dq_tc_kernel,
// flash_bwd_dkv_tc_kernel). The tensor cores have no fp32 product, and
// TF32's 10-bit mantissa cannot hold the fp32 outputs to 1e-4.
//
// CUDA-core forward (fp32 only). What bounds it on the H100: operations
// at prefill sizes, 4 * B * H * Sq * Sk * D FLOPs (half of them when
// causal), over the 67 TFLOP/s fp32 peak of the CUDA cores.
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
#include <type_traits>

#include "flash_mma.cuh"

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
static int launch_flash_cc(const void* q, const void* k, const void* v, const float* bias,
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
// CUDA-core backward (fp32 only). What bounds it on the H100: operations,
// 5 products of 2 * B * H * Sq * Sk * D FLOPs (half of them when causal),
// over the 67 TFLOP/s fp32 peak of the CUDA cores.
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
static int launch_flash_bwd_cc(const void* q, const void* k, const void* v, const void* dout,
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

// ===========================================================================
// Tensor-core kernels (bf16, fp16): the same functions as above, held to the
// same plain versions (_flash_fwd_reference, _flash_bwd_reference).
//
// What bounds them on the H100: operations, 4 * B * H * Sq * Sk * D FLOPs
// forward and 2.5x that backward (5 products), halved under causal, over
// the 989 TFLOP/s bf16/fp16 tensor-core peak. At [4,16,2048,128] causal
// that is 68.7 GFLOP forward (0.069 ms) and 172 GFLOP backward (0.174 ms).
//
// What the design does about it: every product runs on the tensor cores
// (mma.sync m16n8k16, fp32 accumulation, flash_mma.cuh); Q, K, V, dO stay
// in the input type in shared memory (a quarter of the fp32 tiles' bytes),
// K/V (or Q/dO) tiles are double-buffered with cp.async so the next tile's
// copy overlaps this tile's products, and softmax, masks, dropout and dS
// run on the accumulator fragments in registers. Tiles wholly past the
// causal diagonal are skipped, and only tiles that cross the diagonal or
// the ragged end evaluate masks. wgmma/TMA and warp specialisation would
// go further and are not used here.
//
// Why P and dS are split. S = Q K^T and dP = dO V^T have 16-bit inputs,
// so their products are exact and only summed in fp32. P and dS are fp32
// values that the tensor cores can only take as 16-bit inputs. Rounding P
// once to bf16 (8 significant bits) misses the check that the CUDA-core
// kernels pass (1e-4 plus two output ulps against the fp32-P plain
// version): in a CPU model of these kernels' rounding, bf16 causal at
// [2,4,512,128] and [1,2,2048,128], the worst output entry reaches 12.1x
// the tolerance, and dS or P rounded once puts dq, dk, dv at 8.9x-30.9x.
// Split as hi = T(x), lo = T(x - hi), with both products summed in fp32,
// every worst entry is 0.45x-0.48x: the one-output-ulp flip the CUDA-core
// kernels show too (tests/test_torch_flash_tc_numerics.py, which prints
// these shares when run as a script). So P.V, dS K, P^T dO and dS^T Q
// each take two MMAs: the forward runs 3 products of 2 * B * H * Sq * Sk
// * D FLOPs where the bound counts 2, the backward 10 where it counts 5
// (S and dP are computed in both kernels: 7 without the split).
//
// Fully masked rows follow the CUDA-core kernels: out 0, lse -inf, and
// P = 0 in the backward (lse read as 0), so their gradients are 0. The row
// sum l is taken from the fp32 p before the split, undropped.
//
// Resources (ptxas -v for sm_90a, bf16 / fp16; no kernel spills) and
// dynamic shared memory, D = 128 / D = 64:
//   flash_fwd_tc_kernel      212 / 214 registers (D 64: 165), 85.0 / 45.0 KB
//   flash_bwd_dq_tc_kernel   226 / 226 registers (D 64: 192), 102.0 / 54.0 KB
//   flash_bwd_dkv_tc_kernel  241 / 252 registers (D 64: 163), 68.5 / 36.5 KB
// Registers are the scarce resource: 128 threads of at most 255 registers
// allow two blocks (8 warps) per SM, which the shared memory also fits.
// The dk/dv kernel holds 16 keys x D of dK and dV per warp in fp32 (128
// registers at D 128), so it steps over q rows 32 at a time to keep the
// score and dP tiles at 16 registers each; the dq kernel re-reads Q and
// dO from shared memory rather than keep their fragments in registers.

// q rows per step of the dk/dv kernel: with 16 keys of dK and dV per warp
// in fp32 registers (2 * D / 2 per thread), a 32-row step keeps the score
// and dP tiles at 16 registers each
constexpr int kTcDkvRows = 32;

template <int D>
static constexpr size_t flash_fwd_tc_smem_bytes() {  // Q, 2 stages of K and V
  return sizeof(uint16_t) * 5 * (size_t)kTcBlk * (D + kTcPad);
}

// Forward. One block of 4 warps per (h, b, 64-row q tile); warp w owns q
// rows 16w .. 16w + 15 and loops over 64-key tiles. Q fragments stay in
// registers for the whole loop. Grid (H, B, q tiles), the q-tile index
// reversed so that under causal the heaviest tiles are scheduled first.
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ bias, long long bias_batch_stride,
                    const int* __restrict__ seed_ptr, T* __restrict__ out,
                    float* __restrict__ lse, int H, int Hkv, int Sq, int Sk, float scale,
                    int causal, int dropout, uint32_t thresh, float inv_keep) {
  constexpr int LD = D + kTcPad;
  constexpr int KS = D / 16;       // k-steps of Q K^T
  constexpr int NT = kTcBlk / 8;   // score n-tiles (8 keys each)
  constexpr int DT = D / 8;        // output n-tiles
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcBlk;
  const int hk = h / (H / Hkv);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [64][LD]
  T* k_s = q_s + kTcBlk * LD;               // [2][64][LD]
  T* v_s = k_s + 2 * kTcBlk * LD;           // [2][64][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const long long qbase = (long long)(b * H + h) * Sq * D;
  const long long kbase = (long long)(b * Hkv + hk) * Sk * D;
  const int offset = Sk - Sq;
  const int q_last = min(q0 + kTcBlk, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + offset + 1) : Sk;
  const int n_tiles = k_end > 0 ? (k_end + kTcBlk - 1) / kTcBlk : 0;
  const float* brow = bias ? bias + (long long)b * bias_batch_stride : nullptr;
  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;
  const uint32_t bh = (uint32_t)(b * H + h);
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  load_tile<T, kTcBlk, D>(q_s, q + qbase, q0, Sq, tid);
  if (n_tiles > 0) {
    load_tile<T, kTcBlk, D>(k_s, k + kbase, 0, Sk, tid);
    load_tile<T, kTcBlk, D>(v_s, v + kbase, 0, Sk, tid);
  }
  cp_async_commit();

  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t qf[KS][4];

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTcBlk;
    if (j + 1 < n_tiles) {
      const int st = (j + 1) & 1;
      load_tile<T, kTcBlk, D>(k_s + st * kTcBlk * LD, k + kbase, k0 + kTcBlk, Sk, tid);
      load_tile<T, kTcBlk, D>(v_s + st * kTcBlk * LD, v + kbase, k0 + kTcBlk, Sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) ldsm_x4(qf[ks], frag_a<LD>(q_s, warp * 16, ks * 16, lane));
    }
    const T* kt = k_s + (j & 1) * kTcBlk * LD;
    const T* vt = v_s + (j & 1) * kTcBlk * LD;

    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, frag_b_nk<LD>(kt, np * 16, ks * 16, lane));
        mma16816<T>(s[2 * np], qf[ks], kb[0], kb[1]);
        mma16816<T>(s[2 * np + 1], qf[ks], kb[2], kb[3]);
      }

    // logits, masks (only where the tile crosses the diagonal or Sk)
    const bool edge = k0 + kTcBlk > Sk || (causal && q0 + offset < k0 + kTcBlk - 1);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t4 + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        float x = s[nt][e] * scale;
        if (brow != nullptr) x += col < Sk ? brow[col] : 0.f;
        if (edge && (col >= Sk || (causal && row + offset < col))) x = -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], mel[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = quad_max(mx[i]);
      // a row may still be fully masked: keep exp arguments finite so it
      // stays exactly 0 instead of NaN (the TPU kernel's m_eff)
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
          p = dropout_keep(seed, bh, (uint32_t)row, (uint32_t)col, thresh) ? p * inv_keep : 0.f;
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

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lt = quad_sum(l[i]);
    const int row = row0 + i * 8;
    if (row < Sq) {
      const float ls = lt == 0.f ? 1.f : lt;
      T* orow = out + qbase + (long long)row * D + 2 * t4;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<uint32_t*>(orow + dt * 8) =
            pack2<T>(o[dt][2 * i] / ls, o[dt][2 * i + 1] / ls);
      if (t4 == 0) lse[(long long)(b * H + h) * Sq + row] = lt == 0.f ? -INFINITY : m[i] + logf(ls);
    }
  }
}

template <typename T, int D>
static int launch_flash_tc(const void* q, const void* k, const void* v, const float* bias,
                           long long bias_batch_stride, const int* seed, void* out, float* lse,
                           int B, int H, int Hkv, int Sq, int Sk, float scale, int causal,
                           int dropout, uint32_t thresh, float inv_keep, cudaStream_t s) {
  constexpr size_t smem = flash_fwd_tc_smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, B, (Sq + kTcBlk - 1) / kTcBlk);
  flash_fwd_tc_kernel<T, D><<<grid, kTcThreads, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, bias_batch_stride, seed, (T*)out, lse, H,
      Hkv, Sq, Sk, scale, causal, dropout, thresh, inv_keep);
  return (int)cudaGetLastError();
}

template <int D>
static constexpr size_t flash_dq_tc_smem_bytes() {  // Q, dO, 2 stages of K and V
  return sizeof(uint16_t) * 6 * (size_t)kTcBlk * (D + kTcPad);
}

// Backward, dq. One block of 4 warps per (h, b, 64-row q tile), looping
// over 64-key tiles at or below the diagonal: S = Q K^T and dP = dO V^T
// (Q and dO re-read from shared memory by ldmatrix, which keeps 64
// registers free for the fp32 dQ tile), dS = P * (dP - delta) * scale in
// registers, dQ += dS K with dS as hi + lo.
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const float* __restrict__ bias, long long bias_batch_stride,
                       const int* __restrict__ seed_ptr, T* __restrict__ dq, int H, int Hkv,
                       int Sq, int Sk, float scale, int causal, int dropout, uint32_t thresh,
                       float inv_keep) {
  constexpr int LD = D + kTcPad;
  constexpr int KS = D / 16;
  constexpr int NT = kTcBlk / 8;
  constexpr int DT = D / 8;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcBlk;
  const int hk = h / (H / Hkv);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [64][LD]
  T* do_s = q_s + kTcBlk * LD;              // [64][LD]
  T* k_s = do_s + kTcBlk * LD;              // [2][64][LD]
  T* v_s = k_s + 2 * kTcBlk * LD;           // [2][64][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const long long qbase = (long long)(b * H + h) * Sq * D;
  const long long kbase = (long long)(b * Hkv + hk) * Sk * D;
  const long long rbase = (long long)(b * H + h) * Sq;
  const int offset = Sk - Sq;
  const int q_last = min(q0 + kTcBlk, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + offset + 1) : Sk;
  const int n_tiles = k_end > 0 ? (k_end + kTcBlk - 1) / kTcBlk : 0;
  const float* brow = bias ? bias + (long long)b * bias_batch_stride : nullptr;
  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;
  const uint32_t bh = (uint32_t)(b * H + h);
  const int row0 = q0 + warp * 16 + g;

  load_tile<T, kTcBlk, D>(q_s, q + qbase, q0, Sq, tid);
  load_tile<T, kTcBlk, D>(do_s, dout + qbase, q0, Sq, tid);
  if (n_tiles > 0) {
    load_tile<T, kTcBlk, D>(k_s, k + kbase, 0, Sk, tid);
    load_tile<T, kTcBlk, D>(v_s, v + kbase, 0, Sk, tid);
  }
  cp_async_commit();

  float lse_l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    const float lv = row < Sq ? lse[rbase + row] : 0.f;
    lse_l2[i] = (lv == -INFINITY ? 0.f : lv) * kLog2e;  // the reference's lse_safe
    dl[i] = row < Sq ? delta[rbase + row] : 0.f;
  }

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTcBlk;
    if (j + 1 < n_tiles) {
      const int st = (j + 1) & 1;
      load_tile<T, kTcBlk, D>(k_s + st * kTcBlk * LD, k + kbase, k0 + kTcBlk, Sk, tid);
      load_tile<T, kTcBlk, D>(v_s + st * kTcBlk * LD, v + kbase, k0 + kTcBlk, Sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kt = k_s + (j & 1) * kTcBlk * LD;
    const T* vt = v_s + (j & 1) * kTcBlk * LD;

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
        ldsm_x4(kb, frag_b_nk<LD>(kt, np * 16, ks * 16, lane));
        mma16816<T>(s[2 * np], a, kb[0], kb[1]);
        mma16816<T>(s[2 * np + 1], a, kb[2], kb[3]);
      }
      ldsm_x4(a, frag_a<LD>(do_s, warp * 16, ks * 16, lane));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t vb[4];
        ldsm_x4(vb, frag_b_nk<LD>(vt, np * 16, ks * 16, lane));
        mma16816<T>(dp[2 * np], a, vb[0], vb[1]);
        mma16816<T>(dp[2 * np + 1], a, vb[2], vb[3]);
      }
    }

    const bool edge = k0 + kTcBlk > Sk || (causal && q0 + offset < k0 + kTcBlk - 1);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t4 + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        float x = s[nt][e] * scale;
        if (brow != nullptr) x += col < Sk ? brow[col] : 0.f;
        const bool masked = edge && (col >= Sk || (causal && row + offset < col));
        const float p = masked ? 0.f : exp2f(fmaf(x, kLog2e, -lse_l2[e >> 1]));
        float d = dp[nt][e];
        if (dropout) {
          d = dropout_keep(seed, bh, (uint32_t)row, (uint32_t)col, thresh) ? d * inv_keep : 0.f;
        }
        s[nt][e] = p * (d - dl[e >> 1]) * scale;  // dS
      }

    // dQ += dS K, dS as hi + lo; K read as [key][d] = [k][n]
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t ah[4], al[4];
      acc_to_a<T>(s[2 * kk], s[2 * kk + 1], ah, al);
#pragma unroll
      for (int dp2 = 0; dp2 < DT / 2; ++dp2) {
        uint32_t kb[4];
        ldsm_x4_trans(kb, frag_b_kn<LD>(kt, kk * 16, dp2 * 16, lane));
        mma16816<T>(acc[2 * dp2], al, kb[0], kb[1]);
        mma16816<T>(acc[2 * dp2], ah, kb[0], kb[1]);
        mma16816<T>(acc[2 * dp2 + 1], al, kb[2], kb[3]);
        mma16816<T>(acc[2 * dp2 + 1], ah, kb[2], kb[3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row < Sq) {
      T* orow = dq + qbase + (long long)row * D + 2 * t4;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<uint32_t*>(orow + dt * 8) = pack2<T>(acc[dt][2 * i], acc[dt][2 * i + 1]);
    }
  }
}

template <int D>
static constexpr size_t flash_dkv_tc_smem_bytes() {
  // K, V; 2 stages of Q and dO; 2 stages of lse and delta
  return sizeof(uint16_t) * (2 * (size_t)kTcBlk + 4 * (size_t)kTcDkvRows) * (D + kTcPad) +
         sizeof(float) * 4 * kTcDkvRows;
}

// Backward, dk/dv. One block of 4 warps per (kv head, b, 64-key tile);
// warp w owns keys 16w .. 16w + 15 and loops over the GQA group's q heads
// and, for each, the 32-row q tiles at or below the diagonal (Q, dO, lse
// and delta double-buffered with cp.async). It computes the transposed
// tiles S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q
// with P^T and dS^T as hi + lo. The group sum stays in fp32 registers and
// is cast once: deterministic, no atomics.
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_bwd_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const float* __restrict__ bias, long long bias_batch_stride,
                        const int* __restrict__ seed_ptr, T* __restrict__ dk,
                        T* __restrict__ dv, int H, int Hkv, int Sq, int Sk, float scale,
                        int causal, int dropout, uint32_t thresh, float inv_keep) {
  constexpr int LD = D + kTcPad;
  constexpr int KS = D / 16;
  constexpr int BQ = kTcDkvRows;
  constexpr int NQ = BQ / 8;  // n-tiles of q rows
  constexpr int DT = D / 8;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kTcBlk;  // under causal the first key tiles are the heaviest
  const int G = H / Hkv;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // [64][LD]
  T* v_s = k_s + kTcBlk * LD;               // [64][LD]
  T* q_s = v_s + kTcBlk * LD;               // [2][32][LD]
  T* do_s = q_s + 2 * BQ * LD;              // [2][32][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BQ * LD);  // [2][32]
  float* dl_s = lse_s + 2 * BQ;                                  // [2][32]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const long long kbase = (long long)(b * Hkv + hk) * Sk * D;
  const int offset = Sk - Sq;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  const float* brow = bias ? bias + (long long)b * bias_batch_stride : nullptr;
  float bk[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    bk[i] = (brow != nullptr && key0 + 8 * i < Sk) ? brow[key0 + 8 * i] : 0.f;
  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;
  // the first q row that sees any key of this tile, rounded down to a step
  const int q_begin = causal ? (max(0, k0 - offset) / BQ) * BQ : 0;
  const int n_qt = q_begin < Sq ? (Sq - q_begin + BQ - 1) / BQ : 0;
  const int n_it = G * n_qt;

  load_tile<T, kTcBlk, D>(k_s, k + kbase, k0, Sk, tid);
  load_tile<T, kTcBlk, D>(v_s, v + kbase, k0, Sk, tid);
  auto issue = [&](int it, int st) {
    const int hh = it / n_qt;
    const int q0 = q_begin + (it - hh * n_qt) * BQ;
    const long long hrow = (long long)(b * H + hk * G + hh) * Sq;
    load_tile<T, BQ, D>(q_s + st * BQ * LD, q + hrow * D, q0, Sq, tid);
    load_tile<T, BQ, D>(do_s + st * BQ * LD, dout + hrow * D, q0, Sq, tid);
    if (tid < 2 * BQ) {
      const int r = tid & (BQ - 1);
      const bool ok = q0 + r < Sq;
      const float* src = tid < BQ ? lse : delta;
      cp_async4((tid < BQ ? lse_s : dl_s) + st * BQ + r, ok ? src + hrow + q0 + r : src, ok);
    }
  };
  if (n_it > 0) issue(0, 0);
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
      issue(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int hh = it / n_qt;
    const int q0 = q_begin + (it - hh * n_qt) * BQ;
    const uint32_t bh = (uint32_t)(b * H + hk * G + hh);
    const int st = it & 1;
    const T* qt = q_s + st * BQ * LD;
    const T* dot = do_s + st * BQ * LD;
    const float* ls = lse_s + st * BQ;
    const float* dls = dl_s + st * BQ;

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

    const bool edge =
        k0 + kTcBlk > Sk || q0 + BQ > Sq || (causal && q0 + offset < k0 + kTcBlk - 1);
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t4 + (e & 1);
        const int row = q0 + c;
        const int key = key0 + (e >> 1) * 8;
        const float lv = ls[c];
        const float x = s[nt][e] * scale + bk[e >> 1];
        const bool masked = edge && (key >= Sk || row >= Sq || (causal && row + offset < key));
        const float p =
            masked ? 0.f : exp2f(fmaf(x, kLog2e, -(lv == -INFINITY ? 0.f : lv) * kLog2e));
        float pd = p, d = dp[nt][e];
        if (dropout) {
          const bool keep = dropout_keep(seed, bh, (uint32_t)row, (uint32_t)key, thresh);
          pd = keep ? p * inv_keep : 0.f;
          d = keep ? d * inv_keep : 0.f;
        }
        s[nt][e] = pd;                            // dropped P^T
        dp[nt][e] = p * (d - dls[c]) * scale;     // dS^T
      }

    // dV += P^T dO and dK += dS^T Q over this step's 32 q rows (2 k-steps);
    // dO and Q read as [row][d] = [k][n]
#pragma unroll
    for (int kk = 0; kk < NQ / 2; ++kk) {
      uint32_t ph[4], pl[4], dh[4], dlo[4];
      acc_to_a<T>(s[2 * kk], s[2 * kk + 1], ph, pl);
      acc_to_a<T>(dp[2 * kk], dp[2 * kk + 1], dh, dlo);
#pragma unroll
      for (int dp2 = 0; dp2 < DT / 2; ++dp2) {
        uint32_t bo[4], bq[4];
        ldsm_x4_trans(bo, frag_b_kn<LD>(dot, kk * 16, dp2 * 16, lane));
        mma16816<T>(acc_v[2 * dp2], pl, bo[0], bo[1]);
        mma16816<T>(acc_v[2 * dp2], ph, bo[0], bo[1]);
        mma16816<T>(acc_v[2 * dp2 + 1], pl, bo[2], bo[3]);
        mma16816<T>(acc_v[2 * dp2 + 1], ph, bo[2], bo[3]);
        ldsm_x4_trans(bq, frag_b_kn<LD>(qt, kk * 16, dp2 * 16, lane));
        mma16816<T>(acc_k[2 * dp2], dlo, bq[0], bq[1]);
        mma16816<T>(acc_k[2 * dp2], dh, bq[0], bq[1]);
        mma16816<T>(acc_k[2 * dp2 + 1], dlo, bq[2], bq[3]);
        mma16816<T>(acc_k[2 * dp2 + 1], dh, bq[2], bq[3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + i * 8;
    if (key < Sk) {
      T* krow = dk + kbase + (long long)key * D + 2 * t4;
      T* vrow = dv + kbase + (long long)key * D + 2 * t4;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        *reinterpret_cast<uint32_t*>(krow + dt * 8) =
            pack2<T>(acc_k[dt][2 * i], acc_k[dt][2 * i + 1]);
        *reinterpret_cast<uint32_t*>(vrow + dt * 8) =
            pack2<T>(acc_v[dt][2 * i], acc_v[dt][2 * i + 1]);
      }
    }
  }
}

template <typename T, int D>
static int launch_flash_bwd_tc(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* delta, const float* bias,
                               long long bias_batch_stride, const int* seed, void* dq, void* dk,
                               void* dv, int B, int H, int Hkv, int Sq, int Sk, float scale,
                               int causal, int dropout, uint32_t thresh, float inv_keep,
                               cudaStream_t s) {
  constexpr size_t smem_dq = flash_dq_tc_smem_bytes<D>();
  constexpr size_t smem_dkv = flash_dkv_tc_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_dq(H, B, (Sq + kTcBlk - 1) / kTcBlk);
  flash_bwd_dq_tc_kernel<T, D><<<grid_dq, kTcThreads, smem_dq, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, bias,
      bias_batch_stride, seed, (T*)dq, H, Hkv, Sq, Sk, scale, causal, dropout, thresh,
      inv_keep);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_dkv(Hkv, B, (Sk + kTcBlk - 1) / kTcBlk);
  flash_bwd_dkv_tc_kernel<T, D><<<grid_dkv, kTcThreads, smem_dkv, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, bias,
      bias_batch_stride, seed, (T*)dk, (T*)dv, H, Hkv, Sq, Sk, scale, causal, dropout, thresh,
      inv_keep);
  return (int)cudaGetLastError();
}

// ===========================================================================
// Entry points. The route is the dtype's: fp32 -> CUDA-core kernels,
// bf16/fp16 -> tensor-core kernels. No fallback between them: a failed
// launch returns its error.

template <typename T, int D>
static int launch_flash(const void* q, const void* k, const void* v, const float* bias,
                        long long bias_batch_stride, const int* seed, void* out, float* lse,
                        int B, int H, int Hkv, int Sq, int Sk, float scale, int causal,
                        int dropout, uint32_t thresh, float inv_keep, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value)
    return launch_flash_cc<T, D>(q, k, v, bias, bias_batch_stride, seed, out, lse, B, H, Hkv,
                                 Sq, Sk, scale, causal, dropout, thresh, inv_keep, s);
  else
    return launch_flash_tc<T, D>(q, k, v, bias, bias_batch_stride, seed, out, lse, B, H, Hkv,
                                 Sq, Sk, scale, causal, dropout, thresh, inv_keep, s);
}

template <typename T, int D>
static int launch_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, const float* bias,
                            long long bias_batch_stride, const int* seed, void* dq, void* dk,
                            void* dv, int B, int H, int Hkv, int Sq, int Sk, float scale,
                            int causal, int dropout, uint32_t thresh, float inv_keep,
                            cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value)
    return launch_flash_bwd_cc<T, D>(q, k, v, dout, lse, delta, bias, bias_batch_stride, seed,
                                     dq, dk, dv, B, H, Hkv, Sq, Sk, scale, causal, dropout,
                                     thresh, inv_keep, s);
  else
    return launch_flash_bwd_tc<T, D>(q, k, v, dout, lse, delta, bias, bias_batch_stride, seed,
                                     dq, dk, dv, B, H, Hkv, Sq, Sk, scale, causal, dropout,
                                     thresh, inv_keep, s);
}

extern "C" int flash_fwd(const void* q, const void* k, const void* v, const float* bias,
                         long long bias_batch_stride, const int* seed, void* out, float* lse,
                         int B, int H, int Hkv, int Sq, int Sk, int D, float scale, int causal,
                         int dropout, unsigned int thresh, float inv_keep, int dtype,
                         void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype != kF32 && !aligned16({q, k, v, out})) return (int)cudaErrorMisalignedAddress;
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
  if (dtype != kF32 && !aligned16({q, k, v, dout, dq, dk, dv}))
    return (int)cudaErrorMisalignedAddress;
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
