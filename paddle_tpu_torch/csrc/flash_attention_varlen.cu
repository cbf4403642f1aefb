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
// What bounds it on the H100: operations, 4 * D * H * sum_i len_q,i * len_k,i
// FLOPs forward (about half of that causal) and 2.5 times that backward (five
// products), over the 989 TFLOP/s bf16 tensor-core peak. Like the dense
// kernels this first version does its math on the CUDA cores in fp32, far from
// that bound; wgmma and TMA are the tuning PR's work.
//
// Design: the dense kernels' tiles (32 q rows x 32 keys, 4 warps of 8 rows,
// fp32 in shared memory), reading the packed tensors in place at their token
// stride: there is no transpose to [H, T, D] and no padding of T. Where the
// TPU visits every (q block, k block) pair and skips those whose segment
// ranges are disjoint, here a q tile loops only over the keys of its own
// segments, [cu_k[first segment], cu_k[last segment + 1]), cut under causal
// at its largest row bound; a key tile of the dk/dv kernel loops only over
// the q rows of its segments, from the first row that sees its first key.
// The work so stays about sum_i len_i^2 rather than T^2; a tile that
// straddles a segment boundary pays for both segments' keys. The element
// mask is the segment test above. GQA reads kv head h / (H / Hkv); the dk/dv
// kernel loops over the group's q heads and keeps dk and dv in fp32
// registers, cast once.
#include <limits.h>

#include "flash_common.cuh"

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

// The keys [begin, end) that the q rows [q0, q0 + 32) may see: those of their
// segments, and under causal none past their largest bound. Called by a whole
// warp; lane i looks at row q0 + i.
__device__ int2 q_tile_keys(const int* __restrict__ seg_q, const int* __restrict__ bound,
                            const int* __restrict__ cu_k, int q0, int Tq, int Tk, int n_seqs,
                            int causal, int lane) {
  const int row = q0 + lane;
  const int s = row < Tq ? seg_q[row] : n_seqs;
  const bool ok = s < n_seqs;  // rows past cu_q[-1] carry the sentinel n_seqs
  const int lo = warp_min_i(ok ? s : INT_MAX);
  const int hi = warp_max_i(ok ? s : -1);
  const int last = warp_max_i(ok ? bound[row] : -1);
  if (hi < 0) return make_int2(0, 0);
  const int begin = max(cu_k[lo], 0);
  int end = min(cu_k[hi + 1], Tk);
  if (causal) end = min(end, last + 1);
  return make_int2(begin, max(begin, end));
}

// The q rows [begin, end) that may see a key of [k0, k0 + 32): those of the
// keys' segments and, under causal, none before the first row of the first
// segment whose bound reaches the tile's first key. A whole warp; lane i
// looks at key k0 + i.
__device__ int2 k_tile_rows(const int* __restrict__ seg_k, const int* __restrict__ cu_q,
                            const int* __restrict__ cu_k, int k0, int Tq, int Tk, int n_seqs,
                            int causal, int lane) {
  const int key = k0 + lane;
  const int s = key < Tk ? seg_k[key] : n_seqs + 1;
  const bool ok = s < n_seqs;
  const int lo = warp_min_i(ok ? s : INT_MAX);
  const int hi = warp_max_i(ok ? s : -1);
  const int first = warp_min_i(ok ? key : INT_MAX);
  if (hi < 0) return make_int2(0, 0);
  int begin = cu_q[lo];
  if (causal) {
    // bound[row] = cu_k[lo] + (row - cu_q[lo]) + len_k - len_q >= first
    const int len_q = cu_q[lo + 1] - cu_q[lo], len_k = cu_k[lo + 1] - cu_k[lo];
    begin += min(len_q, max(0, first - cu_k[lo] - len_k + len_q));
  }
  begin = max(begin, 0);
  const int end = min(cu_q[hi + 1], Tq);
  return make_int2(begin, max(begin, end));
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
    const int2 r = q_tile_keys(seg_q, bound, cu_k, q0, Tq, Tk, n_seqs, causal, lane);
    if (lane == 0) keys_s = r;
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
// 0, so a row that saw no key has P = 0 and gradients 0, never NaN.

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
    const int2 r = q_tile_keys(seg_q, bound, cu_k, q0, Tq, Tk, n_seqs, causal, lane);
    if (lane == 0) keys_s = r;
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
    const int2 r = k_tile_rows(seg_k, cu_q, cu_k, k0, Tq, Tk, n_seqs, causal, lane);
    if (lane == 0) rows_s = r;
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

// ---------------------------------------------------------------------------
// C entry points. q/k/v are read at a token stride in elements (a token's
// heads and head dims contiguous); dout, out and the gradients are
// contiguous. seg_q, seg_k, bound, cu_q, cu_k, seed: int32 on the device.

template <typename K>
static cudaError_t opt_in_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

static bool bad_shape(int Tq, int Tk, int H, int Hkv, int n_seqs) {
  return Tq <= 0 || Tk <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || n_seqs <= 0;
}

extern "C" int vflash_fwd(const void* q, const void* k, const void* v, long long q_stride,
                          long long k_stride, long long v_stride, const int* seg_q,
                          const int* seg_k, const int* bound, const int* cu_k, const int* seed,
                          void* out, float* lse, int Tq, int Tk, int H, int Hkv, int D,
                          int n_seqs, float scale, int causal, int dropout, unsigned int thresh,
                          float inv_keep, int dtype, void* stream) {
  if (bad_shape(Tq, Tk, H, Hkv, n_seqs)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((Tq + kFaBQ - 1) / kFaBQ, H);
#define VFWD(DIM)                                                                             \
  {                                                                                           \
    constexpr size_t smem = vflash_fwd_smem_bytes<DIM>();                                     \
    cudaError_t e = opt_in_smem(vflash_fwd_kernel<T, DIM>, smem);                             \
    if (e != cudaSuccess) return (int)e;                                                      \
    vflash_fwd_kernel<T, DIM><<<grid, kFaThreads, smem, s>>>(                                 \
        (const T*)q, (const T*)k, (const T*)v, q_stride, k_stride, v_stride, seg_q, seg_k,    \
        bound, cu_k, seed, (T*)out, lse, Tq, Tk, H, Hkv, n_seqs, scale, causal, dropout,      \
        thresh, inv_keep);                                                                    \
    return (int)cudaGetLastError();                                                           \
  }
  DISPATCH_DTYPE(dtype, T, {
    if (D == 64) VFWD(64)
    if (D == 128) VFWD(128)
    return (int)cudaErrorInvalidValue;
  })
#undef VFWD
  return (int)cudaErrorInvalidValue;
}

extern "C" int vflash_bwd_dq(const void* q, const void* k, const void* v, long long q_stride,
                             long long k_stride, long long v_stride, const void* dout,
                             const float* lse, const float* delta, const int* seg_q,
                             const int* seg_k, const int* bound, const int* cu_k,
                             const int* seed, void* dq, int Tq, int Tk, int H, int Hkv, int D,
                             int n_seqs, float scale, int causal, int dropout,
                             unsigned int thresh, float inv_keep, int dtype, void* stream) {
  if (bad_shape(Tq, Tk, H, Hkv, n_seqs)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((Tq + kFaBQ - 1) / kFaBQ, H);
#define VDQ(DIM)                                                                              \
  {                                                                                           \
    constexpr size_t smem = vflash_dq_smem_bytes<DIM>();                                      \
    cudaError_t e = opt_in_smem(vflash_bwd_dq_kernel<T, DIM>, smem);                          \
    if (e != cudaSuccess) return (int)e;                                                      \
    vflash_bwd_dq_kernel<T, DIM><<<grid, kFaThreads, smem, s>>>(                              \
        (const T*)q, (const T*)k, (const T*)v, q_stride, k_stride, v_stride, (const T*)dout,  \
        lse, delta, seg_q, seg_k, bound, cu_k, seed, (T*)dq, Tq, Tk, H, Hkv, n_seqs, scale,   \
        causal, dropout, thresh, inv_keep);                                                   \
    return (int)cudaGetLastError();                                                           \
  }
  DISPATCH_DTYPE(dtype, T, {
    if (D == 64) VDQ(64)
    if (D == 128) VDQ(128)
    return (int)cudaErrorInvalidValue;
  })
#undef VDQ
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
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((Tk + kFaBK - 1) / kFaBK, Hkv);
#define VDKV(DIM)                                                                             \
  {                                                                                           \
    constexpr size_t smem = vflash_dkv_smem_bytes<DIM>();                                     \
    cudaError_t e = opt_in_smem(vflash_bwd_dkv_kernel<T, DIM>, smem);                         \
    if (e != cudaSuccess) return (int)e;                                                      \
    vflash_bwd_dkv_kernel<T, DIM><<<grid, kFaThreads, smem, s>>>(                             \
        (const T*)q, (const T*)k, (const T*)v, q_stride, k_stride, v_stride, (const T*)dout,  \
        lse, delta, seg_q, seg_k, bound, cu_q, cu_k, seed, (T*)dk, (T*)dv, Tq, Tk, H, Hkv,    \
        n_seqs, scale, causal, dropout, thresh, inv_keep);                                    \
    return (int)cudaGetLastError();                                                           \
  }
  DISPATCH_DTYPE(dtype, T, {
    if (D == 64) VDKV(64)
    if (D == 128) VDKV(128)
    return (int)cudaErrorInvalidValue;
  })
#undef VDKV
  return (int)cudaErrorInvalidValue;
}
