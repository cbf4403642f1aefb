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
// Routes, fixed by the dtype in the C entry point vflash_fwd: bf16 and
// fp16 take the tensor-core forward (vflash_fwd_tc_kernel, second part of
// this file); fp32 takes the CUDA-core forward (vflash_fwd_kernel), since
// TF32's 10-bit mantissa cannot hold the fp32 outputs to 1e-4. The
// backward (vflash_bwd_dq_kernel, vflash_bwd_dkv_kernel) runs on the CUDA
// cores in every dtype and takes either forward's out and lse.
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
// Resources (ptxas -v for sm_90a; no spills) and dynamic shared memory:
//   vflash_fwd_tc_kernel  D 128: 218 / 218 registers (bf16 / fp16), 85.5 KB;
//                         D 64: 158 / 157, 45.5 KB
// Registers allow two blocks (8 warps) per SM, which the shared memory
// also fits.

template <int D>
static constexpr size_t vflash_fwd_tc_smem_bytes() {  // Q, 2 stages of K, V and seg_k
  return sizeof(uint16_t) * 5 * (size_t)kTcBlk * (D + kTcPad) + sizeof(int) * 2 * kTcBlk;
}

// One block of 4 warps per (q head, 64-row q tile): warp w owns q rows
// q0 + 16w .. q0 + 16w + 15 and loops over 64-key tiles from k_begin.
// Grid (H, q tiles), heads fastest and the q tiles from the last: the
// blocks in flight read every head of one stretch of tokens (whole token
// rows of k and v), and within a segment the later rows, which see more
// keys, start first. out [Tq, H, D] (contiguous), lse [H, Tq].
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, 2)
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
  uint32_t qf[KS][4];

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
    if (j == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) ldsm_x4(qf[ks], frag_a<LD>(q_s, warp * 16, ks * 16, lane));
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
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, frag_b_nk<LD>(kt, np * 16, ks * 16, lane));
        mma16816<T>(s[2 * np], qf[ks], kb[0], kb[1]);
        mma16816<T>(s[2 * np + 1], qf[ks], kb[2], kb[3]);
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

// What the forward launches share.
struct VFwdArgs {
  const void *q, *k, *v;
  long long q_stride, k_stride, v_stride;
  const int *seg_q, *seg_k, *bound, *cu_k, *seed;
  void* out;
  float* lse;
  int Tq, Tk, H, Hkv, n_seqs;
  float scale;
  int causal, dropout;
  uint32_t thresh;
  float inv_keep;
};

template <typename T, int D>
static int launch_vflash_fwd_cc(const VFwdArgs& a, cudaStream_t s) {
  constexpr size_t smem = vflash_fwd_smem_bytes<D>();
  const cudaError_t e = opt_in_smem(vflash_fwd_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.Tq + kFaBQ - 1) / kFaBQ, a.H);
  vflash_fwd_kernel<T, D><<<grid, kFaThreads, smem, s>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.q_stride, a.k_stride, a.v_stride, a.seg_q,
      a.seg_k, a.bound, a.cu_k, a.seed, (T*)a.out, a.lse, a.Tq, a.Tk, a.H, a.Hkv, a.n_seqs,
      a.scale, a.causal, a.dropout, a.thresh, a.inv_keep);
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int launch_vflash_fwd_tc(const VFwdArgs& a, cudaStream_t s) {
  constexpr size_t smem = vflash_fwd_tc_smem_bytes<D>();
  const cudaError_t e = opt_in_smem(vflash_fwd_tc_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  const int q_tiles = (a.Tq + kTcBlk - 1) / kTcBlk;
  if (q_tiles > 65535) return (int)cudaErrorInvalidValue;  // gridDim.y
  const dim3 grid(a.H, q_tiles);
  vflash_fwd_tc_kernel<T, D><<<grid, kTcThreads, smem, s>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.q_stride, a.k_stride, a.v_stride, a.seg_q,
      a.seg_k, a.bound, a.cu_k, a.seed, (T*)a.out, a.lse, a.Tq, a.Tk, a.H, a.Hkv, a.n_seqs,
      a.scale, a.causal, a.dropout, a.thresh, a.inv_keep);
  return (int)cudaGetLastError();
}

// The route is the dtype's: fp32 -> the CUDA-core kernel, bf16/fp16 -> the
// tensor-core kernel. No fallback between them.
template <typename T, int D>
static int launch_vflash_fwd(const VFwdArgs& a, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value)
    return launch_vflash_fwd_cc<T, D>(a, s);
  else
    return launch_vflash_fwd_tc<T, D>(a, s);
}

extern "C" int vflash_fwd(const void* q, const void* k, const void* v, long long q_stride,
                          long long k_stride, long long v_stride, const int* seg_q,
                          const int* seg_k, const int* bound, const int* cu_k, const int* seed,
                          void* out, float* lse, int Tq, int Tk, int H, int Hkv, int D,
                          int n_seqs, float scale, int causal, int dropout, unsigned int thresh,
                          float inv_keep, int dtype, void* stream) {
  if (bad_shape(Tq, Tk, H, Hkv, n_seqs)) return (int)cudaErrorInvalidValue;
  // the tensor-core kernel copies each token's head in 16-byte pieces
  if (dtype != kF32 && (!aligned16({q, k, v, out}) || q_stride % 8 || k_stride % 8 ||
                        v_stride % 8))
    return (int)cudaErrorMisalignedAddress;
  const VFwdArgs a{q,   k,   v,  q_stride, k_stride, v_stride, seg_q,  seg_k,
                   bound, cu_k, seed, out, lse,  Tq,  Tk, H, Hkv, n_seqs, scale,
                   causal, dropout, thresh, inv_keep};
  cudaStream_t s = (cudaStream_t)stream;
  DISPATCH_DTYPE(dtype, T, {
    if (D == 64) return launch_vflash_fwd<T, 64>(a, s);
    if (D == 128) return launch_vflash_fwd<T, 128>(a, s);
    return (int)cudaErrorInvalidValue;
  })
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
