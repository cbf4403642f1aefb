// RMSNorm forward and backward for Hopper (sm_90a).
//
// Forward. Replaces: paddle_tpu/ops/pallas/rms_norm.py::_rms_fwd (Pallas
// kernel _fwd_kernel): y = x * rsqrt(mean(x^2) + eps) * w per row, fp32
// math, output in x's dtype, rounded once.
//
// Backward. Replaces: paddle_tpu/ops/pallas/rms_norm.py::_rms_bwd (Pallas
// kernel _bwd_kernel): with r = rsqrt(mean(x^2) + eps) recomputed from x,
//   dx = g*w*r - x * mean(g*w*x) * r^3   (x's dtype)
//   dw = sum over rows of g*x*r          (w's dtype)
// in fp32.
//
// What bounds both on the H100: bytes. Each element is read once and written
// once with ~3 (forward) or ~10 (backward) FLOPs in between, far below the
// ~295 FLOP/byte ridge: the floor is (2 * rows * hidden * itemsize + w) /
// 3.35 TB/s forward and (3 * rows * hidden * itemsize + 2 w) backward. At
// decode (8 rows) the launch itself dominates.
//
// What the design does about it: keep enough 16-byte accesses in flight and
// touch each byte once. Three variants, picked per call by the wrapper's
// _launch_config (ops/cuda/rms_norm.py) and checked against the shape here:
//
//   vector  (hidden a multiple of VEC = 16 / sizeof(T), every pointer on a
//           16-byte boundary, hidden <= 8 warps x 32 lanes x 4 x VEC): a row
//           belongs to `wpr` warps (1 up to 8, so a block of 8 warps takes
//           8 / wpr rows at a time), each lane holding NV (1, 2 or 4)
//           16-byte accesses of the row in registers from its sum to its
//           write, so x (and g) is read once. While a row is reduced and
//           written, the lane's loads of its next row are already in flight.
//           The row sums go through warp shuffles; with wpr > 1 the row's
//           warps add their sums through shared memory, one __syncthreads
//           per row (double-buffered). w is loaded into registers once per
//           thread and reused across the rows the block takes in a
//           grid-stride loop over a grid of a few blocks per SM.
//   chunked (the same alignment, hidden wider than registers hold): a block
//           per row, 16-byte accesses, two passes over the row (the second
//           re-reads it from L2).
//   scalar  (any other hidden or alignment): the chunked code with one
//           element per access.
//
// Backward dw without atomics, the same bits on every run. The vector
// variant keeps each thread's columns' fp32 dw partial in registers across
// the block's rows; at the end the block's row groups add theirs in group
// order in shared memory ([hidden] fp32, at most 32 KB), and the block
// writes one partial row of a [blocks, hidden] fp32 workspace (2.2 MB at
// hidden 2048 on 264 blocks). The chunked and scalar variants first compute
// each row's (r, mean(g*w*x) * r^3) (rms_norm_bwd_stats_kernel), then a grid
// of (column chunk, row run) blocks writes dx and one dw partial row per row
// run from registers (rms_norm_bwd_cols_kernel), so no hidden is too wide.
// rms_norm_dw_reduce_kernel then sums the partial rows in a fixed order
// (8 strided runs of rows, then the 8 run sums in order).
#include <algorithm>
#include <type_traits>

#include "common.cuh"

constexpr int kRmsThreads = 256;
constexpr int kRmsWarps = kRmsThreads / 32;
// chunked / scalar backward: accesses per thread in each row of its column chunk
constexpr int kRmsColVecs = 2;

// variant codes shared with ops/cuda/rms_norm.py (VARIANTS)
enum RmsVariant { kVector = 0, kChunked = 1, kScalar = 2 };

template <typename T> __device__ __forceinline__ float bits_to_f32(uint32_t b);
template <> __device__ __forceinline__ float bits_to_f32<__nv_bfloat16>(uint32_t b) {
  return __uint_as_float(b << 16);
}
template <> __device__ __forceinline__ float bits_to_f32<__half>(uint32_t b) {
  return __half2float(__ushort_as_half((unsigned short)b));
}

template <typename T> __device__ __forceinline__ uint32_t f32_to_bits(float v);
template <> __device__ __forceinline__ uint32_t f32_to_bits<__nv_bfloat16>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
template <> __device__ __forceinline__ uint32_t f32_to_bits<__half>(float v) {
  return __half_as_ushort(__float2half_rn(v));
}

// N elements of T as 32-bit words: one access of 8, 16 or 32 bytes. 16-bit
// values stay packed two to a register until they are used.
template <typename T, int N>
struct Pack {
  static constexpr int kBytes = N * (int)sizeof(T);
  static constexpr int kWords = kBytes / 4;
  static_assert(kBytes == 8 || kBytes == 16 || kBytes == 32, "8, 16 or 32 bytes");
  uint32_t u[kWords];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kBytes == 8) {
      const uint2 a = *reinterpret_cast<const uint2*>(p);
      u[0] = a.x;
      u[1] = a.y;
    } else {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i) {
        const uint4 a = reinterpret_cast<const uint4*>(p)[i];
        u[4 * i] = a.x;
        u[4 * i + 1] = a.y;
        u[4 * i + 2] = a.z;
        u[4 * i + 3] = a.w;
      }
    }
  }
  __device__ __forceinline__ void store(T* p) const {
    if constexpr (kBytes == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
    } else {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i)
        reinterpret_cast<uint4*>(p)[i] = make_uint4(u[4 * i], u[4 * i + 1], u[4 * i + 2],
                                                    u[4 * i + 3]);
    }
  }
  __device__ __forceinline__ float get(int i) const {
    if constexpr (sizeof(T) == 4) return __uint_as_float(u[i]);
    else return bits_to_f32<T>((u[i >> 1] >> ((i & 1) * 16)) & 0xffffu);
  }
  __device__ __forceinline__ void set(const float (&v)[N]) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      if constexpr (sizeof(T) == 4) u[i] = __float_as_uint(v[i]);
      else u[i] = f32_to_bits<T>(v[2 * i]) | (f32_to_bits<T>(v[2 * i + 1]) << 16);
    }
  }
};

// VEC consecutive elements as fp32: one 16-byte (or 8 / 32-byte for w) access,
// or one element where VEC is 1.
template <typename T, int VEC>
__device__ __forceinline__ void load_f32(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f32(*p);
  } else {
    Pack<T, VEC> a;
    a.load(p);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = a.get(i);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_f32(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    *p = from_f32<T>(v[0]);
  } else {
    Pack<T, VEC> a;
    a.set(v);
    a.store(p);
  }
}

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// ---------------------------------------------------------------------------
// Forward, vector variant. Thread (row group, slot) holds the accesses
// slot, slot + 32 wpr, ... (NV of them, those below hidden / VEC) of each of
// its rows; w's accesses at the same offsets stay in registers.
template <typename T, typename W, int NV>
__global__ void __launch_bounds__(kRmsThreads)
rms_norm_fwd_vec_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ y,
                        long long rows, int hidden, int wpr, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float red[2][kRmsWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = kRmsWarps / wpr, group = warp / wpr;
  const int stride = 32 * wpr, slot = (warp - group * wpr) * 32 + lane;
  const int nvec = hidden / VEC;

  Pack<W, VEC> wv[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (slot + j * stride < nvec) wv[j].load(w + (long long)(slot + j * stride) * VEC);

  // the row's accesses; the next row's (xn) are loaded before this row is
  // reduced and written, so a warp keeps two rows' loads in flight
  const auto load_row = [&](Pack<T, VEC>(&dst)[NV], long long r) {
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (slot + j * stride < nvec) dst[j].load(x + r * hidden + (long long)(slot + j * stride) * VEC);
  };
  const long long step = (long long)gridDim.x * groups;
  long long row = (long long)blockIdx.x * groups + group;
  Pack<T, VEC> xv[NV], xn[NV];
  if (row < rows) load_row(xv, row);
  int it = 0;
  for (long long base = (long long)blockIdx.x * groups; base < rows; base += step, row += step, ++it) {
    const bool active = row < rows;
    if (row + step < rows) load_row(xn, row + step);
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (active && slot + j * stride < nvec) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float f = xv[j].get(e);
          ss += f * f;
        }
      }
    }
    ss = warp_sum(ss);
    if (wpr > 1) {  // the row's warps add their sums in warp order
      if (lane == 0) red[it & 1][warp] = ss;
      __syncthreads();
      ss = 0.f;
      for (int k = 0; k < wpr; ++k) ss += red[it & 1][group * wpr + k];
    }
    if (active) {
      const float invr = 1.0f / sqrtf(ss / (float)hidden + eps);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int v = slot + j * stride;
        if (v < nvec) {
          float o[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) o[e] = xv[j].get(e) * invr * wv[j].get(e);
          Pack<T, VEC> p;
          p.set(o);
          p.store(y + row * hidden + (long long)v * VEC);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) xv[j] = xn[j];
  }
}

// Forward, chunked (VEC = 16 / sizeof(T)) and scalar (VEC = 1) variants: a
// block per row in a grid-stride loop, the sum of squares in one pass, y in
// a second that re-reads x (from L2).
template <typename T, typename W, int VEC>
__global__ void __launch_bounds__(kRmsThreads)
rms_norm_fwd_rows_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ y,
                         long long rows, int hidden, float eps) {
  __shared__ float red[2][kRmsWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nvec = hidden / VEC;
  int it = 0;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x, ++it) {
    const T* xr = x + row * hidden;
    float ss = 0.f;
    for (int v = threadIdx.x; v < nvec; v += kRmsThreads) {
      float f[VEC];
      load_f32<T, VEC>(xr + (long long)v * VEC, f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss += f[e] * f[e];
    }
    ss = warp_sum(ss);
    if (lane == 0) red[it & 1][warp] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int k = 0; k < kRmsWarps; ++k) ss += red[it & 1][k];
    const float invr = 1.0f / sqrtf(ss / (float)hidden + eps);
    T* yr = y + row * hidden;
    for (int v = threadIdx.x; v < nvec; v += kRmsThreads) {
      float f[VEC], wf[VEC];
      load_f32<T, VEC>(xr + (long long)v * VEC, f);
      load_f32<W, VEC>(w + (long long)v * VEC, wf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = f[e] * invr * wf[e];
      store_f32<T, VEC>(yr + (long long)v * VEC, f);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, vector variant: the forward's layout, with g beside x in
// registers, both row sums in one shuffle pass, and the dw partial of the
// thread's columns in registers. dw_part: [gridDim.x, hidden] fp32.
template <typename T, typename W, int NV>
__global__ void __launch_bounds__(kRmsThreads)
rms_norm_bwd_vec_kernel(const T* __restrict__ x, const W* __restrict__ w, const T* __restrict__ g,
                        T* __restrict__ dx, float* __restrict__ dw_part, long long rows,
                        int hidden, int wpr, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) float acc_s[];  // [hidden] the block's dw partial
  __shared__ float red[2][2][kRmsWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = kRmsWarps / wpr, group = warp / wpr;
  const int stride = 32 * wpr, slot = (warp - group * wpr) * 32 + lane;
  const int nvec = hidden / VEC;

  Pack<W, VEC> wv[NV];
  float dwp[NV][VEC];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (slot + j * stride < nvec) wv[j].load(w + (long long)(slot + j * stride) * VEC);
#pragma unroll
    for (int e = 0; e < VEC; ++e) dwp[j][e] = 0.f;
  }

  // x and g of the row; the next row's (xn, gn) are loaded before this row
  // is reduced and written
  const auto load_row = [&](Pack<T, VEC>(&xd)[NV], Pack<T, VEC>(&gd)[NV], long long r) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = slot + j * stride;
      if (v < nvec) {
        xd[j].load(x + r * hidden + (long long)v * VEC);
        gd[j].load(g + r * hidden + (long long)v * VEC);
      }
    }
  };
  const long long step = (long long)gridDim.x * groups;
  long long row = (long long)blockIdx.x * groups + group;
  Pack<T, VEC> xv[NV], gv[NV], xn[NV], gn[NV];
  if (row < rows) load_row(xv, gv, row);
  int it = 0;
  for (long long base = (long long)blockIdx.x * groups; base < rows; base += step, row += step, ++it) {
    const bool active = row < rows;
    if (row + step < rows) load_row(xn, gn, row + step);
    float ss = 0.f, sgx = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (active && slot + j * stride < nvec) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xf = xv[j].get(e);
          ss += xf * xf;
          sgx += gv[j].get(e) * wv[j].get(e) * xf;
        }
      }
    }
    warp_sum2(ss, sgx);
    if (wpr > 1) {  // the row's warps add their sums in warp order
      if (lane == 0) {
        red[it & 1][0][warp] = ss;
        red[it & 1][1][warp] = sgx;
      }
      __syncthreads();
      ss = 0.f;
      sgx = 0.f;
      for (int k = 0; k < wpr; ++k) {
        ss += red[it & 1][0][group * wpr + k];
        sgx += red[it & 1][1][group * wpr + k];
      }
    }
    if (active) {
      const float invr = 1.0f / sqrtf(ss / (float)hidden + eps);
      const float c = sgx / (float)hidden * invr * invr * invr;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int v = slot + j * stride;
        if (v < nvec) {
          float o[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float xf = xv[j].get(e), gf = gv[j].get(e);
            o[e] = gf * wv[j].get(e) * invr - xf * c;
            dwp[j][e] += gf * xf * invr;
          }
          Pack<T, VEC> p;
          p.set(o);
          p.store(dx + row * hidden + (long long)v * VEC);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      xv[j] = xn[j];
      gv[j] = gn[j];
    }
  }

  // the block's partial: its row groups add theirs in group order (every
  // group's threads cover every column once)
  for (int k = 0; k < groups; ++k) {
    if (group == k) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int v = slot + j * stride;
        if (v < nvec) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc_s[v * VEC + e] = k == 0 ? dwp[j][e] : acc_s[v * VEC + e] + dwp[j][e];
        }
      }
    }
    __syncthreads();
  }
  float* part = dw_part + (long long)blockIdx.x * hidden;
  for (int i = threadIdx.x * 4; i < hidden; i += kRmsThreads * 4)
    *reinterpret_cast<float4*>(part + i) = *reinterpret_cast<const float4*>(acc_s + i);
}

// Backward, chunked and scalar variants, first kernel: each row's
// (r, mean(g*w*x) * r^3) into stats [rows] (a block per row, grid-stride).
template <typename T, typename W, int VEC>
__global__ void __launch_bounds__(kRmsThreads)
rms_norm_bwd_stats_kernel(const T* __restrict__ x, const W* __restrict__ w,
                          const T* __restrict__ g, float2* __restrict__ stats, long long rows,
                          int hidden, float eps) {
  __shared__ float red[2][2][kRmsWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nvec = hidden / VEC;
  int it = 0;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x, ++it) {
    float ss = 0.f, sgx = 0.f;
    for (int v = threadIdx.x; v < nvec; v += kRmsThreads) {
      float xf[VEC], gf[VEC], wf[VEC];
      load_f32<T, VEC>(x + row * hidden + (long long)v * VEC, xf);
      load_f32<T, VEC>(g + row * hidden + (long long)v * VEC, gf);
      load_f32<W, VEC>(w + (long long)v * VEC, wf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ss += xf[e] * xf[e];
        sgx += gf[e] * wf[e] * xf[e];
      }
    }
    warp_sum2(ss, sgx);
    if (lane == 0) {
      red[it & 1][0][warp] = ss;
      red[it & 1][1][warp] = sgx;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      ss = 0.f;
      sgx = 0.f;
#pragma unroll
      for (int k = 0; k < kRmsWarps; ++k) {
        ss += red[it & 1][0][k];
        sgx += red[it & 1][1][k];
      }
      const float invr = 1.0f / sqrtf(ss / (float)hidden + eps);
      stats[row] = make_float2(invr, sgx / (float)hidden * invr * invr * invr);
    }
  }
}

// Backward, chunked and scalar variants, second kernel: block (x, y) takes
// kRmsColVecs accesses per thread of column chunk x over row run y, writes
// dx, and writes its dw partial from registers to row y of dw_part
// [gridDim.y, hidden].
template <typename T, typename W, int VEC>
__global__ void __launch_bounds__(kRmsThreads)
rms_norm_bwd_cols_kernel(const T* __restrict__ x, const W* __restrict__ w,
                         const T* __restrict__ g, const float2* __restrict__ stats,
                         T* __restrict__ dx, float* __restrict__ dw_part, long long rows,
                         int hidden) {
  const int nvec = hidden / VEC;
  const long long run = (rows + gridDim.y - 1) / gridDim.y;
  const long long r0 = (long long)blockIdx.y * run, r1 = min(rows, r0 + run);
  const int v0 = blockIdx.x * kRmsThreads * kRmsColVecs + threadIdx.x;
  float wf[kRmsColVecs][VEC], dwp[kRmsColVecs][VEC];
#pragma unroll
  for (int j = 0; j < kRmsColVecs; ++j) {
    const int v = v0 + j * kRmsThreads;
    if (v < nvec) load_f32<W, VEC>(w + (long long)v * VEC, wf[j]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) dwp[j][e] = 0.f;
  }
  for (long long row = r0; row < r1; ++row) {
    const float2 st = stats[row];
#pragma unroll
    for (int j = 0; j < kRmsColVecs; ++j) {
      const int v = v0 + j * kRmsThreads;
      if (v < nvec) {
        const long long o = row * hidden + (long long)v * VEC;
        float xf[VEC], gf[VEC];
        load_f32<T, VEC>(x + o, xf);
        load_f32<T, VEC>(g + o, gf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          dwp[j][e] += gf[e] * xf[e] * st.x;
          xf[e] = gf[e] * wf[j][e] * st.x - xf[e] * st.y;
        }
        store_f32<T, VEC>(dx + o, xf);
      }
    }
  }
  float* part = dw_part + (long long)blockIdx.y * hidden;
#pragma unroll
  for (int j = 0; j < kRmsColVecs; ++j) {
    const int v = v0 + j * kRmsThreads;
    if (v < nvec) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) part[(long long)v * VEC + e] = dwp[j][e];
    }
  }
}

// dw[col] = the partial rows' sum in a fixed order: warp k of the block adds
// rows k, k + 8, ... of its 32 columns, then lane-wise the 8 sums in order.
template <typename W>
__global__ void __launch_bounds__(kRmsThreads)
rms_norm_dw_reduce_kernel(const float* __restrict__ dw_part, W* __restrict__ dw, int parts,
                          int hidden) {
  __shared__ float red[kRmsWarps][32];
  const int lane = threadIdx.x & 31, k = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < hidden)
    for (int b = k; b < parts; b += kRmsWarps) s += dw_part[(long long)b * hidden + col];
  red[k][lane] = s;
  __syncthreads();
  if (k == 0 && col < hidden) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kRmsWarps; ++i) t += red[i][lane];
    dw[col] = from_f32<W>(t);
  }
}

// ---------------------------------------------------------------------------
// C entry points. x, w, y / g, dx, dw are contiguous; the variant, its
// accesses per thread (nv), warps per row (wpr) and grid come from the
// wrapper's _launch_config; a variant that does not fit the shape or the
// pointers' alignment returns cudaErrorInvalidValue and launches nothing.

static bool pow2_upto8(int n) { return n == 1 || n == 2 || n == 4 || n == 8; }

// Calls f(std::integral_constant<int, NV>) for NV in 1, 2, 4.
template <typename F>
static int with_nv(int nv, F&& f) {
  switch (nv) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 4: return f(std::integral_constant<int, 4>());
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
static bool vector_fits(int hidden, int nv, int wpr) {
  constexpr int VEC = 16 / sizeof(T);
  return hidden % VEC == 0 && pow2_upto8(wpr) && 32LL * wpr * nv * VEC >= hidden;
}

template <typename T, typename W>
static int launch_rms_fwd(const void* x, const void* w, void* y, long long rows, int hidden,
                          float eps, int variant, int nv, int wpr, int grid, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned = aligned16({x, w, y});
  switch (variant) {
    case kVector:
      if (!aligned || !vector_fits<T>(hidden, nv, wpr)) return (int)cudaErrorInvalidValue;
      return with_nv(nv, [&](auto n) {
        rms_norm_fwd_vec_kernel<T, W, decltype(n)::value><<<grid, kRmsThreads, 0, s>>>(
            (const T*)x, (const W*)w, (T*)y, rows, hidden, wpr, eps);
        return (int)cudaGetLastError();
      });
    case kChunked:
      if (!aligned || hidden % VEC) return (int)cudaErrorInvalidValue;
      rms_norm_fwd_rows_kernel<T, W, VEC><<<grid, kRmsThreads, 0, s>>>(
          (const T*)x, (const W*)w, (T*)y, rows, hidden, eps);
      return (int)cudaGetLastError();
    case kScalar:
      rms_norm_fwd_rows_kernel<T, W, 1><<<grid, kRmsThreads, 0, s>>>(
          (const T*)x, (const W*)w, (T*)y, rows, hidden, eps);
      return (int)cudaGetLastError();
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int rms_norm_fwd(const void* x, const void* w, void* y, long long rows, int hidden,
                            float eps, int variant, int nv, int wpr, int grid, int x_dtype,
                            int w_dtype, void* stream) {
  if (rows <= 0 || hidden <= 0 || grid <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  DISPATCH_DTYPE(x_dtype, T,
    DISPATCH_DTYPE(w_dtype, W,
      return launch_rms_fwd<T, W>(x, w, y, rows, hidden, eps, variant, nv, wpr, grid, s)))
  return (int)cudaErrorInvalidValue;
}

// work: fp32 workspace. Vector variant: dw_part [grid_x, hidden]. Chunked
// and scalar: stats [rows] (float2), then dw_part [grid_y, hidden].
template <typename T, typename W>
static int launch_rms_bwd(const void* x, const void* w, const void* g, void* dx, void* dw,
                          float* work, long long rows, int hidden, float eps, int variant,
                          int nv, int wpr, int grid_x, int grid_y, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned = aligned16({x, w, g, dx, work});
  int parts = 0;
  const float* dw_part = work;
  if (variant == kVector) {
    if (!aligned || !vector_fits<T>(hidden, nv, wpr) || grid_y != 1)
      return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * (size_t)hidden;  // at most 32 KB
    const int e = with_nv(nv, [&](auto n) {
      rms_norm_bwd_vec_kernel<T, W, decltype(n)::value><<<grid_x, kRmsThreads, smem, s>>>(
          (const T*)x, (const W*)w, (const T*)g, (T*)dx, work, rows, hidden, wpr, eps);
      return (int)cudaGetLastError();
    });
    if (e != 0) return e;
    parts = grid_x;
  } else if (variant == kChunked || variant == kScalar) {
    const int vec = variant == kChunked ? VEC : 1;
    const long long nvec = hidden / vec;
    if ((variant == kChunked && (!aligned || hidden % VEC)) ||
        (long long)grid_x * kRmsThreads * kRmsColVecs < nvec || grid_y <= 0 ||
        (long long)(grid_x - 1) * kRmsThreads * kRmsColVecs >= nvec)
      return (int)cudaErrorInvalidValue;
    float2* stats = reinterpret_cast<float2*>(work);
    float* part = work + 2 * rows;
    const int stat_grid = (int)std::min(rows, (long long)grid_x * grid_y);
    if (variant == kChunked) {
      rms_norm_bwd_stats_kernel<T, W, VEC><<<stat_grid, kRmsThreads, 0, s>>>(
          (const T*)x, (const W*)w, (const T*)g, stats, rows, hidden, eps);
      rms_norm_bwd_cols_kernel<T, W, VEC><<<dim3(grid_x, grid_y), kRmsThreads, 0, s>>>(
          (const T*)x, (const W*)w, (const T*)g, stats, (T*)dx, part, rows, hidden);
    } else {
      rms_norm_bwd_stats_kernel<T, W, 1><<<stat_grid, kRmsThreads, 0, s>>>(
          (const T*)x, (const W*)w, (const T*)g, stats, rows, hidden, eps);
      rms_norm_bwd_cols_kernel<T, W, 1><<<dim3(grid_x, grid_y), kRmsThreads, 0, s>>>(
          (const T*)x, (const W*)w, (const T*)g, stats, (T*)dx, part, rows, hidden);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    dw_part = part;
    parts = grid_y;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  rms_norm_dw_reduce_kernel<W><<<(hidden + 31) / 32, kRmsThreads, 0, s>>>(dw_part, (W*)dw, parts,
                                                                        hidden);
  return (int)cudaGetLastError();
}

extern "C" int rms_norm_bwd(const void* x, const void* w, const void* g, void* dx, void* dw,
                            float* work, long long rows, int hidden, float eps, int variant,
                            int nv, int wpr, int grid_x, int grid_y, int x_dtype, int w_dtype,
                            void* stream) {
  if (rows <= 0 || hidden <= 0 || grid_x <= 0 || grid_y <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  DISPATCH_DTYPE(x_dtype, T,
    DISPATCH_DTYPE(w_dtype, W,
      return launch_rms_bwd<T, W>(x, w, g, dx, dw, work, rows, hidden, eps, variant, nv, wpr,
                                  grid_x, grid_y, s)))
  return (int)cudaErrorInvalidValue;
}
