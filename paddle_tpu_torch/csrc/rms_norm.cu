// RMSNorm forward and backward for Hopper (sm_90a).
//
// Forward. Replaces: paddle_tpu/ops/pallas/rms_norm.py::_rms_fwd (Pallas
// kernel _fwd_kernel): y = x * rsqrt(mean(x^2) + eps) * w per row, fp32
// math, output in x's dtype.
//
// What bounds it on the H100: bytes. Each element is read once and written
// once with ~3 FLOPs in between, far below the ~295 FLOP/byte ridge, so the
// floor is (2 * rows * hidden * itemsize + hidden * w_itemsize) / 3.35 TB/s.
// At decode (8 rows) the launch itself dominates.
//
// Design: one block per row. Pass 1 accumulates the fp32 sum of squares
// with strided coalesced loads and a warp-shuffle block reduction; pass 2
// re-reads the row (a 4 KB bf16 row at hidden 2048 is still in L1/L2) and
// writes the scaled result. The TPU kernel tiled rows in (8, 128) blocks
// for its vector unit; here a row maps to a block so that enough blocks
// are in flight to fill the 132 SMs at prefill sizes. Vectorised 16-byte
// access and several rows per block are left for a later tuning pass.
#include "common.cuh"

constexpr int kRmsThreads = 256;

template <typename T, typename W>
__global__ void __launch_bounds__(kRmsThreads)
rms_norm_fwd_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ y,
                    int hidden, float eps) {
  __shared__ float red[kRmsThreads / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * hidden;
  T* yr = y + row * hidden;

  float ss = 0.f;
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    ss = warp_sum(ss);
    if (lane == 0) red[0] = ss;
  }
  __syncthreads();
  const float invr = 1.0f / sqrtf(red[0] / (float)hidden + eps);

  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    yr[i] = from_f32<T>(to_f32(xr[i]) * invr * to_f32(w[i]));
  }
}

extern "C" int rms_norm_fwd(const void* x, const void* w, void* y, long long rows, int hidden,
                            float eps, int x_dtype, int w_dtype, void* stream) {
  if (rows <= 0 || hidden <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  DISPATCH_DTYPE(x_dtype, T,
    DISPATCH_DTYPE(w_dtype, W,
      rms_norm_fwd_kernel<T, W><<<(unsigned)rows, kRmsThreads, 0, s>>>(
          (const T*)x, (const W*)w, (T*)y, hidden, eps)))
  return (int)cudaGetLastError();
}

// Backward. Replaces: paddle_tpu/ops/pallas/rms_norm.py::_rms_bwd (Pallas
// kernel _bwd_kernel): with r = rsqrt(mean(x^2) + eps) recomputed from x,
//   dx = g*w*r - x * mean(g*w*x) * r^3   (x's dtype)
//   dw = sum over rows of g*x*r          (w's dtype)
// in fp32.
//
// What bounds it on the H100: bytes. x and g are read and dx written once
// (3 * rows * hidden * itemsize, plus w and dw), ~10 FLOPs per element.
//
// Design: the TPU kernel carries the dw sum in VMEM across a sequential
// row-block grid. Here blocks run in no order, so each block takes a run
// of `rows_per_block` rows, keeps its own fp32 dw partial in shared memory
// (thread t owns columns t, t + 256, ...), and writes it to a
// [blocks, hidden] fp32 workspace; a second kernel sums the workspace
// over blocks in block order, one thread per column. No atomics: the
// result is the same bit for bit on every run. Each row needs two sums
// (x^2 and g*w*x), reduced together through one warp-shuffle pass; the
// second pass over the row re-reads x and g from L1/L2.
constexpr int kRmsBwdThreads = 256;

template <typename T, typename W>
__global__ void __launch_bounds__(kRmsBwdThreads)
rms_norm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w, const T* __restrict__ g,
                    T* __restrict__ dx, float* __restrict__ dw_part, long long rows, int hidden,
                    int rows_per_block, float eps) {
  extern __shared__ float dw_s[];  // [hidden] this block's dw partial
  __shared__ float red[2][kRmsBwdThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < hidden; i += kRmsBwdThreads) dw_s[i] = 0.f;

  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  for (long long row = r0; row < r1; ++row) {
    const T* xr = x + row * hidden;
    const T* gr = g + row * hidden;
    float ss = 0.f, sgx = 0.f;
    for (int i = tid; i < hidden; i += kRmsBwdThreads) {
      const float xv = to_f32(xr[i]);
      ss += xv * xv;
      sgx += to_f32(gr[i]) * to_f32(w[i]) * xv;
    }
    ss = warp_sum(ss);
    sgx = warp_sum(sgx);
    if (lane == 0) {
      red[0][warp] = ss;
      red[1][warp] = sgx;
    }
    __syncthreads();
    ss = 0.f;
    sgx = 0.f;
#pragma unroll
    for (int j = 0; j < kRmsBwdThreads / 32; ++j) {
      ss += red[0][j];
      sgx += red[1][j];
    }
    __syncthreads();  // red is rewritten by the next row
    const float invr = 1.0f / sqrtf(ss / (float)hidden + eps);
    const float c = sgx / (float)hidden * invr * invr * invr;
    T* dxr = dx + row * hidden;
    for (int i = tid; i < hidden; i += kRmsBwdThreads) {
      const float xv = to_f32(xr[i]), gv = to_f32(gr[i]);
      dxr[i] = from_f32<T>(gv * to_f32(w[i]) * invr - xv * c);
      dw_s[i] += gv * xv * invr;
    }
  }
  float* part = dw_part + (long long)blockIdx.x * hidden;
  for (int i = tid; i < hidden; i += kRmsBwdThreads) part[i] = dw_s[i];
}

template <typename W>
__global__ void rms_norm_dw_reduce_kernel(const float* __restrict__ dw_part, W* __restrict__ dw,
                                          int blocks, int hidden) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= hidden) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += dw_part[(long long)b * hidden + col];
  dw[col] = from_f32<W>(s);
}

template <typename T, typename W>
static int launch_rms_bwd(const void* x, const void* w, const void* g, void* dx, void* dw,
                          float* dw_part, long long rows, int hidden, int rows_per_block,
                          float eps, cudaStream_t s) {
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  const size_t smem = sizeof(float) * (size_t)hidden;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rms_norm_bwd_kernel<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rms_norm_bwd_kernel<T, W><<<(unsigned)blocks, kRmsBwdThreads, smem, s>>>(
      (const T*)x, (const W*)w, (const T*)g, (T*)dx, dw_part, rows, hidden, rows_per_block, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rms_norm_dw_reduce_kernel<W><<<(hidden + 255) / 256, 256, 0, s>>>(dw_part, (W*)dw, (int)blocks,
                                                                    hidden);
  return (int)cudaGetLastError();
}

// dw_part: fp32 workspace of ceil(rows / rows_per_block) * hidden floats.
extern "C" int rms_norm_bwd(const void* x, const void* w, const void* g, void* dx, void* dw,
                            float* dw_part, long long rows, int hidden, int rows_per_block,
                            float eps, int x_dtype, int w_dtype, void* stream) {
  if (rows <= 0 || hidden <= 0 || rows_per_block <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  DISPATCH_DTYPE(x_dtype, T,
    DISPATCH_DTYPE(w_dtype, W,
      return launch_rms_bwd<T, W>(x, w, g, dx, dw, dw_part, rows, hidden, rows_per_block, eps,
                                  s)))
  return (int)cudaErrorInvalidValue;
}
