// RMSNorm forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/rms_norm.py::_rms_fwd (Pallas kernel
// _fwd_kernel): y = x * rsqrt(mean(x^2) + eps) * w per row, fp32 math,
// output in x's dtype.
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
