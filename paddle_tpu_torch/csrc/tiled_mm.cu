// Row-tiled bf16 matmul probe for Hopper (sm_90a).
//
// Replaces: tools/conv_calibration.py::pallas_mm (Pallas body mk): the
// "naively tiled" matmul that the conv-calibration tool times beside the
// conv and the library GEMM at each ResNet-50 conv's implicit-GEMM shape:
// bf16 A [M, K] times bf16 B [K, N] -> bf16 C [M, N], accumulated in fp32
// and rounded once.
//
// What bounds it on the H100: operations, 2 * M * K * N FLOPs over the
// 989 TFLOP/s bf16 tensor-core peak (at the probe's shapes the bytes, each
// of A, B and C moved once, take less time). This first version multiplies
// on the CUDA cores in fp32 (67 TFLOP/s peak), so it sits far from that
// bound; mma/wgmma is later work, as the probe's purpose is to time a
// hand-tiled kernel beside the library.
//
// Design: one block of 256 threads per 128 x 128 tile of C, looping over K
// in steps of 16 (the loop takes the place of the TPU's whole-K block).
// Each step stages A^T and B in fp32 shared memory; thread (ty, tx) owns
// rows ty + 16 i and columns tx + 16 j (i, j < 8), so its shared reads and
// C writes are conflict-free and coalesced across a warp. Any M, K and N
// are accepted: the tails are masked (the TPU version wanted M a multiple
// of its 512-row tile and K, N padded to 128).
#include "common.cuh"

constexpr int kMmBM = 128;
constexpr int kMmBN = 128;
constexpr int kMmBK = 16;
constexpr int kMmT = 8;  // rows and columns per thread
constexpr int kMmThreads = 256;

__global__ void __launch_bounds__(kMmThreads)
tiled_mm_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                __nv_bfloat16* __restrict__ c, int M, int K, int N) {
  __shared__ float a_s[kMmBK][kMmBM + 4];  // A^T tile
  __shared__ float b_s[kMmBK][kMmBN + 4];
  const long long m0 = (long long)blockIdx.x * kMmBM;
  const int n0 = blockIdx.y * kMmBN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  float acc[kMmT][kMmT];
#pragma unroll
  for (int i = 0; i < kMmT; ++i)
#pragma unroll
    for (int j = 0; j < kMmT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kMmBK) {
    for (int i = tid; i < kMmBM * kMmBK; i += kMmThreads) {
      const int r = i / kMmBK, kk = i - r * kMmBK;
      const long long row = m0 + r;
      const int col = k0 + kk;
      a_s[kk][r] = (row < M && col < K) ? __bfloat162float(a[row * K + col]) : 0.f;
    }
    for (int i = tid; i < kMmBK * kMmBN; i += kMmThreads) {
      const int kk = i / kMmBN, cc = i - kk * kMmBN;
      const int row = k0 + kk, col = n0 + cc;
      b_s[kk][cc] = (row < K && col < N) ? __bfloat162float(b[(long long)row * N + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kMmBK; ++kk) {
      float av[kMmT], bv[kMmT];
#pragma unroll
      for (int i = 0; i < kMmT; ++i) av[i] = a_s[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kMmT; ++j) bv[j] = b_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kMmT; ++i)
#pragma unroll
        for (int j = 0; j < kMmT; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMmT; ++i) {
    const long long row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < kMmT; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) c[row * N + col] = __float2bfloat16_rn(acc[i][j]);
    }
  }
}

// a [M, K], b [K, N], c [M, N]: contiguous bf16 on the device.
extern "C" int tiled_mm(const void* a, const void* b, void* c, int M, int K, int N,
                        void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kMmBM - 1) / kMmBM, (N + kMmBN - 1) / kMmBN);
  tiled_mm_kernel<<<grid, kMmThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (__nv_bfloat16*)c, M, K, N);
  return (int)cudaGetLastError();
}
