// Tiled bf16 matmul probe for Hopper (sm_90a), on the tensor cores.
//
// Replaces: tools/conv_calibration.py::pallas_mm (Pallas body mk): the
// "naively tiled" matmul that the conv-calibration tool times beside the
// conv and the library GEMM at each ResNet-50 conv's implicit-GEMM shape:
// bf16 A [M, K] times bf16 B [K, N] -> bf16 C [M, N], accumulated in fp32
// and rounded once. Any M, K and N are taken (the TPU version wanted M a
// multiple of its 512-row tile and K, N padded to 128).
//
// What bounds it on the H100: the larger of the bytes (A and B read once,
// C written once) over 3.35 TB/s and 2 * M * K * N FLOPs over the 989
// TFLOP/s bf16 tensor-core peak. At the probe's ResNet-50 shapes (batch
// 64): shape 2, [200704, 640] x [640, 128], is bound by bytes (0.0921 ms:
// 257 MB of A stream past the block once, B stays in L2); shape 17,
// [3136, 4608] x [4608, 512], by operations (0.0150 ms).
//
// What the design does about it: every product runs on the tensor cores
// (mma.sync m16n8k16 bf16, fp32 accumulation; flash_mma.cuh). Both
// operands are bf16, so the products are exact, summed in fp32 and rounded
// once, as tiled_mm_reference does: no split of the operands is needed. A
// block of 8 warps (2 x 4, each 64 x 32 of C) takes a 128 x 128 tile of C
// and steps over K by 64 in a 3-stage cp.async ring of padded bf16 tiles
// (A [128][64 + 8], B [64][128 + 8]: the pads make every ldmatrix
// conflict-free), so two K steps of copies are in flight while one is
// multiplied: that keeps the byte-bound shape 2 streaming. A is read with
// ldmatrix at frag_a, B (row-major [K, N]) with ldmatrix.trans at
// frag_b_kn. The epilogue stages C through shared memory as bf16, so each
// row is stored in coalesced 16-byte pieces. Smaller tiles (64 x 128, 128 x
// 64, 64 x 64) and a K step of 32 were slower at both shapes on the card.
//
// Split-K, where the tiles alone make fewer blocks than the card has SMs
// (shape 17: 100 tiles of 132 SMs): the wrapper's rule
// (ops/cuda/tiled_mm.py::_tile_config) picks the number of K ranges; block
// z of the grid's third axis sums its range into an fp32 partial
// [z, M, N], and tiled_mm_reduce_kernel adds the partials in the order z =
// 0, 1, ... and rounds once: deterministic, and still one fp32 sum rounded
// once.
//
// Alignment: 16-byte copies need K % 8 == 0 (A's rows), N % 8 == 0 (B's
// and C's rows) and 16-byte-aligned pointers. Where that fails (the
// ragged case (1000, 300, 200)), the C entry point takes the same kernel
// with element-wise loads into the same shared-memory layout and
// element-wise stores: a route fixed by the arguments, still on the tensor
// cores.
//
// Resources (ptxas -v for sm_90a), 105.0 KB of dynamic shared memory each:
//   tiled_mm_tc_kernel, one K range   122 registers (16-byte copies) / 128
//                                     (element copies), no spills
//   tiled_mm_tc_kernel, split K       128 registers, a 12-byte spill
// 256 threads of at most 128 registers, and twice the shared memory, fit
// two blocks per SM.
#include "flash_mma.cuh"

using bf16 = __nv_bfloat16;

// The tile: BM x BN of C per block, K steps of BK in a ring of STAGES, 2 x 4
// warps of WM x WN. Rows of the shared-memory tiles are padded by 8
// elements (16 bytes), so the 8 rows of an ldmatrix fall in distinct bank
// groups.
struct Mm {
  static constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3;
  static constexpr int kWarpsN = 4, kThreads = 32 * 2 * kWarpsN;
  static constexpr int WM = BM / 2, WN = BN / kWarpsN;  // one warp's C tile
  static constexpr int MT = WM / 16, NT = WN / 8;       // its mma tiles
  static constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 8;
  static constexpr int kStage = BM * LDA + BK * LDB;  // elements of one ring stage
  static constexpr size_t kSmem = sizeof(bf16) * STAGES * kStage;
  static_assert(STAGES * kStage >= BM * LDC, "the ring holds the bf16 C tile");
};

// 8 elements of a row from src into 16 bytes at dst, those at or past n
// (the row's valid length from src; may be <= 0) zero; no alignment needed
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src, long long n) {
  const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = 2 * i < n ? s[2 * i] : 0u;
    const uint32_t hi = 2 * i + 1 < n ? s[2 * i + 1] : 0u;
    w[i] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// K step k0 of A (rows m0.., row stride K) and B (cols n0..) into one ring
// stage; rows past M, columns past N and K indices at or past k_end are
// zero-filled
template <bool ALIGNED>
__device__ __forceinline__ void mm_load_stage(bf16* a_s, bf16* b_s, const bf16* __restrict__ a,
                                              const bf16* __restrict__ b, long long m0, int n0,
                                              int k0, int k_end, int M, int K, int N, int tid) {
  constexpr int ACH = Mm::BK / 8, BCH = Mm::BN / 8;  // 16-byte chunks per row
  constexpr int T = Mm::kThreads;
  static_assert(Mm::BM * ACH % T == 0 && Mm::BK * BCH % T == 0, "whole chunks per thread");
#pragma unroll
  for (int n = 0; n < Mm::BM * ACH / T; ++n) {
    const int i = tid + n * T;
    const int r = i / ACH, c = (i - r * ACH) * 8;
    const long long row = m0 + r;
    const int col = k0 + c;
    bf16* dst = a_s + r * Mm::LDA + c;
    if constexpr (ALIGNED) {
      const bool ok = row < M && col < k_end;
      cp_async16(dst, ok ? a + row * K + col : a, ok);
    } else {
      copy8(dst, a + row * K + col, row < M ? k_end - col : 0);
    }
  }
#pragma unroll
  for (int n = 0; n < Mm::BK * BCH / T; ++n) {
    const int i = tid + n * T;
    const int r = i / BCH, c = (i - r * BCH) * 8;
    const int row = k0 + r, col = n0 + c;
    bf16* dst = b_s + r * Mm::LDB + c;
    if constexpr (ALIGNED) {
      const bool ok = row < k_end && col < N;
      cp_async16(dst, ok ? b + (long long)row * N + col : b, ok);
    } else {
      copy8(dst, b + (long long)row * N + col, row < k_end ? N - col : 0);
    }
  }
}

// One block per BM x BN tile of C: c [M, N] = bf16(a [M, K] @ b [K, N]);
// or, with SPLIT, per tile and K range blockIdx.z (k_split elements, a
// multiple of BK), part [z, M, N] = the fp32 sum over that range. SPLIT is
// a template argument so that the unsplit kernel keeps its registers.
template <bool ALIGNED, bool SPLIT>
__global__ void __launch_bounds__(Mm::kThreads, 2)
tiled_mm_tc_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                   bf16* __restrict__ c, float* __restrict__ part, int M, int K, int N,
                   int k_split) {
  constexpr int BM = Mm::BM, BN = Mm::BN, BK = Mm::BK, S = Mm::STAGES;
  constexpr int MT = Mm::MT, NT = Mm::NT, T = Mm::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);

  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int k_begin = SPLIT ? blockIdx.z * k_split : 0;
  const int k_end = SPLIT ? min(K, k_begin + k_split) : K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp / Mm::kWarpsN) * Mm::WM, wn = (warp % Mm::kWarpsN) * Mm::WN;
  const int n_steps = (k_end - k_begin + BK - 1) / BK;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < n_steps) {
      bf16* a_s = sm + st * Mm::kStage;
      mm_load_stage<ALIGNED>(a_s, a_s + BM * Mm::LDA, a, b, m0, n0, k_begin + st * BK, k_end,
                             M, K, N, tid);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < n_steps; ++kt) {
    cp_async_wait<S - 2>();  // step kt has landed
    __syncthreads();         // ... for every thread; step kt - 1 is consumed
    const int nk = kt + S - 1;
    if (nk < n_steps) {
      bf16* a_s = sm + (nk % S) * Mm::kStage;
      mm_load_stage<ALIGNED>(a_s, a_s + BM * Mm::LDA, a, b, m0, n0, k_begin + nk * BK, k_end,
                             M, K, N, tid);
    }
    cp_async_commit();
    const bf16* a_s = sm + (kt % S) * Mm::kStage;
    const bf16* b_s = a_s + BM * Mm::LDA;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) ldsm_x4(af[i], frag_a<Mm::LDA>(a_s, wm + i * 16, ks * 16, lane));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bfr[4];
        ldsm_x4_trans(bfr, frag_b_kn<Mm::LDB>(b_s, ks * 16, wn + np * 16, lane));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma16816<bf16>(acc[i][2 * np], af[i], bfr[0], bfr[1]);
          mma16816<bf16>(acc[i][2 * np + 1], af[i], bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  // accumulators: (row g / g + 8, cols 2t, 2t + 1) of each mma tile
  const int g = lane >> 2, t4 = lane & 3;

  if constexpr (SPLIT) {  // an fp32 partial of this K range, straight from registers
    float* pz = part + (long long)blockIdx.z * M * N;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = m0 + wm + i * 16 + g + 8 * h;
        if (row >= M) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = n0 + wn + j * 8 + 2 * t4;
          float* dst = pz + row * N + col;
          if constexpr (ALIGNED) {
            if (col < N)
              *reinterpret_cast<float2*>(dst) = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          } else {
            if (col < N) dst[0] = acc[i][j][2 * h];
            if (col + 1 < N) dst[1] = acc[i][j][2 * h + 1];
          }
        }
      }
    return;
  }

  __syncthreads();  // the ring is free: it becomes the bf16 C tile
  bf16* c_s = sm;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      bf16* p = c_s + (wm + i * 16 + g) * Mm::LDC + wn + j * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(p) = pack2<bf16>(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<uint32_t*>(p + 8 * Mm::LDC) = pack2<bf16>(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
  constexpr int CCH = BN / 8;
  static_assert(BM * CCH % T == 0, "whole chunks per thread");
#pragma unroll
  for (int n = 0; n < BM * CCH / T; ++n) {
    const int i = tid + n * T;
    const int r = i / CCH, cc = (i - r * CCH) * 8;
    const long long row = m0 + r;
    const int col = n0 + cc;
    if (row >= M) continue;
    const bf16* src = c_s + r * Mm::LDC + cc;
    if constexpr (ALIGNED) {
      if (col < N) *reinterpret_cast<uint4*>(c + row * N + col) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (col + e < N) c[row * N + col + e] = src[e];
    }
  }
}

// c[i] = bf16(sum over z = 0, 1, ... of part[z, i]), in that order
__global__ void __launch_bounds__(256)
tiled_mm_reduce_kernel(const float* __restrict__ part, bf16* __restrict__ c, long long MN,
                       int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < MN;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[z * MN + i];
    c[i] = __float2bfloat16_rn(s);
  }
}

template <bool ALIGNED, bool SPLIT>
static int launch_tiled_mm_tc(const void* a, const void* b, void* c, float* part, int M, int K,
                              int N, int k_split, int z, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(tiled_mm_tc_kernel<ALIGNED, SPLIT>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)Mm::kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + Mm::BM - 1) / Mm::BM, (N + Mm::BN - 1) / Mm::BN, z);
  tiled_mm_tc_kernel<ALIGNED, SPLIT><<<grid, Mm::kThreads, Mm::kSmem, s>>>(
      (const bf16*)a, (const bf16*)b, (bf16*)c, part, M, K, N, k_split);
  return (int)cudaGetLastError();
}

template <bool ALIGNED>
static int launch_tiled_mm(const void* a, const void* b, void* c, float* part, int M, int K,
                           int N, int splits, cudaStream_t s) {
  // K ranges of whole BK steps; rounding may leave fewer than `splits`
  const int steps = (K + Mm::BK - 1) / Mm::BK;
  const int k_split = (steps + splits - 1) / splits * Mm::BK;
  const int z = (K + k_split - 1) / k_split;
  if (z == 1) return launch_tiled_mm_tc<ALIGNED, false>(a, b, c, part, M, K, N, K, 1, s);
  if (part == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e =
      (cudaError_t)launch_tiled_mm_tc<ALIGNED, true>(a, b, c, part, M, K, N, k_split, z, s);
  if (e != cudaSuccess) return (int)e;
  const long long mn = (long long)M * N;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  tiled_mm_reduce_kernel<<<blocks, 256, 0, s>>>(part, (bf16*)c, mn, z);
  return (int)cudaGetLastError();
}

// a [M, K], b [K, N], c [M, N]: contiguous bf16 on the device. splits: the
// number of K ranges (ops/cuda/tiled_mm.py::_tile_config); with more than
// one, part is an fp32 workspace of splits * M * N. The copy route is the
// arguments': 16-byte cp.async where every row is 16-byte aligned, element
// copies elsewhere.
extern "C" int tiled_mm(const void* a, const void* b, void* c, float* part, int M, int K, int N,
                        int splits, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (K % 8 == 0 && N % 8 == 0 && aligned16({a, b, c}))
    return launch_tiled_mm<true>(a, b, c, part, M, K, N, splits, s);
  return launch_tiled_mm<false>(a, b, c, part, M, K, N, splits, s);
}
