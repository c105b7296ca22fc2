// Planar complex matrix product for Hopper (sm_90a): kernel B3 of the port.
//
//   (zr + i*zi) @ (wr + i*wi)  ->  (zr@wr - zi@wi,  zr@wi + zi@wr)
//   z: [B, K] row-major planes, w: [K, N] row-major planes, out: [B, N].
//
// Replaces: swiftly_tpu/ops/pallas_kernels.py:102 `cmatmul_pallas` (body
// `_kernel` :68), the Pallas TPU kernel under every planar direct centred
// DFT with n <= 1024 (swiftly_tpu/ops/planar_backend.py:217-236). Here it
// serves swiftly_tpu_torch/ops/planar_backend.py `_fft_direct_centred`.
//
// What bounds it on an H100: the work is 8*B*K*N flops (four real
// products, one multiply-add = 2 flops) against 67 TFLOP/s of f32 FMA
// outside the tensor cores, while the bytes are one read of each plane
// and one write of each output, 4*(2BK + 2KN + 2BN) at f32. For the
// DFT shapes K = N = n the intensity is ~n/2 flop/byte, above the card's
// f32 ridge (67e12 / 3.35e12 = 20 flop/byte) for every n >= 64, so at
// the round trip's n = 256 and 512 the kernel is bound by operations.
//
// The numbers are fixed: every output element is the same chain of IEEE
// FMAs, k ascending from 0 with f32 (or f64) accumulators,
//   accr = fma(zr, wr, accr); accr = fma(-zi, wi, accr);
//   acci = fma(zr, wi, acci); acci = fma(zi, wr, acci);
// with k padded by zeros to a multiple of 16. No TF32 (the twin of
// Precision.HIGHEST), no split-K, no atomics: the bits do not depend on
// the tile variant, and repeated runs are bit-identical.
//
// What held the first design back (64x64 tiles of both planes, 256
// threads, 4x4 outputs a thread, one synchronous 16-deep slice at a time):
// at the streamed and visibility shapes too few blocks for 132 SMs (56 at
// (448, 512, 512), 2.9-5.9x its bound), and everywhere loads that did not
// overlap the arithmetic and one scalar shared load per 4 FMAs (2.0x its
// bound at the fused shapes; chip_smoke.py phase 7 on an H100 80GB HBM3 at
// 700 W: 5.374 ms at (340992, 256, 256), 0.0821 ms at (448, 512, 512)).
// This design:
// - two tile variants (`launch` below), chosen per shape by
//   ops/kernels.py `_cmatmul_config`: 128x128 outputs a block, 8x8 a thread
//   (256 FMAs per 32 values read from shared memory), where the grid holds
//   several waves of blocks; 32x64, 4x4 a thread, where the large tile
//   would leave SMs idle;
// - a ring of kStages 16-deep slices in dynamic shared memory, filled by
//   cp.async while the threads compute on an earlier slice, one barrier a
//   slice;
// - z stored transposed ([k][row]) and w as it lies ([k][col]), so a
//   thread reads its rows and its columns of one k as 16-byte vectors
//   (broadcasts for z, side by side for w), with no bank conflicts; the
//   transposed z slice is written by 4-byte cp.async in 4-row x 8-k warp
//   patches, conflict-free too;
// - the column tiles of one row tile are neighbouring blocks, so z is read
//   from memory once and its other reads hit L2.
// What bounds it now: the FMA issue rate, at ~1.4x the bound at the fused
// shapes (the main loop is mostly FMAs; the rest is the slice copies'
// address arithmetic and the shared loads), and at the visibility shapes
// latency: 16 outputs a thread, 512 deep, over one warp a scheduler, on
// 112 or 128 of the 132 SMs at (448 | 512, 512, 512), with no split-K to
// add more.
// Tiles run on gridDim.x (up to 2^31-1 blocks): the batched DFTs flatten
// every leading axis into B, which reaches ~3.4e5 rows at 32k, past
// gridDim.y's 65535. Offsets into z and out are 64-bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBK = 16;   // contraction depth of one pipeline slice
constexpr int kPadA = 4;  // pads a k-row of the transposed z slice: the
                          // row stride stays 16-byte aligned, and at BM =
                          // 128 and 32 (a stride of 4 banks mod 32) the
                          // 4-row x 8-k write patch of a warp meets 32
                          // distinct banks

// 16 bytes of T read from or written as one vector
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  __device__ static void get(const float* s, float* d) {
    const float4 v = *reinterpret_cast<const float4*>(s);
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  __device__ static void put(float* g, const float* s) {
    *reinterpret_cast<float4*>(g) = make_float4(s[0], s[1], s[2], s[3]);
  }
};
template <>
struct Vec<double> {
  __device__ static void get(const double* s, double* d) {
    const double2 v = *reinterpret_cast<const double2*>(s);
    d[0] = v.x;
    d[1] = v.y;
  }
  __device__ static void put(double* g, const double* s) {
    *reinterpret_cast<double2*>(g) = make_double2(s[0], s[1]);
  }
};

// cp.async of kBytes (4, 8 or 16) from global to shared memory; when
// `valid` is false nothing is read and the destination is zero-filled
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int src_bytes = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(kBytes), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// One tile variant: BM x BN outputs of both planes a block, RM x RN a
// thread, kStages slices in flight. A thread's rows are runs of kVec
// consecutive rows, BM / (RM / kVec) apart, and its columns likewise: each
// run is one 16-byte read of a slice (and one 16-byte store), and the runs
// of neighbouring threads lie side by side.
template <typename T, int BM, int BN, int RM, int RN, int kStages>
struct Tile {
  static constexpr int kVec = 16 / sizeof(T);  // T in 16 bytes
  static constexpr int kTY = BM / RM;  // threads along B
  static constexpr int kTX = BN / RN;  // threads along N
  static constexpr int kThreads = kTX * kTY;
  static constexpr int kRowGap = BM / (RM / kVec);
  static constexpr int kColGap = BN / (RN / kVec);
  static constexpr int kLdA = BM + kPadA;  // a k-row of the z slice
  static constexpr int kLdB = BN;          // a k-row of the w slice
  static constexpr int kPlaneA = kBK * kLdA;
  static constexpr int kPlaneB = kBK * kLdB;
  static constexpr int kStage = 2 * kPlaneA + 2 * kPlaneB;  // elements
  static constexpr size_t kSmemBytes = sizeof(T) * kStages * kStage;
  // z slice: warp patches of 4 rows x 8 k, two patches side by side along
  // k; a thread copies one k of the rows zm + r * kZStep
  static constexpr int kZCopies = BM * kBK / kThreads;
  static constexpr int kZStep = kThreads / 16;
  // w slice: a thread copies one 16-byte column run of the k-rows
  // wk + r * kWStep
  static constexpr int kWRuns = BN / kVec;
  static constexpr int kWCopies = kBK * kWRuns / kThreads;
  static constexpr int kWStep = kThreads / kWRuns;
  static_assert(kThreads % 64 == 0, "whole pairs of warps");
  static_assert(kBK == 16 && (BM * kBK) % kThreads == 0,
                "the z slice splits into whole warp patches");
  static_assert(kThreads % kWRuns == 0 && (kBK * kWRuns) % kThreads == 0 &&
                    (kBK * BN) % kThreads == 0,
                "the w slice splits evenly over the threads");
  static_assert(RM % kVec == 0 && RN % kVec == 0, "whole 16-byte runs");
};

template <typename T, int BM, int BN, int RM, int RN, int kStages>
__global__ void __launch_bounds__((BM / RM) * (BN / RN))
cmatmul_kernel(const T* __restrict__ zr, const T* __restrict__ zi,
               const T* __restrict__ wr, const T* __restrict__ wi,
               T* __restrict__ outr, T* __restrict__ outi, int64_t B, int K,
               int N, bool vec_w, bool vec_out) {
  using C = Tile<T, BM, BN, RM, RN, kStages>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x;
  const int tx = tid % C::kTX;
  const int ty = tid / C::kTX;
  // one block per output tile, the column tiles of a row tile side by
  // side, so that they read their z rows from L2 rather than memory
  const int col_tiles = (N + BN - 1) / BN;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x / col_tiles) * BM;
  const int col0 = static_cast<int>(blockIdx.x % col_tiles) * BN;
  const int slices = (K + kBK - 1) / kBK;

  // what this thread copies of every slice
  const int zk = (tid & 7) + 8 * ((tid >> 5) & 1);
  const int zm = ((tid & 31) >> 3) + 4 * (tid >> 6);
  const int64_t z_rows = B - row0 - zm;  // copy r is a row while r * kZStep < this
  const int64_t z_at = (row0 + zm) * K + zk;
  const int64_t z_step = static_cast<int64_t>(C::kZStep) * K;
  const int wn = (tid % C::kWRuns) * C::kVec;
  const int wk = tid / C::kWRuns;
  const bool w_col = col0 + wn < N;

  // Slice `s` into ring slot `slot`: z transposed, w as it lies, zeros
  // past B, K and N.
  auto load = [&](int slot, int s) {
    T* as_r = smem + slot * C::kStage;
    T* as_i = as_r + C::kPlaneA;
    T* bs_r = as_i + C::kPlaneA;
    T* bs_i = bs_r + C::kPlaneB;
    const int k0 = s * kBK;
    const bool z_k = k0 + zk < K;
#pragma unroll
    for (int r = 0; r < C::kZCopies; ++r) {
      const bool ok = z_k && r * C::kZStep < z_rows;
      const int64_t at = ok ? z_at + k0 + r * z_step : 0;
      const int to = zk * C::kLdA + zm + r * C::kZStep;
      cp_async<sizeof(T)>(as_r + to, zr + at, ok);
      cp_async<sizeof(T)>(as_i + to, zi + at, ok);
    }
    if (vec_w) {
#pragma unroll
      for (int r = 0; r < C::kWCopies; ++r) {
        const int k = wk + r * C::kWStep;
        const bool ok = w_col && k0 + k < K;
        const int64_t at = ok ? static_cast<int64_t>(k0 + k) * N + col0 + wn : 0;
        cp_async<16>(bs_r + k * C::kLdB + wn, wr + at, ok);
        cp_async<16>(bs_i + k * C::kLdB + wn, wi + at, ok);
      }
    } else {
#pragma unroll
      for (int r = 0; r < kBK * BN / C::kThreads; ++r) {
        const int e = tid + r * C::kThreads;
        const int k = e / BN;
        const int n = e % BN;
        const bool ok = k0 + k < K && col0 + n < N;
        const int64_t at = ok ? static_cast<int64_t>(k0 + k) * N + col0 + n : 0;
        cp_async<sizeof(T)>(bs_r + k * C::kLdB + n, wr + at, ok);
        cp_async<sizeof(T)>(bs_i + k * C::kLdB + n, wi + at, ok);
      }
    }
  };

  T accr[RM][RN];
  T acci[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      accr[i][j] = T(0);
      acci[i][j] = T(0);
    }
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slices) load(s, s);
    cp_async_commit();
  }

  for (int s = 0; s < slices; ++s) {
    cp_async_wait<kStages - 2>();  // slice s has landed
    __syncthreads();               // and every thread is done with s - 1
    const int next = s + kStages - 1;
    if (next < slices) load(next % kStages, next);
    cp_async_commit();

    const T* as_r = smem + (s % kStages) * C::kStage + ty * C::kVec;
    const T* as_i = as_r + C::kPlaneA;
    const T* bs_r = smem + (s % kStages) * C::kStage + 2 * C::kPlaneA +
                    tx * C::kVec;
    const T* bs_i = bs_r + C::kPlaneB;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      T a_r[RM], a_i[RM], b_r[RN], b_i[RN];
#pragma unroll
      for (int v = 0; v < RM; v += C::kVec) {
        const int at = k * C::kLdA + (v / C::kVec) * C::kRowGap;
        Vec<T>::get(as_r + at, a_r + v);
        Vec<T>::get(as_i + at, a_i + v);
      }
#pragma unroll
      for (int v = 0; v < RN; v += C::kVec) {
        const int at = k * C::kLdB + (v / C::kVec) * C::kColGap;
        Vec<T>::get(bs_r + at, b_r + v);
        Vec<T>::get(bs_i + at, b_i + v);
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          accr[i][j] = fma(a_r[i], b_r[j], accr[i][j]);
          accr[i][j] = fma(-a_i[i], b_i[j], accr[i][j]);
          acci[i][j] = fma(a_r[i], b_i[j], acci[i][j]);
          acci[i][j] = fma(a_i[i], b_r[j], acci[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy may outlive the block

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t row =
        row0 + (i / C::kVec) * C::kRowGap + ty * C::kVec + i % C::kVec;
    if (row >= B) continue;
    T* orow_r = outr + row * N;
    T* orow_i = outi + row * N;
#pragma unroll
    for (int v = 0; v < RN; v += C::kVec) {
      const int c = col0 + (v / C::kVec) * C::kColGap + tx * C::kVec;
      const T* run_r = accr[i] + v;
      const T* run_i = acci[i] + v;
      if (vec_out) {
        if (c < N) {
          Vec<T>::put(orow_r + c, run_r);
          Vec<T>::put(orow_i + c, run_i);
        }
      } else {
#pragma unroll
        for (int j = 0; j < C::kVec; ++j) {
          if (c + j < N) {
            orow_r[c + j] = run_r[j];
            orow_i[c + j] = run_i[j];
          }
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, int BM, int BN, int RM, int RN, int kStages>
int launch_tile(const void* zr, const void* zi, const void* wr,
                const void* wi, void* outr, void* outi, long long B, int K,
                int N, cudaStream_t stream) {
  using C = Tile<T, BM, BN, RM, RN, kStages>;
  auto kernel = cmatmul_kernel<T, BM, BN, RM, RN, kStages>;
  // above 48 KB, dynamic shared memory must be asked for, once per device
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64 || !configured[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(C::kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 0 && dev < 64) configured[dev] = true;
  }
  const long long tiles = ((B + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool fit = N % C::kVec == 0;
  const bool vec_w = fit && aligned16(wr) && aligned16(wi);
  const bool vec_out = fit && aligned16(outr) && aligned16(outi);
  kernel<<<static_cast<unsigned>(tiles), C::kThreads, C::kSmemBytes, stream>>>(
      static_cast<const T*>(zr), static_cast<const T*>(zi),
      static_cast<const T*>(wr), static_cast<const T*>(wi),
      static_cast<T*>(outr), static_cast<T*>(outi), static_cast<int64_t>(B),
      K, N, vec_w, vec_out);
  return static_cast<int>(cudaGetLastError());
}

// The tile variants, by id: ops/kernels.py `_CMATMUL_TILES` lists the same
// (BM, BN) per type under the same ids (a CPU test holds the two
// together). In f64 variant 0 takes 64 x 128 tiles, 4 x 8 a thread: 8 x 8
// doubles of both planes need more than 255 registers.
template <typename T>
int launch(const void* zr, const void* zi, const void* wr, const void* wi,
           void* outr, void* outi, long long B, int K, int N, int variant,
           void* stream) {
  if (B <= 0 || N <= 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr bool f32 = sizeof(T) == 4;
  constexpr int kStages = f32 ? 4 : 3;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      if constexpr (f32)
        return launch_tile<T, 128, 128, 8, 8, kStages>(
            zr, zi, wr, wi, outr, outi, B, K, N, s);
      else
        return launch_tile<T, 64, 128, 4, 8, kStages>(
            zr, zi, wr, wi, outr, outi, B, K, N, s);
    case 1:
      return launch_tile<T, 32, 64, 4, 4, kStages>(
          zr, zi, wr, wi, outr, outi, B, K, N, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. Each returns cudaGetLastError()
// after the launch (0 on success), or the error of asking for the shared
// memory. The kernel runs on `stream`, does not synchronise, and allocates
// nothing: the caller owns every buffer. `variant` picks the tile variant
// (ops/kernels.py `_cmatmul_config`); an unknown one is refused.
extern "C" int swiftly_cmatmul_f32(const void* zr, const void* zi,
                                   const void* wr, const void* wi,
                                   void* outr, void* outi, long long B, int K,
                                   int N, int variant, void* stream) {
  return launch<float>(zr, zi, wr, wi, outr, outi, B, K, N, variant, stream);
}

extern "C" int swiftly_cmatmul_f64(const void* zr, const void* zi,
                                   const void* wr, const void* wi,
                                   void* outr, void* outi, long long B, int K,
                                   int N, int variant, void* stream) {
  return launch<double>(zr, zi, wr, wi, outr, outi, B, K, N, variant, stream);
}

extern "C" const char* swiftly_cmatmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
