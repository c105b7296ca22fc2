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
// What this simple design does about it: each 256-thread block owns a
// 64x64 output tile of BOTH planes and each thread a 4x4 sub-tile of each,
// so the two accumulators (32 values) live in registers across the whole
// K loop, as the Pallas kernel keeps them in VMEM. Each 16-deep slice of
// the four input planes is staged once in shared memory and every value
// loaded from it feeds four FMAs. Products are plain f32 (or f64) FMAs:
// no TF32, the twin of Precision.HIGHEST. The reduction order is fixed
// (k ascending, no split-K, no atomics), so repeated runs are bit-identical.
// Row tiles run on gridDim.x (up to 2^31-1 blocks): the batched DFTs flatten
// every leading axis into B, which reaches ~3.4e5 rows at 32k, past
// gridDim.y's 65535. Offsets into z and out are 64-bit.
// wgmma, TMA and a 3xTF32 scheme are left for a later, faster version.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 64;        // rows of z per block
constexpr int kBN = 64;        // columns of w per block
constexpr int kBK = 16;        // contraction depth per shared-memory slice
constexpr int kTX = 16;        // threads along N
constexpr int kTY = 16;        // threads along B
constexpr int kThreads = kTX * kTY;
constexpr int kRM = kBM / kTY; // output rows per thread
constexpr int kRN = kBN / kTX; // output columns per thread
constexpr int kPad = 4;        // keeps the transposed z stores off one bank

template <typename T>
__global__ void __launch_bounds__(kThreads)
cmatmul_kernel(const T* __restrict__ zr, const T* __restrict__ zi,
               const T* __restrict__ wr, const T* __restrict__ wi,
               T* __restrict__ outr, T* __restrict__ outi,
               int64_t B, int K, int N) {
  __shared__ T zr_s[kBK][kBM + kPad];
  __shared__ T zi_s[kBK][kBM + kPad];
  __shared__ T wr_s[kBK][kBN];
  __shared__ T wi_s[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int col0 = blockIdx.y * kBN;

  T accr[kRM][kRN];
  T acci[kRM][kRN];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
      accr[i][j] = T(0);
      acci[i][j] = T(0);
    }
  }

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // z slice [kBM, kBK], stored transposed: consecutive threads read
    // consecutive k of one row.
#pragma unroll
    for (int r = 0; r < (kBM * kBK) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int m = e / kBK;
      const int k = e % kBK;
      const int64_t row = row0 + m;
      const int kk = k0 + k;
      T vr = T(0), vi = T(0);
      if (row < B && kk < K) {
        const int64_t off = row * K + kk;
        vr = zr[off];
        vi = zi[off];
      }
      zr_s[k][m] = vr;
      zi_s[k][m] = vi;
    }
    // w slice [kBK, kBN]: consecutive threads read consecutive columns.
#pragma unroll
    for (int r = 0; r < (kBK * kBN) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int k = e / kBN;
      const int n = e % kBN;
      const int kk = k0 + k;
      const int col = col0 + n;
      T vr = T(0), vi = T(0);
      if (kk < K && col < N) {
        const int64_t off = static_cast<int64_t>(kk) * N + col;
        vr = wr[off];
        vi = wi[off];
      }
      wr_s[k][n] = vr;
      wi_s[k][n] = vi;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      T a_r[kRM], a_i[kRM], b_r[kRN], b_i[kRN];
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        a_r[i] = zr_s[k][ty + kTY * i];
        a_i[i] = zi_s[k][ty + kTY * i];
      }
#pragma unroll
      for (int j = 0; j < kRN; ++j) {
        b_r[j] = wr_s[k][tx + kTX * j];
        b_i[j] = wi_s[k][tx + kTX * j];
      }
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
#pragma unroll
        for (int j = 0; j < kRN; ++j) {
          accr[i][j] = fma(a_r[i], b_r[j], accr[i][j]);
          accr[i][j] = fma(-a_i[i], b_i[j], accr[i][j]);
          acci[i][j] = fma(a_r[i], b_i[j], acci[i][j]);
          acci[i][j] = fma(a_i[i], b_r[j], acci[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // Each thread's columns tx + 16*j: 16 consecutive threads write one
  // 16-element run of a row.
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int64_t row = row0 + ty + kTY * i;
    if (row >= B) continue;
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
      const int col = col0 + tx + kTX * j;
      if (col < N) {
        const int64_t off = row * N + col;
        outr[off] = accr[i][j];
        outi[off] = acci[i][j];
      }
    }
  }
}

template <typename T>
int launch(const void* zr, const void* zi, const void* wr, const void* wi,
           void* outr, void* outi, long long B, int K, int N, void* stream) {
  if (B <= 0 || N <= 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long row_tiles = (B + kBM - 1) / kBM;
  if (row_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(row_tiles),
                  static_cast<unsigned>((N + kBN - 1) / kBN));
  cmatmul_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(zr), static_cast<const T*>(zi),
      static_cast<const T*>(wr), static_cast<const T*>(wi),
      static_cast<T*>(outr), static_cast<T*>(outi),
      static_cast<int64_t>(B), K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Each returns cudaGetLastError()
// after the launch (0 on success). The kernel runs on `stream`, does not
// synchronise, and allocates nothing: the caller owns every buffer.
extern "C" int swiftly_cmatmul_f32(const void* zr, const void* zi,
                                   const void* wr, const void* wi,
                                   void* outr, void* outi,
                                   long long B, int K, int N, void* stream) {
  return launch<float>(zr, zi, wr, wi, outr, outi, B, K, N, stream);
}

extern "C" int swiftly_cmatmul_f64(const void* zr, const void* zi,
                                   const void* wr, const void* wi,
                                   void* outr, void* outi,
                                   long long B, int K, int N, void* stream) {
  return launch<double>(zr, zi, wr, wi, outr, outi, B, K, N, stream);
}

extern "C" const char* swiftly_cmatmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
