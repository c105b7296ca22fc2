// Strided, batched planar complex matrix product: the tile engine of
// kernels B1 (colpass.cu) and B2 (fold.cu).
//
//   out[b0, b1] (=|+= w (.)) sum_{r < nR} L[b0, b1, r] @ R[b0, b1, r]
//
// L is [M, K] and R is [K, N] per (b0, b1, r), complex, as two real
// planes (re, im) that share one set of element strides. Every axis has
// its own 64-bit stride (0 broadcasts), so the callers hand in views of
// their tensors as they lie in memory: interleaved (..., 2) planar
// layouts (stride 2), transposed phase matrices, a facet axis broadcast
// over subgrids, the accumulator's [F, B, yB] slab. The imaginary plane
// of L may be negated on load (`l_im_sign`, exact), which gives B2 its
// conjugated phase matrix without a copy.
//
// Design (the same as kernel B3, cmatmul.cu): a 256-thread block owns a
// 64x64 output tile of both planes; each thread a 4x4 sub-tile of each,
// the 32 sums in registers across the whole (r, k) loop. 16-deep slices
// of the four input planes are staged in shared memory; every value read
// from it feeds four FMAs. Each operand is loaded with its contiguous
// axis running across neighbouring threads (the axis whose stride is 1;
// for a stride-2 interleaved plane the two planes' loads share sectors).
// Products are plain IEEE FMAs in T (no TF32, no tensor cores). The sum
// runs r ascending, then k ascending, in one block: no split-K and no
// atomics, so reruns are bit-identical. The batch index runs on
// gridDim.x (up to 2^31-1), row tiles on gridDim.y and column tiles on
// gridDim.z (M, N < 4,194,240); offsets are 64-bit.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace swiftly {

constexpr int kBM = 64;         // output rows per block
constexpr int kBN = 64;         // output columns per block
constexpr int kBK = 16;         // contraction depth per shared-memory slice
constexpr int kTX = 16;         // threads along N
constexpr int kTY = 16;         // threads along M
constexpr int kThreads = kTX * kTY;
constexpr int kRM = kBM / kTY;  // output rows per thread
constexpr int kRN = kBN / kTX;  // output columns per thread
constexpr int kPad = 4;         // keeps column-wise shared stores off one bank

// A strided planar operand: element (b0, b1, r, row, col) of either
// plane lies at b0*s_b0 + b1*s_b1 + r*s_r + row*s_row + col*s_col.
template <typename T>
struct Operand {
  const T* re;
  const T* im;
  int64_t s_b0, s_b1, s_r, s_row, s_col;
};

// The output: element (b0, b1, row, col) at b0*s_b0 + b1*s_b1 +
// row*s_row + col*s_col. With `w`, the product is scaled by w[row*s_w]
// and added to what the output holds (read once, written once).
template <typename T>
struct Output {
  T* re;
  T* im;
  int64_t s_b0, s_b1, s_row, s_col;
  const T* w;
  int64_t s_w;
};

// kMinBlocks: resident blocks per SM asked of the register allocator
// (__launch_bounds__; 1 leaves it free). kLKFast: L's k axis runs across
// neighbouring threads (else its m axis); kRNFast: R's n axis does (else
// its k axis). Each thread loads the same kLoads positions of every
// slice, so their offsets are computed once, outside the contraction
// loop (a mapping chosen at run time, inside the kernel, held more
// registers and ran slower).
template <typename T, int kMinBlocks, bool kLKFast, bool kRNFast>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cgemm_kernel(Operand<T> L, Operand<T> R, Output<T> O, int M, int N, int K,
             int nR, int nb1, T l_im_sign) {
  constexpr int kLoads = (kBM * kBK) / kThreads;  // == (kBK * kBN) / kThreads
  __shared__ T lr_s[kBK][kBM + kPad];
  __shared__ T li_s[kBK][kBM + kPad];
  __shared__ T rr_s[kBK][kBN + kPad];
  __shared__ T ri_s[kBK][kBN + kPad];

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int64_t bz = blockIdx.x;
  const int64_t b0 = bz / nb1;
  const int64_t b1 = bz % nb1;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.z * kBN;

  // this thread's positions in the L slice [kBM, kBK] and R slice [kBK, kBN]
  const int l_m0 = kLKFast ? tid / kBK : tid % kBM;
  const int l_k0 = kLKFast ? tid % kBK : tid / kBM;
  constexpr int l_dm = kLKFast ? kThreads / kBK : 0;
  constexpr int l_dk = kLKFast ? 0 : kThreads / kBM;
  const int r_n0 = kRNFast ? tid % kBN : tid / kBK;
  const int r_k0 = kRNFast ? tid / kBN : tid % kBK;
  constexpr int r_dn = kRNFast ? 0 : kThreads / kBK;
  constexpr int r_dk = kRNFast ? kThreads / kBN : 0;

  int64_t l_off[kLoads], r_off[kLoads];
  bool l_ok[kLoads], r_ok[kLoads];
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    const int row = row0 + l_m0 + q * l_dm;
    const int col = col0 + r_n0 + q * r_dn;
    l_ok[q] = row < M;
    r_ok[q] = col < N;
    l_off[q] = b0 * L.s_b0 + b1 * L.s_b1 + row * L.s_row
               + (l_k0 + q * l_dk) * L.s_col;
    r_off[q] = b0 * R.s_b0 + b1 * R.s_b1 + col * R.s_col
               + (r_k0 + q * r_dk) * R.s_row;
  }
  const int64_t l_step = kBK * L.s_col;  // one slice further along k
  const int64_t r_step = kBK * R.s_row;

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

  for (int r = 0; r < nR; ++r) {
    const int64_t lo = r * L.s_r;
    const int64_t ro = r * R.s_r;
    int64_t kstep = 0;
    for (int k0 = 0; k0 < K; k0 += kBK, ++kstep) {
#pragma unroll
      for (int q = 0; q < kLoads; ++q) {
        const int k = l_k0 + q * l_dk;
        T vr = T(0), vi = T(0);
        if (l_ok[q] && k0 + k < K) {
          const int64_t off = lo + l_off[q] + kstep * l_step;
          vr = L.re[off];
          vi = l_im_sign * L.im[off];
        }
        lr_s[k][l_m0 + q * l_dm] = vr;
        li_s[k][l_m0 + q * l_dm] = vi;
      }
#pragma unroll
      for (int q = 0; q < kLoads; ++q) {
        const int k = r_k0 + q * r_dk;
        T vr = T(0), vi = T(0);
        if (r_ok[q] && k0 + k < K) {
          const int64_t off = ro + r_off[q] + kstep * r_step;
          vr = R.re[off];
          vi = R.im[off];
        }
        rr_s[k][r_n0 + q * r_dn] = vr;
        ri_s[k][r_n0 + q * r_dn] = vi;
      }
      __syncthreads();

#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        T a_r[kRM], a_i[kRM], b_r[kRN], b_i[kRN];
#pragma unroll
        for (int i = 0; i < kRM; ++i) {
          a_r[i] = lr_s[k][ty + kTY * i];
          a_i[i] = li_s[k][ty + kTY * i];
        }
#pragma unroll
        for (int j = 0; j < kRN; ++j) {
          b_r[j] = rr_s[k][tx + kTX * j];
          b_i[j] = ri_s[k][tx + kTX * j];
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
  }

  // Columns tx + 16*j: 16 neighbouring threads write one 16-wide run.
  const int64_t o_base = b0 * O.s_b0 + b1 * O.s_b1;
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int row = row0 + ty + kTY * i;
    if (row >= M) continue;
    const T wv = O.w == nullptr ? T(1) : O.w[row * O.s_w];
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
      const int col = col0 + tx + kTX * j;
      if (col < N) {
        const int64_t off = o_base + row * O.s_row + col * O.s_col;
        if (O.w == nullptr) {
          O.re[off] = accr[i][j];
          O.im[off] = acci[i][j];
        } else {
          O.re[off] = O.re[off] + wv * accr[i][j];
          O.im[off] = O.im[off] + wv * acci[i][j];
        }
      }
    }
  }
}

// Launch one product; returns cudaGetLastError() (0 on success). The
// grid is nb0*nb1 batch entries x row tiles x column tiles.
template <typename T, int kMinBlocks>
int launch_cgemm(const Operand<T>& L, const Operand<T>& R, const Output<T>& O,
                 int M, int N, int K, int nR, long long nb0, int nb1,
                 T l_im_sign, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || nR < 0 || nb0 <= 0 || nb1 <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long batch = nb0 * nb1;
  const long long row_tiles = (M + kBM - 1) / kBM;
  const long long col_tiles = (N + kBN - 1) / kBN;
  if (batch > 0x7fffffffLL || row_tiles > 65535 || col_tiles > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(batch),
                  static_cast<unsigned>(row_tiles),
                  static_cast<unsigned>(col_tiles));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // an operand's contiguous axis runs across threads: L's k unless only
  // its m axis is contiguous, R's n unless only its k axis is
  const bool l_k_fast = L.s_col == 1 || L.s_row != 1;
  const bool r_n_fast = R.s_col == 1 || R.s_row != 1;
  if (l_k_fast && r_n_fast) {
    cgemm_kernel<T, kMinBlocks, true, true><<<grid, kThreads, 0, st>>>(
        L, R, O, M, N, K, nR, nb1, l_im_sign);
  } else if (l_k_fast) {
    cgemm_kernel<T, kMinBlocks, true, false><<<grid, kThreads, 0, st>>>(
        L, R, O, M, N, K, nR, nb1, l_im_sign);
  } else if (r_n_fast) {
    cgemm_kernel<T, kMinBlocks, false, true><<<grid, kThreads, 0, st>>>(
        L, R, O, M, N, K, nR, nb1, l_im_sign);
  } else {
    cgemm_kernel<T, kMinBlocks, false, false><<<grid, kThreads, 0, st>>>(
        L, R, O, M, N, K, nR, nb1, l_im_sign);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace swiftly
