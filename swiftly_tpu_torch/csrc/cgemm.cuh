// Strided, batched planar complex matrix product for Hopper (sm_90a): the
// tile engine of kernels B1 (colpass.cu) and B2 (fold.cu).
//
//   out[b0, b1] (=|+= w (.)) sum_{r < nR} L[b0, b1, r] @ R[b0, b1, r]
//
// L is [M, K] and R is [K, N] per (b0, b1, r), complex, as two real
// planes (re, im) that share one set of element strides. Every axis has
// its own 64-bit stride (0 broadcasts), so the callers hand in views of
// their tensors as they lie in memory: interleaved (..., 2) planar
// layouts (stride 2), transposed phase matrices, a facet axis broadcast
// over subgrids, the accumulator's [F, B, yB] slab. With kConjL the
// imaginary plane of L enters negated (exact), which gives B2 its
// conjugated phase matrix without a copy.
//
// Replaces the first strided engine of B1 and B2 (64x64 tiles); the Pallas
// kernels they port (swiftly_tpu/ops/pallas_kernels.py:171 and :265) run
// their products on the TPU's MXU, with the operands as whole VMEM blocks.
//
// The numbers are fixed: every output element is the same chain of IEEE
// FMAs, r ascending, then k ascending from 0 with k padded by zeros to a
// multiple of 16 for every r,
//   accr = fma(ar, br, accr); accr = fma(-ai, bi, accr);
//   acci = fma(ar, bi, acci); acci = fma(ai, br, acci);
// in T accumulators, then the output written once, or read once and
// written once as O = O + w * acc. No tensor cores, no TF32, no split-K,
// no atomics: the bits depend on neither the tile nor the copy paths, and
// reruns are bit-identical. They are the first engine's bits (chip_smoke.py
// B1_DIGESTS, B2_DIGESTS).
//
// What bounds it on an H100: 8 flops (four real products) per complex
// multiply-add against 67 TFLOP/s of f32 FMA outside the tensor cores; at
// B1's and B2's path shapes the operands are reused hundreds of times
// from shared memory, so they are bound by operations (colpass.cu,
// fold.cu).
//
// What held the first design back (64x64 tiles of both planes, 256
// threads, 4x4 outputs a thread): one scalar shared load per four FMAs (16
// loads for 64 FMAs a k); loads from global memory through registers into
// shared memory, one 16-deep slice at a time, two barriers a slice and
// nothing overlapping the copies with the arithmetic; 64-bit offset
// arithmetic for every element loaded. On an H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 7, at the 32k path shapes) B1 ran at 1.99-2.09x
// its bound and B2 at 1.83-1.88x; this design runs them at 1.37-1.39x and
// 1.40-1.47x (colpass.cu, fold.cu).
// This design carries kernel B3's (cmatmul.cu) over to strided operands:
// - 128x128 outputs a block in f32 (64x128 in f64: 8x8 doubles of both
//   planes need more than 255 registers), 8x8 a thread (4x8), so that a
//   thread's 32 values read from shared memory a k feed 256 FMAs;
// - a ring of kStages 16-deep slices in dynamic shared memory, filled by
//   cp.async while the threads compute on an earlier slice, one barrier a
//   slice; the (r, k) loop is one run of slices, so B1's sum over facets
//   streams through the same ring;
// - L stored transposed ([k][m]) and R as it lies ([k][n]): a thread reads
//   its rows and its columns of one k as 16-byte vectors, with no bank
//   conflicts;
// - per operand, a copy path picked by the wrapper (ops/kernels.py
//   `_cgemm_paths`): 16-byte runs where the operand's fast axis is
//   contiguous and aligned (B2's phases and rows; B1's staged T and its
//   operators, as the wrapper lays them out), else one element a copy with
//   any strides (B1's X, an interleaved view; L's in 4-row x 8-k warp
//   patches, R's along n), each copy's 64-bit address one add from a base
//   the thread computes once;
// - the output written as 16-byte runs along n or along m, as interleaved
//   (re, im) pairs (B2's accumulator), or element by element;
// - the tiles of one batch entry are neighbouring blocks, the axis with
//   fewer tiles the faster, so the operand band they share is read from
//   memory once and from L2 after.
// Blocks run on gridDim.x: at most 2^31-1 tiles in all (and, as before, at
// most 2^31-1 batch entries and 65535 row or column tiles); offsets are
// 64-bit.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace swiftly {

constexpr int kBK = 16;        // contraction depth of one pipeline slice
constexpr int kThreads = 256;  // a block's threads, in every tile
constexpr int kPadA = 4;       // pads a k-row of the transposed L slice: the row
                               // stride stays 16-byte aligned, and at
                               // BM = 128 (a stride of 4 banks mod 32) the
                               // 4-row x 8-k write patch of a warp meets 32
                               // distinct banks

// The copy paths, as the C entry points take them (`paths`): bit 0 copies
// L in 16-byte runs along m, bit 1 copies R in 16-byte runs along n, bits
// 2-3 say how the output is written. ops/kernels.py `_cgemm_paths` picks
// them from the operands' strides, sizes and alignment.
constexpr int kPathLRuns = 1;
constexpr int kPathRRuns = 2;
constexpr int kOutShift = 2;
enum OutPath : int {
  kOutElements = 0,  // any strides, one element a store
  kOutRunsN = 1,     // 16-byte runs along n (n contiguous)
  kOutRunsM = 2,     // 16-byte runs along m (m contiguous)
  kOutPairs = 3,     // (re, im) pairs: im at re + 1, n stride 2
};

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

// The tile: BM x BN outputs of both planes a block, RM x RN a thread,
// kStages slices in flight. A thread's rows are runs of kVec consecutive
// rows, BM / (RM / kVec) apart, and its columns likewise: each run is one
// 16-byte read of a slice, and the runs of neighbouring threads lie side
// by side.
template <typename T, int BM, int BN, int RM, int RN, int kStages_>
struct Tile {
  static constexpr int kBM = BM;
  static constexpr int kBN = BN;
  static constexpr int kRM = RM;
  static constexpr int kRN = RN;
  static constexpr int kStages = kStages_;
  static constexpr int kVec = 16 / sizeof(T);  // T in 16 bytes
  static constexpr int kTY = BM / RM;  // threads along M
  static constexpr int kTX = BN / RN;  // threads along N
  static constexpr int kThreads = kTX * kTY;
  static constexpr int kRowGap = BM / (RM / kVec);
  static constexpr int kColGap = BN / (RN / kVec);
  static constexpr int kLdA = BM + kPadA;  // a k-row of the L slice
  static constexpr int kLdB = BN;          // a k-row of the R slice
  static constexpr int kPlaneA = kBK * kLdA;
  static constexpr int kPlaneB = kBK * kLdB;
  static constexpr int kStage = 2 * kPlaneA + 2 * kPlaneB;  // elements
  static constexpr size_t kSmemBytes = sizeof(T) * kStages * kStage;
  // L, one element a copy: warp patches of 4 rows x 8 k, two patches side
  // by side along k; a thread copies one k of the rows lm + c * kLElStep
  static constexpr int kLElCopies = BM * kBK / kThreads;
  static constexpr int kLElStep = kThreads / kBK;
  // L in runs along m: a thread copies one run of the k-rows
  // lk + c * kLRunStep
  static constexpr int kLRuns = BM / kVec;
  static constexpr int kLRunCopies = kBK * kLRuns / kThreads;
  static constexpr int kLRunStep = kThreads / kLRuns;
  // R in runs along n, likewise
  static constexpr int kRRuns = BN / kVec;
  static constexpr int kRRunCopies = kBK * kRRuns / kThreads;
  static constexpr int kRRunStep = kThreads / kRRuns;
  // R, one element a copy: a thread copies column tid % BN of the k-rows
  // tid / BN + c * kRElStep
  static constexpr int kRElCopies = kBK * BN / kThreads;
  static constexpr int kRElStep = kThreads / BN;
  static_assert(kThreads == swiftly::kThreads,
                "one thread count (the L warp patches assume 256)");
  static_assert(kBK == 16 && (BM * kBK) % kThreads == 0,
                "the L slice splits into whole warp patches");
  static_assert(kThreads % kLRuns == 0 && (kBK * kLRuns) % kThreads == 0,
                "the L runs split evenly over the threads");
  static_assert(kThreads % kRRuns == 0 && (kBK * kRRuns) % kThreads == 0,
                "the R runs split evenly over the threads");
  static_assert(kThreads % BN == 0 && (kBK * BN) % kThreads == 0,
                "the R elements split evenly over the threads");
  static_assert(RM % kVec == 0 && RN % kVec == 0, "whole 16-byte runs");
};

// The engine's one tile per type. f64 takes 64 x 128 outputs a block, 4 x 8
// a thread, and three stages (150,528 bytes of shared memory).
template <typename T>
struct EngineTile;
template <>
struct EngineTile<float> {
  using type = Tile<float, 128, 128, 8, 8, 4>;
};
template <>
struct EngineTile<double> {
  using type = Tile<double, 64, 128, 4, 8, 3>;
};

// kLRuns / kRRuns: L / R copied in 16-byte runs along m / n (else one
// element a copy). kConjL: L's imaginary plane enters negated.
template <typename T, bool kLRuns, bool kRRuns, bool kConjL>
__global__ void __launch_bounds__(kThreads)
cgemm_kernel(const Operand<T> L, const Operand<T> R, const Output<T> O,
             int M, int N, int K, int nR, int nb1, int row_tiles,
             int col_tiles, bool rows_fast, int out_path) {
  using C = typename EngineTile<T>::type;
  constexpr int RM = C::kRM;
  constexpr int RN = C::kRN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x;
  const int tx = tid % C::kTX;
  const int ty = tid / C::kTX;
  // the tiles of one batch entry are neighbouring blocks, the axis with
  // fewer tiles the faster
  const int tiles = row_tiles * col_tiles;
  const int64_t bz = blockIdx.x / tiles;
  const int t = blockIdx.x % tiles;
  const int rt = rows_fast ? t % row_tiles : t / col_tiles;
  const int ct = rows_fast ? t / row_tiles : t % col_tiles;
  const int64_t b0 = bz / nb1;
  const int64_t b1 = bz % nb1;
  const int row0 = rt * C::kBM;
  const int col0 = ct * C::kBN;
  const int per_r = (K + kBK - 1) / kBK;  // slices of one r
  const int slices = nR * per_r;

  // What this thread copies of every slice: a base offset, the offset
  // between its copies, and the bounds its copies are tested against.
  int l_m, l_k, l_ok_rows;
  int64_t l_at, l_step;
  if constexpr (kLRuns) {
    l_m = (tid % C::kLRuns) * C::kVec;
    l_k = tid / C::kLRuns;
    l_ok_rows = row0 + l_m < M;
    l_step = C::kLRunStep * L.s_col;
  } else {
    l_k = (tid & 7) + 8 * ((tid >> 5) & 1);
    l_m = ((tid & 31) >> 3) + 4 * (tid >> 6);
    l_ok_rows = M - row0 - l_m;  // copy c is a row while c * step < this
    l_step = C::kLElStep * L.s_row;
  }
  l_at = b0 * L.s_b0 + b1 * L.s_b1 + (row0 + l_m) * L.s_row + l_k * L.s_col;
  int r_n, r_k;
  bool r_ok_col;
  int64_t r_step;
  if constexpr (kRRuns) {
    r_n = (tid % C::kRRuns) * C::kVec;
    r_k = tid / C::kRRuns;
    r_step = C::kRRunStep * R.s_row;
  } else {
    r_n = tid % C::kBN;
    r_k = tid / C::kBN;
    r_step = C::kRElStep * R.s_row;
  }
  r_ok_col = col0 + r_n < N;
  const int64_t r_at =
      b0 * R.s_b0 + b1 * R.s_b1 + (col0 + r_n) * R.s_col + r_k * R.s_row;

  // Slice `s` (r = s / per_r, k0 = 16 * (s % per_r)) into ring slot
  // `slot`: L transposed, R as it lies, zeros past M, N and K.
  auto load = [&](int slot, int s) {
    T* as_r = smem + slot * C::kStage;
    T* as_i = as_r + C::kPlaneA;
    T* bs_r = as_i + C::kPlaneA;
    T* bs_i = bs_r + C::kPlaneB;
    const int r = s / per_r;
    const int k0 = (s - r * per_r) * kBK;
    const int64_t lo = l_at + r * L.s_r + k0 * L.s_col;
    const int64_t ro = r_at + r * R.s_r + k0 * R.s_row;
    if constexpr (kLRuns) {
#pragma unroll
      for (int c = 0; c < C::kLRunCopies; ++c) {
        const int k = l_k + c * C::kLRunStep;
        const bool ok = l_ok_rows && k0 + k < K;
        const int64_t at = ok ? lo + c * l_step : 0;
        cp_async<16>(as_r + k * C::kLdA + l_m, L.re + at, ok);
        cp_async<16>(as_i + k * C::kLdA + l_m, L.im + at, ok);
      }
    } else {
      const bool k_ok = k0 + l_k < K;
#pragma unroll
      for (int c = 0; c < C::kLElCopies; ++c) {
        const bool ok = k_ok && c * C::kLElStep < l_ok_rows;
        const int64_t at = ok ? lo + c * l_step : 0;
        const int to = l_k * C::kLdA + l_m + c * C::kLElStep;
        cp_async<sizeof(T)>(as_r + to, L.re + at, ok);
        cp_async<sizeof(T)>(as_i + to, L.im + at, ok);
      }
    }
    if constexpr (kRRuns) {
#pragma unroll
      for (int c = 0; c < C::kRRunCopies; ++c) {
        const int k = r_k + c * C::kRRunStep;
        const bool ok = r_ok_col && k0 + k < K;
        const int64_t at = ok ? ro + c * r_step : 0;
        cp_async<16>(bs_r + k * C::kLdB + r_n, R.re + at, ok);
        cp_async<16>(bs_i + k * C::kLdB + r_n, R.im + at, ok);
      }
    } else {
#pragma unroll
      for (int c = 0; c < C::kRElCopies; ++c) {
        const int k = r_k + c * C::kRElStep;
        const bool ok = r_ok_col && k0 + k < K;
        const int64_t at = ok ? ro + c * r_step : 0;
        cp_async<sizeof(T)>(bs_r + k * C::kLdB + r_n, R.re + at, ok);
        cp_async<sizeof(T)>(bs_i + k * C::kLdB + r_n, R.im + at, ok);
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
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < slices) load(s, s);
    cp_async_commit();
  }

  for (int s = 0; s < slices; ++s) {
    cp_async_wait<C::kStages - 2>();  // slice s has landed
    __syncthreads();                  // and every thread is done with s - 1
    const int next = s + C::kStages - 1;
    if (next < slices) load(next % C::kStages, next);
    cp_async_commit();

    const T* as_r = smem + (s % C::kStages) * C::kStage + ty * C::kVec;
    const T* as_i = as_r + C::kPlaneA;
    const T* bs_r = smem + (s % C::kStages) * C::kStage + 2 * C::kPlaneA +
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
        // the conjugate: the negation is exact and folds into the FMAs
        const T ai = kConjL ? -a_i[i] : a_i[i];
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          accr[i][j] = fma(a_r[i], b_r[j], accr[i][j]);
          accr[i][j] = fma(-ai, b_i[j], accr[i][j]);
          acci[i][j] = fma(a_r[i], b_i[j], acci[i][j]);
          acci[i][j] = fma(ai, b_r[j], acci[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy may outlive the block

  // The output, written once (or read once and written once as
  // O + w * acc). Thread rows: row0 + u * kRowGap + ty * kVec + q for run
  // u and lane q; columns likewise.
  const int64_t o_b = b0 * O.s_b0 + b1 * O.s_b1;
  const bool add = O.w != nullptr;
  if (out_path == kOutRunsM) {
#pragma unroll
    for (int u = 0; u < RM / C::kVec; ++u) {
      const int row = row0 + u * C::kRowGap + ty * C::kVec;
      if (row >= M) continue;
      T wv[C::kVec];
#pragma unroll
      for (int q = 0; q < C::kVec; ++q) {
        wv[q] = add ? O.w[(row + q) * O.s_w] : T(1);
      }
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int col = col0 + (j / C::kVec) * C::kColGap + tx * C::kVec +
                        j % C::kVec;
        if (col >= N) continue;
        const int64_t off = o_b + row + col * O.s_col;
        T vr[C::kVec], vi[C::kVec];
        if (add) {
          Vec<T>::get(O.re + off, vr);
          Vec<T>::get(O.im + off, vi);
        }
#pragma unroll
        for (int q = 0; q < C::kVec; ++q) {
          const T ar = accr[u * C::kVec + q][j];
          const T ai = acci[u * C::kVec + q][j];
          vr[q] = add ? vr[q] + wv[q] * ar : ar;
          vi[q] = add ? vi[q] + wv[q] * ai : ai;
        }
        Vec<T>::put(O.re + off, vr);
        Vec<T>::put(O.im + off, vi);
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row =
        row0 + (i / C::kVec) * C::kRowGap + ty * C::kVec + i % C::kVec;
    if (row >= M) continue;
    const T wv = add ? O.w[row * O.s_w] : T(1);
    const int64_t o_row = o_b + row * O.s_row;
#pragma unroll
    for (int v = 0; v < RN; v += C::kVec) {
      const int c = col0 + (v / C::kVec) * C::kColGap + tx * C::kVec;
      const T* run_r = accr[i] + v;
      const T* run_i = acci[i] + v;
      if (out_path == kOutRunsN) {
        if (c >= N) continue;
        T vr[C::kVec], vi[C::kVec];
        if (add) {
          Vec<T>::get(O.re + o_row + c, vr);
          Vec<T>::get(O.im + o_row + c, vi);
        }
#pragma unroll
        for (int q = 0; q < C::kVec; ++q) {
          vr[q] = add ? vr[q] + wv * run_r[q] : run_r[q];
          vi[q] = add ? vi[q] + wv * run_i[q] : run_i[q];
        }
        Vec<T>::put(O.re + o_row + c, vr);
        Vec<T>::put(O.im + o_row + c, vi);
      } else if (out_path == kOutPairs) {
        // one vector holds the (re, im) pairs of kVec / 2 columns
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int cc = c + h * (C::kVec / 2);
          if (cc >= N) continue;
          T* at = O.re + o_row + 2 * static_cast<int64_t>(cc);
          T p[C::kVec];
          if (add) Vec<T>::get(at, p);
#pragma unroll
          for (int q = 0; q < C::kVec / 2; ++q) {
            const T ar = run_r[h * (C::kVec / 2) + q];
            const T ai = run_i[h * (C::kVec / 2) + q];
            p[2 * q] = add ? p[2 * q] + wv * ar : ar;
            p[2 * q + 1] = add ? p[2 * q + 1] + wv * ai : ai;
          }
          Vec<T>::put(at, p);
        }
      } else {
#pragma unroll
        for (int q = 0; q < C::kVec; ++q) {
          if (c + q >= N) continue;
          const int64_t off = o_row + (c + q) * O.s_col;
          if (add) {
            O.re[off] = O.re[off] + wv * run_r[q];
            O.im[off] = O.im[off] + wv * run_i[q];
          } else {
            O.re[off] = run_r[q];
            O.im[off] = run_i[q];
          }
        }
      }
    }
  }
}

// The tile of T's engine, for the callers' records: BM, BN, RM, RN, the
// stages and the dynamic shared memory a block asks for, in bytes.
template <typename T>
void engine_tile(long long* out) {
  using C = typename EngineTile<T>::type;
  out[0] = C::kBM;
  out[1] = C::kBN;
  out[2] = C::kRM;
  out[3] = C::kRN;
  out[4] = C::kStages;
  out[5] = static_cast<long long>(C::kSmemBytes);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, bool kLRuns, bool kRRuns, bool kConjL>
int launch_paths(const Operand<T>& L, const Operand<T>& R, const Output<T>& O,
                 int M, int N, int K, int nR, int nb1, int row_tiles,
                 int col_tiles, unsigned blocks, int out_path,
                 cudaStream_t stream) {
  using C = typename EngineTile<T>::type;
  auto kernel = cgemm_kernel<T, kLRuns, kRRuns, kConjL>;
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
  kernel<<<blocks, C::kThreads, C::kSmemBytes, stream>>>(
      L, R, O, M, N, K, nR, nb1, row_tiles, col_tiles, row_tiles < col_tiles,
      out_path);
  return static_cast<int>(cudaGetLastError());
}

// Launch one product; returns cudaGetLastError() (0 on success). The
// grid is nb0*nb1 batch entries x row tiles x column tiles. `paths` are
// the copy paths (kPathLRuns | kPathRRuns | out << kOutShift); a 16-byte
// path on an unaligned plane is refused (cudaErrorInvalidValue).
template <typename T, bool kConjL>
int launch_cgemm(const Operand<T>& L, const Operand<T>& R, const Output<T>& O,
                 int M, int N, int K, int nR, long long nb0, int nb1,
                 int paths, void* stream) {
  using C = typename EngineTile<T>::type;
  if (M <= 0 || N <= 0 || K < 0 || nR < 0 || nb0 <= 0 || nb1 <= 0 ||
      paths < 0 || paths > 15) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long batch = nb0 * nb1;
  const long long row_tiles = (M + C::kBM - 1) / C::kBM;
  const long long col_tiles = (N + C::kBN - 1) / C::kBN;
  const long long blocks = batch * row_tiles * col_tiles;
  if (batch > 0x7fffffffLL || row_tiles > 65535 || col_tiles > 65535 ||
      blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool l_runs = paths & kPathLRuns;
  const bool r_runs = paths & kPathRRuns;
  const int out_path = paths >> kOutShift;
  if ((l_runs && !(aligned16(L.re) && aligned16(L.im))) ||
      (r_runs && !(aligned16(R.re) && aligned16(R.im))) ||
      ((out_path == kOutRunsN || out_path == kOutRunsM) &&
       !(aligned16(O.re) && aligned16(O.im))) ||
      (out_path == kOutPairs && !(aligned16(O.re) && O.im == O.re + 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const int rt = static_cast<int>(row_tiles);
  const int ct = static_cast<int>(col_tiles);
  const auto nblocks = static_cast<unsigned>(blocks);
  if (l_runs && r_runs) {
    return launch_paths<T, true, true, kConjL>(L, R, O, M, N, K, nR, nb1, rt,
                                               ct, nblocks, out_path, st);
  } else if (l_runs) {
    return launch_paths<T, true, false, kConjL>(L, R, O, M, N, K, nR, nb1, rt,
                                                ct, nblocks, out_path, st);
  } else if (r_runs) {
    return launch_paths<T, false, true, kConjL>(L, R, O, M, N, K, nR, nb1, rt,
                                                ct, nblocks, out_path, st);
  }
  return launch_paths<T, false, false, kConjL>(L, R, O, M, N, K, nR, nb1, rt,
                                               ct, nblocks, out_path, st);
}

}  // namespace swiftly
