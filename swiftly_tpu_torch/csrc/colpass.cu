// Fused complex column-pass product for Hopper (sm_90a): kernel B1.
//
//   reduce_f:  out[s]    = sum_f A[f] @ X[s, f] @ B[f]     ([S, M, N])
//   otherwise: out[s, f] =       A[f] @ X[s, f] @ B[f]     ([S, F, M, N])
//   A: [F, M, P], X: [S, Fx, P, Q] (Fx = F, or 1 broadcast over f),
//   B: [F, Q, N]; every operand complex, as (re, im) planes.
//
// Replaces: swiftly_tpu/ops/pallas_kernels.py:265 `colpass_pallas` (body
// `_colpass_kernel` :221), the streamed column pass's fused triple
// product: forward (reduce_f, swiftly_tpu/parallel/streamed.py:488) and
// adjoint (per facet, :881). Here its wrapper is
// swiftly_tpu_torch/ops/kernels.py `colpass`.
//
// What bounds it on an H100: 8*S*F*(M*P*Q + M*Q*N) flops (both products,
// four real products each) against 67 TFLOP/s of f32 FMA; at the 32k
// forward shape (S=74, F=9, M=N=512, P=Q=256) that is 5.36e11 flops,
// 8.0 ms, while its bytes (one read of X, ~350 MB, and one write of the
// output) take ~0.15 ms: bound by operations.
//
// Design: the Pallas grid recomputes T = A_f @ X_sf for every output
// column tile and keeps it in VMEM; a [bm, Q] tile of T (512 KB at
// bm = Q = 256) does not fit an SM's shared memory, and recomputing
// slices of it per 64-column output tile would multiply the first
// product's work by N/64 (8x at N = 512). So T is STAGED THROUGH GLOBAL
// MEMORY: launch 1 writes T[s, f] = A[f] @ X[s, f] for all (s, f)
// ([S, F, M, Q] planes, 0.7 GB at the 32k forward shape, allocated by
// the wrapper); launch 2 computes out from T with the facet sum folded
// into the contraction loop (r = f outer, k = q inner), so the sum over
// f accumulates in registers, in a fixed order, never through global
// memory between launches. The extra traffic, one write and one read of
// T (~1.4 GB, ~0.4 ms), is 5% of the operations bound. Both launches
// run the strided tile engine of cgemm.cuh (see there: 64x64 tiles,
// plain FMAs, no split-K, bit-identical reruns). Tensor cores (3xTF32),
// TMA and a fused T kept in shared memory are left for a faster version.

#include "cgemm.cuh"

namespace {

template <typename T>
int colpass_stage(const void* lr, const void* li, const long long* ls,
                  const void* rr, const void* ri, const long long* rs,
                  void* outr, void* outi, const long long* os, int M, int N,
                  int K, int nR, long long nb0, int nb1, void* stream) {
  const swiftly::Operand<T> L{static_cast<const T*>(lr),
                              static_cast<const T*>(li),
                              ls[0], ls[1], ls[2], ls[3], ls[4]};
  const swiftly::Operand<T> R{static_cast<const T*>(rr),
                              static_cast<const T*>(ri),
                              rs[0], rs[1], rs[2], rs[3], rs[4]};
  const swiftly::Output<T> O{static_cast<T*>(outr), static_cast<T*>(outi),
                             os[0], os[1], os[2], os[3], nullptr, 0};
  // f32: three blocks per SM (80 registers, a few bytes of spills) ran
  // both forms of B1 faster at the 32k shapes than the allocator's free
  // choice (116-128 registers, two blocks); f64 would spill kilobytes.
  constexpr int kMinBlocks = sizeof(T) == 4 ? 3 : 1;
  return swiftly::launch_cgemm<T, kMinBlocks>(L, R, O, M, N, K, nR, nb0, nb1,
                                              T(1), stream);
}

}  // namespace

// Plain C interface, loaded with ctypes: one stage of B1,
//   out[b0, b1] = sum_{r < nR} L[b0, b1, r] @ R[b0, b1, r],
// with element strides ls/rs = (b0, b1, r, row, col) and
// os = (b0, b1, row, col). The wrapper runs it twice per B1 launch
// (T = A @ X, then out = sum_f T @ B). Returns cudaGetLastError() after
// the launch (0 on success); runs on `stream`, does not synchronise and
// allocates nothing.
extern "C" int swiftly_colpass_f32(
    const void* lr, const void* li, const long long* ls, const void* rr,
    const void* ri, const long long* rs, void* outr, void* outi,
    const long long* os, int M, int N, int K, int nR, long long nb0, int nb1,
    void* stream) {
  return colpass_stage<float>(lr, li, ls, rr, ri, rs, outr, outi, os, M, N,
                              K, nR, nb0, nb1, stream);
}

extern "C" int swiftly_colpass_f64(
    const void* lr, const void* li, const long long* ls, const void* rr,
    const void* ri, const long long* rs, void* outr, void* outi,
    const long long* os, int M, int N, int K, int nR, long long nb0, int nb1,
    void* stream) {
  return colpass_stage<double>(lr, li, ls, rr, ri, rs, outr, outi, os, M, N,
                               K, nR, nb0, nb1, stream);
}

extern "C" const char* swiftly_colpass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
