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
// shapes, forward (S, F, M, P, Q, N) = (74, 9, 512, 256, 256, 512) and
// adjoint (74, 9, 256, 512, 512, 256), that is 5.36e11 flops, 8.0 ms,
// while the bytes (one read of X, ~350 MB, and one write of the output)
// take ~0.15 ms: bound by operations.
//
// Design: the Pallas grid recomputes T = A_f @ X_sf for every output
// column tile and keeps it in VMEM; a [bm, Q] band of T (512 KB at
// bm = Q = 256) does not fit an SM's shared memory, and recomputing
// slices of it per output column tile would multiply the first product's
// work by N/128. So T is STAGED THROUGH GLOBAL MEMORY, in two launches of
// the tile engine (cgemm.cuh): launch 1 writes T[s, f] = A[f] @ X[s, f]
// for all (s, f) TRANSPOSED, [S, F, Q, M] planes (0.7 GB at the 32k
// forward shape, allocated by the wrapper), as 16-byte runs along m;
// launch 2 reads them back as 16-byte runs along m straight into its
// transposed L slices, and computes out with the facet sum folded into
// the contraction (r = f outer, k = q inner), so the sum over f stays in
// registers, in a fixed order, never through global memory between
// launches. The extra traffic, one write and one read of T (~1.4 GB,
// ~0.4 ms), is 5% of the operations bound.
//
// The first version ran both launches on a 64x64-tile engine, three
// blocks an SM (80 registers, a few bytes spilled): 16.751 ms forward and
// 15.923 ms adjoint at the 32k shapes, 2.09x and 1.99x the bound. On the
// pipelined engine, with the operators A and B copied by the wrapper so
// that they move in 16-byte runs (X, the path's interleaved view, moves
// one element a copy): 10.996 and 11.127 ms, 1.37x and 1.39x, against
// torch.einsum's 11.107 and 10.798 ms (complex64). All on an H100 80GB
// HBM3 at 700 W, chip_smoke.py phase 7.

#include "cgemm.cuh"

namespace {

template <typename T>
int colpass_stage(const void* lr, const void* li, const long long* ls,
                  const void* rr, const void* ri, const long long* rs,
                  void* outr, void* outi, const long long* os, int M, int N,
                  int K, int nR, long long nb0, int nb1, int paths,
                  void* stream) {
  const swiftly::Operand<T> L{static_cast<const T*>(lr),
                              static_cast<const T*>(li),
                              ls[0], ls[1], ls[2], ls[3], ls[4]};
  const swiftly::Operand<T> R{static_cast<const T*>(rr),
                              static_cast<const T*>(ri),
                              rs[0], rs[1], rs[2], rs[3], rs[4]};
  const swiftly::Output<T> O{static_cast<T*>(outr), static_cast<T*>(outi),
                             os[0], os[1], os[2], os[3], nullptr, 0};
  return swiftly::launch_cgemm<T, false>(L, R, O, M, N, K, nR, nb0, nb1,
                                         paths, stream);
}

}  // namespace

// Plain C interface, loaded with ctypes: one stage of B1,
//   out[b0, b1] = sum_{r < nR} L[b0, b1, r] @ R[b0, b1, r],
// with element strides ls/rs = (b0, b1, r, row, col) and
// os = (b0, b1, row, col), and the copy paths `paths` (cgemm.cuh). The
// wrapper runs it twice per B1 launch (T = A @ X, then out = sum_f T @ B).
// Returns cudaGetLastError() after the launch (0 on success); runs on
// `stream`, does not synchronise and allocates nothing.
extern "C" int swiftly_colpass_f32(
    const void* lr, const void* li, const long long* ls, const void* rr,
    const void* ri, const long long* rs, void* outr, void* outi,
    const long long* os, int M, int N, int K, int nR, long long nb0, int nb1,
    int paths, void* stream) {
  return colpass_stage<float>(lr, li, ls, rr, ri, rs, outr, outi, os, M, N,
                              K, nR, nb0, nb1, paths, stream);
}

extern "C" int swiftly_colpass_f64(
    const void* lr, const void* li, const long long* ls, const void* rr,
    const void* ri, const long long* rs, void* outr, void* outi,
    const long long* os, int M, int N, int K, int nR, long long nb0, int nb1,
    int paths, void* stream) {
  return colpass_stage<double>(lr, li, ls, rr, ri, rs, outr, outi, os, M, N,
                               K, nR, nb0, nb1, paths, stream);
}

// The engine's tile (cgemm.cuh `engine_tile`) for f32 (f64 = 0) or f64:
// out[0..5] = BM, BN, RM, RN, stages, dynamic shared memory in bytes.
extern "C" void swiftly_colpass_tile(int f64, long long* out) {
  if (f64) {
    swiftly::engine_tile<double>(out);
  } else {
    swiftly::engine_tile<float>(out);
  }
}

extern "C" const char* swiftly_colpass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
