// Adjoint sampled fold for Hopper (sm_90a): kernel B2.
//
//   acc[f] += w (.) ((Bc - i*Bs)^T @ (Rr + i*Ri)[f])      for every f
//   acc: [F, B, J] planes (a row block of the image accumulator, updated
//   in place), Bc/Bs: [R, B] adjoint phase planes, Rr/Ri: [F, R, J]
//   phase-rotated row planes, w: [B] row weights (Fb window x keep mask).
//
// Replaces: swiftly_tpu/ops/pallas_kernels.py:171 `bwd_fold_pallas` (body
// `_fold_kernel` :139), called per output-row block by the streamed
// backward's sampled fold (swiftly_tpu/parallel/streamed.py:1481). Here
// its wrapper is swiftly_tpu_torch/ops/kernels.py `fold`.
//
// What bounds it on an H100: 8*F*B*J*R flops against 67 TFLOP/s of f32
// FMA; at the 32k shape (F=9, B=384, J=11264, R=1024) that is 3.19e11
// flops, 4.8 ms, while its bytes (the rows once, ~0.8 GB, and the
// accumulator block read and written once, ~0.25 GB) take ~0.3 ms:
// bound by operations.
//
// Design: the JAX caller flattens the facet axis into the output columns
// (J = F*yB) and copies the accumulator block in and out of that layout;
// here the facet axis is the batch axis of the strided tile engine
// (cgemm.cuh), which reads and writes the accumulator's [F, B, yB] slab
// where it lies, in its interleaved (..., 2) layout, so no copy of the
// 9 GB accumulator or of its blocks is made. The conjugate of the phase
// matrix is the engine's negated imaginary load; its transpose is a
// stride. Each output element is owned by one thread: its w-scaled sum is
// added to the accumulator once, after the whole R contraction ran in
// registers (read once, written once, no atomics, bit-identical reruns).
// Tensor cores (3xTF32) and TMA are left for a faster version.

#include "cgemm.cuh"

namespace {

template <typename T>
int fold(void* accr, void* acci, const long long* as, const void* bc,
         const void* bs, const long long* bst, const void* rr, const void* ri,
         const long long* rst, const void* w, long long w_stride, long long F,
         int B, int J, int R, void* stream) {
  // L[b, r] = Bc[r, b] - i*Bs[r, b]: strides (row=b, col=r) of [R, B]
  const swiftly::Operand<T> L{static_cast<const T*>(bc),
                              static_cast<const T*>(bs),
                              0, 0, 0, bst[1], bst[0]};
  // rows[f, r, j]
  const swiftly::Operand<T> Rm{static_cast<const T*>(rr),
                               static_cast<const T*>(ri),
                               rst[0], 0, 0, rst[1], rst[2]};
  // acc[f, b, j], accumulated with weights w[b]
  const swiftly::Output<T> O{static_cast<T*>(accr), static_cast<T*>(acci),
                             as[0], 0, as[1], as[2],
                             static_cast<const T*>(w), w_stride};
  // the allocator's free choice: asking for three blocks per SM (80
  // registers) made B2 slower at the 32k shape
  return swiftly::launch_cgemm<T, 1>(L, Rm, O, B, J, R, 1, F, 1, T(-1),
                                     stream);
}

}  // namespace

// Plain C interface, loaded with ctypes. Element strides: as = (f, b, j)
// of the accumulator, bst = (r, b) of the phase planes, rst = (f, r, j)
// of the row planes. Returns cudaGetLastError() after the launch (0 on
// success); runs on `stream`, does not synchronise, allocates nothing.
extern "C" int swiftly_fold_f32(void* accr, void* acci, const long long* as,
                                const void* bc, const void* bs,
                                const long long* bst, const void* rr,
                                const void* ri, const long long* rst,
                                const void* w, long long w_stride,
                                long long F, int B, int J, int R,
                                void* stream) {
  return fold<float>(accr, acci, as, bc, bs, bst, rr, ri, rst, w, w_stride,
                     F, B, J, R, stream);
}

extern "C" int swiftly_fold_f64(void* accr, void* acci, const long long* as,
                                const void* bc, const void* bs,
                                const long long* bst, const void* rr,
                                const void* ri, const long long* rst,
                                const void* w, long long w_stride,
                                long long F, int B, int J, int R,
                                void* stream) {
  return fold<double>(accr, acci, as, bc, bs, bst, rr, ri, rst, w, w_stride,
                      F, B, J, R, stream);
}

extern "C" const char* swiftly_fold_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
