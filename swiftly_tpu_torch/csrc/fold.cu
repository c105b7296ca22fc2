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
// where it lies, in its interleaved (..., 2) layout, as 16-byte (re, im)
// pairs, so no copy of the 9 GB accumulator or of its blocks is made. The
// phase planes [R, B] are the engine's transposed L slices as they lie
// (16-byte runs along b); the row planes are its R slices (16-byte runs
// along j). The conjugate of the phase matrix is the engine's negated
// imaginary plane (exact, folded into the FMAs); its transpose is a
// stride. Each output element is owned by one thread: its w-scaled sum is
// added to the accumulator once, after the whole R contraction ran in
// registers (read once, written once, no atomics, bit-identical reruns).
// The row tiles of one column band are neighbouring blocks, so each row
// plane is read from memory once.
//
// The first version ran on a 64x64-tile engine: 8.731 ms at R = 1024 and
// 4.489 ms at R = 512, 1.83x and 1.88x the bound. On the pipelined engine:
// 6.668 and 3.492 ms, 1.40x and 1.47x, against torch.matmul (complex64)
// plus the weighted add's 6.366 and 3.461 ms. All on an H100 80GB HBM3 at
// 700 W, chip_smoke.py phase 7.

#include "cgemm.cuh"

namespace {

template <typename T>
int fold(void* accr, void* acci, const long long* as, const void* bc,
         const void* bs, const long long* bst, const void* rr, const void* ri,
         const long long* rst, const void* w, long long w_stride, long long F,
         int B, int J, int R, int paths, void* stream) {
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
  return swiftly::launch_cgemm<T, true>(L, Rm, O, B, J, R, 1, F, 1, paths,
                                        stream);
}

}  // namespace

// Plain C interface, loaded with ctypes. Element strides: as = (f, b, j)
// of the accumulator, bst = (r, b) of the phase planes, rst = (f, r, j)
// of the row planes; `paths` the copy paths (cgemm.cuh). Returns
// cudaGetLastError() after the launch (0 on success); runs on `stream`,
// does not synchronise, allocates nothing.
extern "C" int swiftly_fold_f32(void* accr, void* acci, const long long* as,
                                const void* bc, const void* bs,
                                const long long* bst, const void* rr,
                                const void* ri, const long long* rst,
                                const void* w, long long w_stride,
                                long long F, int B, int J, int R, int paths,
                                void* stream) {
  return fold<float>(accr, acci, as, bc, bs, bst, rr, ri, rst, w, w_stride,
                     F, B, J, R, paths, stream);
}

extern "C" int swiftly_fold_f64(void* accr, void* acci, const long long* as,
                                const void* bc, const void* bs,
                                const long long* bst, const void* rr,
                                const void* ri, const long long* rst,
                                const void* w, long long w_stride,
                                long long F, int B, int J, int R, int paths,
                                void* stream) {
  return fold<double>(accr, acci, as, bc, bs, bst, rr, ri, rst, w, w_stride,
                      F, B, J, R, paths, stream);
}

// The engine's tile (cgemm.cuh `engine_tile`) for f32 (f64 = 0) or f64:
// out[0..5] = BM, BN, RM, RN, stages, dynamic shared memory in bytes.
extern "C" void swiftly_fold_tile(int f64, long long* out) {
  if (f64) {
    swiftly::engine_tile<double>(out);
  } else {
    swiftly::engine_tile<float>(out);
  }
}

extern "C" const char* swiftly_fold_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
