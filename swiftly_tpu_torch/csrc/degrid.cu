// Visibility degrid (kernel B4) and its exact adjoint, grid, for Hopper
// (sm_90a).
//
//   degrid:  vis[b] = sum_ij row[u0_b + i, v0_b + j] * cu[b, i] * cv[b, j]
//            for the real and the imaginary plane of one served subgrid row
//   grid:    acc[u0_b + i, v0_b + j] += y[b] * cu[b, i] * cv[b, j]
//            in place, for both planes, samples b in input order
//
//   row / acc: [H, Wd] planes given by element strides (s0, s1), e.g. the
//   two planes of an interleaved [xA, xA, 2] tensor; iu0, iv0: [B] int64
//   first-tap indices; cu, cv: [B, W] contiguous tap weights; vis, y: [B].
//
// Replaces: swiftly_tpu/vis/degrid.py:71 `_degrid_fn`, its `use_pallas`
// branch (kernel body :97, pl.pallas_call :109), which reduces patches the
// caller gathered into [B, W, W] arrays first. `grid` is the port of the
// scatter-add adjoint swiftly_tpu/vis/grid.py:42 `_grid_fn` (`.at[idx].add`
// :53), not a TPU kernel. Here the wrappers are
// swiftly_tpu_torch/ops/kernels.py `degrid` and `grid`.
//
// What bounds them on an H100: almost nothing. A dispatch of B samples at
// W = 8 does 5*W^2*B flops and needs the distinct patch pixels of one
// 448^2 row (at most 1.6 MB, read through L2) plus 2*(W + 1)*B weights and
// indices: microseconds at 3.35 TB/s, so each launch is bound by its own
// launch latency and the serving path by the host that prepares it.
//
// Design. degrid fuses the gather: it reads the row where it lies, by
// strides, so neither the [B, W, W] patches nor the weight plane exist in
// device memory (the Pallas kernel takes pre-gathered patches). One warp
// answers one sample: lane l takes taps t = l, l + 32, ... of the W^2 taps
// (i = t / W, j = t % W), accumulating row * (cu[i] * cv[j]) in ascending
// t, and a fixed xor-shuffle tree sums the 32 lanes. Which taps a lane
// takes and the order of every sum depend on W alone, never on B or on the
// sample's place in the batch, so a sample's bits do not depend on how its
// batch was coalesced, and identical rows give identical samples whether
// they came from the cache or were computed. Indices follow JAX's rules:
// a negative one counts once from the end, and the gather clamps the rest
// to the row.
//
// grid is deterministic, with no atomics: one block per dispatch, thread t
// owning tap (t / W, t % W) of every sample, the samples taken in input
// order with a barrier between them, so each pixel receives its
// contributions in sample order. Taps outside the plane (after the same
// negative-index rule) are dropped, as JAX's scatter drops them; inside it
// the W^2 taps of one sample are distinct pixels, so no two threads touch
// one pixel between barriers. The products and the sum are rounded one by
// one (no contraction to FMA): y * (cu * cv) added to the pixel, the
// operations of the plain version (ops/kernels.py `grid_plain`, which adds
// in sample order too), so the two give the same bits. One block is slow
// for large dispatches (a barrier and a read-modify-write per sample): a
// faster deterministic design (blocks owning disjoint pixel tiles, or one
// launch over all subgrids of a batch) is left for a later version.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;  // degrid: samples per block
constexpr int kMaxSupport = 32;    // grid: W^2 <= 1024 threads

// JAX's index rules: a negative index counts once from the end; past
// that, a gather clamps to the row and a scatter drops the update.
__device__ __forceinline__ int64_t wrap_index(int64_t i, int n) {
  return i < 0 ? i + n : i;
}

__device__ __forceinline__ int64_t clamp_index(int64_t i, int n) {
  i = wrap_index(i, n);
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
degrid_kernel(const T* __restrict__ rr, const T* __restrict__ ri,
              int64_t s0, int64_t s1, int H, int Wd,
              const int64_t* __restrict__ iu0,
              const int64_t* __restrict__ iv0, const T* __restrict__ cu,
              const T* __restrict__ cv, T* __restrict__ vr,
              T* __restrict__ vi, int64_t B, int W) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // b is the same for the whole warp
  const int64_t u0 = iu0[b];
  const int64_t v0 = iv0[b];
  const T* cub = cu + b * W;
  const T* cvb = cv + b * W;
  T sr = T(0);
  T si = T(0);
  const int taps = W * W;
  for (int t = lane; t < taps; t += kWarp) {
    const int i = t / W;
    const int j = t - i * W;
    const int64_t off =
        clamp_index(u0 + i, H) * s0 + clamp_index(v0 + j, Wd) * s1;
    const T w = cub[i] * cvb[j];
    sr += rr[off] * w;
    si += ri[off] * w;
  }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    sr += __shfl_xor_sync(0xffffffffu, sr, o);
    si += __shfl_xor_sync(0xffffffffu, si, o);
  }
  if (lane == 0) {
    vr[b] = sr;
    vi[b] = si;
  }
}

template <typename T>
__global__ void grid_kernel(T* ar, T* ai, int64_t s0, int64_t s1, int H,
                            int Wd, const int64_t* __restrict__ iu0,
                            const int64_t* __restrict__ iv0,
                            const T* __restrict__ cu,
                            const T* __restrict__ cv,
                            const T* __restrict__ yr,
                            const T* __restrict__ yi, int64_t B, int W) {
  const int t = threadIdx.x;
  const int i = t / W;
  const int j = t - i * W;
  const bool mine = t < W * W;
  for (int64_t b = 0; b < B; ++b) {
    if (mine) {
      const int64_t u = wrap_index(iu0[b] + i, H);
      const int64_t v = wrap_index(iv0[b] + j, Wd);
      if (u >= 0 && u < H && v >= 0 && v < Wd) {
        const T w = mul_rn(cu[b * W + i], cv[b * W + j]);
        const int64_t off = u * s0 + v * s1;
        ar[off] = add_rn(ar[off], mul_rn(yr[b], w));
        ai[off] = add_rn(ai[off], mul_rn(yi[b], w));
      }
    }
    __syncthreads();  // the next sample may add to the same pixels
  }
}

template <typename T>
int degrid(const void* rr, const void* ri, long long s0, long long s1, int H,
           int Wd, const void* iu0, const void* iv0, const void* cu,
           const void* cv, void* vr, void* vi, long long B, int W,
           void* stream) {
  if (B <= 0 || W <= 0 || H <= 0 || Wd <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  degrid_kernel<T><<<static_cast<unsigned>(blocks), kWarp * kWarpsPerBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rr), static_cast<const T*>(ri), s0, s1, H, Wd,
      static_cast<const int64_t*>(iu0), static_cast<const int64_t*>(iv0),
      static_cast<const T*>(cu), static_cast<const T*>(cv),
      static_cast<T*>(vr), static_cast<T*>(vi), B, W);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int grid(void* ar, void* ai, long long s0, long long s1, int H, int Wd,
         const void* iu0, const void* iv0, const void* cu, const void* cv,
         const void* yr, const void* yi, long long B, int W, void* stream) {
  if (B <= 0 || W <= 0 || W > kMaxSupport || H <= 0 || Wd <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((W * W + kWarp - 1) / kWarp) * kWarp;
  grid_kernel<T><<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(ar), static_cast<T*>(ai), s0, s1, H, Wd,
      static_cast<const int64_t*>(iu0), static_cast<const int64_t*>(iv0),
      static_cast<const T*>(cu), static_cast<const T*>(cv),
      static_cast<const T*>(yr), static_cast<const T*>(yi), B, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Each returns cudaGetLastError()
// after the launch (0 on success); runs on `stream`, does not synchronise,
// allocates nothing. (s0, s1) are the element strides of both planes.
extern "C" int swiftly_degrid_f32(const void* rr, const void* ri,
                                  long long s0, long long s1, int H, int Wd,
                                  const void* iu0, const void* iv0,
                                  const void* cu, const void* cv, void* vr,
                                  void* vi, long long B, int W,
                                  void* stream) {
  return degrid<float>(rr, ri, s0, s1, H, Wd, iu0, iv0, cu, cv, vr, vi, B, W,
                       stream);
}

extern "C" int swiftly_degrid_f64(const void* rr, const void* ri,
                                  long long s0, long long s1, int H, int Wd,
                                  const void* iu0, const void* iv0,
                                  const void* cu, const void* cv, void* vr,
                                  void* vi, long long B, int W,
                                  void* stream) {
  return degrid<double>(rr, ri, s0, s1, H, Wd, iu0, iv0, cu, cv, vr, vi, B,
                        W, stream);
}

extern "C" int swiftly_grid_f32(void* ar, void* ai, long long s0,
                                long long s1, int H, int Wd, const void* iu0,
                                const void* iv0, const void* cu,
                                const void* cv, const void* yr,
                                const void* yi, long long B, int W,
                                void* stream) {
  return grid<float>(ar, ai, s0, s1, H, Wd, iu0, iv0, cu, cv, yr, yi, B, W,
                     stream);
}

extern "C" int swiftly_grid_f64(void* ar, void* ai, long long s0,
                                long long s1, int H, int Wd, const void* iu0,
                                const void* iv0, const void* cu,
                                const void* cv, const void* yr,
                                const void* yi, long long B, int W,
                                void* stream) {
  return grid<double>(ar, ai, s0, s1, H, Wd, iu0, iv0, cu, cv, yr, yi, B, W,
                      stream);
}

extern "C" const char* swiftly_degrid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
