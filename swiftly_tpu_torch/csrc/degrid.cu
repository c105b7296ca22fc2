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
// grid is deterministic, with no atomics, and its blocks own pixels: the
// plane is cut into kTile x kTile pixel tiles, one block of kTile^2 threads
// per tile and one pixel per thread. Each block walks the samples in input
// order, kTile^2 at a time: every thread tests one sample's patch against
// the tile (exactly: a patch is the product of its row set and its column
// set, each one or two bands after the negative-index rule), and a warp
// ballot and a prefix sum over the warps compact the samples that meet the
// tile, in order, into shared memory. Each thread then adds, for each kept
// sample in turn, that sample's taps on its own pixel. No two threads ever
// write one pixel, so there is no barrier per sample, and each pixel still
// receives its contributions in sample order (within a sample, in tap
// order (i, j): a pixel meets two taps of one sample only when the plane is
// narrower than the support). Taps outside the plane (after the same
// negative-index rule) are dropped, as JAX's scatter drops them. The
// products and the sum are rounded one by one (no contraction to FMA):
// y * (cu * cv) added to the pixel, the operations of the plain version
// (ops/kernels.py `grid_plain`, which adds in sample order too), so the two
// give the same bits. A tile that no sample meets exits after its scan.
//
// What bounded the earlier design on the H100: one block of W^2 threads per
// dispatch, one SM of 132 at work, and a barrier after every sample
// (~0.44 us a sample): 1.42-1.44 ms for a hot subgrid's 3268 samples at
// W = 8, 448^2 (chip_smoke.py phase 7 on an H100 80GB HBM3 at 700 W),
// against a bound of 0.0007 ms. Here 196 blocks share a 448^2 plane, each scans the
// dispatch's indices once (16 bytes a sample, from L2) and adds only the
// samples that meet its tile. One launch per dispatch stays: its caller,
// vis/grid.py, is unchanged.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;  // degrid: samples per block
constexpr int kTile = 32;          // grid: pixel tiles of kTile^2
constexpr int kGridThreads = kTile * kTile;  // one pixel each

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

// Whether a patch whose first tap is at index i0 (W taps) reaches any of
// the indices [lo, hi) of an axis of length n, by JAX's rule: taps with
// i0 + t >= 0 stay at i0 + t, the rest count once from the end, n + i0 + t;
// indices outside [0, n) after that are dropped.
__device__ __forceinline__ bool band_meets(int64_t i0, int W, int n, int lo,
                                           int hi) {
  const int64_t a = i0 > 0 ? i0 : 0;
  const int64_t b = i0 + W < n ? i0 + W : n;
  if (a < b && a < hi && b > lo) return true;
  if (i0 >= 0) return false;
  const int64_t wa = n + i0 > 0 ? n + i0 : 0;
  const int64_t wb = i0 + W < 0 ? n + i0 + W : n;
  return wa < wb && wa < hi && wb > lo;
}

template <typename T>
__global__ void __launch_bounds__(kGridThreads)
grid_kernel(T* ar, T* ai, int64_t s0, int64_t s1, int H, int Wd,
            const int64_t* __restrict__ iu0, const int64_t* __restrict__ iv0,
            const T* __restrict__ cu, const T* __restrict__ cv,
            const T* __restrict__ yr, const T* __restrict__ yi, int64_t B,
            int W) {
  // the samples of one chunk that meet this tile, in input order; their
  // first taps fit in int: a patch that meets the plane starts in (-n-W, n)
  __shared__ int k_u0[kGridThreads];
  __shared__ int k_v0[kGridThreads];
  __shared__ int k_b[kGridThreads];
  __shared__ T k_yr[kGridThreads];
  __shared__ T k_yi[kGridThreads];
  __shared__ int warp_first[kGridThreads / kWarp];
  __shared__ int kept;

  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid >> 5;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  const int u = r0 + tid / kTile;
  const int v = c0 + tid % kTile;
  const bool inside = u < H && v < Wd;
  const int r1 = min(r0 + kTile, H);
  const int c1 = min(c0 + kTile, Wd);
  const int64_t off = static_cast<int64_t>(u) * s0 + static_cast<int64_t>(v) * s1;
  T accr = T(0);
  T acci = T(0);
  bool touched = false;

  for (int64_t base = 0; base < B; base += kGridThreads) {
    const int64_t b = base + tid;
    int64_t su = 0, sv = 0;
    bool meets = false;
    if (b < B) {
      su = iu0[b];
      sv = iv0[b];
      meets = band_meets(su, W, H, r0, r1) && band_meets(sv, W, Wd, c0, c1);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, meets);
    if (lane == 0) warp_first[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {  // exclusive prefix sum of the warps' counts
      const int count = warp_first[lane];
      int incl = count;
#pragma unroll
      for (int o = 1; o < kWarp; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      warp_first[lane] = incl - count;
      if (lane == kWarp - 1) kept = incl;
    }
    __syncthreads();
    if (meets) {
      const int at = warp_first[warp] + __popc(ballot & ((1u << lane) - 1u));
      k_u0[at] = static_cast<int>(su);
      k_v0[at] = static_cast<int>(sv);
      k_b[at] = tid;
      k_yr[at] = yr[b];
      k_yi[at] = yi[b];
    }
    __syncthreads();
    const int n = kept;
    if (inside) {
      for (int k = 0; k < n; ++k) {
        // the taps (i, j) of sample k on this pixel: i = u - u0 (direct)
        // or u - H - u0 (wrapped from a negative index); the wrapped one
        // is the smaller, so taking it first keeps tap order
        const int64_t du = static_cast<int64_t>(u) - k_u0[k];
        const int64_t dv = static_cast<int64_t>(v) - k_v0[k];
        const bool iw = static_cast<uint64_t>(du - H) < static_cast<uint64_t>(W);
        const bool id = static_cast<uint64_t>(du) < static_cast<uint64_t>(W);
        const bool jw = static_cast<uint64_t>(dv - Wd) < static_cast<uint64_t>(W);
        const bool jd = static_cast<uint64_t>(dv) < static_cast<uint64_t>(W);
        if (!((iw || id) && (jw || jd))) continue;
        if (!touched) {
          accr = ar[off];
          acci = ai[off];
          touched = true;
        }
        const int64_t bk = base + k_b[k];
        const T* cub = cu + bk * W;
        const T* cvb = cv + bk * W;
        const T y_r = k_yr[k];
        const T y_i = k_yi[k];
#pragma unroll
        for (int ci = 0; ci < 2; ++ci) {
          if (!(ci == 0 ? iw : id)) continue;
          const int i = static_cast<int>(ci == 0 ? du - H : du);
#pragma unroll
          for (int cj = 0; cj < 2; ++cj) {
            if (!(cj == 0 ? jw : jd)) continue;
            const int j = static_cast<int>(cj == 0 ? dv - Wd : dv);
            const T w = mul_rn(cub[i], cvb[j]);
            accr = add_rn(accr, mul_rn(y_r, w));
            acci = add_rn(acci, mul_rn(y_i, w));
          }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites the kept samples
  }
  if (touched) {
    ar[off] = accr;
    ai[off] = acci;
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
  if (B <= 0 || W <= 0 || H <= 0 || Wd <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 tiles((Wd + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  if (tiles.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  grid_kernel<T><<<tiles, kGridThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
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
