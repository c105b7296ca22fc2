// Visibility degrid (kernel B4) and its exact adjoint, grid, for Hopper
// (sm_90a).
//
//   degrid:  vis[b] = sum_ij row[u0_b + i, v0_b + j] * cu[b, i] * cv[b, j]
//            for the real and the imaginary plane of a served subgrid row
//   grid:    acc[u0_b + i, v0_b + j] += y[b] * cu[b, i] * cv[b, j]
//            in place, for both planes, samples b in input order
//
//   row / acc: [H, Wd] planes given by element strides (s0, s1), e.g. the
//   two planes of an interleaved [xA, xA, 2] tensor; iu0, iv0: [B] int64
//   first-tap indices; cu, cv: [B, W] contiguous tap weights; vis, y: [B].
//
// Replaces: swiftly_tpu/vis/degrid.py:71 `_degrid_fn`, its `use_pallas`
// branch (kernel body :97, pl.pallas_call :109), which reduces patches the
// caller gathered into [B, W, W] arrays first, one dispatch per served
// subgrid. `grid` is the port of the scatter-add adjoint
// swiftly_tpu/vis/grid.py:42 `_grid_fn` (`.at[idx].add` :53), not a TPU
// kernel. Here the wrappers are swiftly_tpu_torch/ops/kernels.py
// `degrid_rows` (a serving pump), `degrid` (one row, weights given) and
// `grid`.
//
// What bounds degrid on an H100: almost nothing on the device. A sample at
// W = 8 does 5*W^2 flops and needs at most W^2 pixels of its row (read
// through L2) and a few words of indices: a serving pump of ~10^2-10^3
// samples is microseconds at 3.35 TB/s, so a launch costs its launch
// latency. What bounded the serving path was the host around it: one
// launch per served subgrid (80,074 for 2^20 samples at 32k, 13 samples
// each), each after numpy tap weights, two pageable uploads and a copy back
// that waited for the device.
//
// Design. degrid_rows answers every sample of a serving pump in one
// launch, over G rows (the pump's subgrids) read where they lie through a
// descriptor table (two plane addresses, strides and shape a row: device
// rows of the compute path, interleaved [xA, xA, 2] rows, a complex row's
// real and imaginary views). The descriptors and each sample's row slot,
// first taps and f64 fractions arrive in one buffer, one upload. The tap
// weights are computed here from the kernel's [oversample + 1, W] f64
// table, staged in shared memory once a block, with the host's operations
// in the host's order, each rounded once (tap_weights), so the weights
// are the host's bits. Then one warp answers one sample as before: the
// gather fused (neither the [B, W, W] patches nor the weight plane exist
// in device memory), lane l takes taps t = l, l + 32, ... of the W^2 taps
// with one FMA per plane, and a fixed xor-shuffle tree sums the 32 lanes.
// Which taps a lane takes and the order of every sum depend on W alone,
// never on B, G, the sample's row slot or its place in the pump, so a
// sample's bits do not depend on how its requests were coalesced or
// pumped, and identical rows give identical samples whether they came
// from the cache or were computed. `degrid` (one row, the weights given as
// [B, W] arrays) runs the same reduction, degrid_sample. Indices follow
// JAX's rules: a negative one counts once from the end, and the gather
// clamps the rest to the row.
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
constexpr long long kMaxSmem = 232448;  // a block's shared memory on Hopper
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

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float from_f64(double x, float) {
  return __double2float_rn(x);
}
__device__ __forceinline__ double from_f64(double x, double) { return x; }

// The W tap weights of a sub-pixel fraction, from the [oversample + 1, W]
// f64 table, as vis/kernel.py `VisKernel.weights(frac, float64)` computes
// them on the host, then rounded to T: a = clip(frac, 0, nextafter(1, 0))
// * oversample (numpy's clip: max first, then min), i0 = trunc(a),
// t = a - i0, w = table[i0] * (1 - t) + table[i0 + 1] * t, every operation
// rounded once (no contraction to FMA), so the bits are the host's. The
// wrapper refuses non-finite fractions and a table whose largest lookup
// would read past its last row (ops/kernels.py `check_tap_table`), so
// i0 + 1 <= oversample. Lanes l, l + 32, ... write weight l into `w`.
template <typename T>
__device__ __forceinline__ void tap_weights(double frac,
                                            const double* __restrict__ table,
                                            int oversample, int W, int lane,
                                            T* w) {
  const double hi = 0x1.fffffffffffffp-1;  // nextafter(1.0, 0.0)
  double c = frac > 0.0 ? frac : 0.0;
  c = c < hi ? c : hi;
  const double a = __dmul_rn(c, static_cast<double>(oversample));
  const int i0 = static_cast<int>(a);  // a >= 0: truncation is the floor
  const double t = __dsub_rn(a, static_cast<double>(i0));
  const double s = __dsub_rn(1.0, t);
  const double* lo = table + static_cast<int64_t>(i0) * W;
  for (int i = lane; i < W; i += kWarp)
    w[i] = from_f64(__dadd_rn(__dmul_rn(lo[i], s), __dmul_rn(lo[W + i], t)),
                    T());
}

// One sample's reduction, by one warp: lane l takes taps t = l, l + 32, ...
// of the W^2 taps (i = t / W, j = t % W) in ascending t, each adding
// row * (cu[i] * cv[j]) with one FMA per plane, then a fixed xor-shuffle
// tree sums the 32 lanes. The order of every operation depends on W alone.
template <typename T>
__device__ __forceinline__ void degrid_sample(
    const T* __restrict__ rr, const T* __restrict__ ri, int64_t s0,
    int64_t s1, int H, int Wd, int64_t u0, int64_t v0, const T* cu,
    const T* cv, int W, int lane, T* vr, T* vi) {
  T sr = T(0);
  T si = T(0);
  const int taps = W * W;
  for (int t = lane; t < taps; t += kWarp) {
    const int i = t / W;
    const int j = t - i * W;
    const int64_t off =
        clamp_index(u0 + i, H) * s0 + clamp_index(v0 + j, Wd) * s1;
    const T w = mul_rn(cu[i], cv[j]);
    sr = fma_rn(__ldg(rr + off), w, sr);
    si = fma_rn(__ldg(ri + off), w, si);
  }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    sr = add_rn(sr, __shfl_xor_sync(0xffffffffu, sr, o));
    si = add_rn(si, __shfl_xor_sync(0xffffffffu, si, o));
  }
  if (lane == 0) {
    *vr = sr;
    *vi = si;
  }
}

// The words of one row's descriptor in a pump's table (int64 each): the
// real plane's and the imaginary plane's addresses, their element strides
// (s0, s1, shared) and their shape (H, W').
constexpr int kRowWords = 6;

// degrid with the weights given: one row, [B, W] weights cu, cv.
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
  degrid_sample(rr, ri, s0, s1, H, Wd, iu0[b], iv0[b], cu + b * W,
                cv + b * W, W, lane, vr + b, vi + b);
}

// degrid over a pump: G rows by descriptor, each sample's row slot, first
// taps and fractions, the weights computed here from the table. `pump`
// holds, as int64 words: the [G, kRowWords] descriptors, then slot[B],
// iu0[B], iv0[B], and fu[B], fv[B] as f64 bits. Dynamic shared memory: the
// table, then 2 W weights a warp.
template <typename T>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
degrid_rows_kernel(const int64_t* __restrict__ pump, int64_t G, int64_t B,
                   int W, const double* __restrict__ table, int oversample,
                   T* __restrict__ vr, T* __restrict__ vi) {
  extern __shared__ double smem[];
  const int n_table = (oversample + 1) * W;
  for (int k = threadIdx.x; k < n_table; k += blockDim.x)
    smem[k] = __ldg(table + k);
  __syncthreads();
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x >> 5;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  if (b >= B) return;  // b is the same for the whole warp
  const int64_t* slot = pump + G * kRowWords;
  const int64_t* iu0 = slot + B;
  const int64_t* iv0 = iu0 + B;
  const double* fu = reinterpret_cast<const double*>(iv0 + B);
  const double* fv = fu + B;
  T* cu = reinterpret_cast<T*>(smem + n_table) + warp * 2 * W;
  T* cv = cu + W;
  tap_weights(fu[b], smem, oversample, W, lane, cu);
  tap_weights(fv[b], smem, oversample, W, lane, cv);
  __syncwarp();
  const int64_t* d = pump + slot[b] * kRowWords;
  degrid_sample(reinterpret_cast<const T*>(d[0]),
                reinterpret_cast<const T*>(d[1]), d[2], d[3],
                static_cast<int>(d[4]), static_cast<int>(d[5]), iu0[b],
                iv0[b], cu, cv, W, lane, vr + b, vi + b);
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

// Dynamic shared memory of degrid_rows_kernel<T>: the table and the warps'
// weights; 0 when it exceeds what a block may have.
template <typename T>
long long degrid_rows_smem(int W, int oversample) {
  const long long bytes =
      static_cast<long long>(oversample + 1) * W * sizeof(double) +
      static_cast<long long>(kWarpsPerBlock) * 2 * W * sizeof(T);
  return bytes <= kMaxSmem ? bytes : 0;
}

template <typename T>
int degrid_rows(const void* pump, long long G, long long B, int W,
                const void* table, int oversample, void* vr, void* vi,
                void* stream) {
  if (G <= 0 || B <= 0 || W <= 0 || oversample <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const long long smem = degrid_rows_smem<T>(W, oversample);
  if (blocks > 0x7fffffffLL || smem == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        degrid_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  degrid_rows_kernel<T><<<static_cast<unsigned>(blocks),
                          kWarp * kWarpsPerBlock, static_cast<size_t>(smem),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(pump), G, B, W,
      static_cast<const double*>(table), oversample, static_cast<T*>(vr),
      static_cast<T*>(vi));
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

extern "C" int swiftly_degrid_rows_f32(const void* pump, long long G,
                                       long long B, int W, const void* table,
                                       int oversample, void* vr, void* vi,
                                       void* stream) {
  return degrid_rows<float>(pump, G, B, W, table, oversample, vr, vi, stream);
}

extern "C" int swiftly_degrid_rows_f64(const void* pump, long long G,
                                       long long B, int W, const void* table,
                                       int oversample, void* vr, void* vi,
                                       void* stream) {
  return degrid_rows<double>(pump, G, B, W, table, oversample, vr, vi,
                             stream);
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
