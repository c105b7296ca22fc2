// Native (host C++) kernels for the streaming distributed Fourier transform.
//
// The port's copy of the JAX package's `swiftly_tpu/native/swiftly_native.cpp`
// (the same code; `swiftly_tpu_torch/native/__init__.py` builds it with the
// same g++ flags into `swiftly_tpu_torch/_build/`). Role parity with the
// external `ska-sdp-func` C library (its `Swiftly` class): an opaque handle
// holding the configuration + window constants, and the eight streaming-FT
// primitives operating on caller-provided complex128 buffers, with
// accumulate (+=) semantics where the dataflow sums contributions.
// Implemented from scratch — self-contained FFT (iterative radix-2 for
// power-of-two sizes, Bluestein chirp-z for the rest), OpenMP lane
// parallelism, no external dependencies.
//
// Array model: every per-axis operation sees its operand as [pre, n, post]
// — a bundle of pre*post independent lanes of length n strided by `post`.
// The Python wrapper maps (ndim, axis) onto that decomposition, so 1D and
// 2D arrays and both axes share one code path.
//
// All offsets use floor division/modulo (Python semantics), so negative
// offsets behave identically to the numpy backend.

#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

using cplx = std::complex<double>;
using std::int64_t;

namespace {

constexpr double PI = 3.141592653589793238462643383279502884;

int64_t floordiv(int64_t a, int64_t b) {
    int64_t q = a / b;
    if ((a % b) != 0 && ((a < 0) != (b < 0))) --q;
    return q;
}

int64_t pmod(int64_t a, int64_t n) {
    int64_t r = a % n;
    return r < 0 ? r + n : r;
}

bool is_pow2(int64_t n) { return n > 0 && (n & (n - 1)) == 0; }

int64_t next_pow2(int64_t n) {
    int64_t p = 1;
    while (p < n) p <<= 1;
    return p;
}

// ---------------------------------------------------------------------------
// FFT plans
// ---------------------------------------------------------------------------

// Radix-2 plan: bit-reversal permutation + per-stage twiddle tables.
struct Radix2Plan {
    int64_t n;
    std::vector<int64_t> rev;
    std::vector<cplx> twiddle;  // exp(-2*pi*i*k/n) for k in [0, n/2)

    explicit Radix2Plan(int64_t n_) : n(n_), rev(n_), twiddle(n_ / 2) {
        int log2n = 0;
        while ((int64_t(1) << log2n) < n) ++log2n;
        for (int64_t i = 0; i < n; ++i) {
            int64_t r = 0;
            for (int b = 0; b < log2n; ++b)
                if (i & (int64_t(1) << b)) r |= int64_t(1) << (log2n - 1 - b);
            rev[i] = r;
        }
        for (int64_t k = 0; k < n / 2; ++k)
            twiddle[k] = std::polar(1.0, -2.0 * PI * double(k) / double(n));
    }

    // In-place DFT of contiguous data; sign=-1 forward, +1 inverse
    // (unnormalised — caller divides by n for the inverse).
    void run(cplx* a, int sign) const {
        for (int64_t i = 0; i < n; ++i) {
            int64_t j = rev[i];
            if (i < j) std::swap(a[i], a[j]);
        }
        for (int64_t len = 2; len <= n; len <<= 1) {
            int64_t half = len >> 1, step = n / len;
            for (int64_t base = 0; base < n; base += len) {
                for (int64_t k = 0; k < half; ++k) {
                    cplx w = twiddle[k * step];
                    if (sign > 0) w = std::conj(w);
                    cplx u = a[base + k];
                    cplx v = a[base + k + half] * w;
                    a[base + k] = u + v;
                    a[base + k + half] = u - v;
                }
            }
        }
    }
};

// Bluestein chirp-z plan for arbitrary n: linear convolution with the
// chirp via a power-of-two cyclic FFT of size M >= 2n-1.
struct BluesteinPlan {
    int64_t n, M;
    Radix2Plan fftM;
    std::vector<cplx> chirp;      // u[j] = exp(-i*pi*j^2/n)  (forward sign)
    std::vector<cplx> kernel_fft; // FFT of the wrapped conjugate chirp

    explicit BluesteinPlan(int64_t n_)
        : n(n_), M(next_pow2(2 * n_ - 1)), fftM(M), chirp(n_) {
        for (int64_t j = 0; j < n; ++j) {
            // j^2 mod 2n keeps the phase argument small and exact
            int64_t m = (j * j) % (2 * n);
            chirp[j] = std::polar(1.0, -PI * double(m) / double(n));
        }
        std::vector<cplx> b(M, cplx(0, 0));
        for (int64_t j = 0; j < n; ++j) {
            cplx c = std::conj(chirp[j]);
            b[j] = c;
            if (j > 0) b[M - j] = c;
        }
        fftM.run(b.data(), -1);
        kernel_fft = std::move(b);
    }

    // Transform contiguous data of length n using caller scratch (size M).
    void run(cplx* a, int sign, cplx* scratch) const {
        for (int64_t j = 0; j < n; ++j) {
            cplx u = sign < 0 ? chirp[j] : std::conj(chirp[j]);
            scratch[j] = a[j] * u;
        }
        std::memset(reinterpret_cast<void*>(scratch + n), 0,
                    sizeof(cplx) * size_t(M - n));
        fftM.run(scratch, -1);
        if (sign < 0) {
            for (int64_t j = 0; j < M; ++j) scratch[j] *= kernel_fft[j];
        } else {
            for (int64_t j = 0; j < M; ++j)
                scratch[j] *= std::conj(kernel_fft[j]);
        }
        fftM.run(scratch, +1);
        double inv = 1.0 / double(M);  // unnormalised inverse above
        for (int64_t k = 0; k < n; ++k) {
            cplx u = sign < 0 ? chirp[k] : std::conj(chirp[k]);
            a[k] = scratch[k] * u * inv;
        }
    }
};

struct FftPlan {
    int64_t n;
    std::unique_ptr<Radix2Plan> r2;
    std::unique_ptr<BluesteinPlan> blu;

    explicit FftPlan(int64_t n_) : n(n_) {
        if (is_pow2(n))
            r2 = std::make_unique<Radix2Plan>(n);
        else
            blu = std::make_unique<BluesteinPlan>(n);
    }

    int64_t scratch_size() const { return blu ? blu->M : 0; }

    void run(cplx* a, int sign, cplx* scratch) const {
        if (r2)
            r2->run(a, sign);
        else
            blu->run(a, sign, scratch);
    }
};

// ---------------------------------------------------------------------------
// Handle
// ---------------------------------------------------------------------------

struct Swiftly {
    int64_t N, xM, yN, m;              // m = contribution size xM*yN/N
    std::vector<double> Fb;            // size yN-1 (reciprocal PSWF)
    std::vector<double> Fn;            // size m (subsampled PSWF)
    std::map<int64_t, std::unique_ptr<FftPlan>> plans;
    std::mutex plan_mutex;

    const FftPlan& plan(int64_t n) {
        std::lock_guard<std::mutex> lock(plan_mutex);
        auto it = plans.find(n);
        if (it == plans.end())
            it = plans.emplace(n, std::make_unique<FftPlan>(n)).first;
        return *it->second;
    }
};

// Per-lane worker: gathers a strided lane into contiguous scratch, applies
// a centred (fftshift) FFT, and scatters results back with wrap-around.
struct Lane {
    std::vector<cplx> buf, fft_scratch;

    void ensure(int64_t n, int64_t scratch) {
        if (int64_t(buf.size()) < n) buf.resize(n);
        if (int64_t(fft_scratch.size()) < scratch) fft_scratch.resize(scratch);
    }

    // Centred transform of buf[0:n]: fftshift(fft(ifftshift(x))). The
    // shifts are index rotations folded into a rotate-copy.
    void centred_fft(const FftPlan& p, int64_t n, int sign) {
        ensure(2 * n, p.scratch_size());
        cplx* tmp = buf.data() + n;
        int64_t h = n / 2;
        for (int64_t j = 0; j < n; ++j) tmp[j] = buf[(j + h) % n];
        p.run(tmp, sign, fft_scratch.data());
        if (sign > 0) {
            double inv = 1.0 / double(n);
            for (int64_t j = 0; j < n; ++j) tmp[j] *= inv;
        }
        for (int64_t j = 0; j < n; ++j) buf[(j + h) % n] = tmp[j];
    }
};

// Iterate lanes of [pre, n, post] in parallel; `fn(lane, in_lane, out_lane)`.
template <typename F>
void for_lanes(int64_t pre, int64_t post, const cplx* in, cplx* out,
               int64_t n_in, int64_t n_out, F&& fn) {
#if defined(_OPENMP)
#pragma omp parallel
    {
        Lane lane;
#pragma omp for collapse(2) schedule(static)
        for (int64_t i = 0; i < pre; ++i)
            for (int64_t k = 0; k < post; ++k)
                fn(lane, in + (i * n_in) * post + k,
                   out + (i * n_out) * post + k);
    }
#else
    Lane lane;
    for (int64_t i = 0; i < pre; ++i)
        for (int64_t k = 0; k < post; ++k)
            fn(lane, in + (i * n_in) * post + k,
               out + (i * n_out) * post + k);
#endif
}

}  // namespace

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

extern "C" {

void* sw_create(int64_t N, int64_t xM, int64_t yN, const double* fb,
                const double* fn) {
    if (N <= 0 || xM <= 0 || yN <= 0 || N % xM || N % yN ||
        (xM * yN) % N)
        return nullptr;
    auto* h = new Swiftly;
    h->N = N;
    h->xM = xM;
    h->yN = yN;
    h->m = xM * yN / N;
    h->Fb.assign(fb, fb + (yN - 1));
    h->Fn.assign(fn, fn + h->m);
    return h;
}

void sw_destroy(void* handle) { delete static_cast<Swiftly*>(handle); }

// facet[nF] * Fb window, embedded at facet_off in the yN frame, centred iFFT.
// In: [pre, nF, post] -> out: [pre, yN, post].
void sw_prepare_facet(void* handle, const double* in, double* out,
                      int64_t pre, int64_t nF, int64_t post,
                      int64_t facet_off) {
    auto* h = static_cast<Swiftly*>(handle);
    const int64_t yN = h->yN;
    const int64_t fb0 = (yN - 1) / 2 - nF / 2;  // extract_mid of Fb
    const int64_t emb0 = yN / 2 - nF / 2 + facet_off;
    const auto& plan = h->plan(yN);
    for_lanes(pre, post, reinterpret_cast<const cplx*>(in),
              reinterpret_cast<cplx*>(out), nF, yN,
              [&](Lane& lane, const cplx* src, cplx* dst) {
                  lane.ensure(2 * yN, plan.scratch_size());
                  std::fill(lane.buf.begin(), lane.buf.begin() + yN,
                            cplx(0, 0));
                  for (int64_t j = 0; j < nF; ++j)
                      lane.buf[pmod(emb0 + j, yN)] =
                          src[j * post] * h->Fb[fb0 + j];
                  lane.centred_fft(plan, yN, +1);
                  for (int64_t j = 0; j < yN; ++j) dst[j * post] = lane.buf[j];
              });
}

// Gather the m-sized contribution window of a prepared facet for one
// subgrid offset. In: [pre, yN, post] -> out: [pre, m, post].
void sw_extract_from_facet(void* handle, const double* in, double* out,
                           int64_t pre, int64_t post, int64_t subgrid_off) {
    auto* h = static_cast<Swiftly*>(handle);
    const int64_t yN = h->yN, m = h->m;
    const int64_t scaled = floordiv(subgrid_off * yN, h->N);
    const int64_t src0 = yN / 2 - m / 2 + scaled;
    for_lanes(pre, post, reinterpret_cast<const cplx*>(in),
              reinterpret_cast<cplx*>(out), yN, m,
              [&](Lane&, const cplx* src, cplx* dst) {
                  for (int64_t j = 0; j < m; ++j)
                      dst[pmod(j + scaled, m) * post] =
                          src[pmod(src0 + j, yN) * post];
              });
}

// Contribution -> padded-subgrid summand: centred FFT, roll by -scaled,
// Fn window, embed at +scaled; ACCUMULATES into out.
// In: [pre, m, post] -> out (+=): [pre, xM, post].
void sw_add_to_subgrid(void* handle, const double* in, double* out,
                       int64_t pre, int64_t post, int64_t facet_off) {
    auto* h = static_cast<Swiftly*>(handle);
    const int64_t xM = h->xM, m = h->m;
    const int64_t scaled = floordiv(facet_off * xM, h->N);
    const int64_t emb0 = xM / 2 - m / 2 + scaled;
    const auto& plan = h->plan(m);
    for_lanes(pre, post, reinterpret_cast<const cplx*>(in),
              reinterpret_cast<cplx*>(out), m, xM,
              [&](Lane& lane, const cplx* src, cplx* dst) {
                  lane.ensure(2 * m, plan.scratch_size());
                  for (int64_t j = 0; j < m; ++j) lane.buf[j] = src[j * post];
                  lane.centred_fft(plan, m, -1);
                  for (int64_t j = 0; j < m; ++j)
                      dst[pmod(emb0 + j, xM) * post] +=
                          lane.buf[pmod(j + scaled, m)] * h->Fn[j];
              });
}

// One axis of finish_subgrid: centred iFFT then wrapped extract of the
// true subgrid window. In: [pre, xM, post] -> out: [pre, sg_size, post].
void sw_finish_subgrid_axis(void* handle, const double* in, double* out,
                            int64_t pre, int64_t post, int64_t subgrid_off,
                            int64_t sg_size) {
    auto* h = static_cast<Swiftly*>(handle);
    const int64_t xM = h->xM;
    const int64_t src0 = xM / 2 - sg_size / 2 + subgrid_off;
    const auto& plan = h->plan(xM);
    for_lanes(pre, post, reinterpret_cast<const cplx*>(in),
              reinterpret_cast<cplx*>(out), xM, sg_size,
              [&](Lane& lane, const cplx* src, cplx* dst) {
                  lane.ensure(2 * xM, plan.scratch_size());
                  for (int64_t j = 0; j < xM; ++j) lane.buf[j] = src[j * post];
                  lane.centred_fft(plan, xM, +1);
                  for (int64_t j = 0; j < sg_size; ++j)
                      dst[j * post] = lane.buf[pmod(src0 + j, xM)];
              });
}

// One axis of prepare_subgrid: wrapped embed at the subgrid offset, then
// centred FFT. In: [pre, sg_size, post] -> out: [pre, xM, post].
void sw_prepare_subgrid_axis(void* handle, const double* in, double* out,
                             int64_t pre, int64_t post, int64_t subgrid_off,
                             int64_t sg_size) {
    auto* h = static_cast<Swiftly*>(handle);
    const int64_t xM = h->xM;
    const int64_t emb0 = xM / 2 - sg_size / 2 + subgrid_off;
    const auto& plan = h->plan(xM);
    for_lanes(pre, post, reinterpret_cast<const cplx*>(in),
              reinterpret_cast<cplx*>(out), sg_size, xM,
              [&](Lane& lane, const cplx* src, cplx* dst) {
                  lane.ensure(2 * xM, plan.scratch_size());
                  std::fill(lane.buf.begin(), lane.buf.begin() + xM,
                            cplx(0, 0));
                  for (int64_t j = 0; j < sg_size; ++j)
                      lane.buf[pmod(emb0 + j, xM)] = src[j * post];
                  lane.centred_fft(plan, xM, -1);
                  for (int64_t j = 0; j < xM; ++j) dst[j * post] = lane.buf[j];
              });
}

// Windowed contribution of a prepared subgrid to one facet: gather the m
// window at scaled offset, Fn multiply, roll back, centred iFFT.
// In: [pre, xM, post] -> out: [pre, m, post].
void sw_extract_from_subgrid(void* handle, const double* in, double* out,
                             int64_t pre, int64_t post, int64_t facet_off) {
    auto* h = static_cast<Swiftly*>(handle);
    const int64_t xM = h->xM, m = h->m;
    const int64_t scaled = floordiv(facet_off * xM, h->N);
    const int64_t src0 = xM / 2 - m / 2 + scaled;
    const auto& plan = h->plan(m);
    for_lanes(pre, post, reinterpret_cast<const cplx*>(in),
              reinterpret_cast<cplx*>(out), xM, m,
              [&](Lane& lane, const cplx* src, cplx* dst) {
                  lane.ensure(2 * m, plan.scratch_size());
                  for (int64_t j = 0; j < m; ++j)
                      lane.buf[pmod(j + scaled, m)] =
                          src[pmod(src0 + j, xM) * post] * h->Fn[j];
                  lane.centred_fft(plan, m, +1);
                  for (int64_t j = 0; j < m; ++j) dst[j * post] = lane.buf[j];
              });
}

// Subgrid contribution -> padded-facet summand: roll to centre, embed at
// the scaled subgrid offset; ACCUMULATES into out.
// In: [pre, m, post] -> out (+=): [pre, yN, post].
void sw_add_to_facet(void* handle, const double* in, double* out,
                     int64_t pre, int64_t post, int64_t subgrid_off) {
    auto* h = static_cast<Swiftly*>(handle);
    const int64_t yN = h->yN, m = h->m;
    const int64_t scaled = floordiv(subgrid_off * yN, h->N);
    const int64_t emb0 = yN / 2 - m / 2 + scaled;
    for_lanes(pre, post, reinterpret_cast<const cplx*>(in),
              reinterpret_cast<cplx*>(out), m, yN,
              [&](Lane&, const cplx* src, cplx* dst) {
                  for (int64_t j = 0; j < m; ++j)
                      dst[pmod(emb0 + j, yN) * post] +=
                          src[pmod(j + scaled, m) * post];
              });
}

// One axis of finish_facet: centred FFT, wrapped extract of the facet
// window, Fb correction. In: [pre, yN, post] -> out: [pre, f_size, post].
void sw_finish_facet_axis(void* handle, const double* in, double* out,
                          int64_t pre, int64_t post, int64_t facet_off,
                          int64_t f_size) {
    auto* h = static_cast<Swiftly*>(handle);
    const int64_t yN = h->yN;
    const int64_t fb0 = (yN - 1) / 2 - f_size / 2;
    const int64_t src0 = yN / 2 - f_size / 2 + facet_off;
    const auto& plan = h->plan(yN);
    for_lanes(pre, post, reinterpret_cast<const cplx*>(in),
              reinterpret_cast<cplx*>(out), yN, f_size,
              [&](Lane& lane, const cplx* src, cplx* dst) {
                  lane.ensure(2 * yN, plan.scratch_size());
                  for (int64_t j = 0; j < yN; ++j) lane.buf[j] = src[j * post];
                  lane.centred_fft(plan, yN, -1);
                  for (int64_t j = 0; j < f_size; ++j)
                      dst[j * post] = lane.buf[pmod(src0 + j, yN)] *
                                      h->Fb[fb0 + j];
              });
}

// Fused 2D fast path (parity: the external library's add_to_subgrid_2d):
// both axes of the contribution -> padded-subgrid transform in one call,
// no intermediate crossing the language boundary.
// In: [m, m] -> out (+=): [xM, xM].
void sw_add_to_subgrid_2d(void* handle, const double* in, double* out,
                          int64_t facet_off0, int64_t facet_off1) {
    auto* h = static_cast<Swiftly*>(handle);
    const int64_t xM = h->xM, m = h->m;
    std::vector<cplx> mid(size_t(xM) * m);
    sw_add_to_subgrid(handle, in, reinterpret_cast<double*>(mid.data()),
                      /*pre=*/1, /*post=*/m, facet_off0);
    sw_add_to_subgrid(handle, reinterpret_cast<const double*>(mid.data()),
                      out, /*pre=*/xM, /*post=*/1, facet_off1);
}

int sw_num_threads() {
#if defined(_OPENMP)
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
