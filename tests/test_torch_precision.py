"""The governed products' knobs, ``SWIFTLY_PRECISION`` and
``SWIFTLY_CMATMUL``, against the JAX package, plus the knob-parity table
and B1's tile record.

The port's ``highest`` is IEEE float32, ``default`` one TF32 pass and
``high`` three (on the CPU the TF32 passes' plain version: each operand
rounded to TF32, then an IEEE product). The JAX package on the CPU runs
every setting as float32 (XLA's CPU dot ignores the precision), so each
port setting is held to the JAX package's output within that setting's
relative-RMS budget (``PRECISION_RMS_BUDGET_REL``, bench.py's table), and
to the direct-DFT oracle within the same budget. Bounds:

* FFTs (n = 96 direct, n = 2048 factored), float64: 1e-9 absolute
  against numpy's FFT and 1e-12 against the JAX package (the reference
  test's bound; karatsuba at float64 rounds at ~1e-14);
* the same FFTs at float32 under each setting: the relative RMS against
  numpy's float64 FFT within the setting's budget, and `high` closer to it
  than `default`;
* the 1k sampled forward (f32): relative RMS (absolute RMS x N^2, the unit
  source's normalisation) against the oracle and against the JAX
  package's f32 forward within the budget; `highest` bit-equal to the
  same run with the governed products as direct ``torch`` calls.

Torch runs on one intra-op thread.
"""

import ast
import json
import functools
import re
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import swiftly_tpu as J
import swiftly_tpu_torch as T
from swiftly_tpu.ops import planar_backend as jplk
from swiftly_tpu.parallel import streamed as jstreamed
from swiftly_tpu_torch.ops import kernels
from swiftly_tpu_torch.ops import planar_backend as plk

ROOT = Path(__file__).resolve().parent.parent
PARAMS = {"W": 13.5625, "fov": 1.0, "N": 1024, "yB_size": 416,
          "yN_size": 512, "xA_size": 228, "xM_size": 256}
SOURCES = [(1.0, 1, 0)]  # a unit source: |subgrid| = 1/N^2
N = PARAMS["N"]
BUDGET = plk.PRECISION_RMS_BUDGET_REL


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_fft(z):
    return np.fft.fftshift(np.fft.fft(np.fft.ifftshift(z, axes=1), axis=1),
                           axes=1)


def _z(n):
    rng = np.random.default_rng(3)
    return rng.standard_normal((5, n)) + 1j * rng.standard_normal((5, n))


def _rel_rms(got, ref):
    return float(np.sqrt(np.mean(np.abs(got - ref) ** 2))
                 / np.sqrt(np.mean(np.abs(ref) ** 2)))


# -- the knobs ----------------------------------------------------------------


@pytest.mark.parametrize("n", [96, 2048])
def test_karatsuba_cmatmul(monkeypatch, n):
    """tests/test_fused.py:178: the 3-product complex FFT matches numpy's
    FFT (n = 96 is a direct DFT, B3 and always 4mul; n = 2048 the factored
    FFT, whose two contractions take karatsuba) and the JAX package's, and
    a bad value raises the reference's ValueError when a core is built."""
    monkeypatch.setenv("SWIFTLY_CMATMUL", "karatsuba")
    z = _z(n)
    ns = plk.bound("highest", plk._cmatmul_algo())
    got = plk.from_planar(ns.fft(plk.to_planar(z, torch.float64), 1))
    np.testing.assert_allclose(got, _np_fft(z), rtol=0, atol=1e-9)
    ref = jplk.from_planar(jplk.fft(jplk.to_planar(z, np.float64), 1))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    monkeypatch.setenv("SWIFTLY_CMATMUL", "bogus")
    with pytest.raises(ValueError, match="SWIFTLY_CMATMUL"):
        T.SwiftlyCore(13.5625, 1024, 256, 512, backend="planar",
                      device="cpu")


@pytest.mark.parametrize("name,value,fn", [
    ("SWIFTLY_PRECISION", "bogus", "matmul_precision"),
    ("SWIFTLY_CMATMUL", "5mul", "_cmatmul_algo"),
])
def test_bad_values_raise_the_reference_errors(monkeypatch, name, value, fn):
    monkeypatch.setenv(name, value)
    with pytest.raises(ValueError) as want:
        getattr(jplk, fn)()
    with pytest.raises(ValueError) as got:
        getattr(plk, fn)()
    assert str(got.value) == str(want.value)
    assert name in str(got.value)


def test_defaults_and_values(monkeypatch):
    monkeypatch.delenv("SWIFTLY_PRECISION", raising=False)
    monkeypatch.delenv("SWIFTLY_CMATMUL", raising=False)
    assert (plk.matmul_precision(), plk._cmatmul_algo()) == ("highest",
                                                             "4mul")
    monkeypatch.setenv("SWIFTLY_PRECISION", "HIGH")  # case-insensitive
    assert plk.matmul_precision() == "high"


def test_budget_table_is_bench_pys():
    """The port's copy of the budget equals ``bench.py``'s, read as text."""
    text = (ROOT / "bench.py").read_text()
    block = re.search(r"PRECISION_RMS_BUDGET_REL = (\{.*?\})", text,
                      re.S).group(1)
    assert ast.literal_eval(block) == plk.PRECISION_RMS_BUDGET_REL


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("algo", ["4mul", "karatsuba"])
def test_f32_fft_per_setting_against_numpy_and_jax(monkeypatch, precision,
                                                  algo):
    """The factored f32 FFT (n = 2048) under each setting: within the
    setting's budget of numpy's f64 FFT and of the JAX package's f32 FFT
    at the same knobs."""
    monkeypatch.setenv("SWIFTLY_PRECISION", precision)
    monkeypatch.setenv("SWIFTLY_CMATMUL", algo)
    z = _z(2048)
    got = plk.from_planar(plk.bound(precision, algo).fft(
        plk.to_planar(z, torch.float32), 1))
    ref = jplk.from_planar(jplk.fft(jplk.to_planar(z, np.float32), 1))
    assert _rel_rms(got, _np_fft(z)) < BUDGET[precision]
    assert _rel_rms(got, np.asarray(ref)) < BUDGET[precision]


def test_high_is_closer_than_default_and_highest_is_ieee():
    """Three TF32 passes land at IEEE float32's rounding floor (within 2x
    of it), far below one pass."""
    z = _z(2048)
    err = {p: _rel_rms(plk.from_planar(plk.bound(p).fft(
        plk.to_planar(z, torch.float32), 1)), _np_fft(z))
        for p in BUDGET}
    assert err["highest"] < 1e-6
    assert err["high"] < 2 * err["highest"]
    assert err["default"] > 1e-5  # TF32 really rounds (~2^-11 a pass)


def test_round_tf32_rounds_to_nearest_even_at_ten_bits():
    x = torch.tensor([1.0, 1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11,
                      1 + 2.0 ** -10 + 2.0 ** -12, -1 - 3 * 2.0 ** -11,
                      float("inf"), 0.0], dtype=torch.float32)
    want = [1.0, 1.0, 1 + 2 * 2.0 ** -10, 1 + 2.0 ** -10, -1 - 2 * 2.0 ** -10,
            float("inf"), 0.0]
    assert plk.round_tf32(x).tolist() == want
    r = plk.round_tf32(torch.randn(1000, generator=torch.Generator()
                                   .manual_seed(0)))
    assert torch.equal(plk.round_tf32(r), r)  # TF32 holds it exactly


@pytest.mark.parametrize("precision,passes", [("default", 1), ("high", 3)])
def test_tf32_passes_within_their_roundoff_bound(precision, passes):
    """|C - A@B| <= (r + (passes K + 2) 2^-24) (|A|@|B|) elementwise, with
    TF32's unit roundoff u = 2^-11: one pass rounds both operands, r =
    2u + u^2; three passes leave out lo.lo and round lo, r = 3u^2; each
    pass's float32 sum over K = 300 terms adds K 2^-24, the passes' sum
    2^-23."""
    g = torch.Generator().manual_seed(1)
    a = torch.randn(64, 300, generator=g)
    b = torch.randn(300, 48, generator=g)
    got = plk.contract(a, b, precision).double()
    exact = a.double() @ b.double()
    scale = a.abs().double() @ b.abs().double()
    u = 2.0 ** -11
    r = 2 * u + u * u if passes == 1 else 3 * u * u
    bound = (r + (passes * 300 + 2) * 2.0 ** -24) * scale
    assert ((got - exact).abs() <= bound).all()
    assert ((got - exact).abs() > 2.0 ** -24 * scale).any()  # not IEEE
    # f64 ignores the knob
    assert torch.equal(plk.contract(a.double(), b.double(), precision),
                       a.double() @ b.double())


def test_complex_products_run_on_their_planes():
    g = torch.Generator().manual_seed(2)
    a = torch.complex(torch.randn(8, 40, generator=g),
                      torch.randn(8, 40, generator=g))
    b = torch.complex(torch.randn(40, 6, generator=g),
                      torch.randn(40, 6, generator=g))
    want = torch.complex(
        plk.contract(a.real, b.real, "high") - plk.contract(a.imag, b.imag,
                                                            "high"),
        plk.contract(a.real, b.imag, "high") + plk.contract(a.imag, b.real,
                                                            "high"))
    assert torch.equal(plk.contract(a, b, "high"), want)
    ein = plk.contract(a, b, "default", spec="ij,jk->ik")
    assert (ein - a @ b).abs().max() < 1e-2


def test_tf32_flag_is_restored_after_a_product_that_raises():
    """The window's flag is restored, and the lock released, when the
    product raises."""
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    try:
        flags.allow_tf32 = False
        with pytest.raises(RuntimeError):
            plk._launch(torch.ones(3, 4), torch.ones(5, 6), None, True)
        assert flags.allow_tf32 is False
        assert plk._TF32_LOCK.acquire(blocking=False)
        plk._TF32_LOCK.release()
    finally:
        flags.allow_tf32 = before


def test_concurrent_products_each_see_their_own_flag(monkeypatch):
    """Threads launching TF32 and IEEE products at once: every product
    launches under its own mode's flag, never another thread's."""
    flags = torch.backends.cuda.matmul
    seen = []
    real = plk._product

    def spy(a, b, spec):
        seen.append((bool(a[0, 0] > 0), flags.allow_tf32))
        return real(a, b, spec)

    monkeypatch.setattr(plk, "_product", spy)
    before = flags.allow_tf32
    pos, neg = torch.ones(2, 2), -torch.ones(2, 2)

    def worker(tf32):
        for _ in range(200):
            plk._launch(pos if tf32 else neg, pos, None, tf32)

    try:
        threads = [threading.Thread(target=worker, args=(k % 2 == 0,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        flags.allow_tf32 = before
    assert len(seen) == 800
    assert all(tf32 == flag for tf32, flag in seen)
    assert flags.allow_tf32 == before


# -- the sampled forward at 1k, f32 ---------------------------------------------


@functools.cache
def _jax_config():
    return J.SwiftlyConfig(backend="planar", dtype=np.float32, **PARAMS)


@functools.cache
def _covers():
    cfg = _jax_config()
    fcs = J.make_full_facet_cover(cfg)
    sgcs = J.make_full_subgrid_cover(cfg)
    data = [J.make_facet(N, fc, SOURCES) for fc in fcs]
    truth = np.stack([J.make_subgrid(N, sg, SOURCES) for sg in sgcs])
    return fcs, sgcs, data, truth


@functools.cache
def _jax_forward():
    cfg = _jax_config()
    fcs, sgcs, data, _ = _covers()
    fwd = jstreamed.StreamedForward(cfg, list(zip(fcs, data)),
                                    residency="device")
    return cfg.core.as_complex(fwd.all_subgrids(sgcs))


def _port_forward(precision, algo="4mul", colpass=None, monkeypatch=None):
    monkeypatch.setenv("SWIFTLY_PRECISION", precision)
    monkeypatch.setenv("SWIFTLY_CMATMUL", algo)
    if colpass:
        monkeypatch.setenv("SWIFTLY_COLPASS", colpass)
    jcore = _jax_config().core
    cfg = T.SwiftlyConfig.from_numpy_state(
        np.asarray(jcore._Fb), np.asarray(jcore._Fn), backend="planar",
        dtype=torch.float32, device="cpu", **PARAMS)
    fcs, sgcs, data, _ = _covers()
    tasks = list(zip(T.make_full_facet_cover(cfg), data))
    fwd = T.StreamedForward(cfg, tasks, residency="device")
    out = fwd.all_subgrids(T.make_full_subgrid_cover(cfg))
    return fwd, out


@functools.cache
def _port_at(precision, algo="4mul", colpass=None):
    mp = pytest.MonkeyPatch()
    try:
        fwd, out = _port_forward(precision, algo, colpass, mp)
    finally:
        mp.undo()
    return fwd.last_plan, fwd.core.as_complex(out)


def _rel_vs_oracle(subgrids):
    return float(np.sqrt(np.mean(np.abs(subgrids - _covers()[3]) ** 2))
                 * N * N)


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_sampled_forward_per_setting_within_budget(precision):
    """The 1k f32 sampled forward (the facet pass governed, B1's plain
    version not) against the oracle and the JAX package's f32 forward,
    within the setting's budget, its plan stamped with the knobs."""
    plan, got = _port_at(precision)
    assert plan["precision"] == precision and plan["cmatmul"] == "4mul"
    assert _rel_vs_oracle(got) < BUDGET[precision]
    jax = _jax_forward()
    assert np.sqrt(np.mean(np.abs(got - jax) ** 2)) * N * N \
        < BUDGET[precision]


def test_sampled_forward_high_is_closer_to_the_oracle_than_default():
    assert (_rel_vs_oracle(_port_at("high")[1])
            < _rel_vs_oracle(_port_at("default")[1]))
    assert not np.array_equal(_port_at("high")[1], _port_at("highest")[1])


def test_highest_forward_is_bit_equal_to_direct_torch_products(monkeypatch):
    """``highest`` (knob unset) gives the bits of the same forward whose
    governed products are direct ``torch.matmul`` / ``torch.einsum`` calls,
    the products the port ran before the knob."""
    monkeypatch.delenv("SWIFTLY_PRECISION", raising=False)
    _, knob = _port_forward("highest", monkeypatch=monkeypatch)

    def direct(a, b, precision="highest", spec=None, plain=False):
        return torch.matmul(a, b) if spec is None else torch.einsum(spec, a,
                                                                    b)

    monkeypatch.setattr(plk, "contract", direct)
    _, ref = _port_forward("highest", monkeypatch=monkeypatch)
    assert np.array_equal(knob, ref)


@pytest.mark.parametrize("algo", ["4mul", "karatsuba"])
def test_einsum_body_under_karatsuba_matches_jax(algo):
    """``SWIFTLY_COLPASS=einsum``: the column pass's ``_ceinsum`` products
    take the complex-product algorithm (both packages' einsum body); the
    f32 forward stays within the f32 budget of the oracle and of the JAX
    package's forward."""
    plan, got = _port_at("highest", algo, "einsum")
    assert plan["colpass"] == "einsum" and plan["cmatmul"] == algo
    assert "colpass_blocks" not in plan
    assert _rel_vs_oracle(got) < BUDGET["highest"]
    assert np.sqrt(np.mean(np.abs(got - _jax_forward()) ** 2)) * N * N \
        < BUDGET["highest"]


def test_two_executors_in_one_process_keep_their_settings(monkeypatch):
    """The knobs are read when an executor is built: one process holds
    executors at two settings, each core a copy at its own."""
    jcore = _jax_config().core
    cfg = T.SwiftlyConfig.from_numpy_state(
        np.asarray(jcore._Fb), np.asarray(jcore._Fn), backend="planar",
        dtype=torch.float32, device="cpu", **PARAMS)
    tasks = list(zip(T.make_full_facet_cover(cfg), _covers()[2]))
    monkeypatch.setenv("SWIFTLY_PRECISION", "default")
    a = T.StreamedForward(cfg, tasks, residency="device")
    monkeypatch.setenv("SWIFTLY_PRECISION", "highest")
    monkeypatch.setenv("SWIFTLY_CMATMUL", "karatsuba")
    b = T.StreamedForward(cfg, tasks, residency="device")
    assert (a.core.precision, a.core.cmatmul) == ("default", "4mul")
    assert (b.core.precision, b.core.cmatmul) == ("highest", "karatsuba")
    assert a.core._p.precision == "default"
    assert b.core._p.cmatmul == "karatsuba"
    assert a.core._Fb is cfg.core._Fb  # the constants are shared
    monkeypatch.delenv("SWIFTLY_PRECISION")
    monkeypatch.delenv("SWIFTLY_CMATMUL")
    assert cfg.core.with_knobs() is cfg.core  # built at the defaults


# -- B1's tile record and the knob-parity table ----------------------------------


def test_plan_colpass_blocks_is_the_tile_b1_runs():
    """The forward's plan records the tile ``csrc/cgemm.cuh`` compiles B1
    with (``EngineTile<float>``, ``kBK``), which autotune then learns."""
    plan, _ = _port_at("highest")
    assert plan["colpass"] == "kernel"
    text = (ROOT / "swiftly_tpu_torch/csrc/cgemm.cuh").read_text()
    bm, bn, rm, rn, st = map(int, re.search(
        r"EngineTile<float> \{\s*using type = Tile<float, (\d+), (\d+), "
        r"(\d+), (\d+), (\d+)>", text).groups())
    bk = int(re.search(r"constexpr int kBK = (\d+);", text).group(1))
    assert plan["colpass_blocks"] == {"bm": bm, "bn": bn, "bk": bk,
                                      "rm": rm, "rn": rn, "stages": st}
    assert plan["colpass_blocks"] == kernels.colpass_blocks(torch.float32)
    from swiftly_tpu_torch.plan import refit
    rec = {"plan": dict(plan), "telemetry": {"stages": {
        "fwd.column_pass": {"total_s": 1.0, "flops": 1e12}}}}
    assert refit([rec]).colpass_blocks \
        == plan["colpass_blocks"]


def _knob_names(root):
    names = set()
    for path in root.rglob("*.py"):
        names |= set(re.findall(r"SWIFTLY_[A-Z0-9_]+", path.read_text()))
    return names


def test_every_reference_knob_is_read_or_listed_not_applicable():
    """Every ``SWIFTLY_*`` name of the JAX package is read by the port or
    listed in ``swiftly_tpu_torch.knobs.NOT_APPLICABLE`` with its reason,
    and no listed one is read."""
    from swiftly_tpu_torch import knobs

    ref = _knob_names(ROOT / "swiftly_tpu")
    port = set()
    for path in (ROOT / "swiftly_tpu_torch").rglob("*.py"):
        if path.name != "knobs.py":
            port |= set(re.findall(r"SWIFTLY_[A-Z0-9_]+", path.read_text()))
    assert ref - port == set(knobs.NOT_APPLICABLE)
    assert all(len(r) > 20 for r in knobs.NOT_APPLICABLE.values())
    assert {"SWIFTLY_PRECISION", "SWIFTLY_CMATMUL"} <= port


# -- f32 against f32 at a catalogue size (ROADMAP §C) ----------------------------


@pytest.mark.slow
def test_f32_round_trip_at_4k_against_the_jax_package():
    """The f32 round trip of ``4k[1]-n2k-512`` (sampled forward into the
    sampled backward) through both packages, each against the oracle and
    against each other: subgrids within 1e-4 x the sources' amplitude sum
    over N^2 of the oracle (chip_smoke's bound), facets within 1e-6 RMS
    of their input planes, and the two packages' subgrids within the f32
    budget of each other (relative RMS 3e-4)."""
    name = "4k[1]-n2k-512"
    params = dict(J.SWIFT_CONFIGS[name], fov=1.0)
    jcfg = J.SwiftlyConfig(backend="planar", dtype=np.float32, **params)
    Nk = jcfg.image_size
    sources = [(1.0 + 0.25 * k, int(a * Nk), int(b * Nk)) for k, (a, b) in
               enumerate([(0.0, 0.0), (0.1, -0.2), (-0.3, 0.25)])]
    fcs = J.make_full_facet_cover(jcfg)
    sgcs = J.make_full_subgrid_cover(jcfg)
    planes = [np.real(J.make_facet(Nk, fc, sources)).astype(np.float32)
              for fc in fcs]
    jfwd = jstreamed.StreamedForward(jcfg, list(zip(fcs, planes)),
                                     residency="device")
    jsub = jcfg.core.as_complex(np.asarray(jfwd.all_subgrids(sgcs)))
    jbwd = jstreamed.StreamedBackward(jcfg, fcs, residency="sampled")
    jstreamed.feed_backward_passes(jfwd, sgcs, [jbwd])
    jfacets = jcfg.core.as_complex(np.asarray(jbwd.finish()))

    tcfg = T.SwiftlyConfig.from_numpy_state(
        np.asarray(jcfg.core._Fb), np.asarray(jcfg.core._Fn),
        backend="planar", dtype=torch.float32, device="cpu",
        **{k: v for k, v in params.items() if k in (
            "W", "fov", "N", "yB_size", "yN_size", "xA_size", "xM_size")})
    tfcs = T.make_full_facet_cover(tcfg)
    tsgcs = T.make_full_subgrid_cover(tcfg)
    tfwd = T.StreamedForward(tcfg, list(zip(tfcs, planes)),
                             residency="device")
    tsub = tcfg.core.as_complex(tfwd.all_subgrids(tsgcs))
    tbwd = T.StreamedBackward(tcfg, tfcs, residency="sampled")
    T.feed_backward_passes(tfwd, tsgcs, [tbwd])
    tfacets = tcfg.core.as_complex(np.asarray(tbwd.finish()))

    truth = np.stack([J.make_subgrid(Nk, sg, sources) for sg in sgcs])
    scale = sum(s[0] for s in sources) / Nk ** 2

    def rms(a, b):
        return float(np.sqrt(np.mean(np.abs(a - b) ** 2)))

    err = {"jax_subgrids": rms(jsub, truth), "port_subgrids": rms(tsub, truth),
           "between_subgrids": rms(tsub, jsub),
           "jax_facets": max(rms(f, p) for f, p in zip(jfacets, planes)),
           "port_facets": max(rms(f, p) for f, p in zip(tfacets, planes)),
           "between_facets": rms(tfacets, jfacets)}
    print(json.dumps(err))
    assert err["jax_subgrids"] < 1e-4 * scale
    assert err["port_subgrids"] < 1e-4 * scale
    assert err["jax_facets"] < 1e-6 and err["port_facets"] < 1e-6
    assert err["between_subgrids"] * Nk ** 2 < BUDGET["highest"]
    assert err["between_facets"] < 1e-6
