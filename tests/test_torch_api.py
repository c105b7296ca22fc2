"""The port's slice as a whole: the fused facet<->subgrid round trip.

Same facets (numpy, from the analytic oracle) through the JAX package and
the port at `1k[1]-n512-256`, where every DFT is direct: port "planar"
(float64, B3's plain version on the CPU) against JAX "planar", and port
"torch" (complex128) against JAX "jax". Subgrids and facets agree to atol
1e-12 (tests/test_fused.py's float64 bound); the round trip meets the
reference's oracle bound, RMS < 3e-10 (tests/conftest.py).

Each backend's fused round trip is computed once per module and shared;
torch runs on one intra-op thread here, as the suite runs beside other
pytest-xdist workers on the same cores.
"""

import functools

import numpy as np
import pytest
import torch

import swiftly_tpu as J
import swiftly_tpu_torch as T
from swiftly_tpu_torch.api import FlightQueue, LRUCache

CONFIG = "1k[1]-n512-256"
SOURCES = [(1, 1, 0)]
ATOL = 1e-12
RMS_BOUND = 3e-10
TWINS = {"planar": ("planar", torch.float64), "torch": ("jax", torch.complex128)}
N_FACETS = 9  # the full facet cover of CONFIG


def _setup(pkg, **kwargs):
    config = pkg.SwiftlyConfig(**kwargs, **pkg.SWIFT_CONFIGS[CONFIG])
    fcs = pkg.make_full_facet_cover(config)
    sgcs = pkg.make_full_subgrid_cover(config)
    tasks = [(fc, J.make_facet(config.image_size, fc, SOURCES)) for fc in fcs]
    return config, fcs, sgcs, tasks


def _column_rows(sgcs, picks):
    """Indices of the subgrids in the cover's columns number `picks`."""
    offs0 = sorted({sg.off0 for sg in sgcs})
    chosen = {offs0[p] for p in picks}
    return [i for i, sg in enumerate(sgcs) if sg.off0 in chosen]


def _first_columns(sgcs, n):
    return [sgcs[i] for i in _column_rows(sgcs, range(n))]


def _fused_raw(pkg, sgcs=None, **kwargs):
    config, fcs, all_sgcs, tasks = _setup(pkg, **kwargs)
    sgcs = all_sgcs if sgcs is None else sgcs
    subgrids = pkg.SwiftlyForward(config, tasks).all_subgrids(sgcs)
    facets = pkg.backward_all(config, fcs, list(zip(sgcs, subgrids)))
    return config, subgrids, facets


def _fused(pkg, sgcs=None, **kwargs):
    config, subgrids, facets = _fused_raw(pkg, sgcs, **kwargs)
    return config.core.as_complex(subgrids), config.core.as_complex(facets)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def _port_fused(backend):
    """The port's fused (subgrids, facets) on the full cover, as tensors;
    computed once per backend."""
    _, subgrids, facets = _fused_raw(T, backend=backend,
                                     dtype=TWINS[backend][1], device="cpu")
    return subgrids, facets


@pytest.fixture(scope="module", params=sorted(TWINS))
def roundtrips(request):
    jax_backend, _ = TWINS[request.param]
    core = _setup(T, backend=request.param, dtype=TWINS[request.param][1],
                  device="cpu")[0].core
    t_sg, t_f = _port_fused(request.param)
    return (
        request.param,
        _fused(J, backend=jax_backend),
        (core.as_complex(t_sg), core.as_complex(t_f)),
    )


def test_fused_roundtrip_matches_reference(roundtrips):
    _, (j_sg, j_f), (t_sg, t_f) = roundtrips
    assert t_sg.shape == j_sg.shape and t_f.shape == j_f.shape
    np.testing.assert_allclose(t_sg, j_sg, rtol=0, atol=ATOL)
    np.testing.assert_allclose(t_f, j_f, rtol=0, atol=ATOL)


@pytest.mark.parametrize("k", range(N_FACETS))
def test_fused_roundtrip_meets_oracle_bound(roundtrips, k):
    """Facet k of the fused round trip meets the oracle bound, and so do
    the subgrids whose index is k modulo the facet count."""
    _, _, (t_sg, t_f) = roundtrips
    config, fcs, sgcs, _ = _setup(T, backend="numpy")
    assert len(fcs) == N_FACETS
    assert T.check_facet(config.image_size, fcs[k], t_f[k], SOURCES) < RMS_BOUND
    for i in range(k, len(sgcs), N_FACETS):
        assert T.check_subgrid(config.image_size, sgcs[i], t_sg[i], SOURCES) < 1e-12


def test_numpy_backend_roundtrip_matches_reference():
    # the eager float64 host backend on the first two columns of the cover
    part = _first_columns(_setup(T, backend="numpy")[2], 2)
    j_sg, j_f = _fused(J, part, backend="numpy")
    t_sg, t_f = _fused(T, part, backend="numpy")
    np.testing.assert_allclose(t_sg, j_sg, rtol=0, atol=ATOL)
    np.testing.assert_allclose(t_f, j_f, rtol=0, atol=ATOL)


@pytest.mark.parametrize("backend,dtype", [("planar", torch.float64),
                                           ("torch", torch.complex128)])
def test_per_subgrid_streaming_matches_fused(backend, dtype):
    config, fcs, all_sgcs, tasks = _setup(T, backend=backend, dtype=dtype,
                                          device="cpu")
    core = config.core
    # the cover's first and last columns against the full cover's fused rows
    rows = _column_rows(all_sgcs, [0, -1])
    sgcs = [all_sgcs[i] for i in rows]
    fused_sg = _port_fused(backend)[0][rows]
    fused_f = T.backward_all(config, fcs, list(zip(sgcs, fused_sg)))
    fwd = T.SwiftlyForward(config, tasks, lru_forward=2, queue_size=3)
    streamed = [fwd.get_subgrid_task(sg) for sg in sgcs]
    np.testing.assert_allclose(core.as_complex(torch.stack(streamed)),
                               core.as_complex(fused_sg), rtol=0, atol=ATOL)
    # per-column batches, in shuffled request order
    perm = np.random.default_rng(7).permutation(len(sgcs))
    batched = T.SwiftlyForward(config, tasks).get_subgrid_tasks(
        [sgcs[i] for i in perm])
    np.testing.assert_allclose(core.as_complex(torch.stack(batched)),
                               core.as_complex(fused_sg[perm]), rtol=0, atol=ATOL)

    bwd = T.SwiftlyBackward(config, fcs, lru_backward=2, queue_size=3)
    for i in perm:
        bwd.add_new_subgrid_task(sgcs[i], streamed[i])
    np.testing.assert_allclose(core.as_complex(bwd.finish()),
                               core.as_complex(fused_f), rtol=0, atol=ATOL)
    with pytest.raises(RuntimeError, match="finish"):
        bwd.add_new_subgrid_task(sgcs[0], streamed[0])
    bwd2 = T.SwiftlyBackward(config, fcs)
    bwd2.add_new_subgrid_tasks([(sgcs[i], streamed[i]) for i in perm])
    np.testing.assert_allclose(core.as_complex(bwd2.finish()),
                               core.as_complex(fused_f), rtol=0, atol=ATOL)


def test_ragged_cover_and_mixed_sizes():
    config, fcs, sgcs, tasks = _setup(T, backend="planar", dtype=torch.float64,
                                      device="cpu")
    core = config.core
    rows = _column_rows(sgcs, [0, -1])
    part = [sgcs[i] for i in rows][:-3]  # the last column is short
    full = _port_fused("planar")[0][rows]
    fwd = T.SwiftlyForward(config, tasks)
    ragged = fwd.all_subgrids(part)
    assert ragged.shape[0] == len(part)
    torch.testing.assert_close(ragged, full[: len(part)], rtol=0, atol=ATOL)
    # the call released its prepared facet stack; a second call on the
    # same object prepares it again. Requested in shuffled order: the same
    # values, row for row.
    assert fwd._BF_Fs is None
    perm = np.random.default_rng(7).permutation(len(part))
    shuffled = fwd.all_subgrids([part[i] for i in perm])
    assert torch.equal(shuffled, ragged[perm])
    f_part = T.backward_all(config, fcs, list(zip(part, ragged)))
    bwd = T.SwiftlyBackward(config, fcs)
    bwd.add_new_subgrid_tasks(list(zip(part, ragged)))
    np.testing.assert_allclose(core.as_complex(f_part),
                               core.as_complex(bwd.finish()), rtol=0, atol=ATOL)
    bad = list(sgcs)
    bad[0] = T.SubgridConfig(bad[0].off0, bad[0].off1, bad[0].size - 2)
    with pytest.raises(ValueError, match="share one size"):
        T.SwiftlyForward(config, tasks).all_subgrids(bad)


def test_lru_cache_behaviour():
    lru = LRUCache(2)
    assert lru.set("a", 1) == (None, None)
    assert lru.set("b", 2) == (None, None)
    assert lru.get("a") == 1  # refresh: "b" is now the oldest
    assert lru.set("c", 3) == ("b", 2)
    assert lru.keys() == ["a", "c"] and lru.get("b") is None
    assert lru.set("a", 10) == (None, None)  # refresh in place
    assert list(lru.pop_all()) == [("c", 3), ("a", 10)]
    assert len(lru) == 0


def test_flight_queue_bounds_inflight_tasks():
    q = FlightQueue(3)
    for _ in range(5):
        q.admit(torch.zeros(2))
        assert len(q) <= 3
    q.admit([torch.zeros(2)] * 7)  # one slot per task, not per call
    assert len(q) == 3
    q.drain()
    assert len(q) == 0


def test_flop_counts_match_the_dfts_the_path_runs(monkeypatch):
    """The FLOP counts of utils/flops.py against the DFTs the fused round
    trip really runs. At this config every DFT is direct (n <= 1024), so
    each is one B3 call of 8*B*n*n flops; the counts add the elementwise
    windows and twiddles (6 per complex point) and the facet sum. The
    round trip covers the first two columns: the counts take the column
    count as a parameter."""
    import swiftly_tpu.utils.flops as jflops
    import swiftly_tpu_torch.ops.planar_backend as plk
    import swiftly_tpu_torch.utils.flops as tflops

    dft = {"fwd": 0, "bwd": 0}
    phase = ["fwd"]
    real = plk.cmatmul

    def record(zr, zi, wr, wi):
        dft[phase[0]] += 8 * zr.shape[0] * zr.shape[1] * wr.shape[1]
        return real(zr, zi, wr, wi)

    monkeypatch.setattr(plk, "cmatmul", record)
    config, fcs, sgcs, tasks = _setup(T, backend="planar", dtype=torch.float64,
                                      device="cpu")
    sgcs = _first_columns(sgcs, 2)
    subgrids = T.SwiftlyForward(config, tasks).all_subgrids(sgcs)
    phase[0] = "bwd"
    T.backward_all(config, fcs, list(zip(sgcs, subgrids)))

    core = config.core
    F, yB, C = len(fcs), fcs[0].size, len({sg.off0 for sg in sgcs})
    S, xA = len(sgcs) // C, sgcs[0].size
    m, xM, yN = core.xM_yN_size, core.xM_size, core.yN_size
    counts = dict(n_facets=F, facet_size=yB, n_columns=C,
                  subgrids_per_column=S, subgrid_size=xA)
    fwd_elementwise = (F * 6 * yB * yN + C * F * 6 * m * yN
                       + C * S * (F * (6 * m * m + 6 * xM * m)
                                  + 2 * (F - 1) * xM * xM + 4 * xA * xA))
    bwd_elementwise = (C * S * F * (6 * m * xM + 6 * m * m)
                       + C * F * 6 * m * yB + F * 6 * yB * yN)
    assert tflops.forward_batched_flops(core, **counts) == dft["fwd"] + fwd_elementwise
    assert tflops.backward_batched_flops(core, **counts) == dft["bwd"] + bwd_elementwise
    # the reference's backward count misses the axis-0 extraction's
    # xM - m extra rows (ROADMAP, queue C)
    assert jflops.forward_batched_flops(core, **counts) == \
        tflops.forward_batched_flops(core, **counts)
    assert jflops.backward_batched_flops(core, **counts) == \
        tflops.backward_batched_flops(core, **counts) - C * S * F * 8 * m * m * (xM - m)
