"""Kernel B4 (the visibility degrid reduction) and its adjoint scatter
``grid`` in the port.

On the CPU the wrappers run the plain versions (gather plus ``einsum``;
``index_put_`` rounds that add each pixel's contributions in sample order),
held here against the JAX package's ``degrid_batch`` / ``grid_batch`` on
the same seeded numpy inputs: its einsum path, and B4's Pallas kernel in
interpreter mode; B4 over a serving pump (``degrid_rows``, G rows in one
launch, the tap weights computed from the table) likewise, row by row, with
its weights equal to the reference's ``VisKernel.weights`` bit for bit. On
this JAX (0.9) the reference's own Pallas branch
(``SWIFTLY_PALLAS_INTERPRET=1``) does not trace: its kernel indexes refs
with ``None``, which Pallas refuses (ROADMAP §C; pinned by
``test_reference_b4_pallas_branch_does_not_trace``). So B4's kernel body
runs here through ``pl.pallas_call(interpret=True)`` as the reference
writes it, with the refs read before the broadcast. Bounds: 1e-5 relative
in float32 (the sum-reorder bound of the reference's Pallas tests), 1e-12
in float64. The
shapes are ragged (rows that are no multiple of anything, B no power of
two) with taps at the rows' edges, and the scatter gets many samples on
one pixel. The CUDA kernels run only on a GPU: the ``cuda``-marked tests
compare them with the plain versions there and skip elsewhere. The JAX
package is imported inside the tests that need it, so the GPU machine,
which has no JAX, can run this file's cuda tests:
``python -m pytest --noconftest tests/test_torch_vis_kernels.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from swiftly_tpu_torch.ops.kernels import (
    check_tap_table,
    degrid,
    degrid_plain,
    degrid_rows,
    degrid_rows_plain,
    degrid_stats,
    grid,
    grid_plain,
    grid_stats,
    tap_weights,
)
from swiftly_tpu_torch.vis import (
    ADJOINT_TOLERANCE,
    bucket_size,
    degrid_batch,
    grid_batch,
    split_row_planes,
    vis_kernel,
)
from swiftly_tpu_torch.vis import degrid_rows as vis_degrid_rows

REL = {np.float32: 1e-5, np.float64: 1e-12}
# (row size, B, support W): ragged rows and batches
SHAPES = [(56, 64, 8), (37, 5, 8), (61, 300, 8), (24, 17, 4), (50, 33, 6)]
DTYPES = [np.float32, np.float64]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs beside other pytest-xdist workers on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(shape, dtype, seed=0, one_pixel=False):
    """A planar row, first-tap indices (the first two samples at opposite
    corners of the row), kernel weights and complex samples."""
    size, B, W = shape
    rng = np.random.default_rng(seed)
    row = rng.standard_normal((size, size, 2)).astype(dtype)
    iu0 = rng.integers(0, size - W + 1, size=B)
    iv0 = rng.integers(0, size - W + 1, size=B)
    if one_pixel:
        iu0[:] = size // 3
        iv0[:] = size // 2
    iu0[:2], iv0[:2] = (0, size - W), (size - W, 0)
    k = vis_kernel(support=W)
    cu = k.weights(rng.uniform(0, 1, size=B), dtype=dtype)
    cv = k.weights(rng.uniform(0, 1, size=B), dtype=dtype)
    y = rng.standard_normal(B) + 1j * rng.standard_normal(B)
    return row, iu0, iv0, cu, cv, y


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def _b4_pallas_interpret(row, iu0, iv0, cu, cv):
    """B4 in interpreter mode: the reference's gather and kernel body
    (``swiftly_tpu/vis/degrid.py:81-115``) with the weight refs read before
    they are broadcast."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    W = cu.shape[1]
    offs = jnp.arange(W)

    def gather(plane):
        iu = jnp.asarray(iu0)[:, None] + offs
        iv = jnp.asarray(iv0)[:, None] + offs
        return jnp.asarray(plane)[iu[:, :, None], iv[:, None, :]]

    def kernel(pr_ref, pi_ref, cu_ref, cv_ref, vr_ref, vi_ref):
        cu_b, cv_b = cu_ref[...], cv_ref[...]
        w2 = cu_b[:, :, None] * cv_b[:, None, :]
        vr_ref[...] = jnp.sum(pr_ref[...] * w2, axis=(1, 2))
        vi_ref[...] = jnp.sum(pi_ref[...] * w2, axis=(1, 2))

    pr, pi = gather(row[..., 0]), gather(row[..., 1])
    out = jax.ShapeDtypeStruct((pr.shape[0],), pr.dtype)
    vr, vi = pl.pallas_call(kernel, out_shape=(out, out), interpret=True)(
        pr, pi, jnp.asarray(cu), jnp.asarray(cv))
    return np.asarray(vr) + 1j * np.asarray(vi)


def test_reference_b4_pallas_branch_does_not_trace(monkeypatch):
    """The reference's B4 Pallas branch indexes refs with ``None``
    (``cu_ref[:, :, None]``, ``swiftly_tpu/vis/degrid.py:101``), which this
    JAX refuses while tracing; its tests never take that branch. A
    reference caveat (ROADMAP §C), pinned so that a JAX that accepts it
    shows up here."""
    from swiftly_tpu.vis import degrid_batch as jax_degrid_batch

    monkeypatch.setenv("SWIFTLY_PALLAS_INTERPRET", "1")
    row, iu0, iv0, cu, cv, _ = _inputs(SHAPES[1], np.float32)
    with pytest.raises(ValueError, match="must not be longer than"):
        jax_degrid_batch(row, iu0, iv0, cu, cv)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("interpret", [False, True],
                         ids=["einsum", "pallas-interpret"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_degrid_plain_matches_jax(shape, interpret, dtype):
    from swiftly_tpu.vis import degrid_batch as jax_degrid_batch

    row, iu0, iv0, cu, cv, _ = _inputs(shape, dtype)
    if interpret:
        ref = _b4_pallas_interpret(row, iu0, iv0, cu, cv)
    else:
        ref = jax_degrid_batch(row, iu0, iv0, cu, cv)
    vr, vi = degrid_plain(*_t(row[..., 0], row[..., 1], iu0, iv0, cu, cv))
    got = vr.numpy() + 1j * vi.numpy()
    assert _rel(got, ref) <= REL[dtype]
    # the port's dispatch (bucket padding, one row upload) gives the same
    port = degrid_batch(row, iu0, iv0, cu, cv, device="cpu")
    assert port.dtype == np.complex128 and port.shape == (shape[1],)
    assert _rel(port, ref) <= REL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("one_pixel", [False, True],
                         ids=["spread", "one-pixel"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_grid_plain_matches_jax(shape, one_pixel, dtype):
    from swiftly_tpu.vis import grid_batch as jax_grid_batch

    size = shape[0]
    _, iu0, iv0, cu, cv, y = _inputs(shape, dtype, seed=1,
                                     one_pixel=one_pixel)
    rr, ri = jax_grid_batch(size, iu0, iv0, cu, cv, y, dtype=dtype)
    ref = np.asarray(rr) + 1j * np.asarray(ri)
    gr, gi = grid_batch(size, iu0, iv0, cu, cv, y, dtype=dtype, device="cpu")
    got = gr.numpy() + 1j * gi.numpy()
    assert _rel(got, ref) <= REL[dtype]
    # accumulating into given planes adds, in place
    acc = torch.ones((size, size, 2), dtype=gr.dtype)
    grid_batch(size, iu0, iv0, cu, cv, y, acc=(acc[..., 0], acc[..., 1]))
    again = torch.view_as_complex(acc).numpy() - (1 + 1j)
    assert _rel(again, ref) <= REL[dtype]


@pytest.mark.parametrize("shape", SHAPES[:3], ids=str)
def test_adjoint_identity(shape):
    """< degrid(G), y > == < G, grid(y) > in float32, within
    ADJOINT_TOLERANCE: the same indices and weights, transposed."""
    size = shape[0]
    row, iu0, iv0, cu, cv, y = _inputs(shape, np.float32, seed=2)
    d = degrid_batch(row, iu0, iv0, cu, cv, device="cpu")
    gr, gi = grid_batch(size, iu0, iv0, cu, cv, y, device="cpu")
    lhs = np.vdot(d, y)
    rhs = np.vdot(row[..., 0] + 1j * row[..., 1],
                  gr.numpy() + 1j * gi.numpy())
    assert abs(lhs - rhs) / abs(lhs) <= ADJOINT_TOLERANCE


def test_out_of_range_taps_clamp_in_degrid_and_drop_in_grid():
    """The JAX semantics at the row's edge: the gather clamps indices past
    the row, the scatter drops taps past the planes."""
    from swiftly_tpu.vis import degrid_batch as jax_degrid_batch
    from swiftly_tpu.vis import grid_batch as jax_grid_batch

    size, W = 20, 8
    row, _, _, cu, cv, y = _inputs((size, 3, W), np.float64, seed=3)
    iu0 = np.array([-3, size - 5, 4])
    iv0 = np.array([size - 2, -1, 4])
    ref = jax_degrid_batch(row, iu0, iv0, cu, cv)
    got = degrid_batch(row, iu0, iv0, cu, cv, device="cpu")
    assert _rel(got, ref) <= 1e-12
    rr, ri = jax_grid_batch(size, iu0, iv0, cu, cv, y, dtype=np.float64)
    gr, gi = grid_batch(size, iu0, iv0, cu, cv, y, dtype=torch.float64,
                        device="cpu")
    assert _rel(gr.numpy() + 1j * gi.numpy(),
                np.asarray(rr) + 1j * np.asarray(ri)) <= 1e-12


def _wrapped_indices(size, B, W, seed):
    """First taps from [-2W, size + 2): some patches wholly wrapped from a
    negative index, some split between the plane's two ends, some partly
    past its far edge, the rest inside."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-2 * W, size + 2, size=B),
            rng.integers(-2 * W, size + 2, size=B))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("W", [4, 6, 8])
def test_grid_plain_matches_jax_with_wrapped_indices(W, dtype):
    """JAX's scatter rules at both ends of a plane that spans several
    32-pixel tiles: a negative index counts once from the end, taps past
    the plane are dropped."""
    from swiftly_tpu.vis import grid_batch as jax_grid_batch

    size, B = 70, 200
    _, _, _, cu, cv, y = _inputs((size, B, W), dtype, seed=W)
    iu0, iv0 = _wrapped_indices(size, B, W, seed=W)
    rr, ri = jax_grid_batch(size, iu0, iv0, cu, cv, y, dtype=dtype)
    ref = np.asarray(rr) + 1j * np.asarray(ri)
    gr, gi = grid_batch(size, iu0, iv0, cu, cv, y, dtype=dtype, device="cpu")
    assert _rel(gr.numpy() + 1j * gi.numpy(), ref) <= REL[dtype]


def test_bucket_size_and_dispatch_cap():
    assert [bucket_size(n) for n in (0, 1, 2, 3, 17, 4096, 10**6)] == [
        2, 2, 2, 4, 32, 4096, 4096]
    row, iu0, iv0, cu, cv, _ = _inputs((24, 4097, 4), np.float32)
    with pytest.raises(ValueError, match="at most 4096"):
        degrid_batch(row, iu0, iv0, cu, cv, device="cpu")


def test_wrappers_on_cpu_are_the_plain_versions_and_launch_nothing():
    row, iu0, iv0, cu, cv, y = _inputs(SHAPES[1], np.float32, seed=4)
    args = _t(row[..., 0], row[..., 1], iu0, iv0, cu, cv)
    degrid_stats.reset()
    grid_stats.reset()
    assert all(torch.equal(a, b) for a, b in zip(degrid(*args),
                                                 degrid_plain(*args)))
    acc1, acc2 = torch.zeros((2, 37, 37, 2))
    yr, yi = _t(y.real.astype(np.float32), y.imag.astype(np.float32))
    grid(acc1[..., 0], acc1[..., 1], *args[2:], yr, yi)
    grid_plain(acc2[..., 0], acc2[..., 1], *args[2:], yr, yi)
    assert torch.equal(acc1, acc2) and acc1.abs().sum() > 0
    assert degrid_stats.launches == 0 and not degrid_stats.shapes
    assert grid_stats.launches == 0 and not grid_stats.shapes


def test_wrappers_never_fall_back_for_non_cpu_tensors():
    """A tensor that is not on the CPU never reaches a plain version."""
    meta = [torch.empty(s, device="meta") for s in ((9, 9), (9, 9))]
    idx = [torch.zeros(3, dtype=torch.int64) for _ in range(2)]
    w = [torch.zeros((3, 4)) for _ in range(2)]
    with pytest.raises(ValueError, match="CUDA device"):
        degrid(*meta, *idx, *w)
    with pytest.raises(ValueError, match="CUDA device"):
        grid(*meta, *idx, *w, torch.zeros(3), torch.zeros(3))
    with pytest.raises(ValueError, match="shapes do not match"):
        degrid(torch.zeros(9, 9), torch.zeros(9, 9), idx[0],
               torch.zeros(4, dtype=torch.int64), *w)


# ---------------------------------------------------------------------------
# B4 over a serving pump: G rows, the weights from the table
# ---------------------------------------------------------------------------

# G rows -> support W; the layouts cycle through LAYOUTS
PUMPS = {1: 8, 3: 6, 7: 8}
LAYOUTS = ("interleaved", "complex", "host")


def _pump_inputs(G, W, dtype, seed):
    """G planar host rows of mixed sizes, and B samples spread over them in
    random order: slots, first taps from [-2W, size + 2) (wrapped from
    negative indices, clamped past the far edge, inside), fractions with
    the edge values 0, nextafter(1, 0) and a multiple of 1/oversample."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(W + 3, 60, size=G)
    rows = [rng.standard_normal((n, n, 2)).astype(dtype) for n in sizes]
    B = 40 * G + 3
    slot = rng.integers(0, G, size=B)
    iu0 = rng.integers(-2 * W, sizes[slot] + 2)
    iv0 = rng.integers(-2 * W, sizes[slot] + 2)
    fu, fv = rng.uniform(0, 1, size=(2, B))
    fu[:3] = [0.0, np.nextafter(1.0, 0.0), 5 / 128]
    fv[:3] = [np.nextafter(1.0, 0.0), 0.0, 0.25]
    return rows, slot, iu0, iv0, fu, fv


def _layout(row, layout):
    """A host row as the serve path hands it over: a torch tensor of the
    interleaved [..., 2] layout, a complex tensor, or the numpy array."""
    if layout == "host":
        return row
    t = torch.from_numpy(row)
    return torch.view_as_complex(t) if layout == "complex" else t


def _pump_reference(rows, slot, iu0, iv0, fu, fv, W, dtype, interpret):
    """The JAX package's degrid, row by row, fed its own weights."""
    from swiftly_tpu import vis as jvis

    k = jvis.VisKernel(support=W)
    cu = k.weights(fu, dtype=np.float64).astype(dtype)
    cv = k.weights(fv, dtype=np.float64).astype(dtype)
    ref = np.zeros(slot.size, dtype=np.complex128)
    for g, row in enumerate(rows):
        sel = np.flatnonzero(slot == g)
        if sel.size == 0:
            continue
        args = (row, iu0[sel], iv0[sel], cu[sel], cv[sel])
        ref[sel] = (_b4_pallas_interpret(*args) if interpret
                    else jvis.degrid_batch(*args))
    return ref


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("interpret", [False, True],
                         ids=["einsum", "pallas-interpret"])
@pytest.mark.parametrize("G", sorted(PUMPS))
def test_degrid_rows_plain_matches_jax(G, interpret, dtype):
    W = PUMPS[G]
    rows, slot, iu0, iv0, fu, fv = _pump_inputs(G, W, dtype, seed=G)
    ref = _pump_reference(rows, slot, iu0, iv0, fu, fv, W, dtype, interpret)
    table = torch.from_numpy(vis_kernel(support=W).table)
    planes = [split_row_planes(_layout(row, LAYOUTS[g % 3]))
              for g, row in enumerate(rows)]
    vr, vi = degrid_rows_plain(planes, *_t(slot, iu0, iv0, fu, fv), table)
    got = vr.numpy() + 1j * vi.numpy()
    assert _rel(got, ref) <= REL[dtype]
    # the pump through the port's vis layer: host rows beside torch rows
    port = vis_degrid_rows([_layout(row, LAYOUTS[g % 3])
                            for g, row in enumerate(rows)],
                           slot, iu0, iv0, fu, fv, table, device="cpu")
    assert port.dtype == np.complex128 and port.shape == slot.shape
    assert _rel(port, ref) <= REL[dtype]


@pytest.mark.parametrize("params", [(8, 128, 0.75), (6, 64, 0.5),
                                    (4, 100, 0.3)], ids=str)
def test_tap_weights_equal_the_reference_bit_for_bit(params):
    """The weights B4 computes from the table are the reference's
    ``VisKernel.weights(frac, float64)`` cast to the row dtype, bit for
    bit (compared as integers, so -0.0 and 0.0 differ)."""
    from swiftly_tpu import vis as jvis

    jk = jvis.VisKernel(*params)
    oversample = params[1]
    rng = np.random.default_rng(oversample)
    frac = np.concatenate([
        [0.0, -0.0, np.nextafter(1.0, 0.0), np.nextafter(0.0, 1.0), 1.0,
         1.5, -0.25],
        np.arange(oversample + 1) / oversample,
        rng.uniform(0, 1, size=500)])
    table = torch.from_numpy(jk.table)
    for np_dt, dt, bits in ((np.float32, torch.float32, np.uint32),
                            (np.float64, torch.float64, np.uint64)):
        want = jk.weights(frac, dtype=np.float64).astype(np_dt)
        got = tap_weights(torch.from_numpy(frac), table, dt).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(bits), want.view(bits))


def test_tap_table_that_would_be_read_past_its_end_is_refused():
    """A table of one row: the host's lookup reads row 1 and raises; the
    port refuses the table before any lookup or launch."""
    from swiftly_tpu import vis as jvis

    jk = jvis.VisKernel(4, 4, 0.3)
    jk.table, jk.oversample = jk.table[:1], 0
    with pytest.raises(IndexError):
        jk.weights(np.array([0.5]))
    one_row = torch.from_numpy(jk.table)
    with pytest.raises(ValueError, match="past the table"):
        check_tap_table(one_row)
    with pytest.raises(ValueError, match="past the table"):
        tap_weights(torch.tensor([0.5], dtype=torch.float64), one_row,
                    torch.float32)
    rows, slot, iu0, iv0, fu, fv = _pump_inputs(1, 4, np.float32, seed=0)
    planes = [split_row_planes(torch.from_numpy(rows[0]))]
    with pytest.raises(ValueError, match="past the table"):
        degrid_rows(planes, *_t(slot, iu0, iv0, fu, fv), one_row)
    with pytest.raises(ValueError, match="float64"):
        check_tap_table(one_row.float())
    assert check_tap_table(torch.from_numpy(vis_kernel().table)) == (128, 8)


def test_degrid_rows_cap_per_row():
    """4096 samples a row pass and 4097 raise the reference's cap, whatever
    the pump holds in all."""
    W = 4
    row = np.zeros((24, 24, 2), dtype=np.float32)
    k = torch.from_numpy(vis_kernel(support=W).table)
    slot = np.repeat([0, 1], [4096, 4000])
    zeros = np.zeros(slot.size)
    out = vis_degrid_rows([row, row], slot, zeros.astype(int),
                          zeros.astype(int), zeros, zeros, k, device="cpu")
    assert out.shape == (8096,) and not out.any()
    slot = np.repeat([0, 1], [10, 4097])
    with pytest.raises(ValueError, match="at most 4096"):
        vis_degrid_rows([row, row], slot, slot * 0, slot * 0, slot * 0.0,
                        slot * 0.0, k, device="cpu")


def test_degrid_rows_wrapper_on_cpu_is_the_plain_version():
    rows, slot, iu0, iv0, fu, fv = _pump_inputs(3, 8, np.float32, seed=6)
    planes = [split_row_planes(torch.from_numpy(r)) for r in rows]
    args = (planes, *_t(slot, iu0, iv0, fu, fv),
            torch.from_numpy(vis_kernel().table))
    degrid_stats.reset()
    got, want = degrid_rows(*args), degrid_rows_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].abs().sum() > 0
    assert degrid_stats.launches == 0 and not degrid_stats.shapes


def test_degrid_rows_never_falls_back_for_non_cpu_tensors():
    """Rows that are not on the CPU never reach the plain version."""
    meta = [(torch.empty((9, 9), device="meta"),) * 2]
    idx = torch.zeros(3, dtype=torch.int64)
    frac = torch.zeros(3, dtype=torch.float64)
    table = torch.from_numpy(vis_kernel().table)
    with pytest.raises(ValueError, match="CUDA device"):
        degrid_rows(meta, idx, idx, idx, frac, frac, table)
    with pytest.raises(ValueError, match="CUDA device"):
        degrid_rows(meta, idx, idx, idx, frac, frac, table.to("meta"))
    with pytest.raises(TypeError, match="on the host"):
        degrid_rows(meta, idx, idx, idx, frac.float(), frac, table)
    with pytest.raises(ValueError, match="row slots"):
        degrid_rows(meta, idx + 1, idx, idx, frac, frac, table)
    with pytest.raises(ValueError, match="expected"):
        degrid_rows(meta, idx, idx[:2], idx, frac, frac, table)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the B4 and grid CUDA kernels have "
                    "no CPU mode")
    return torch.device("cuda")


def _cuda_inputs(shape, dtype, device, one_pixel=False):
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    row, iu0, iv0, cu, cv, y = _inputs(shape, np_dt, seed=5,
                                       one_pixel=one_pixel)
    row = torch.as_tensor(row, device=device)
    iu0, iv0, cu, cv = (torch.as_tensor(a, device=device)
                        for a in (iu0, iv0, cu, cv))
    yr, yi = (torch.as_tensor(a.astype(np_dt), device=device)
              for a in (y.real, y.imag))
    return row, iu0, iv0, cu, cv, yr, yi


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_cuda_degrid_matches_plain(cuda_device, dtype, tol):
    for shape in SHAPES + [(448, 4096, 8)]:
        row, iu0, iv0, cu, cv, _, _ = _cuda_inputs(shape, dtype, cuda_device)
        planes = (row[..., 0], row[..., 1])
        before = degrid_stats.launches
        vr, vi = degrid(*planes, iu0, iv0, cu, cv)
        torch.cuda.synchronize()
        assert degrid_stats.launches == before + 1
        pr, pi = degrid_plain(*planes, iu0, iv0, cu, cv)
        scale = max(pr.abs().max().item(), pi.abs().max().item())
        err = max((vr - pr).abs().max().item(), (vi - pi).abs().max().item())
        assert err / scale <= tol, (shape, err / scale)
        # the first two lanes alone (B = 2) give the same bits
        v2r, v2i = degrid(*planes, iu0[:2], iv0[:2], cu[:2], cv[:2])
        assert torch.equal(v2r, vr[:2]) and torch.equal(v2i, vi[:2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_cuda_degrid_rows_matches_plain(cuda_device, dtype, tol):
    """B4 over a pump against its plain version; bitwise equal to B4 on
    each row fed the host's weights, and to the same pump with its rows
    and samples in another order."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    for G, W in PUMPS.items():
        rows, slot, iu0, iv0, fu, fv = _pump_inputs(G, W, np_dt, seed=G)
        host = [_layout(row, LAYOUTS[g % 3]) for g, row in enumerate(rows)]
        planes = [split_row_planes(torch.as_tensor(r, device=cuda_device))
                  for r in host]
        table = torch.as_tensor(vis_kernel(support=W).table,
                                device=cuda_device)
        samples = _t(slot, iu0, iv0, fu, fv)
        before = degrid_stats.launches
        vr, vi = degrid_rows(planes, *samples, table)
        torch.cuda.synchronize()
        assert degrid_stats.launches == before + 1
        pr, pi = degrid_rows_plain(planes, *samples, table)
        scale = max(pr.abs().max().item(), pi.abs().max().item())
        err = max((vr - pr).abs().max().item(), (vi - pi).abs().max().item())
        assert err / scale <= tol, (G, err / scale)
        k = vis_kernel(support=W)
        cu, cv = (torch.as_tensor(k.weights(f, np.float64).astype(np_dt),
                                  device=cuda_device) for f in (fu, fv))
        idx = [torch.as_tensor(a, device=cuda_device) for a in (iu0, iv0)]
        for g in range(G):
            sel = torch.as_tensor(np.flatnonzero(slot == g),
                                  device=cuda_device)
            dr, di = degrid(*planes[g], idx[0][sel], idx[1][sel], cu[sel],
                            cv[sel])
            assert torch.equal(dr, vr[sel]) and torch.equal(di, vi[sel])
        perm = np.random.default_rng(G).permutation(slot.size)
        again = degrid_rows(planes[::-1], *_t(G - 1 - slot[perm], iu0[perm],
                                              iv0[perm], fu[perm], fv[perm]),
                            table)
        p = torch.as_tensor(perm, device=cuda_device)
        assert torch.equal(again[0], vr[p]) and torch.equal(again[1], vi[p])


# (row size, B, support W, indices): ragged shapes, a hot subgrid's
# B ~ 3300 at 448^2, and first taps that wrap across the plane's ends
GRID_CUDA_CASES = [(*shape, "inside") for shape in SHAPES + [(448, 1000, 8)]] + [
    (448, 3300, 8, "inside"), (448, 3300, 8, "wrapped"),
    (70, 200, 4, "wrapped"), (70, 200, 6, "wrapped"), (61, 300, 8, "wrapped"),
    (448, 500, 6, "wrapped"), (5, 40, 8, "wrapped"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_grid_matches_plain(cuda_device, dtype):
    """The kernel gives the plain version's bits, which add each pixel's
    contributions in sample order with the same rounded operations."""
    for one_pixel in (False, True):
        for size, B, W, where in GRID_CUDA_CASES:
            if one_pixel and where == "wrapped":
                continue
            # (a plane narrower than the support takes its weights from a
            # wider one's inputs; only its indices matter here)
            _, iu0, iv0, cu, cv, yr, yi = _cuda_inputs(
                (max(size, W), B, W), dtype, cuda_device, one_pixel=one_pixel)
            if where == "wrapped":
                iu0, iv0 = (torch.as_tensor(a, device=cuda_device)
                            for a in _wrapped_indices(size, B, W, seed=B))
            acc0 = torch.randn((size + 3, size + 2, 2), dtype=dtype,
                               device=cuda_device)
            outs = []
            for fn in (grid, grid, grid_plain):
                acc = acc0.clone()
                view = acc[1:1 + size, 2:2 + size]
                fn(view[..., 0], view[..., 1], iu0, iv0, cu, cv, yr, yi)
                outs.append(acc)
            torch.cuda.synchronize()
            got, again, want = outs
            assert torch.equal(got, again)  # deterministic
            assert torch.equal(got, want), (size, B, W, where, one_pixel)
            assert not torch.equal(got, acc0)
