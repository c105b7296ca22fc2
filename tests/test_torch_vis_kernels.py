"""Kernel B4 (the visibility degrid reduction) and its adjoint scatter
``grid`` in the port.

On the CPU the wrappers run the plain versions (gather plus ``einsum``;
``index_put_`` rounds that add each pixel's contributions in sample order),
held here against the JAX package's ``degrid_batch`` / ``grid_batch`` on
the same seeded numpy inputs: its einsum path, and B4's Pallas kernel in
interpreter mode. On
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
    degrid,
    degrid_plain,
    degrid_stats,
    grid,
    grid_plain,
    grid_stats,
)
from swiftly_tpu_torch.vis import (
    ADJOINT_TOLERANCE,
    bucket_size,
    degrid_batch,
    grid_batch,
    vis_kernel,
)

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
