"""Kernels B1 (fused column pass) and B2 (adjoint sampled fold) of the port.

On the CPU each wrapper runs its kernel's plain version (``torch.matmul``
products), held here against the JAX package's Pallas kernels
``colpass_pallas`` and ``bwd_fold_pallas`` in interpreter mode and against
a float64 numpy einsum of the same product, on the same seeded inputs, in
float64, with a relative bound of 1e-12 (f64 rounding over contractions of
at most a few hundred terms is ~1e-15). The shapes are ragged (no size a
multiple of the kernels' tiles) and cover both forms of B1 and its facet
broadcast (Fx = 1). The CUDA kernels run only on a GPU: the ``cuda``-marked
tests compare them with the plain versions there and skip elsewhere. The
JAX package is imported inside the tests that need it, so the GPU machine,
which has no JAX, can run this file's cuda tests:
``python -m pytest --noconftest tests/test_torch_streamed_kernels.py -m cuda``.
"""

import functools
from unittest import mock

import numpy as np
import pytest
import torch

from swiftly_tpu_torch.ops import kernels
from swiftly_tpu_torch.ops.kernels import (
    OUT_ELEMENTS,
    OUT_PAIRS,
    OUT_RUNS_M,
    OUT_RUNS_N,
    PATH_L_RUNS,
    PATH_R_RUNS,
    colpass,
    colpass_plain,
    colpass_stats,
    fold,
    fold_plain,
    fold_stats,
)

REL = 1e-12

# (S, F, Fx, M, P, Q, N, reduce_f)
B1_SHAPES = [
    (5, 3, 3, 40, 24, 24, 40, True),   # the forward form
    (5, 3, 1, 40, 24, 24, 40, False),  # the adjoint form, X broadcast over f
    (4, 2, 2, 33, 17, 50, 21, False),
    (3, 2, 1, 70, 40, 9, 65, True),
]
# (F, B, J, R)
B2_SHAPES = [(3, 40, 56, 24), (2, 70, 100, 50), (1, 9, 130, 17)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs beside other pytest-xdist workers on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _c(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _b1_inputs(shape, seed=0):
    S, F, Fx, M, P, Q, N, _ = shape
    rng = np.random.default_rng(seed)
    return _c(rng, (F, M, P)), _c(rng, (S, Fx, P, Q)), _c(rng, (F, Q, N))


def _planes(*arrays):
    out = []
    for a in arrays:
        out += [torch.from_numpy(np.ascontiguousarray(a.real)),
                torch.from_numpy(np.ascontiguousarray(a.imag))]
    return out


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def _b1_exact(A, X, B, reduce_f):
    X = np.broadcast_to(X, (X.shape[0], A.shape[0]) + X.shape[2:])
    if reduce_f:
        return np.einsum("fmp,sfpq,fqn->smn", A, X, B)
    return np.einsum("fmp,sfpq,fqn->sfmn", A, X, B)


@pytest.mark.parametrize("shape", B1_SHAPES, ids=str)
def test_colpass_plain_matches_pallas_interpret(shape):
    import jax.numpy as jnp

    from swiftly_tpu.ops.pallas_kernels import colpass_pallas

    reduce_f = shape[-1]
    A, X, B = _b1_inputs(shape)
    planes = _planes(A, X, B)
    pr, pi = colpass_pallas(*[jnp.asarray(p.numpy()) for p in planes],
                            reduce_f=reduce_f, bm=32, bn=32, bk=16,
                            interpret=True)
    ref = np.asarray(pr) + 1j * np.asarray(pi)
    outr, outi = colpass_plain(*planes, reduce_f=reduce_f)
    got = outr.numpy() + 1j * outi.numpy()
    assert got.shape == ref.shape
    assert _rel(got, ref) < REL
    # and both are the einsum chain of the column-pass bodies
    assert _rel(got, _b1_exact(A, X, B, reduce_f)) < REL


@pytest.mark.parametrize("shape", B2_SHAPES, ids=str)
def test_fold_plain_matches_pallas_interpret(shape):
    """B2's plain version updates an [F, B, J] accumulator block in place;
    the Pallas kernel takes the facet axis folded into J (the JAX caller's
    layout), and gives the same block."""
    import jax.numpy as jnp

    from swiftly_tpu.ops.pallas_kernels import bwd_fold_pallas

    F, B, J, R = shape
    rng = np.random.default_rng(1)
    acc = rng.normal(size=(F, B + 5, J, 2))
    bc, bs = rng.normal(size=(R, B)), rng.normal(size=(R, B))
    rows = _c(rng, (F, R, J))
    w = rng.uniform(size=B)

    def flat(a):  # [F, B, J] -> [B, F*J]
        return np.moveaxis(a, 0, 1).reshape(a.shape[1], F * J)

    blk = acc[:, 3:3 + B]
    pr, pi = bwd_fold_pallas(
        jnp.asarray(flat(blk[..., 0])), jnp.asarray(flat(blk[..., 1])),
        jnp.asarray(bc), jnp.asarray(bs), jnp.asarray(flat(rows.real)),
        jnp.asarray(flat(rows.imag)), jnp.asarray(w[:, None]),
        bm=32, bn=64, bk=16, interpret=True,
    )
    ref = np.moveaxis(
        (np.asarray(pr) + 1j * np.asarray(pi)).reshape(B, F, J), 0, 1)

    t_acc = torch.from_numpy(acc.copy())
    cur = t_acc[:, 3:3 + B]
    fold_plain(cur[..., 0], cur[..., 1], torch.from_numpy(bc),
               torch.from_numpy(bs), torch.from_numpy(rows.real.copy()),
               torch.from_numpy(rows.imag.copy()), torch.from_numpy(w))
    got = t_acc.numpy()
    got_blk = got[:, 3:3 + B, :, 0] + 1j * got[:, 3:3 + B, :, 1]
    update = ref - (blk[..., 0] + 1j * blk[..., 1])
    assert np.abs(got_blk - ref).max() / np.abs(update).max() < REL
    # the exact adjoint product, and nothing written outside the block
    exact = (blk[..., 0] + 1j * blk[..., 1]) + w[None, :, None] * np.einsum(
        "rb,frj->fbj", bc - 1j * bs, rows)
    assert np.abs(got_blk - exact).max() / np.abs(update).max() < REL
    assert np.array_equal(got[:, :3], acc[:, :3])
    assert np.array_equal(got[:, 3 + B:], acc[:, 3 + B:])


def test_wrappers_on_cpu_are_the_plain_versions_and_launch_nothing():
    shape = B1_SHAPES[1]
    planes = _planes(*_b1_inputs(shape, seed=2))
    colpass_stats.reset()
    fold_stats.reset()
    got = colpass(*planes, reduce_f=False)
    want = colpass_plain(*planes, reduce_f=False)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    rng = np.random.default_rng(3)
    F, B, J, R = B2_SHAPES[0]
    args = [torch.from_numpy(rng.normal(size=s)) for s in
            ((R, B), (R, B), (F, R, J), (F, R, J), (B,))]
    acc1, acc2 = (torch.from_numpy(rng.normal(size=(F, B, J, 2)))
                  for _ in range(2))
    acc2.copy_(acc1)
    fold(acc1[..., 0], acc1[..., 1], *args)
    fold_plain(acc2[..., 0], acc2[..., 1], *args)
    assert torch.equal(acc1, acc2)
    assert colpass_stats.launches == 0 and not colpass_stats.shapes
    assert fold_stats.launches == 0 and not fold_stats.shapes


def test_wrappers_never_fall_back_for_non_cpu_tensors():
    """A tensor that is not on the CPU never reaches a plain version: the
    wrapper checks it for the kernel and raises."""
    meta = [torch.empty(s, device="meta") for s in
            ((2, 4, 3), (2, 4, 3), (5, 2, 3, 6), (5, 2, 3, 6), (2, 6, 4),
             (2, 6, 4))]
    with pytest.raises(ValueError, match="CUDA device"):
        colpass(*meta)
    acc = torch.empty((2, 3, 5), device="meta")
    args = [torch.empty(s) for s in ((4, 3), (4, 3), (2, 4, 5), (2, 4, 5),
                                     (3,))]
    with pytest.raises(ValueError, match="CUDA device"):
        fold(acc, acc, *args)
    with pytest.raises(ValueError, match="shapes do not"):
        colpass(*[torch.empty(s) for s in ((2, 4, 3), (2, 4, 3), (5, 2, 7, 6),
                                           (5, 2, 7, 6), (2, 6, 4),
                                           (2, 6, 4))])


# -- the launches the wrappers build for the tile engine (csrc/cgemm.cuh) --
#
# On the CPU the wrappers run the plain versions, so the launches they build
# on the card (strides, sizes, copy paths) are checked here directly:
# `kernels.cgemm_emulate` computes what one launch of the engine computes,
# through the same strides, and the launches together must give the plain
# version's result. The layouts are those of chip_smoke.py's ragged checks.

B1_LAYOUTS = ["path", "planar", "offset"]
B2_LAYOUTS = ["path", "odd", "planar", "shifted"]


def _b1_layout(shape, layout, dtype, seed=0, device="cpu"):
    """B1's six planes at `shape` in `layout`: "path", strided views of
    interleaved tensors as the streamed path passes them (X a permuted
    gather, or broadcast over f when Fx = 1); "planar", contiguous planes;
    "offset", contiguous planes one element off 16-byte alignment."""
    S, F, Fx, M, P, Q, N, _ = shape
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*dims):
        return torch.randn(dims, generator=g, dtype=dtype, device=device)

    if layout == "path":
        A = randn(F, M, P, 2)
        if Fx == F:
            X = randn(F, P, S, Q, 2).permute(2, 0, 1, 3, 4)
        else:
            X = randn(S, P, Q, 2)[:, None]
        B = randn(F, Q, N, 2)
        return (A[..., 0], A[..., 1], X[..., 0], X[..., 1], B[..., 0],
                B[..., 1])
    skip = {"planar": 0, "offset": 1}[layout]
    planes = []
    for dims in ((F, M, P), (S, Fx, P, Q), (F, Q, N)):
        n = int(np.prod(dims))
        flat = randn(2 * n + skip)[skip:]
        planes += [flat[:n].view(dims), flat[n:].view(dims)]
    return tuple(planes)


def _b2_layout(shape, layout, dtype, seed=0, device="cpu"):
    """(accumulator tensor, block(acc) -> (acc_r, acc_i), (bc, bs, rr, ri,
    w)) at `shape` in `layout`: "path", a row block of an interleaved
    accumulator; "odd", an odd first row with phases and rows off 16-byte
    alignment; "planar", contiguous accumulator planes; "shifted", the block
    one (re, im) pair into its rows."""
    F, B, J, R = shape
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*dims):
        return torch.randn(dims, generator=g, dtype=dtype, device=device)

    if layout == "planar":
        acc = randn(2, F, B, J)
        block = lambda a: (a[0], a[1])  # noqa: E731
    elif layout == "shifted":
        acc = randn(F, B + 3, J + 1, 2)
        block = lambda a: (a[:, 2:2 + B, 1:, 0], a[:, 2:2 + B, 1:, 1])  # noqa: E731
    else:
        start = 1 if layout == "odd" else 2
        acc = randn(F, B + 3, J, 2)
        block = lambda a: (a[:, start:start + B, :, 0],  # noqa: E731
                           a[:, start:start + B, :, 1])
    if layout == "odd":
        bc, bs = randn(R, B + 1)[:, 1:], randn(R, B + 1)[:, 1:]
        rr, ri = (randn(F * R * J + 1)[1:].view(F, R, J) for _ in range(2))
    else:
        bc, bs, rr, ri = randn(R, B), randn(R, B), randn(F, R, J), randn(F, R, J)
    return acc, block, (bc, bs, rr, ri, torch.rand((B,), generator=g,
                                                   dtype=dtype, device=device))


def _run_colpass_launches(planes, reduce_f):
    """B1 through the launches `colpass` builds, each emulated on the CPU;
    returns the output planes and the launches."""
    F, M, P, S, Fx, Q, N = kernels._colpass_shapes(*planes)
    dt = planes[0].dtype
    shape = (S, M, N) if reduce_f else (S, F, M, N)
    outr, outi = torch.empty(shape, dtype=dt), torch.empty(shape, dtype=dt)
    t = kernels.colpass_staging(S, F, M, Q, dt, "cpu")
    launches = kernels.colpass_launches(*planes, t, outr, outi, reduce_f)
    for ln in launches:
        kernels.cgemm_emulate(ln)
    return (outr, outi), launches


def _run_fold_launch(acc, block, args):
    """B2 through the launch `fold` builds, emulated on the CPU, in place."""
    ln = kernels.fold_launch(*block(acc), *args[:4])
    kernels.cgemm_emulate(ln, w=args[4], conj_l=True)
    return ln


@pytest.mark.parametrize("layout", B1_LAYOUTS)
@pytest.mark.parametrize("shape", B1_SHAPES, ids=str)
def test_colpass_launches_compute_the_product(shape, layout):
    planes = _b1_layout(shape, layout, torch.float64, seed=4)
    (gr, gi), _ = _run_colpass_launches(planes, shape[-1])
    pr, pi = colpass_plain(*planes, reduce_f=shape[-1])
    scale = max(pr.abs().max().item(), pi.abs().max().item())
    assert (gr - pr).abs().max().item() / scale < REL
    assert (gi - pi).abs().max().item() / scale < REL


@pytest.mark.parametrize("layout", B2_LAYOUTS)
@pytest.mark.parametrize("shape", B2_SHAPES, ids=str)
def test_fold_launch_computes_the_update(shape, layout):
    acc, block, args = _b2_layout(shape, layout, torch.float64, seed=5)
    got, want = acc.clone(), acc.clone()
    _run_fold_launch(got, block, args)
    fold_plain(*block(want), *args)
    scale = (want - acc).abs().max().item()
    assert (got - want).abs().max().item() / scale < REL
    outside = torch.ones_like(acc, dtype=torch.bool)
    for view in block(outside):
        view.fill_(False)
    assert torch.equal(got[outside], acc[outside])


def _paths(ln):
    """(L in runs, R in runs, output path) of one launch."""
    return (bool(ln.paths & PATH_L_RUNS), bool(ln.paths & PATH_R_RUNS),
            ln.paths >> 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_copy_paths_follow_alignment_and_layout(dtype):
    """16-byte runs only where the fast axis is contiguous, a whole number
    of runs long, every other stride a whole number of runs and both planes
    16-byte aligned; the narrower paths take the rest."""
    v = 16 // torch.empty((), dtype=dtype).element_size()  # T in 16 bytes
    # B1 at a path-like shape: the interleaved X is copied one element a
    # copy; A (copied k-major) and T in runs along m, B (copied planar) in
    # runs along n; the output in runs
    _, lns = _run_colpass_launches(
        _b1_layout((2, 3, 3, 64, 24, 32, 40, True), "path", dtype), True)
    assert [_paths(ln) for ln in lns] == [(True, False, OUT_RUNS_M),
                                          (True, True, OUT_RUNS_N)]
    assert lns[0].L.strides == (0, 24 * 64, 0, 1, 64)  # A's copy
    assert lns[1].R.strides == (0, 0, 32 * 40, 40, 1)  # B's, f summed
    _, lns = _run_colpass_launches(
        _b1_layout((2, 3, 1, 64, 24, 32, 40, False), "path", dtype), False)
    assert lns[1].R.strides == (0, 32 * 40, 0, 40, 1)  # f a batch axis
    # contiguous planes: X and B in runs along n as well
    _, lns = _run_colpass_launches(
        _b1_layout((2, 3, 3, 64, 24, 32, 40, True), "planar", dtype), True)
    assert [_paths(ln) for ln in lns] == [(True, True, OUT_RUNS_M),
                                          (True, True, OUT_RUNS_N)]
    # one element off alignment: X one element a copy again (A and B are
    # copied)
    _, lns = _run_colpass_launches(
        _b1_layout((2, 3, 3, 64, 24, 32, 40, True), "offset", dtype), True)
    assert [_paths(ln) for ln in lns] == [(True, False, OUT_RUNS_M),
                                          (True, True, OUT_RUNS_N)]
    # M not a whole number of runs: A as given, T and its reads one element
    # a copy; N not one either: B as given, the output element by element
    planes = _b1_layout((2, 3, 3, 4 * v + 1, 24, 32, 4 * v + 1, True),
                        "planar", dtype)
    _, lns = _run_colpass_launches(planes, True)
    assert [_paths(ln) for ln in lns] == [(False, True, OUT_ELEMENTS),
                                          (False, False, OUT_ELEMENTS)]
    assert lns[0].L.re is planes[0] and lns[1].R.re is planes[4]
    # B2: phases and rows in runs, the interleaved block as (re, im) pairs
    F, B, J, R = 2, 8 * v, 16 * v, 24
    for layout, want in (
            ("path", (True, True, OUT_PAIRS)),
            ("planar", (True, True, OUT_RUNS_N)),
            # a pair is 8 bytes: one pair in, a float32 block is off 16-byte
            # alignment, a float64 one is not
            ("shifted", (True, True, OUT_PAIRS if v == 2 else OUT_ELEMENTS))):
        acc, block, args = _b2_layout((F, B, J, R), layout, dtype)
        assert _paths(kernels.fold_launch(*block(acc), *args[:4])) == want
    # odd J, odd first row, phases and rows one element off alignment
    acc, block, args = _b2_layout((F, B, J + 1, R), "odd", dtype)
    assert _paths(kernels.fold_launch(*block(acc), *args[:4])) == (
        False, False, OUT_PAIRS if v == 2 else OUT_ELEMENTS)


@functools.cache
def _path_views():
    """The planes `colpass` (forward, adjoint) and `fold` are given on the
    streamed path, float32 as on the card, at 1k[1]-n512-256 on the CPU:
    the first call of each, captured from one round trip through the
    public entry points."""
    import swiftly_tpu_torch as st

    seen = {}

    def spy(name, fn):
        def wrapped(*args, **kw):
            key = (name if name == "fold"
                   else ("colpass_forward" if kw.get("reduce_f", True)
                         else "colpass_adjoint"))
            seen.setdefault(key, (args, kw))
            return fn(*args, **kw)
        return wrapped

    cfg = st.SwiftlyConfig(backend="planar", dtype=torch.float32,
                           device="cpu", **st.SWIFT_CONFIGS["1k[1]-n512-256"])
    fcs = st.make_full_facet_cover(cfg)
    sgcs = st.make_full_subgrid_cover(cfg)
    tasks = [(fc, st.make_facet(cfg.image_size, fc, [(1.0, 1, 0)]))
             for fc in fcs]
    with mock.patch.object(kernels, "colpass", spy("colpass", kernels.colpass)), \
            mock.patch.object(kernels, "fold", spy("fold", kernels.fold)):
        fwd = st.StreamedForward(cfg, tasks, residency="device")
        bwd = st.StreamedBackward(cfg, fcs, residency="sampled")
        st.feed_backward_passes(fwd, sgcs, [bwd])
    return seen


# the copy paths each launch takes at the path's views (float32): B1's
# interleaved X one element a copy, its operators A and B (copied with
# their run axis contiguous) and its staged T in 16-byte runs, B2 all in
# 16-byte runs and (re, im) pairs
PATH_COPY_PATHS = {
    "colpass_forward": [(True, False, OUT_RUNS_M), (True, True, OUT_RUNS_N)],
    "colpass_adjoint": [(True, False, OUT_RUNS_M), (True, True, OUT_RUNS_N)],
    "fold": [(True, True, OUT_PAIRS)],
}


@pytest.mark.parametrize("call", sorted(PATH_COPY_PATHS))
def test_path_views_take_the_fast_copy_paths(call):
    """At the views the streamed round trip passes (X a permuted gather for
    the forward, broadcast over f for the adjoint; B2's accumulator a row
    block of the interleaved image accumulator), the launches take the
    expected copy paths and compute the plain version's result."""
    args, kw = _path_views()[call]
    if call == "fold":
        acc_r, acc_i, *rest = args
        # a copy of the image accumulator, the block views at their strides
        acc = acc_r._base.clone()
        got_r, got_i = (torch.as_strided(acc, t.shape, t.stride(),
                                         t.storage_offset())
                        for t in (acc_r, acc_i))
        ln = kernels.fold_launch(got_r, got_i, *rest[:4])
        assert [_paths(ln)] == PATH_COPY_PATHS[call]
        before = got_r.clone()
        want_r, want_i = fold_plain(got_r.clone(), got_i.clone(), *rest)
        kernels.cgemm_emulate(ln, w=rest[4], conj_l=True)
        scale = (want_r - before).abs().max().item()
        assert (got_r - want_r).abs().max().item() / scale < 1e-5
        assert (got_i - want_i).abs().max().item() / scale < 1e-5
        return
    (gr, gi), lns = _run_colpass_launches(args, kw.get("reduce_f", True))
    assert [_paths(ln) for ln in lns] == PATH_COPY_PATHS[call]
    pr, pi = colpass_plain(*args, **kw)
    scale = max(pr.abs().max().item(), pi.abs().max().item())
    assert (gr - pr).abs().max().item() / scale < 1e-5
    assert (gi - pi).abs().max().item() / scale < 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the B1 and B2 CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


# B1 and B2 at the 32k path's shapes (B1's S and B2's J cut), in the path's
# layout, beside the ragged shapes in every layout
B1_CUDA = [(shape, layout) for shape in B1_SHAPES for layout in B1_LAYOUTS] + [
    ((74, 9, 9, 512, 256, 256, 512, True), "path"),
    ((20, 9, 1, 256, 512, 512, 256, False), "path"),
    ((4, 3, 1, 132, 40, 33, 72, False), "path"),  # odd Q, interleaved
]
B2_CUDA = [(shape, layout) for shape in B2_SHAPES for layout in B2_LAYOUTS] + [
    ((9, 384, 11264, 256), "path"),
    ((3, 70, 101, 50), "odd"),  # odd J
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_cuda_colpass_matches_plain(cuda_device, dtype, tol):
    for k, (shape, layout) in enumerate(B1_CUDA):
        reduce_f = shape[-1]
        planes = _b1_layout(shape, layout, dtype, seed=k, device=cuda_device)
        before = colpass_stats.launches
        outr, outi = colpass(*planes, reduce_f=reduce_f)
        torch.cuda.synchronize()
        assert colpass_stats.launches == before + 1
        pr, pi = colpass_plain(*planes, reduce_f=reduce_f)
        scale = max(pr.abs().max().item(), pi.abs().max().item())
        err = max((outr - pr).abs().max().item(),
                  (outi - pi).abs().max().item())
        assert err / scale <= tol, (shape, layout, err / scale)
        again = colpass(*planes, reduce_f=reduce_f)
        assert torch.equal(again[0], outr) and torch.equal(again[1], outi)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_cuda_fold_matches_plain(cuda_device, dtype, tol):
    for k, (shape, layout) in enumerate(B2_CUDA):
        acc0, block, args = _b2_layout(shape, layout, dtype, seed=k,
                                       device=cuda_device)
        got, want = acc0.clone(), acc0.clone()
        before = fold_stats.launches
        fold(*block(got), *args)
        torch.cuda.synchronize()
        assert fold_stats.launches == before + 1
        fold_plain(*block(want), *args)
        scale = (want - acc0).abs().max().item()
        assert (got - want).abs().max().item() / scale <= tol, (shape, layout)
        outside = torch.ones_like(acc0, dtype=torch.bool)
        for view in block(outside):
            view.fill_(False)
        assert torch.equal(got[outside], acc0[outside])
        again = acc0.clone()
        fold(*block(again), *args)
        assert torch.equal(again, got)
