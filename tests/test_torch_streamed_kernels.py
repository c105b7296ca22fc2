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

import numpy as np
import pytest
import torch

from swiftly_tpu_torch.ops.kernels import (
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the B1 and B2 CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_cuda_colpass_matches_plain(cuda_device, dtype, tol):
    shapes = B1_SHAPES + [(74, 9, 9, 512, 256, 256, 512, True),
                          (20, 9, 1, 256, 512, 512, 256, False)]
    for k, shape in enumerate(shapes):
        S, F, Fx, M, P, Q, N, reduce_f = shape
        g = torch.Generator(device=cuda_device).manual_seed(k)

        def rand(*s):
            return torch.randn(s + (2,), generator=g, device=cuda_device,
                               dtype=dtype)

        A, X, B = rand(F, M, P), rand(S, Fx, P, Q), rand(F, Q, N)
        planes = (A[..., 0], A[..., 1], X[..., 0], X[..., 1], B[..., 0],
                  B[..., 1])
        before = colpass_stats.launches
        outr, outi = colpass(*planes, reduce_f=reduce_f)
        torch.cuda.synchronize()
        assert colpass_stats.launches == before + 1
        pr, pi = colpass_plain(*planes, reduce_f=reduce_f)
        scale = max(pr.abs().max().item(), pi.abs().max().item())
        err = max((outr - pr).abs().max().item(),
                  (outi - pi).abs().max().item())
        assert err / scale <= tol, (shape, err / scale)
        again = colpass(*planes, reduce_f=reduce_f)
        assert torch.equal(again[0], outr) and torch.equal(again[1], outi)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_cuda_fold_matches_plain(cuda_device, dtype, tol):
    for k, (F, B, J, R) in enumerate(B2_SHAPES + [(9, 384, 11264, 256)]):
        g = torch.Generator(device=cuda_device).manual_seed(k)

        def rand(*s):
            return torch.randn(s, generator=g, device=cuda_device, dtype=dtype)

        acc0 = rand(F, B + 2, J, 2)
        args = (rand(R, B), rand(R, B), rand(F, R, J), rand(F, R, J),
                rand(B))
        got, want = acc0.clone(), acc0.clone()
        before = fold_stats.launches
        fold(got[:, 1:1 + B, :, 0], got[:, 1:1 + B, :, 1], *args)
        torch.cuda.synchronize()
        assert fold_stats.launches == before + 1
        fold_plain(want[:, 1:1 + B, :, 0], want[:, 1:1 + B, :, 1], *args)
        scale = (want - acc0).abs().max().item()
        assert (got - want).abs().max().item() / scale <= tol
        assert torch.equal(got[:, :1], acc0[:, :1])
        assert torch.equal(got[:, 1 + B:], acc0[:, 1 + B:])
