"""Kernel B3 (planar complex matmul) of the port.

On the CPU the wrapper runs the plain version (four torch.matmul
products), held here against the JAX package's Pallas kernel
`cmatmul_pallas` in interpreter mode on the same float32 inputs, with the
f32 sum-reorder bound of tests/test_pallas.py (max relative error 1e-5).
The CUDA kernel itself runs only on a GPU: the `cuda`-marked test compares
it with the plain version there and skips elsewhere. The JAX package is
imported inside the test that needs it, so that the GPU machine, which has
no JAX, can run this file's cuda tests:
``python -m pytest --noconftest tests/test_torch_kernels.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from swiftly_tpu_torch.ops import kernels
from swiftly_tpu_torch.ops.kernels import cmatmul, cmatmul_plain, cmatmul_stats

SHAPES = [
    (8, 16, 16),      # single block
    (300, 228, 228),  # ragged: exercises padding on every axis
    (512, 256, 512),  # multi-block contraction
]


def _inputs(B, K, N, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, K)) + 1j * rng.normal(size=(B, K))
    w = rng.normal(size=(K, N)) + 1j * rng.normal(size=(K, N))
    return z, w


@pytest.mark.parametrize("B,K,N", SHAPES)
def test_cmatmul_plain_matches_pallas_interpret(B, K, N):
    import jax.numpy as jnp

    from swiftly_tpu.ops.pallas_kernels import cmatmul_pallas

    z, w = _inputs(B, K, N)
    planes = [np.ascontiguousarray(x, dtype=np.float32)
              for x in (z.real, z.imag, w.real, w.imag)]
    pr, pi = cmatmul_pallas(*map(jnp.asarray, planes), bm=128, bn=128, bk=128,
                            interpret=True)
    ref = np.asarray(pr) + 1j * np.asarray(pi)
    outr, outi = cmatmul_plain(*map(torch.from_numpy, planes))
    got = outr.numpy() + 1j * outi.numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() / scale < 1e-5
    # both sit within the same bound of the exact float64 product
    assert np.abs(got - z @ w).max() / np.abs(z @ w).max() < 1e-5


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    z, w = _inputs(40, 24, 32, seed=1)
    planes = [torch.as_tensor(x) for x in (z.real, z.imag, w.real, w.imag)]
    cmatmul_stats.reset()
    got = cmatmul(*planes)
    want = cmatmul_plain(*planes)
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))
    assert cmatmul_stats.launches == 0 and not cmatmul_stats.shapes


def test_wrapper_never_falls_back_for_non_cpu_tensors():
    """A tensor that is not on the CPU never reaches the plain version:
    the wrapper checks it for the kernel and raises."""
    meta = [torch.empty(s, device="meta") for s in ((4, 8), (4, 8), (8, 4), (8, 4))]
    with pytest.raises(ValueError, match="CUDA device"):
        cmatmul(*meta)
    mixed = [torch.empty(4, 8), torch.empty(4, 8, device="meta"),
             torch.empty(8, 4), torch.empty(8, 4)]
    with pytest.raises(ValueError, match="CUDA device"):
        cmatmul(*mixed)


def test_kernel_stats_count_and_reset():
    stats = kernels.KernelStats("probe")
    stats.record((1, 2, 3))
    stats.record((1, 2, 3))
    stats.record((4, 5, 6))
    assert stats.launches == 3 and stats.shapes[(1, 2, 3)] == 2
    stats.reset()
    assert stats.launches == 0 and not stats.shapes


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the B3 CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_cuda_kernel_matches_plain(cuda_device, dtype, tol):
    shapes = SHAPES + [(1, 1, 1), (70001, 256, 256), (4100, 512, 512),
                       (257, 1024, 1024)]
    for k, (B, K, N) in enumerate(shapes):
        g = torch.Generator(device=cuda_device).manual_seed(k)
        zr, zi = (torch.randn(B, K, generator=g, device=cuda_device, dtype=dtype)
                  for _ in range(2))
        wr, wi = (torch.randn(K, N, generator=g, device=cuda_device, dtype=dtype)
                  for _ in range(2))
        before = cmatmul_stats.launches
        outr, outi = cmatmul(zr, zi, wr, wi)
        torch.cuda.synchronize()
        assert cmatmul_stats.launches == before + 1
        pr, pi = cmatmul_plain(zr, zi, wr, wi)
        scale = max(pr.abs().max().item(), pi.abs().max().item())
        err = max((outr - pr).abs().max().item(), (outi - pi).abs().max().item())
        assert err / scale <= tol, (B, K, N, err / scale)
        again = cmatmul(zr, zi, wr, wi)
        assert torch.equal(again[0], outr) and torch.equal(again[1], outi)
    with pytest.raises(ValueError, match="contiguous"):
        cmatmul(zr.T.contiguous().T, zi, wr, wi)
