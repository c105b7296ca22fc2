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

import re
from pathlib import Path

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

# (B, K, N) that B3 gets on the 32k paths: fused, streamed, visibility
PATH_SHAPES = [
    (340992, 256, 256), (170496, 256, 256), (37888, 512, 512),
    (33152, 512, 512), (2304, 512, 512), (4608, 256, 256), (2304, 256, 256),
    (512, 512, 512), (448, 512, 512),
]
# ragged shapes on which the chooser picks each tile variant in turn
# (variant 0, 1), then ones too small to fill the card
VARIANT_SHAPES = [(40000, 100, 300), (4100, 70, 270), (130, 33, 1000),
                  (2300, 33, 250), (300, 228, 228), (1, 1, 1), (70, 5, 1000)]
SMS = kernels.H100_SMS


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


def _c_tiles():
    """{dtype: {variant: (BM, BN)}} as csrc/cmatmul.cu's `launch` dispatches
    them: a case's first tile is f32's and its last f64's (one tile: both)."""
    src = (Path(kernels.__file__).parent.parent / "csrc" / "cmatmul.cu"
           ).read_text()
    body = src.split("switch (variant) {")[1].split("default:")[0]
    parts = re.split(r"case (\d+):", body)
    tiles = {torch.float32: {}, torch.float64: {}}
    for v, case in zip(parts[1::2], parts[2::2]):
        found = re.findall(r"launch_tile<T, (\d+), (\d+),", case)
        tiles[torch.float32][int(v)] = tuple(map(int, found[0]))
        tiles[torch.float64][int(v)] = tuple(map(int, found[-1]))
    return tiles


def test_cmatmul_tiles_match_the_c_dispatch():
    assert _c_tiles() == kernels._CMATMUL_TILES


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,K,N", PATH_SHAPES + VARIANT_SHAPES, ids=str)
def test_cmatmul_config_fills_the_card(B, K, N, dtype):
    """The chosen tile variant is one the C entry knows, and its grid has
    at least one block per SM, or every block any variant could give."""
    variant = kernels._cmatmul_config(B, K, N, dtype)
    assert variant in _c_tiles()[dtype]
    blocks = kernels._cmatmul_blocks(B, N, variant, dtype)
    most = max(kernels._cmatmul_blocks(B, N, v, dtype)
               for v in kernels._CMATMUL_TILES[dtype])
    assert blocks >= SMS or blocks == most, (variant, blocks, most)


def test_cmatmul_config_covers_every_variant():
    for dtype, tiles in kernels._CMATMUL_TILES.items():
        chosen = [kernels._cmatmul_config(*s, dtype) for s in VARIANT_SHAPES[:2]]
        assert chosen == sorted(tiles)
        # the fused path's long batches take the largest tile
        assert {kernels._cmatmul_config(*s, dtype) for s in PATH_SHAPES[:4]} == {0}
    # the rule follows the card's SM count: a card of twice the SMs takes
    # the small tile where an H100 takes the large one
    assert kernels._cmatmul_config(*PATH_SHAPES[0], sms=2 * SMS) == 0
    assert kernels._cmatmul_config(40000, 100, 300, sms=2 * SMS) == 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the B3 CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_cuda_kernel_matches_plain(cuda_device, dtype, tol):
    shapes = SHAPES + VARIANT_SHAPES + [(70001, 256, 256), (4100, 512, 512),
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
        # every tile variant runs the same FMAs per output: the same bits
        for v in kernels._CMATMUL_TILES[dtype]:
            other = kernels._cmatmul_launch(zr, zi, wr, wi, v)
            assert torch.equal(other[0], outr), (B, K, N, v)
            assert torch.equal(other[1], outi), (B, K, N, v)
    with pytest.raises(ValueError, match="contiguous"):
        cmatmul(zr.T.contiguous().T, zi, wr, wi)
