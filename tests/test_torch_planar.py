"""The port's planar matmul FFT vs the JAX planar backend and numpy.

Direct DFTs (n <= 1024, through the B3 kernel's plain version on the CPU)
and the four-step factored FFT (n = 1536, 2048, 4096), with the
tolerances of tests/test_planar.py.
"""

import numpy as np
import pytest
import torch

import swiftly_tpu.ops.numpy_backend as npk
import swiftly_tpu.ops.planar_backend as jplk
import swiftly_tpu_torch.ops.planar_backend as plk


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # the suite runs beside other pytest-xdist workers on the same cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a, dtype=torch.float64):
    return plk.to_planar(a, dtype=dtype, device="cpu")


@pytest.mark.parametrize("n", [8, 13, 100, 448, 512, 1000, 1024, 1536, 2048, 4096])
def test_planar_fft_matches_jax_planar_and_numpy(n):
    rng = np.random.default_rng(0)
    a = rng.normal(size=n) + 1j * rng.normal(size=n)
    got = plk.from_planar(plk.fft(_t(a), 0))
    np.testing.assert_allclose(got, npk.fft(a, 0), atol=1e-10 * n)
    want = jplk.from_planar(jplk.fft(jplk.to_planar(a, np.float64), 0))
    np.testing.assert_allclose(got, want, atol=1e-10 * n)
    back = plk.from_planar(plk.ifft(_t(npk.fft(a, 0)), 0))
    np.testing.assert_allclose(back, a, atol=1e-10 * n)
    want_back = jplk.from_planar(
        jplk.ifft(jplk.to_planar(npk.fft(a, 0), np.float64), 0))
    np.testing.assert_allclose(back, want_back, atol=1e-10 * n)


@pytest.mark.parametrize("axis", [0, 1, -1, -2])
@pytest.mark.parametrize("shape", [(96, 80), (1536, 6)])
def test_planar_fft_2d_axis(shape, axis):
    if shape[axis] > 1024 and axis in (1, -1):
        shape = shape[::-1]
    rng = np.random.default_rng(1)
    a = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    got = plk.from_planar(plk.fft(_t(a), axis))
    np.testing.assert_allclose(got, npk.fft(a, axis % 2), atol=1e-9)
    want = jplk.from_planar(jplk.fft(jplk.to_planar(a, np.float64), axis % 2))
    np.testing.assert_allclose(got, want, atol=1e-9)


@pytest.mark.parametrize("n", [512, 2048])
def test_planar_fft_float32_accuracy(n):
    rng = np.random.default_rng(2)
    a = rng.normal(size=n) + 1j * rng.normal(size=n)
    got = plk.from_planar(plk.fft(_t(a, torch.float32), 0))
    expected = npk.fft(a, 0)
    scale = np.max(np.abs(expected))
    assert np.max(np.abs(got - expected)) / scale < 1e-5


def test_planar_matrices_are_the_reference_matrices():
    """Both packages build their DFT and twiddle matrices in float64 numpy
    the same way, so they transform with identical constants."""
    for n, sign, centred in ((256, -1, True), (512, 1, True), (16, -1, False)):
        for mine, ref in zip(plk._dft_matrix(n, sign, centred),
                             jplk._dft_matrix(n, sign, centred)):
            assert np.array_equal(mine, ref)
    for mine, ref in zip(plk._twiddle(1024, 16, 1), jplk._twiddle(1024, 16, 1)):
        assert np.array_equal(mine, ref)
    for n in (1536, 2048, 16384, 32768):
        assert plk._factor(n) == jplk._factor(n)


def test_planar_l0_roundtrips():
    rng = np.random.default_rng(3)
    a = torch.as_tensor(rng.normal(size=(6, 4, 2)))
    assert torch.equal(plk.extract_mid(plk.pad_mid(a, 12, 0), 6, 0), a)
    emb = plk.wrapped_embed(a, 12, 5, 0)
    np.testing.assert_array_equal(
        emb.numpy(), np.asarray(jplk.wrapped_embed(a.numpy(), 12, 5, 0)))
    assert torch.equal(plk.wrapped_extract(emb, 6, 5, 0), a)
    assert plk.ndim(a) == 2
    assert plk.broadcast_along(torch.ones(4), 2, 1).shape == (1, 4, 1)
    assert plk.broadcast_along(torch.ones(4), 3, -1).shape == (1, 1, 4, 1)
