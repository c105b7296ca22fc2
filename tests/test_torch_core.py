"""The port's eight SwiftlyCore primitives vs the JAX package's.

Same numpy inputs (seeded) through `swiftly_tpu` and `swiftly_tpu_torch`:
the complex torch backend ("torch", complex128) against the JAX backend
("jax"), and the planar torch backend (float64, its DFTs through the B3
kernel's plain version on the CPU) against the JAX "planar" backend, over
both axes and several offsets. Tolerance atol 1e-12 (as tests/test_fused.py
holds the fused path to the streaming one in float64) on each output scaled
to unit peak: the inputs are unit normals, and the windows (1/PSWF at the
facet edges) and unnormalised FFTs lift outputs to ~1e5.
"""

import numpy as np
import pytest
import torch

from swiftly_tpu.ops.core import SwiftlyCore as JaxCore
from swiftly_tpu.ops.core import scaled_offset as jax_scaled_offset
import swiftly_tpu_torch.ops.primitives as tpk
import swiftly_tpu_torch.ops.planar_backend as plk
from swiftly_tpu_torch.ops.core import SwiftlyCore as TorchCore
from swiftly_tpu_torch.ops.core import scaled_offset


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # the suite runs beside other pytest-xdist workers on the same cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

PARAMS = {"W": 13.5625, "N": 1024, "yB_size": 416, "yN_size": 512,
          "xA_size": 228, "xM_size": 256}
ATOL = 1e-12
TWINS = {"torch": ("jax", torch.complex128), "planar": ("planar", torch.float64)}

# facet offsets are multiples of facet_off_step (4), subgrid offsets of
# subgrid_off_step (2); negative and past-half offsets exercise the wraps
FACET_OFFS = [0, 4 * 37, -4 * 61, 1024 - 8]
SUBGRID_OFFS = [0, 2 * 91, -2 * 200, 1024 - 2]


@pytest.fixture(scope="module", params=sorted(TWINS))
def cores(request):
    jax_backend, dtype = TWINS[request.param]
    args = (PARAMS["W"], PARAMS["N"], PARAMS["xM_size"], PARAMS["yN_size"])
    return (
        JaxCore(*args, backend=jax_backend),
        TorchCore(*args, backend=request.param, dtype=dtype, device="cpu"),
    )


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _check(cores, method, data, *args):
    jcore, tcore = cores
    want = jcore.as_complex(getattr(jcore, method)(data, *args))
    got = tcore.as_complex(getattr(tcore, method)(data, *args))
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=ATOL)


def _shape(n_axis, axis, other=40):
    return (n_axis, other) if axis == 0 else (other, n_axis)


@pytest.mark.parametrize("axis", [0, 1])
def test_facet_to_subgrid_primitives(cores, axis):
    yB, yN, m = PARAMS["yB_size"], PARAMS["yN_size"], cores[1].xM_yN_size
    for k, foff in enumerate(FACET_OFFS):
        _check(cores, "prepare_facet", _data(_shape(yB, axis), k), foff, axis)
        _check(cores, "add_to_subgrid", _data(_shape(m, axis), 10 + k), foff, axis)
    for k, soff in enumerate(SUBGRID_OFFS):
        _check(cores, "extract_from_facet", _data(_shape(yN, axis), 20 + k),
               soff, axis)


@pytest.mark.parametrize("axis", [0, 1])
def test_subgrid_to_facet_primitives(cores, axis):
    yN, xM, m = PARAMS["yN_size"], PARAMS["xM_size"], cores[1].xM_yN_size
    for k, foff in enumerate(FACET_OFFS):
        _check(cores, "extract_from_subgrid", _data(_shape(xM, axis), 30 + k),
               foff, axis)
        _check(cores, "finish_facet", _data(_shape(yN, axis), 40 + k), foff,
               PARAMS["yB_size"], axis)
    for k, soff in enumerate(SUBGRID_OFFS):
        _check(cores, "add_to_facet", _data(_shape(m, axis), 50 + k), soff, axis)


def test_all_axes_primitives(cores):
    xA, xM = PARAMS["xA_size"], PARAMS["xM_size"]
    for k, offs in enumerate(zip(SUBGRID_OFFS, reversed(FACET_OFFS))):
        offs = [int(o) for o in offs]
        _check(cores, "finish_subgrid", _data((xM, xM), 60 + k), offs, xA)
        _check(cores, "prepare_subgrid", _data((xA, xA), 70 + k), offs)


def test_out_parameter_adds_in_place(cores):
    _, tcore = cores
    data = _data((tcore.xM_yN_size, 16), 80)
    once = tcore.add_to_subgrid(data, 8, 0)
    out = torch.zeros_like(once)
    tcore.add_to_subgrid(data, 8, 0, out=out)
    tcore.add_to_subgrid(data, 8, 0, out=out)
    torch.testing.assert_close(out, 2 * once, rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="Output shape"):
        tcore.add_to_subgrid(data, 8, 0, out=out[:1])


def test_scaled_offset_matches_reference():
    rng = np.random.default_rng(9)
    for N, num in ((1024, 512), (32768, 16384), (131072, 65536), (131072, 512)):
        offs = rng.integers(-4 * N, 4 * N, size=200)
        want = [int(jax_scaled_offset(int(o), num, N)) for o in offs]
        assert [scaled_offset(int(o), num, N) for o in offs] == want
        got = scaled_offset(torch.as_tensor(offs), num, N)
        assert got.tolist() == want


@pytest.mark.parametrize("ns,axis", [(tpk, -2), (tpk, -1), (plk, -2), (plk, -1)])
def test_per_row_offsets_match_scalar_offsets(ns, axis):
    """A batch whose rows carry different offsets (int64 tensor) gives,
    row for row, what each row's offset gives as a Python int."""
    rng = np.random.default_rng(11)
    shape = (3, 4, 24, 20)
    a = torch.as_tensor(_data(shape, 12))
    if ns is plk:
        a = torch.view_as_real(a).contiguous()
    shifts = torch.as_tensor(rng.integers(-50, 50, size=(3, 4)))
    ops = [
        ("roll_axis", lambda x, s: ns.roll_axis(x, s, axis)),
        ("wrapped_extract", lambda x, s: ns.wrapped_extract(x, 9, s, axis)),
        ("wrapped_embed", lambda x, s: ns.wrapped_embed(x, 31, s, axis)),
    ]
    for name, op in ops:
        batched = op(a, shifts)
        for i in range(3):
            for j in range(4):
                want = op(a[i, j], int(shifts[i, j]))
                assert torch.equal(batched[i, j], want), (name, i, j)
    # a shift shared along one batch dimension broadcasts
    col = shifts[:1]
    torch.testing.assert_close(
        ns.wrapped_extract(a, 9, col, axis),
        ns.wrapped_extract(a, 9, col.expand(3, 4), axis), rtol=0, atol=0)


def test_wrapped_embed_add_equals_embed_then_add():
    a = torch.as_tensor(_data((5, 12), 13))
    acc = torch.as_tensor(_data((5, 40), 14))
    for shift in (0, 7, 19, 33, -25):
        want = acc + tpk.wrapped_embed(a, 40, shift, 1)
        got = tpk.wrapped_embed_add_(acc.clone(), a, shift, 1)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
