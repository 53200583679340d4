"""The warp geometry K5 derives from the matrix, against the host's.

``lerf_torch.ops.geometry.warp_operands_plain`` and ``warp_pads`` are the
plain twin of the geometry K5 computes on the card: the float64 grid of
``_warp_grid`` and the field of view of ``_warp_axis``, from the inverse
homography alone.  They must be bit-equal to the port's host operands
(``WarpOperands.create`` of ``WarpGeometry``) and to lerf_tpu's
``WarpGeometry`` fov / dis / pads, at every case of
``test_torch_kernels.WARP_CASES`` (the main path's full frames, an
identity, a rotation, a 1/16 minification and ragged small sizes).  The
card's own derivation is held to the same operands by the ``cuda`` tests
of ``test_torch_kernels.py``.
"""
import os
import re
from collections import OrderedDict

import numpy as np
import pytest
import torch

from lerf_tpu.ops.geometry import WarpGeometry as JaxWarpGeometry
from test_torch_kernels import WARP_CASES

from lerf_torch import pipeline
from lerf_torch.ops import geometry as tgeo
from lerf_torch.ops.kernels import _build
from lerf_torch.ops.kernels import warp as k5
from lerf_torch.ops.resample import steering_warp_codes_plain


def case(name):
    matrix, shape, out_sz = WARP_CASES[name]
    return matrix, shape[1:], out_sz


@pytest.mark.parametrize("name", sorted(WARP_CASES))
def test_warp_operands_plain_equals_host_operands(name):
    matrix, in_sz, out_sz = case(name)
    corners, dis, masks, pad = tgeo.warp_operands_plain(
        np.linalg.inv(matrix), in_sz, out_sz)
    want = k5.WarpOperands.create(
        tgeo.WarpGeometry.create(in_sz, matrix, out_sz), "cpu")
    assert corners.dtype == torch.int32 and dis.dtype == torch.float32
    assert masks.dtype == torch.uint8
    assert pad == want.pad
    assert torch.equal(corners, want.corners)
    assert torch.equal(dis, want.dis)
    assert torch.equal(masks, want.masks)


@pytest.mark.parametrize("name", sorted(WARP_CASES))
def test_warp_operands_plain_hold_jax_field_of_view(name):
    """Each corner, clipped as K5 clips it, gives back lerf_tpu's two rows
    and two columns; the distances are lerf_tpu's float64 ones cast once."""
    matrix, in_sz, out_sz = case(name)
    corners, dis, _, pad = tgeo.warp_operands_plain(np.linalg.inv(matrix),
                                                    in_sz, out_sz)
    jg = JaxWarpGeometry.create(in_sz, matrix, out_sz)
    assert pad == (jg.pad_x[0], jg.pad_y[0])
    corners = corners.numpy().reshape(out_sz + (2,))
    dis = dis.numpy().reshape(out_sz + (4,))
    for k, (fov, d, n) in enumerate(((jg.fov_x, jg.dis_x, in_sz[0]),
                                     (jg.fov_y, jg.dis_y, in_sz[1]))):
        for s in (0, 1):
            np.testing.assert_array_equal(
                np.clip(corners[..., k] + s, 0, n - 1), fov[..., s])
        np.testing.assert_array_equal(dis[..., 2 * k:2 * k + 2],
                                      d.astype(np.float32))


# every case at K5's support 2; the small ones also at supports 1 and 3,
# whose pads warp_pads gives as well
PAD_CASES = [(name, 2) for name in sorted(WARP_CASES)] + [
    (name, support) for name in sorted(WARP_CASES)
    for support in (1, 3) if np.prod(WARP_CASES[name][2]) < 10 ** 5]


@pytest.mark.parametrize("name,support", PAD_CASES,
                         ids=[f"{n}-s{s}" for n, s in PAD_CASES])
def test_warp_pads_equal_geometry_pads(name, support):
    matrix, in_sz, out_sz = case(name)
    want = tgeo.WarpGeometry.create(in_sz, matrix, out_sz, support=support)
    got = tgeo.warp_pads(np.linalg.inv(matrix), in_sz, out_sz,
                         support=support)
    assert got == (want.pad_x, want.pad_y)
    jg = JaxWarpGeometry.create(in_sz, matrix, out_sz, support=support)
    assert got == (tuple(jg.pad_x), tuple(jg.pad_y))


def test_warp_cases_cover_pads_and_direct_path():
    """The cases reach both pads, and the minification's blocks all exceed
    the shared-memory tile (K5's direct path), the main path's none, the
    rotation's some."""
    pads = {name: tgeo.warp_pads(np.linalg.inv(case(name)[0]), *case(name)[1:])
            for name in WARP_CASES}
    assert pads["pad1"][0][0] == pads["pad1"][1][0] == 1
    assert pads["main"][0][0] == 0

    def entries(name):
        matrix, in_sz, out_sz = case(name)
        ops = k5.WarpOperands.create(
            tgeo.WarpGeometry.create(in_sz, matrix, out_sz), "cpu")
        return k5.footprint_entries(ops, in_sz, out_sz,
                                    WARP_CASES[name][1][0])

    assert (entries("minify16") > k5.TILE_ENTRIES).all()
    assert (entries("main") <= k5.TILE_ENTRIES).all()
    rot = entries("rotation")
    assert (rot <= k5.TILE_ENTRIES).any() and (rot > k5.TILE_ENTRIES).any()


def test_tile_constants_match_the_kernel_source():
    with open(os.path.join(_build.CSRC, "steering_warp.cu")) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("kTileH"), const("kTileW")) == k5.TILE
    assert const("kTileEntries") == k5.TILE_ENTRIES


def test_warp_params_hold_the_inverse_and_pads():
    matrix, in_sz, out_sz = case("pad1")
    params = k5.WarpParams.create(in_sz, matrix, out_sz)
    np.testing.assert_array_equal(np.asarray(params.inv).reshape(3, 3),
                                  np.linalg.inv(matrix))
    np.testing.assert_array_equal(np.asarray(params.matrix).reshape(3, 3),
                                  matrix)
    assert params.pad == (1, 1)
    assert (params.in_sz, params.out_sz) == (in_sz, out_sz)
    # the validity mask needs no pads of its own: the geometry's at
    # support 1 are 0, even where the support-2 ones are 1
    mask_geom = tgeo.WarpGeometry.create(in_sz, matrix, out_sz, support=1)
    assert (mask_geom.pad_x[0], mask_geom.pad_y[0]) == (0, 0)


def test_warp_entry_caches_host_geometry_on_cpu_and_params_on_a_card():
    matrix, in_sz, out_sz = case("3x7x9")
    cpu = pipeline._warp_entry(OrderedDict(), in_sz, matrix, out_sz, 2,
                               torch.device("cpu"))
    assert isinstance(cpu[0], tgeo.WarpGeometry)
    # a card's entry is the matrix, and no host geometry; its mask comes
    # from the first call's K5 launch on the card
    card = pipeline._warp_entry(OrderedDict(), in_sz, matrix, out_sz, 2,
                                torch.device("cuda"))
    assert isinstance(card[0], k5.WarpParams) and card[1] is None
    assert card[0] == k5.WarpParams.create(in_sz, matrix, out_sz)
    assert cpu[1].dtype == np.bool_ and cpu[1].shape == out_sz
    np.testing.assert_array_equal(cpu[1], card[0].host_mask(4))


def stage_outputs(shape, seed=4):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randint(0, 256, shape).astype(np.int32)),
            torch.from_numpy(rng.randint(0, 256, shape + (3,))
                             .astype(np.int32)))


@pytest.mark.parametrize("name", ["3x7x9", "rotation", "minify16"])
def test_warp_wrapper_on_cpu_takes_params(name):
    matrix, shape, out_sz = WARP_CASES[name]
    feat, codes = stage_outputs(shape)
    params = k5.WarpParams.create(shape[1:], matrix, out_sz)
    before = k5.launches
    got = k5.steering_warp(feat, codes, params)
    got_u8 = k5.steering_warp(feat, codes, params, out_dtype=torch.uint8)
    assert k5.launches == before
    want = steering_warp_codes_plain(
        feat, codes, tgeo.WarpGeometry.create(shape[1:], matrix, out_sz))
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert got_u8.dtype == torch.uint8


def test_warp_wrapper_rejects_params_for_another_shape():
    matrix, shape, out_sz = WARP_CASES["3x7x9"]
    feat, codes = stage_outputs(shape)
    other = k5.WarpParams.create((8, 9), matrix, out_sz)
    with pytest.raises(ValueError, match="geometry is for"):
        k5.steering_warp(feat, codes, other)
