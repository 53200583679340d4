"""LeRF-L (the amplified-linear kernel), the fixed-kernel resize and the
warp at any support: the port against lerf_tpu on the CPU.

Same numpy-seeded inputs through both packages.  Tolerances:

* float resizes and warps within atol 1e-3 on 0..255 values, NaN patterns
  equal: both sides do the same float32 operations in the same order, but
  XLA's CPU backend may contract ``α·x + 1`` (and the Gaussian's products)
  into FMAs, an ulp apart;
* the branch masks, the warp geometry (corners, distances, masks) and the
  LUT stage codes exactly;
* uint8 frames equal but for pixels whose float value sits at a .5
  rounding tie, each one step apart;
* the Gaussian warp at support 3 and 4 as ``test_torch_warp`` holds
  support 2 (:func:`test_torch_warp.assert_warp_matches`: atol 1e-3 and
  equal NaN patterns where the window's largest weight is ≥ e^-50, a
  convex combination below that, where XLA's CPU ``exp`` and FMAs make the
  value ill-conditioned); the predictors' uint8 frames there equal but for
  ties on those well-conditioned windows;
* micro-net stage codes within 1 on < 0.5 % of pixels, as
  ``test_torch_net_pipeline.py`` holds them.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import shared_lut_predictor
from lerf_tpu.ops import geometry as jgeo
from lerf_tpu.ops import resample as jrs
from lerf_tpu.pipeline import NetPredictor as JaxNetPredictor
from test_torch_pipeline import port_of
from test_torch_srnet import assert_close_levels, np_params
from test_torch_warp import (MATRICES, assert_close_with_nans,
                             assert_warp_matches, count_ties, geometries,
                             lut_image, window_stats)

from lerf_torch.convert import lerf_nets_from_arrays
from lerf_torch.ops import geometry as tgeo
from lerf_torch.ops import interp_kernels as tik
from lerf_torch.ops import resample as trs
from lerf_torch.ops.kernels import resize as k1
from lerf_torch.ops.kernels import warp as k5
from lerf_torch.pipeline import NetPredictor

ATOL = 1e-3
# name → (scale, antialias): integer, fractional and non-periodic (×3.55,
# rational period 71) upscales, mixed axes, antialiased downscales (support
# 4 and 7) and a crop (0.25 without antialias: negative pads)
RESIZE_CASES = {"x2": ((2.0, 2.0), True), "x3": ((3.0, 3.0), True),
                "x4": ((4.0, 4.0), True), "x2.5": ((2.5, 2.5), True),
                "x3.55": ((3.55, 3.55), True), "x1.5x2.0": ((1.5, 2.0), True),
                "x0.5-aa": ((0.5, 0.5), True), "x0.3-aa": ((0.3, 0.3), True),
                "x0.25-crop": ((0.25, 0.25), False)}


def linear_inputs(shape=(3, 20, 28), seed=0):
    """int feature and one α code a pixel, as the LeRF-L stages give them."""
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, shape).astype(np.int32),
            rng.randint(0, 256, shape + (1,)).astype(np.int32))


def geometry_pair(in_sz, scale, antialias=True, support=2):
    return (jgeo.ResizeGeometry.create(in_sz, scale_factors=list(scale),
                                       support=support, antialias=antialias),
            tgeo.ResizeGeometry.create(in_sz, scale_factors=list(scale),
                                       support=support, antialias=antialias))


def jax_linear_resize(geom, feat, codes):
    alpha = codes[..., 0].astype(np.float32) / np.float32(255.0)
    return np.asarray(jax.jit(lambda x, a: jrs.amplified_linear_resize(
        x, a, geom))(jnp.asarray(feat, jnp.float32), jnp.asarray(alpha)))


# -- ops -----------------------------------------------------------------------


def test_branch_masks_and_bits_equal():
    d = np.concatenate([np.linspace(-2.5, 2.5, 101),
                        [-1.0, -1e-16, 0.0, 1e-16, 1.0, 1 + 1e-16,
                         -1 - 2e-16, 1e8]])
    for got, want in zip(trs._branch_masks(d), jrs._branch_masks(d)):
        np.testing.assert_array_equal(got, want)
    neg, pos = jrs._branch_masks(d, np.uint8)
    np.testing.assert_array_equal(trs.branch_bits(d), neg + 2 * pos)
    # the float64 edge is kept: 1e-16 above 1 is off the branch
    assert trs.branch_bits(np.array([1 + 2.3e-16]))[0] == 0


def test_amplified_linear_weight_matches_jax():
    rng = np.random.RandomState(3)
    a = rng.uniform(-1, 1, 500).astype(np.float32)
    dx64, dy64 = rng.uniform(-1.5, 1.5, (2, 500))
    want = np.asarray(jrs.amplified_linear_weight(
        jnp.asarray(a), jnp.asarray(dx64, jnp.float32),
        jnp.asarray(dy64, jnp.float32),
        tuple(map(jnp.asarray, jrs._branch_masks(dx64))),
        tuple(map(jnp.asarray, jrs._branch_masks(dy64)))))
    got = trs.amplified_linear_weight(
        torch.from_numpy(a), torch.from_numpy(dx64.astype(np.float32)),
        torch.from_numpy(dy64.astype(np.float32)),
        trs._masks_on(dx64, "cpu"), trs._masks_on(dy64, "cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got >= 0).all() and (got == 0).any()


@pytest.mark.parametrize("case", sorted(RESIZE_CASES))
def test_amplified_linear_resize_matches_jax(case):
    scale, aa = RESIZE_CASES[case]
    feat, codes = linear_inputs()
    jg, tg = geometry_pair(feat.shape[1:], scale, aa)
    want = jax_linear_resize(jg, feat, codes)
    got = trs.linear_resize_codes_plain(torch.from_numpy(feat),
                                        torch.from_numpy(codes), tg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    count_ties(np.clip(np.round(got.numpy()), 0, 255).astype(np.uint8),
               np.clip(np.round(want), 0, 255).astype(np.uint8), want)


@pytest.mark.parametrize("case", ["x2.5", "x0.5-aa", "x0.25-crop"])
def test_linear_resize_wrapper_on_cpu_is_the_twin(case):
    scale, aa = RESIZE_CASES[case]
    feat, codes = (torch.from_numpy(a) for a in linear_inputs((3, 11, 13), 1))
    _, tg = geometry_pair(tuple(feat.shape[1:]), scale, aa)
    before = k1.launches
    got = k1.steering_resize(feat, codes, tg, linear=True)
    got_u8 = k1.steering_resize(feat, codes, tg, linear=True,
                                out_dtype=torch.uint8)
    assert k1.launches == before              # CPU tensors take the twin
    twin = trs.linear_resize_codes_plain(feat, codes, tg)
    assert torch.equal(got, twin)
    assert torch.equal(got_u8, trs.quantize_device(twin, 255,
                                                   nan_to_zero=True))


def test_resize_wrappers_reject_codes_of_the_other_mode():
    feat, codes = (torch.from_numpy(a) for a in linear_inputs((3, 9, 11)))
    _, tg = geometry_pair((9, 11), (2.0, 2.0))
    with pytest.raises(ValueError, match="Gaussian"):
        k1.steering_resize(feat, codes, tg)
    with pytest.raises(ValueError, match="linear"):
        k1.steering_resize(feat, codes.expand(-1, -1, -1, 3).contiguous(),
                           tg, linear=True)


def test_linear_resize_operands_scale_in_float64():
    """K1's linear operands: the distances scaled by min_scale in float64,
    cast once, the masks from those float64 values; the Gaussian's stay
    unscaled (K1 scales them in float32)."""
    _, tg = geometry_pair((20, 28), (0.3, 0.3))
    lin = k1.ResizeOperands.create(tg, "cpu", linear=True)
    gauss = k1.ResizeOperands.create(tg, "cpu")
    m = tg.min_scale
    assert lin.dis_x is None and gauss.lin_x is None
    np.testing.assert_array_equal(lin.lin_x.numpy(),
                                  (m * tg.dis_x).astype(np.float32))
    np.testing.assert_array_equal(lin.mask_y.numpy(),
                                  trs.branch_bits(m * tg.dis_y))
    np.testing.assert_array_equal(gauss.dis_x.numpy(),
                                  tg.dis_x.astype(np.float32))


@pytest.mark.parametrize("case", ["x2.5", "x3", "x0.5-aa"])
@pytest.mark.parametrize("kernel", sorted(tik.NP_KERNELS_1D))
def test_fixed_kernel_resize_matches_jax(kernel, case):
    scale, aa = RESIZE_CASES[case]
    support = tik.KERNELS_1D[kernel].support_sz
    img = np.random.RandomState(4).randint(0, 256, (3, 15, 19)) \
        .astype(np.float32)
    jg, tg = geometry_pair(img.shape[1:], scale, aa, support)
    want = np.asarray(jax.jit(lambda x: jrs.fixed_kernel_resize(
        x, jg, kernel))(jnp.asarray(img)))
    got = trs.fixed_kernel_resize(torch.from_numpy(img), tg, kernel)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_fixed_kernel_resize_unnormalized_matches_jax():
    img = np.random.RandomState(5).rand(2, 12, 14).astype(np.float32) * 255
    jg, tg = geometry_pair(img.shape[1:], (2.5, 2.5), support=4)
    want = np.asarray(jrs.fixed_kernel_resize(jnp.asarray(img), jg, "cubic",
                                              normalize=False))
    got = trs.fixed_kernel_resize(torch.from_numpy(img), tg, "cubic",
                                  normalize=False).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


# -- the warp ------------------------------------------------------------------


def jax_linear_warp(geom, feat, codes, u8_inputs):
    if u8_inputs:
        args = (jnp.asarray(feat), jnp.asarray(codes[..., 0]))
    else:
        args = (jnp.asarray(feat, jnp.float32),
                jnp.asarray(codes[..., 0].astype(np.float32)
                            / np.float32(255.0)))
    return np.asarray(jax.jit(lambda x, a: jrs.amplified_linear_warp(
        x, a, geom, u8_inputs=u8_inputs))(*args))


@pytest.mark.parametrize("u8_inputs", [True, False], ids=["u8", "float"])
@pytest.mark.parametrize("support", [2, 3], ids=["s2", "s3-generic"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_amplified_linear_warp_matches_jax(name, support, u8_inputs):
    jg, tg = geometries(name, support)
    feat, codes = linear_inputs((3,) + jg.in_sz, seed=support)
    want = jax_linear_warp(jg, feat, codes, u8_inputs)
    if u8_inputs:
        args = (torch.from_numpy(feat), torch.from_numpy(codes[..., 0]))
    else:
        args = (torch.from_numpy(feat).to(torch.float32),
                torch.from_numpy(codes[..., 0]).to(torch.float32) / 255.0)
    got = trs.amplified_linear_warp(*args, tg, u8_inputs=u8_inputs).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert_close_with_nans(got, want)
    if name == "pad1":
        assert np.isnan(want).any()     # windows whose weights all clip


def test_amplified_linear_warp_batched_runs_per_frame():
    jg, tg = geometries("jitter")
    feat, codes = linear_inputs((2, 3) + jg.in_sz, seed=6)
    got = trs.amplified_linear_warp(torch.from_numpy(feat),
                                    torch.from_numpy(codes[..., 0]), tg,
                                    u8_inputs=True).numpy()
    for b in range(2):
        assert_close_with_nans(got[b], jax_linear_warp(jg, feat[b], codes[b],
                                                       True))


@pytest.mark.parametrize("support", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_linear_warp_codes_plain_is_the_u8_warp(name, support):
    """K5's linear twin (codes decoded after the gather, any support)
    against lerf_tpu's u8-input warp, and for support 2 exactly the port's
    own."""
    jg, tg = geometries(name, support)
    feat, codes = linear_inputs((3,) + jg.in_sz, seed=7)
    got = trs.linear_warp_codes_plain(torch.from_numpy(feat),
                                      torch.from_numpy(codes), tg).numpy()
    assert_close_with_nans(got, jax_linear_warp(jg, feat, codes, True))
    if support == 2:
        np.testing.assert_array_equal(got, trs.amplified_linear_warp(
            torch.from_numpy(feat), torch.from_numpy(codes[..., 0]), tg,
            u8_inputs=True).numpy())


@pytest.mark.parametrize("support", [3, 4])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_gaussian_warp_codes_plain_at_support(name, support):
    """K5's Gaussian twin at supports 3 and 4 against lerf_tpu's generic
    u8-input gather."""
    jg, tg = geometries(name, support)
    rng = np.random.RandomState(support)
    feat = rng.randint(0, 256, (3,) + jg.in_sz).astype(np.int32)
    codes = rng.randint(0, 256, (3,) + jg.in_sz + (3,)).astype(np.int32)
    want = np.asarray(jax.jit(lambda x, r, a, b: jrs.steering_gaussian_warp(
        x, r, a, b, jg, max_sigma=10.0, u8_inputs=True))(
        jnp.asarray(feat), *(jnp.asarray(codes[..., k]) for k in range(3))))
    got = trs.steering_warp_codes_plain(torch.from_numpy(feat),
                                        torch.from_numpy(codes), tg).numpy()
    assert_warp_matches(got, want, tg, feat, codes)


@pytest.mark.parametrize("support", [1, 3, 4])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_warp_operands_plain_at_support(name, support):
    """The geometry K5 derives (its plain twin) at other supports: equal to
    the host's per-pixel operands, and each corner, clipped as K5 clips it,
    gives back lerf_tpu's S rows and S columns."""
    matrix, in_sz, out_sz = MATRICES[name]
    corners, dis, masks, pad = tgeo.warp_operands_plain(
        np.linalg.inv(matrix), in_sz, out_sz, support)
    jg = jgeo.WarpGeometry.create(in_sz, matrix, out_sz, support=support)
    want = k5.WarpOperands.create(
        tgeo.WarpGeometry.create(in_sz, matrix, out_sz, support=support),
        "cpu")
    assert pad == want.pad == (jg.pad_x[0], jg.pad_y[0])
    assert torch.equal(corners, want.corners)
    assert torch.equal(dis, want.dis) and torch.equal(masks, want.masks)
    c = corners.numpy().reshape(out_sz + (2,))
    for k, (fov, n) in enumerate(((jg.fov_x, in_sz[0]), (jg.fov_y, in_sz[1]))):
        for s in range(support):
            np.testing.assert_array_equal(np.clip(c[..., k] + s, 0, n - 1),
                                          fov[..., s])
    np.testing.assert_array_equal(
        masks.numpy().reshape(out_sz + (2 * support,)),
        trs.branch_bits(np.concatenate([jg.dis_x, jg.dis_y], -1)))


@pytest.mark.parametrize("support", [2, 3])
@pytest.mark.parametrize("name", ["jitter", "pad1"])
def test_linear_warp_wrapper_on_cpu_is_the_twin(name, support):
    matrix, in_sz, out_sz = MATRICES[name]
    feat, codes = (torch.from_numpy(a) for a in linear_inputs((3,) + in_sz, 8))
    params = k5.WarpParams.create(in_sz, matrix, out_sz, support=support)
    before = k5.launches
    got = k5.steering_warp(feat, codes, params, linear=True)
    got_u8 = k5.steering_warp(feat, codes, params, linear=True,
                              out_dtype=torch.uint8)
    assert k5.launches == before
    twin = trs.linear_warp_codes_plain(feat, codes, params.geometry())
    assert torch.equal(torch.isnan(got), torch.isnan(twin))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(twin))
    assert torch.equal(got_u8, trs.quantize_device(twin, 255,
                                                   nan_to_zero=True))


# -- predictors ----------------------------------------------------------------


SR_SCALES = [(2.0, 2.0), (3.0, 3.0), (4.0, 4.0), (2.5, 2.5), (0.5, 0.5)]


def sr_image(h=17, w=22, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)) \
        .astype(np.uint8)


@pytest.mark.parametrize("scale", SR_SCALES, ids=lambda s: f"x{s[0]}")
def test_lut_linear_upscale_matches_jax(scale):
    jax_pred = shared_lut_predictor(linear=True)
    img = sr_image()
    want = jax_pred.upscale(img, *scale, return_aux=True)
    port = port_of(jax_pred, device="cpu", linear=True)
    out, feat, hyper = port.upscale(img, *scale, return_aux=True)
    assert hyper.shape == (3, 17, 22, 1) and out.dtype == np.uint8
    np.testing.assert_array_equal(feat, np.asarray(want[1]))
    np.testing.assert_array_equal(hyper, np.asarray(want[2]))
    geom = tgeo.ResizeGeometry.create(img.shape[:2], scale_factors=list(scale))
    f32 = trs.linear_resize_codes_plain(torch.from_numpy(feat),
                                        torch.from_numpy(hyper), geom)
    count_ties(out, np.asarray(want[0]), f32.numpy().transpose(1, 2, 0))


@pytest.mark.parametrize("name", ["jitter", "jitter-wide", "pad1"])
def test_lut_linear_warp_matches_jax(name):
    matrix, _, out_sz = MATRICES[name]
    jax_pred = shared_lut_predictor(linear=True)
    img = lut_image(name)
    want = jax_pred.warp(img, matrix, out_sz, return_aux=True)
    port = port_of(jax_pred, device="cpu", linear=True)
    before = k5.launches
    out, mask, feat, hyper = port.warp(img, matrix, out_sz, return_aux=True)
    assert k5.launches == before
    np.testing.assert_array_equal(feat, np.asarray(want[2]))
    np.testing.assert_array_equal(hyper, np.asarray(want[3]))
    np.testing.assert_array_equal(mask, np.asarray(want[1]))
    f32 = trs.linear_warp_codes_plain(
        torch.from_numpy(feat), torch.from_numpy(hyper),
        tgeo.WarpGeometry.create(img.shape[:2], matrix, out_sz))
    count_ties(out, np.asarray(want[0]),
               np.nan_to_num(f32.numpy()).transpose(1, 2, 0))


@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("support", [3, 4])
def test_lut_warp_at_support_matches_jax(support, linear):
    """``supp_size`` 3 and 4: the stage codes and the mask exactly; the
    frame equal but for ties, on the well-conditioned windows for the
    Gaussian (linear weights are never ill-conditioned)."""
    from lerf_tpu.pipeline import LutPredictor as JaxLutPredictor

    matrix, _, out_sz = MATRICES["jitter-wide"]
    base = shared_lut_predictor(linear=linear)
    jax_pred = JaxLutPredictor(base.bank, linear=linear, supp_size=support,
                               table_layout="flat")
    img = lut_image("jitter-wide", seed=support)
    want = jax_pred.warp(img, matrix, out_sz, return_aux=True)
    port = port_of(base, device="cpu", linear=linear, supp_size=support)
    out, mask, feat, hyper = port.warp(img, matrix, out_sz, return_aux=True)
    np.testing.assert_array_equal(feat, np.asarray(want[2]))
    np.testing.assert_array_equal(hyper, np.asarray(want[3]))
    np.testing.assert_array_equal(mask, np.asarray(want[1]))
    geom = tgeo.WarpGeometry.create(img.shape[:2], matrix, out_sz,
                                    support=support)
    twin = trs.linear_warp_codes_plain if linear \
        else trs.steering_warp_codes_plain
    f32 = np.nan_to_num(twin(torch.from_numpy(feat), torch.from_numpy(hyper),
                             geom).numpy())
    well = np.ones(f32.shape, bool) if linear else \
        window_stats(geom, feat, hyper)[0] >= np.exp(-50.0)
    keep = well.transpose(1, 2, 0)
    count_ties(out[keep], np.asarray(want[0])[keep],
               f32.transpose(1, 2, 0)[keep])


_NET = {}


def net_predictors():
    """(lerf_tpu, port) LeRF-L micro-net predictors on the same seed-0 nf=8
    params with one-output stage-2 heads, shared across tests."""
    if not _NET:
        params = np_params(nf=8, seed=0, out_c=1)
        _NET["pair"] = (
            JaxNetPredictor.from_srnets(
                jax.tree.map(jnp.asarray, params), linear=True,
                backend="xla"),
            NetPredictor.from_srnets(lerf_nets_from_arrays(params),
                                     linear=True, device="cpu"))
    return _NET["pair"]


@pytest.mark.parametrize("scale", SR_SCALES, ids=lambda s: f"x{s[0]}")
def test_net_linear_upscale_matches_jax(scale):
    jax_pred, port = net_predictors()
    img = sr_image(seed=1)
    want = jax_pred.upscale(img, *scale, return_aux=True)
    out, feat, hyper = port.upscale(img, *scale, return_aux=True)
    assert hyper.shape == (3, 17, 22, 1) and hyper.dtype == np.float32
    assert_close_levels(np.asarray(want[1]), feat, 1.0)
    codes = np.round(hyper * 255).astype(np.int32)
    assert_close_levels(np.round(np.asarray(want[2]) * 255), codes, 1.0)
    geom = tgeo.ResizeGeometry.create(img.shape[:2], scale_factors=list(scale))

    def plain(f, c):
        return trs.linear_resize_codes_plain(
            torch.from_numpy(np.asarray(f).astype(np.int32)),
            torch.from_numpy(c), geom).numpy().transpose(1, 2, 0)

    # the port's frame is the resize of its own stages
    own = plain(feat, codes)
    count_ties(out, np.clip(np.round(own), 0, 255).astype(np.uint8), own)
    # the resize link alone: fed lerf_tpu's stages, lerf_tpu's frame
    jc = np.round(np.asarray(want[2]) * 255).astype(np.int32)
    theirs = plain(want[1], jc)
    count_ties(np.clip(np.round(theirs), 0, 255).astype(np.uint8),
               np.asarray(want[0]), theirs)


@pytest.mark.parametrize("name", ["jitter", "jitter-wide", "pad1"])
def test_net_linear_warp_matches_jax(name):
    matrix, in_sz, out_sz = MATRICES[name]
    jax_pred, port = net_predictors()
    img = lut_image(name, seed=2)
    want_out, want_mask = jax_pred.warp(img, matrix, out_sz)
    _, jf, jh = jax_pred.upscale(img, 2, 2, return_aux=True)
    out, mask, feat, hyper = port.warp(img, matrix, out_sz, return_aux=True)
    np.testing.assert_array_equal(mask, np.asarray(want_mask))
    assert_close_levels(np.asarray(jf), feat, 1.0)
    codes = np.round(hyper * 255).astype(np.int32)
    assert_close_levels(np.round(np.asarray(jh) * 255), codes, 1.0)
    geom = tgeo.WarpGeometry.create(in_sz, matrix, out_sz)

    def plain(f, c):
        return np.nan_to_num(trs.linear_warp_codes_plain(
            torch.from_numpy(np.asarray(f).astype(np.int32)),
            torch.from_numpy(c), geom).numpy()).transpose(1, 2, 0)

    own = plain(feat, codes)
    count_ties(out, np.clip(np.round(own), 0, 255).astype(np.uint8), own)
    theirs = plain(jf, np.round(np.asarray(jh) * 255).astype(np.int32))
    count_ties(np.clip(np.round(theirs), 0, 255).astype(np.uint8),
               np.asarray(want_out), theirs)
