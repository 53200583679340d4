"""lerf_torch steerable-Gaussian resize (the plain twin of kernel K1 and the
K1 wrapper on CPU tensors) against lerf_tpu.ops.resample.

Tolerance: atol 1e-3 on 0..255 outputs.  Both sides compute the same
float32 operations in the same order (s-major, t-minor sums); what differs
is each library's float32 ``exp``, a few ulp apart.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lerf_tpu.ops import resample as jrs
from lerf_tpu.ops.geometry import ResizeGeometry as JaxGeometry

from lerf_torch.ops import resample as trs
from lerf_torch.ops.geometry import ResizeGeometry
from lerf_torch.ops.kernels import resize as k1

ATOL = 1e-3
# name → (scale, antialias); 0.25 without antialias has negative pads
CASES = {"x2": ((2.0, 2.0), True), "x3": ((3.0, 3.0), True),
         "x4": ((4.0, 4.0), True), "x1.5x2.0": ((1.5, 2.0), True),
         "x2.5": ((2.5, 2.5), True), "x3.55": ((3.55, 3.55), True),
         "x0.5-aa": ((0.5, 0.5), True), "x0.25-crop": ((0.25, 0.25), False)}


def inputs(shape=(3, 20, 28), seed=0):
    """int feature and hyper codes, as the stages would produce them."""
    rng = np.random.RandomState(seed)
    feat = rng.randint(0, 256, shape).astype(np.int32)
    codes = rng.randint(0, 256, shape + (3,)).astype(np.int32)
    return feat, codes


def jax_resize(feat, codes, scale, antialias):
    geom = JaxGeometry.create(feat.shape[1:], scale_factors=list(scale),
                              support=2, antialias=antialias)
    hyper = codes.astype(np.float32) / np.float32(255.0)
    out = jax.jit(lambda x, r, a, b: jrs.steering_gaussian_resize(
        x, r, a, b, geom, max_sigma=10.0))(
        jnp.asarray(feat, jnp.float32), *(jnp.asarray(hyper[..., k])
                                          for k in range(3)))
    return np.asarray(out)


def geometry(feat, scale, antialias):
    return ResizeGeometry.create(feat.shape[1:], scale_factors=list(scale),
                                 support=2, antialias=antialias)


@pytest.mark.parametrize("case", sorted(CASES))
def test_steering_gaussian_resize_matches_jax(case):
    scale, aa = CASES[case]
    feat, codes = inputs()
    want = jax_resize(feat, codes, scale, aa)
    hyper = torch.from_numpy(codes).to(torch.float32) / 255.0
    got = trs.steering_gaussian_resize(
        torch.from_numpy(feat).to(torch.float32), hyper[..., 0],
        hyper[..., 1], hyper[..., 2], geometry(feat, scale, aa))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_resize_wrapper_on_cpu_matches_jax(case):
    scale, aa = CASES[case]
    feat, codes = inputs(shape=(3, 17, 23), seed=1)
    want = jax_resize(feat, codes, scale, aa)
    before = k1.launches
    got = k1.steering_resize(torch.from_numpy(feat), torch.from_numpy(codes),
                             geometry(feat, scale, aa))
    assert k1.launches == before          # CPU tensors take the plain twin
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(
        np.clip(np.round(got.numpy()), 0, 255).astype(np.uint8),
        np.clip(np.round(want), 0, 255).astype(np.uint8))


@pytest.mark.parametrize("case", sorted(CASES))
def test_resize_wrapper_uint8_on_cpu_matches_jax(case):
    """K1's uint8 mode (the plain twin, then round / clip / cast) against
    lerf_tpu's resize rounded, clipped and cast the same way."""
    scale, aa = CASES[case]
    feat, codes = inputs(shape=(3, 17, 23), seed=1)
    want = np.asarray(jnp.clip(jnp.round(jnp.asarray(
        jax_resize(feat, codes, scale, aa))), 0, 255).astype(jnp.uint8))
    before = k1.launches
    got = k1.steering_resize(torch.from_numpy(feat), torch.from_numpy(codes),
                             geometry(feat, scale, aa),
                             out_dtype=torch.uint8)
    assert k1.launches == before
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pads", [((2, 1), (0, 3)), ((-1, -2), (1, -1)),
                                  ((-2, 3), (-1, 0))])
@pytest.mark.parametrize("mode", ["constant", "edge"])
def test_pad2d_matches_jax(pads, mode):
    x = np.random.RandomState(2).rand(2, 7, 9).astype(np.float32)
    want = np.asarray(jrs.pad2d(jnp.asarray(x), *pads, mode))
    got = trs.pad2d(torch.from_numpy(x), *pads, mode).numpy()
    np.testing.assert_array_equal(got, want)
