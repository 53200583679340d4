"""lerf_torch.ops.geometry against lerf_tpu.ops.geometry: the host float64
resize geometry must be identical, field for field."""
import dataclasses

import numpy as np
import pytest

from lerf_tpu.ops.geometry import ResizeGeometry as JaxGeometry
from lerf_tpu.ops.geometry import resolve_scale_and_out_sz as jax_resolve

from lerf_torch.ops.geometry import ResizeGeometry, resolve_scale_and_out_sz

# the golden SR scales plus the fractional, non-periodic and AA cases
SCALES = [(2.0, 2.0), (3.0, 3.0), (4.0, 4.0), (1.5, 2.0), (2.5, 2.5),
          (3.55, 3.55), (0.5, 0.5)]


def assert_same_geometry(want, got):
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("scale", SCALES, ids=lambda s: f"x{s[0]}x{s[1]}")
def test_resize_geometry_fields_equal(scale):
    want = JaxGeometry.create((20, 28), scale_factors=list(scale), support=2)
    got = ResizeGeometry.create((20, 28), scale_factors=list(scale),
                                support=2)
    assert_same_geometry(want, got)
    if scale == (0.5, 0.5):
        assert got.antialias and got.support == 4


def test_resize_geometry_negative_pads_equal():
    """A downscale without antialias crops: its pads are negative."""
    want = JaxGeometry.create((20, 28), scale_factors=[0.25, 0.25],
                              support=2, antialias=False)
    got = ResizeGeometry.create((20, 28), scale_factors=[0.25, 0.25],
                                support=2, antialias=False)
    assert_same_geometry(want, got)
    assert min(got.pad_x) < 0 and min(got.pad_y) < 0


@pytest.mark.parametrize("spec", [
    {"scale_factors": 3.0}, {"out_sz": (37, 50)},
    {"scale_factors": [1.5, 2.0], "out_sz": (31, 57)}])
def test_resolve_scale_and_out_sz_equal(spec):
    assert resolve_scale_and_out_sz((20, 28), **spec) \
        == jax_resolve((20, 28), **spec)


def test_resize_geometry_out_size_spec_equal():
    want = JaxGeometry.create((20, 28), out_sz=(13, 71), support=2)
    got = ResizeGeometry.create((20, 28), out_sz=(13, 71), support=2)
    assert_same_geometry(want, got)
