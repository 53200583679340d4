"""The port's static homographic warp (LeRF-G) against lerf_tpu on the CPU.

Same numpy-seeded inputs through both packages.  Tolerances: the warp
geometry, the validity mask and the LUT stages are held exactly; float
warps within atol 1e-3 on 0..255 values with the NaN pattern equal (both
sides do the same float32 operations in the same order; their ``exp``
differs by a few ulp) on every window whose largest weight is at least
e^-50, and a convex combination of the window's values (or NaN) below
that (:func:`assert_warp_matches` says why); uint8 frames equal but for
pixels whose float value sits at a .5 rounding tie, each one step apart;
micro-net stage codes within 1 level on < 0.5 % of pixels (the stages sum
the same products in another order, as in ``test_torch_net_pipeline.py``).

The TPU has no subnormal floats, and XLA's CPU ``exp`` mostly returns 0
below 2^-126; the port flushes warp weights below 2^-126 to match
(``ops.resample.flush_subnormal``) — without it the NaN patterns differ
wherever all four weights of a window are subnormal.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from conftest import shared_lut_predictor, shared_net_predictor
from lerf_tpu.ops import geometry as jgeo
from lerf_tpu.ops import interp_kernels as jik
from lerf_tpu.ops import resample as jrs
from test_torch_pipeline import port_of
from test_torch_srnet import assert_close_levels

from lerf_torch.convert import bank_from_arrays, lerf_nets_from_arrays
from lerf_torch.lut.io import save_lut_bank
from lerf_torch.ops import geometry as tgeo
from lerf_torch.ops import interp_kernels as tik
from lerf_torch.ops import resample as trs
from lerf_torch.ops.kernels import warp as k5
from lerf_torch.pipeline import NetPredictor

ATOL = 1e-3
TIE_TOL = 1e-3      # a uint8 mismatch needs a float value this close to k + .5
SMALL = ((14, 18), (25, 31))
WIDE = ((24, 40), (52, 90))


def jitter_matrix(seed, zoom):
    """``diag(zoom) @ (I + randn · [[.05,.05,4],[.05,.05,4],[1e-4,1e-4,0]])``:
    the projective jitter of bench.py:380-381 under a zoom (x, y order)."""
    rng = np.random.RandomState(seed)
    scale = np.array([[.05, .05, 4], [.05, .05, 4], [1e-4, 1e-4, 0]])
    return np.diag([zoom[1], zoom[0], 1.0]) @ (np.eye(3)
                                               + rng.randn(3, 3) * scale)


# name → (matrix, in_sz, out_sz).  "pad1": output (0, 0) maps above and
# left of the image, so pad0 = 1 on both axes and the far side reaches
# distances of 2 (NaN windows under random codes).  "clip": output (0, 0)
# maps inside (pad0 = 0), but the top-right / bottom-left corners map
# outside, so their left = -1 is clipped instead of padded.
MATRICES = {
    "jitter": (jitter_matrix(0, (1.8, 1.7)), *SMALL),
    "jitter-wide": (jitter_matrix(3, (2.2, 2.25)), *WIDE),
    "pad1": (np.array([[1.2, 0.05, 5.0], [0.02, 1.1, 5.0], [1e-3, 0.0, 1.0]]),
             *WIDE),
    "clip": (np.linalg.inv(np.array([[1.0, -0.2, 2.0], [-0.2, 1.0, 2.0],
                                     [0.0, 0.0, 1.0]])), *SMALL),
}


def geometries(name, support=2):
    matrix, in_sz, out_sz = MATRICES[name]
    return (jgeo.WarpGeometry.create(in_sz, matrix, out_sz, support=support),
            tgeo.WarpGeometry.create(in_sz, matrix, out_sz, support=support))


def stage_inputs(shape, seed=0):
    """int feature and hyper codes, as the stages would produce them."""
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, shape).astype(np.int32),
            rng.randint(0, 256, shape + (3,)).astype(np.int32))


def assert_close_with_nans(got, want, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                               rtol=0, atol=atol)


def count_ties(got_u8, want_u8, f32):
    """uint8 mismatches, each one step at a .5 tie of ``f32``."""
    mism = got_u8 != want_u8
    if mism.any():
        step = np.abs(got_u8[mism].astype(int) - want_u8[mism].astype(int))
        v = f32[mism]
        assert step.max() == 1
        assert np.abs(v - np.floor(v) - 0.5).max() <= TIE_TOL
    return int(mism.sum())


# -- geometry, kernels, mask ------------------------------------------------


@pytest.mark.parametrize("support", [2, 1, 3])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_warp_geometry_fields_equal(name, support):
    want, got = geometries(name, support)
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert got.padded_sz == want.padded_sz
    if support == 2 and name == "pad1":
        assert got.pad_x[0] == got.pad_y[0] == 1
        assert np.abs(got.dis_x).max() == 2.0
    if support == 2 and name == "clip":
        # corner (0, 0) in view, yet some pixels' pairs are clipped at 0
        assert got.pad_x[0] == got.pad_y[0] == 0
        for fov in (got.fov_x, got.fov_y):
            assert ((fov[..., 0] == 0) & (fov[..., 1] == 0)).any()


@pytest.mark.parametrize("kernel", sorted(tik.KERNELS_1D))
def test_interp_kernels_equal(kernel):
    x = np.concatenate([np.linspace(-3.5, 3.5, 141),
                        [-2, -1, 0, 1, 2, -1e-7, 1e-7, 1 + 1e-7, 2 - 1e-7]])
    np.testing.assert_array_equal(tik.NP_KERNELS_1D[kernel](x),
                                  jik.NP_KERNELS_1D[kernel](x))
    x32 = x.astype(np.float32)
    want = np.asarray(jik.KERNELS_1D[kernel](jnp.asarray(x32)))
    got = tik.KERNELS_1D[kernel](torch.from_numpy(x32)).numpy()
    assert getattr(tik.KERNELS_1D[kernel], "support_sz") == \
        getattr(jik.KERNELS_1D[kernel], "support_sz")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the branch points themselves are exact
    edges = np.isin(x32, np.float32([-2, -1, 0, 1, 2]))
    np.testing.assert_array_equal(got[edges], want[edges])


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_nearest_warp_mask_equal_and_host_bit_equal(name):
    matrix, in_sz, out_sz = MATRICES[name]
    jg1, tg1 = geometries(name, support=1)
    want = np.asarray(jrs.nearest_warp_mask(in_sz, jg1, border=4))
    got = trs.nearest_warp_mask(in_sz, tg1, border=4).numpy()
    np.testing.assert_array_equal(got, want)
    host = trs.nearest_warp_mask_host(in_sz, matrix, out_sz, border=4)
    assert host.dtype == np.bool_
    np.testing.assert_array_equal(host, got == 1.0)
    np.testing.assert_array_equal(
        host, jrs.nearest_warp_mask_host(in_sz, matrix, out_sz, border=4))


@pytest.mark.parametrize("kernel", ["box", "linear", "cubic"])
@pytest.mark.parametrize("name", ["jitter", "pad1"])
def test_fixed_kernel_warp_matches_jax(name, kernel):
    support = {"box": 1, "linear": 2, "cubic": 4}[kernel]
    jg, tg = geometries(name, support)
    img = np.random.RandomState(2).randint(
        0, 256, (3,) + jg.in_sz).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: jrs.fixed_kernel_warp(
        x, jg, kernel))(jnp.asarray(img)))
    got = trs.fixed_kernel_warp(torch.from_numpy(img), tg, kernel)
    assert got.dtype == torch.float32
    assert_close_with_nans(got.numpy(), want)


# -- the steerable warp ------------------------------------------------------


def jax_warp(geom, feat, codes, u8_inputs):
    """lerf_tpu's warp of int feat / codes: u8 integer inputs, or float
    feature with hyper maps code / 255."""
    if u8_inputs:
        args = [jnp.asarray(feat)] + [jnp.asarray(codes[..., k])
                                      for k in range(3)]
    else:
        hyper = codes.astype(np.float32) / np.float32(255.0)
        args = [jnp.asarray(feat, jnp.float32)] + [
            jnp.asarray(hyper[..., k]) for k in range(3)]
    return np.asarray(jax.jit(lambda x, r, a, b: jrs.steering_gaussian_warp(
        x, r, a, b, geom, max_sigma=10.0, u8_inputs=u8_inputs))(*args))


def torch_warp(geom, feat, codes, u8_inputs):
    if u8_inputs:
        args = [torch.from_numpy(feat)] + [torch.from_numpy(codes[..., k])
                                           for k in range(3)]
    else:
        hyper = torch.from_numpy(codes).to(torch.float32) / 255.0
        args = [torch.from_numpy(feat).to(torch.float32)] + [
            hyper[..., k] for k in range(3)]
    return trs.steering_gaussian_warp(*args, geom, max_sigma=10.0,
                                      u8_inputs=u8_inputs).numpy()


def window_stats(geom, feat, codes):
    """Per output: the largest weight of its window in float64 (from the
    same decoded float32 hyper values) and the window's value range."""
    hyp = torch.from_numpy(codes).to(torch.float32) / 255.0
    r, sx, sy = trs.decode_gaussian_hyper(hyp[..., 0], hyp[..., 1],
                                          hyp[..., 2], 10.0)
    g = [trs._gather_warp(p.double(), geom, "edge") for p in (r, sx, sy)]
    w = trs.steering_gaussian_weight(*g, *trs._warp_dis(geom, torch.float64,
                                                          "cpu"))
    x = trs._gather_warp(torch.from_numpy(feat).double(), geom, "constant")
    return (w.amax(dim=(-4, -3)).numpy(), x.amin(dim=(-4, -3)).numpy(),
            x.amax(dim=(-4, -3)).numpy())


def assert_warp_matches(got, want, geom, feat, codes):
    """atol 1e-3 and equal NaN patterns wherever the window's largest
    weight is at least e^-50.  Below that the value is ill-conditioned on
    XLA's CPU backend: it contracts float32 products and sums into FMAs
    (an ulp of an exponent argument near 60 moves a weight by ~1e-5
    relative), and its ``exp`` returns 0 below 2^-126 in some fusions and
    a subnormal in others.  There both sides must give a convex
    combination of the window's values or NaN, both NaN where every weight
    underflows in float32, and most outputs must be well conditioned."""
    wmax, lo, hi = window_stats(geom, feat, codes)
    well = wmax >= np.exp(-50.0)
    assert_close_with_nans(got[well], want[well])
    gone = wmax < 2.0 ** -150
    assert np.isnan(got[gone]).all() and np.isnan(want[gone]).all()
    band = ~well & ~gone
    for v in (got, want):
        ok = np.isnan(v) | ((v >= lo - ATOL) & (v <= hi + ATOL))
        assert ok[band].all()
    assert well.mean() > 0.6, well.mean()


@pytest.mark.parametrize("u8_inputs", [True, False], ids=["u8", "float"])
@pytest.mark.parametrize("batched", [False, True], ids=["chw", "bchw"])
@pytest.mark.parametrize("support", [2, 3], ids=["s2", "s3-generic"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_steering_gaussian_warp_matches_jax(name, support, batched,
                                            u8_inputs):
    jg, tg = geometries(name, support)
    shape = ((2, 3) if batched else (3,)) + jg.in_sz
    feat, codes = stage_inputs(shape, seed=support)
    want = jax_warp(jg, feat, codes, u8_inputs)
    got = torch_warp(tg, feat, codes, u8_inputs)
    assert got.dtype == np.float32 and got.shape == shape[:-2] + jg.out_sz
    assert_warp_matches(got, want, tg, feat, codes)
    if name == "pad1" and support == 2:
        assert np.isnan(want).any()      # the case holds NaN windows


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_warp_codes_plain_is_the_u8_warp(name):
    """K5's twin (integer codes, decoded after the gather) against
    lerf_tpu's u8-input warp, and for norm 255 exactly the port's own."""
    jg, tg = geometries(name)
    feat, codes = stage_inputs((3,) + jg.in_sz, seed=5)
    got = trs.steering_warp_codes_plain(torch.from_numpy(feat),
                                        torch.from_numpy(codes), tg).numpy()
    assert_close_with_nans(got, jax_warp(jg, feat, codes, True))
    np.testing.assert_array_equal(got, torch_warp(tg, feat, codes, True))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_warp_wrapper_on_cpu_is_the_twin(name):
    _, tg = geometries(name)
    feat, codes = (torch.from_numpy(a)
                   for a in stage_inputs((3,) + tg.in_sz, seed=6))
    twin = trs.steering_warp_codes_plain(feat, codes, tg)
    before = k5.launches
    got = k5.steering_warp(feat, codes, tg)
    got_u8 = k5.steering_warp(feat, codes, tg, out_dtype=torch.uint8)
    assert k5.launches == before          # CPU tensors take the plain twin
    np.testing.assert_array_equal(got.numpy(), twin.numpy())
    assert got_u8.dtype == torch.uint8
    want_u8 = np.clip(np.round(np.nan_to_num(twin.numpy(), nan=0.0)), 0,
                      255).astype(np.uint8)
    np.testing.assert_array_equal(got_u8.numpy(), want_u8)


def test_warp_wrapper_checks_its_arguments():
    _, tg = geometries("jitter")
    feat, codes = (torch.from_numpy(a)
                   for a in stage_inputs((3,) + tg.in_sz))
    with pytest.raises(ValueError, match="norm"):
        k5.steering_warp(feat, codes, tg, norm=1023, out_dtype=torch.uint8)
    with pytest.raises(ValueError, match="out_dtype"):
        k5.steering_warp(feat, codes, tg, out_dtype=torch.float16)
    # the codes must match the mode: three (Gaussian) or one (linear)
    with pytest.raises(ValueError, match="linear"):
        k5.steering_warp(feat, codes, tg, linear=True)
    with pytest.raises(ValueError, match="Gaussian"):
        k5.steering_warp(feat, codes[..., :1], tg)


@pytest.mark.parametrize("name", ["pad1", "clip"])
def test_warp_operands_hold_the_clipped_field_of_view(name):
    """K5's per-pixel corner, clipped as the kernel clips it, gives back
    the geometry's two rows and two columns; the distances are the float64
    ones cast once."""
    _, tg = geometries(name)
    ops = k5.WarpOperands.create(tg, "cpu")
    oh, ow = tg.out_sz
    corners = ops.corners.numpy().reshape(oh, ow, 2)
    assert ops.pad == (tg.pad_x[0], tg.pad_y[0])
    for k, (fov, n) in enumerate(((tg.fov_x, tg.in_sz[0]),
                                  (tg.fov_y, tg.in_sz[1]))):
        for s in (0, 1):
            np.testing.assert_array_equal(
                np.clip(corners[..., k] + s, 0, n - 1), fov[..., s])
    dis = ops.dis.numpy().reshape(oh, ow, 4)
    np.testing.assert_array_equal(dis[..., :2], tg.dis_x.astype(np.float32))
    np.testing.assert_array_equal(dis[..., 2:], tg.dis_y.astype(np.float32))


# -- predictors --------------------------------------------------------------


LUT_CASES = ["jitter", "jitter-wide", "pad1"]


def lut_image(name, seed=0):
    in_sz = MATRICES[name][1]
    return np.random.RandomState(seed).randint(0, 256, in_sz + (3,)) \
        .astype(np.uint8)


@pytest.mark.parametrize("name", LUT_CASES)
def test_lut_warp_matches_jax(name):
    matrix, _, out_sz = MATRICES[name]
    jax_pred = shared_lut_predictor()
    img = lut_image(name)
    want = jax_pred.warp(img, matrix, out_sz, return_aux=True)
    port = port_of(jax_pred, device="cpu")
    before = k5.launches
    got = port.warp(img, matrix, out_sz, return_aux=True)
    assert k5.launches == before
    out, mask, feat, hyper = got
    assert out.dtype == np.uint8 and out.shape == out_sz + (3,)
    assert mask.dtype == np.bool_ and mask.shape == out_sz
    np.testing.assert_array_equal(feat, np.asarray(want[2]))
    np.testing.assert_array_equal(hyper, np.asarray(want[3]))
    np.testing.assert_array_equal(mask, np.asarray(want[1]))
    f32 = trs.steering_warp_codes_plain(
        torch.from_numpy(feat), torch.from_numpy(hyper),
        tgeo.WarpGeometry.create(img.shape[:2], matrix, out_sz))
    count_ties(out, np.asarray(want[0]),
               np.nan_to_num(f32.numpy()).transpose(1, 2, 0))


def test_lut_warp_caches_a_few_geometries():
    from lerf_torch import pipeline

    port = port_of(shared_lut_predictor(), device="cpu")
    img = lut_image("jitter")
    for k in range(pipeline.WARP_CACHE_SIZE + 2):
        port.warp(img, MATRICES["jitter"][0] * (1 + k), SMALL[1])
    assert len(port._warp_cache) == pipeline.WARP_CACHE_SIZE
    # the latest key is cached; the mask returned is a copy of the cached
    again = port.warp(img, MATRICES["jitter"][0] * (1 + k), SMALL[1])[1]
    again[:] = False
    assert list(port._warp_cache.values())[-1][1].any()
    # another support caches the geometry at that support
    s3 = port_of(shared_lut_predictor(), device="cpu", supp_size=3)
    s3.warp(img, MATRICES["jitter"][0], SMALL[1])
    assert next(iter(s3._warp_cache.values()))[0].support == 3


def net_port():
    params = shared_net_predictor().params
    return NetPredictor.from_srnets(
        lerf_nets_from_arrays({sk: {n: {k: np.asarray(v) for k, v in h.items()}
                                    for n, h in heads.items()}
                               for sk, heads in params.items()}),
        device="cpu")


@pytest.mark.parametrize("name", ["jitter-wide", "pad1"])
def test_net_warp_matches_jax(name):
    matrix, in_sz, out_sz = MATRICES[name]
    jax_pred = shared_net_predictor()
    img = lut_image(name, seed=1)
    want_out, want_mask = jax_pred.warp(img, matrix, out_sz)
    _, want_feat, want_hyper = jax_pred.upscale(img, 2, 2, return_aux=True)
    port = net_port()
    out, mask, feat, hyper = port.warp(img, matrix, out_sz, return_aux=True)
    assert out.dtype == np.uint8 and out.shape == out_sz + (3,)
    np.testing.assert_array_equal(mask, np.asarray(want_mask))
    assert_close_levels(np.asarray(want_feat), feat, 1.0)
    codes = np.round(hyper * 255).astype(np.int32)
    assert_close_levels(np.round(np.asarray(want_hyper) * 255), codes, 1.0)
    geom = tgeo.WarpGeometry.create(in_sz, matrix, out_sz)

    def plain(f, c):
        return np.nan_to_num(trs.steering_warp_codes_plain(
            torch.from_numpy(f.astype(np.int32)), torch.from_numpy(c),
            geom).numpy()).transpose(1, 2, 0)

    # the port's frame is the plain warp of its own stages
    own = plain(feat, codes)
    count_ties(out, np.clip(np.round(own), 0, 255).astype(np.uint8), own)
    # the warp link alone: fed lerf_tpu's stages, the twin gives lerf_tpu's
    # frame
    jf = np.asarray(want_feat)
    jc = np.round(np.asarray(want_hyper) * 255).astype(np.int32)
    theirs = plain(jf, jc)
    count_ties(np.clip(np.round(theirs), 0, 255).astype(np.uint8),
               np.asarray(want_out), theirs)


# -- CLIs ----------------------------------------------------------------------


def save_bank(path):
    b = shared_lut_predictor().bank
    save_lut_bank(bank_from_arrays(b.stage1, b.stage2, b.inter, b.out_c),
                  str(path), lut_name="LUTft")


def warp_tree(tmp_path):
    """A WarpBenchmark tree: Tiny/{HR, isc, osc} with .npy homographies."""
    root = tmp_path / "warp"
    for i in range(2):
        hr = np.random.RandomState(20 + i).randint(0, 256, (26, 34, 3)) \
            .astype(np.uint8)
        os.makedirs(root / "Tiny" / "HR", exist_ok=True)
        Image.fromarray(hr).save(root / "Tiny" / "HR" / f"{i}.png")
        for k, scale_p in enumerate(("isc", "osc")):
            os.makedirs(root / "Tiny" / scale_p, exist_ok=True)
            lr = np.random.RandomState(30 + 2 * i + k).randint(
                0, 256, (13, 17, 3)).astype(np.uint8)
            Image.fromarray(lr).save(root / "Tiny" / scale_p / f"{i}.png")
            np.save(root / "Tiny" / scale_p / f"{i}.npy",
                    jitter_matrix(40 + 2 * i + k, (2.0, 2.0)))
    return root


def test_eval_lut_warp_cli_prints_jax_table(tmp_path, capsys):
    from lerf_tpu.cli.eval_lut_warp import main as jax_main
    from lerf_torch.cli.eval_lut_warp import main as torch_main

    root = warp_tree(tmp_path)
    save_bank(tmp_path / "bank")
    capsys.readouterr()
    args = ["-e", str(tmp_path / "bank"), "--testDir", str(root),
            "--datasets", "Tiny", "--platform", "cpu"]
    want = jax_main(args + ["--resultRoot", str(tmp_path / "res_jax")])
    want_out = capsys.readouterr().out
    got = torch_main(args + ["--resultRoot", str(tmp_path / "res_torch")])
    got_out = capsys.readouterr().out
    assert got_out == want_out and len(got_out.splitlines()) == 2
    assert got == want
    assert sorted(os.listdir(tmp_path / "res_torch" / "bank" / "Tiny"
                             / "isc")) == ["0_out.png", "1_out.png"]


@pytest.mark.parametrize("flags", [["--dynamicWarp"], ["--bucket", "8"]],
                         ids=lambda f: f[0].lstrip("-"))
def test_eval_lut_warp_cli_serving_flags_print_jax_table(flags, tmp_path,
                                                        capsys, monkeypatch):
    """The warp's serving flags, which exited "not ported" before the
    serving forms were ported: ``--dynamicWarp`` and ``--bucket`` now serve
    through ``warp_dynamic`` and print lerf_tpu's table (lerf_tpu's LUT
    predictor in its flat layout, bit-equal to its packed one and quicker
    to compile)."""
    from lerf_tpu import pipeline as jax_pipeline
    from lerf_tpu.cli.eval_lut_warp import main as jax_main
    from lerf_torch.cli.eval_lut_warp import main as torch_main

    make = jax_pipeline.LutPredictor.from_config.__func__
    monkeypatch.setattr(
        jax_pipeline.LutPredictor, "from_config",
        classmethod(lambda cls, cfg, **kw: make(cls, cfg, table_layout="flat",
                                                **kw)))
    root = warp_tree(tmp_path)
    save_bank(tmp_path / "bank")
    capsys.readouterr()
    args = ["-e", str(tmp_path / "bank"), "--testDir", str(root),
            "--datasets", "Tiny", "--platform", "cpu", *flags]
    want = jax_main(args + ["--resultRoot", str(tmp_path / "res_jax")])
    want_out = capsys.readouterr().out
    got = torch_main(args + ["--resultRoot", str(tmp_path / "res_torch")])
    assert capsys.readouterr().out == want_out
    assert len(want_out.splitlines()) == 2 and got == want


def test_run_warp_benchmark_dynamic_serves_through_warp_dynamic(tmp_path, monkeypatch):
    """``dynamic`` (or ``bucket`` > 0) serves through ``warp_dynamic`` with
    the bucket as its granularity, neither through ``warp``, as lerf_tpu's
    does; it no longer raises."""
    from lerf_torch import evaluate

    calls = []

    class Fake:
        def warp(self, img, matrix, out_hw):
            calls.append("static")
            return np.zeros(out_hw + (3,), np.uint8), np.ones(out_hw, bool)

        def warp_dynamic(self, img, matrix, out_hw, granularity=0):
            calls.append(f"dynamic{granularity}")
            return np.zeros(out_hw + (3,), np.uint8), np.ones(out_hw, bool)

    root = warp_tree(tmp_path)
    for kw in ({}, {"dynamic": True}, {"bucket": 8},
               {"dynamic": True, "bucket": 16}):
        evaluate.run_warp_benchmark(Fake(), str(root), "Tiny", ("isc",),
                                    **kw)
    assert calls == ["static"] * 2 + ["dynamic0"] * 2 + ["dynamic8"] * 2 \
        + ["dynamic16"] * 2


def test_load_matrix_reads_npy_and_pth(tmp_path):
    from lerf_tpu.data.benchmarks import load_matrix as jax_load
    from lerf_torch.data.benchmarks import load_matrix

    m = jitter_matrix(9, (2.0, 2.0))
    np.save(tmp_path / "a.npy", m)
    torch.save(torch.from_numpy(m), str(tmp_path / "b.pth"))
    for stem in ("a", "b"):
        got = load_matrix(str(tmp_path / stem))
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, m)
        np.testing.assert_array_equal(got, jax_load(str(tmp_path / stem)))
    with pytest.raises(FileNotFoundError):
        load_matrix(str(tmp_path / "c"))


def test_upscale_cli_warp_matches_jax(tmp_path):
    from lerf_tpu.cli.upscale import main as jax_main
    from lerf_torch.cli.upscale import main as torch_main

    save_bank(tmp_path / "bank")
    img = lut_image("jitter-wide", seed=3)
    Image.fromarray(img).save(tmp_path / "in.png")
    matrix = MATRICES["jitter-wide"][0]
    flags = ["-e", str(tmp_path / "bank"), "--input", str(tmp_path / "in.png"),
             "--matrix", ",".join(repr(float(v)) for v in matrix.ravel()),
             "--outSize", "52x90", "--platform", "cpu"]
    want = jax_main(flags + ["--output", str(tmp_path / "jax.png")])
    got = torch_main(flags + ["--output", str(tmp_path / "out" / "w.png")])
    assert got.shape == (52, 90, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(
        np.array(Image.open(tmp_path / "out" / "w.png")), got)
    np.testing.assert_array_equal(got, want)
