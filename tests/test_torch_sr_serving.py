"""The SR serving forms — ``upscale_bucketed``, ``upscale_dynamic`` and
``upscale_batch`` — and their geometry, the port against lerf_tpu on the
CPU, as ``tests/test_dynamic_resize.py``, ``test_bucketed.py`` and
``test_batch_serving.py`` pin lerf_tpu.

Tolerances: the serving geometry (indices, float64 distances, masks),
the rings resize against the port's static resize and every serving form
against the port's own ``upscale`` exactly (the same float32 operations in
the same order on the same data: PyTorch compiles nothing per shape, so a
bucket or a batch changes no value); against lerf_tpu the LUT stages
exactly, float resizes within atol 1e-3 (XLA's CPU backend may contract
products into FMAs), uint8 frames equal but for .5 rounding ties, and the
micro-net forms' frames equal but for ties on top of their stage codes
(within 1 on < 0.5 % of pixels, ``test_torch_net_pipeline.py``), so held
here at one step on < 1 % of pixels.

The lerf_tpu references run the LUT bank in its flat table layout (the
port's only one), which lerf_tpu holds bit-equal to its default packed
layout (``tests/test_packed.py``) and which XLA's CPU backend compiles
six to seven times faster: each case here compiles programs of its own
shapes, and those compiles were most of this file's time.  Torch runs on
one thread here (``one_torch_thread``): under the test workers' load its
thread pool made the port's small CPU ops 80× slower.
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from conftest import shared_lut_predictor
from lerf_tpu.ops import geometry as jgeo
from lerf_tpu.ops import resample as jrs
from lerf_tpu.pipeline import LutPredictor as JaxLutPredictor
from lerf_tpu.pipeline import NetPredictor as JaxNetPredictor
from test_torch_pipeline import port_of
from test_torch_srnet import np_params
from test_torch_warp import count_ties

from lerf_torch import pipeline
from lerf_torch.convert import bank_from_arrays, lerf_nets_from_arrays
from lerf_torch.lut.io import save_lut_bank
from lerf_torch.ops import geometry as tgeo
from lerf_torch.ops import resample as trs
from lerf_torch.ops.kernels import lut_stage as k2
from lerf_torch.ops.kernels import resize as k1
from lerf_torch.pipeline import NetPredictor

IN_SZ = (13, 17)
# the envelope: integer, aligned and non-aligned fractional, non-periodic
# (×3.55), mixed axes, scale 1 on one axis
SCALES = [(2.0, 2.0), (3.0, 3.0), (1.5, 2.0), (2.5, 2.5), (3.55, 3.55),
          (1.0, 1.7), (4.0, 4.0), (1.37, 2.93)]
# antialiased downscales: pure, fractional, mixed up / down, and a deep one
# in a larger support bucket
AA_SCALES = [(0.5, 0.5), (0.71, 0.71), (0.5, 2.0), (1.5, 0.33),
             (0.21, 0.21)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU twins run many small torch ops; with one intra-op
    thread a core they stall whenever the test workers share the cores
    (80× slower under load), so this module runs torch on one thread and
    gives the count back after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def both_ops(in_sz, scale):
    return (jgeo.ResizeOperands.create_any(in_sz, scale_factors=list(scale)),
            tgeo.ResizeOperands.create_any(in_sz, scale_factors=list(scale)))


def assert_fields_equal(want, got):
    for f in ("in_sz", "out_sz", "support", "pad", "aa_scale"):
        assert tuple(np.atleast_1d(getattr(want, f))) == \
            tuple(np.atleast_1d(getattr(got, f))), f
    for f in ("idx_x", "idx_y", "dis_x", "dis_y", "wmask_x", "wmask_y"):
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


# -- geometry ------------------------------------------------------------------


@pytest.mark.parametrize("scale", SCALES + AA_SCALES, ids=str)
def test_serving_operands_equal_jax(scale):
    in_sz = (40, 56) if scale in AA_SCALES else IN_SZ
    want, got = both_ops(in_sz, scale)
    assert_fields_equal(want, got)
    if scale not in AA_SCALES:
        # the ±1 frame changes only the index origin of the static geometry
        geom = tgeo.ResizeGeometry.create(in_sz, scale_factors=list(scale))
        np.testing.assert_array_equal(geom.dis_x, got.dis_x)
        np.testing.assert_array_equal(geom.fov_y[:, 0], got.idx_y)


def test_serving_operands_envelope():
    for make in (jgeo.ResizeOperands, tgeo.ResizeOperands):
        with pytest.raises(ValueError):
            make.create(IN_SZ, scale_factors=[0.5, 2.0])
        with pytest.raises(ValueError):
            make.create(IN_SZ, scale_factors=[2.0, 2.0], support=4)
        with pytest.raises(ValueError):      # beyond the 1/32 support cap
            make.create_any((256, 256), scale_factors=[0.01, 0.01])
    deep = tgeo.ResizeOperands.create_any((64, 64), scale_factors=[0.21] * 2)
    assert (deep.support, deep.pad, deep.true_support) == (16, 9, 10)
    assert [tgeo.support_bucket(s, floor=4) for s in (3, 4, 7, 33)] == \
        [jgeo.support_bucket(s, floor=4) for s in (3, 4, 7, 33)] == \
        [4, 4, 8, 64]


@pytest.mark.parametrize("scale", SCALES[:4] + AA_SCALES, ids=str)
def test_k1_operands_from_serving_equal_the_static_ones(scale):
    """What K1 reads for ``upscale_dynamic``: the serving geometry's true
    support, moved to unpadded coordinates, IS the static geometry's
    operands — rows, columns, distances and linear masks."""
    in_sz = (40, 56) if scale in AA_SCALES else IN_SZ
    ops = tgeo.ResizeOperands.create_any(in_sz, scale_factors=list(scale))
    geom = tgeo.ResizeGeometry.create(in_sz, scale_factors=list(scale))
    for linear in (False, True):
        got = k1.ResizeOperands.from_serving(ops, "cpu", linear=linear)
        want = k1.ResizeOperands.create(geom, "cpu", linear=linear)
        for f in want._fields:
            a, b = getattr(want, f), getattr(got, f)
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), f
            else:
                assert a == b, f


def rings_inputs(in_sz, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (3,) + in_sz).astype(np.int32),
            rng.randint(0, 256, (3,) + in_sz + (3,)).astype(np.int32))


@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("scale", SCALES + AA_SCALES, ids=str)
def test_rings_resize_is_the_static_resize(scale, linear):
    """The plain serving resize (the rings) bit-equal to the static twin at
    the same scale, and within atol 1e-3 of lerf_tpu's rings."""
    in_sz = (40, 56) if scale in AA_SCALES else IN_SZ
    feat, codes = rings_inputs(in_sz, seed=len(scale))
    if linear:
        codes = codes[..., :1].copy()
    jops, tops = both_ops(in_sz, scale)
    geom = tgeo.ResizeGeometry.create(in_sz, scale_factors=list(scale))
    got = trs.resize_codes_rings_plain(
        torch.from_numpy(feat), torch.from_numpy(codes),
        trs.resize_rings(tops, linear=linear), linear=linear, pad=tops.pad)
    plain = trs.linear_resize_codes_plain if linear \
        else trs.steering_resize_codes_plain
    assert torch.equal(got, plain(torch.from_numpy(feat),
                                  torch.from_numpy(codes), geom))
    hyper = codes.astype(np.float32) / np.float32(255.0)
    rings = jrs.resize_rings(jops, linear=linear)
    if linear:
        want = jrs.amplified_linear_resize_rings(
            jnp.asarray(feat, jnp.float32), jnp.asarray(hyper[..., 0]),
            rings, pad=jops.pad)
    else:
        want = jrs.steering_gaussian_resize_rings(
            jnp.asarray(feat, jnp.float32),
            *(jnp.asarray(hyper[..., k]) for k in range(3)), rings,
            pad=jops.pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3)


def test_rings_match_jax_rings():
    for linear in (False, True):
        for scale in ((2.5, 2.5), (0.5, 2.0)):
            jops, tops = both_ops((40, 56), scale)
            want = jrs.resize_rings(jops, linear=linear)
            got = trs.resize_rings(tops, linear=linear)
            for f in got._fields:
                a, b = getattr(want, f), getattr(got, f)
                assert (a is None) == (b is None), f
                if isinstance(a, tuple):
                    for x, y in zip(a, b):
                        np.testing.assert_array_equal(x, y)
                elif a is not None:
                    np.testing.assert_array_equal(np.asarray(a), b)


def test_serving_resize_wrapper_on_cpu_is_the_rings_resize():
    """K1's serving wrapper on CPU tensors: the plain rings resize of the
    serving geometry, no launch; a frame other than the geometry's is
    refused (PyTorch needs no bucket frame)."""
    in_sz, scale = (19, 23), (2.26, 2.26)
    ops = tgeo.ResizeOperands.create(in_sz, scale_factors=list(scale))
    feat, codes = rings_inputs(in_sz, seed=3)
    feat, codes = torch.from_numpy(feat), torch.from_numpy(codes)
    before = k1.launches
    got = k1.steering_resize_serving(feat, codes, ops)
    assert k1.launches == before
    assert got.shape == (3,) + tuple(ops.out_sz)
    assert torch.equal(got, trs.resize_codes_rings_plain(
        feat, codes, trs.resize_rings(ops)))
    with pytest.raises(ValueError):
        k1.steering_resize_serving(feat[:, :16], codes[:, :16], ops)


# -- predictors ----------------------------------------------------------------


def image(h, w, seed):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)) \
        .astype(np.uint8)


_LUT = {}


def flat_lut_predictor(linear=False):
    """lerf_tpu's predictor of the shared bank in the flat table layout,
    one for the module."""
    if linear not in _LUT:
        _LUT[linear] = JaxLutPredictor(shared_lut_predictor(linear).bank,
                                       linear=linear, table_layout="flat")
    return _LUT[linear]


def lut_pair(linear=False):
    jax_pred = flat_lut_predictor(linear)
    return jax_pred, port_of(jax_pred, device="cpu", linear=linear)


@pytest.fixture
def flat_lut_cli(monkeypatch):
    """lerf_tpu's CLIs build their LUT predictor in the flat layout."""
    from lerf_tpu import pipeline as jax_pipeline

    make = jax_pipeline.LutPredictor.from_config.__func__
    monkeypatch.setattr(
        jax_pipeline.LutPredictor, "from_config",
        classmethod(lambda cls, cfg, **kw: make(cls, cfg, table_layout="flat",
                                                **kw)))


_NET = {}


def net_pair(linear=False):
    """(lerf_tpu, port) micro-net predictors, seed-0 nf=8 params (one-output
    stage-2 heads for LeRF-L), lerf_tpu's xla backend against the port's
    K3 twin."""
    if linear not in _NET:
        params = np_params(nf=8, seed=0, out_c=1 if linear else 3)
        _NET[linear] = (
            JaxNetPredictor.from_srnets(
                {sk: {n: {k: jnp.asarray(v) for k, v in h.items()}
                      for n, h in heads.items()}
                 for sk, heads in params.items()},
                linear=linear, backend="xla"),
            NetPredictor.from_srnets(lerf_nets_from_arrays(params),
                                     linear=linear, device="cpu"))
    return _NET[linear]


def assert_net_frames_close(want, got):
    d = np.abs(np.asarray(want, np.int32) - np.asarray(got, np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())


# (image size, scale, granularity): upscales at both granularities
# (aligned, non-aligned ceil output, non-periodic, mixed axes) and
# antialiased downscales (0.5 and 0.3 in the support-4 and -8 buckets, 2 x
# 0.5 mixed), which serve at granularity 0 whatever is asked
DYNAMIC_CASES = {
    "x2-g0": ((21, 26), (2.0, 2.0), 0),
    "x3.55-g0": ((20, 20), (3.55, 3.55), 0),
    "x2.26-g64": ((19, 23), (2.26, 2.26), 64),
    "x2.17x2-g64": ((21, 26), (2.17, 2.0), 64),
    "x0.5-g0": ((32, 40), (0.5, 0.5), 0),
    "x0.3-g64": ((30, 42), (0.3, 0.3), 64),
    "x2x0.5-g0": ((32, 40), (2.0, 0.5), 0),
}


@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("case", sorted(DYNAMIC_CASES))
def test_lut_upscale_dynamic(case, linear):
    in_sz, scale, g = DYNAMIC_CASES[case]
    jax_pred, port = lut_pair(linear)
    img = image(*in_sz, seed=len(case))
    before = (k1.launches, k2.launches)
    got = port.upscale_dynamic(img, *scale, granularity=g)
    assert (k1.launches, k2.launches) == before
    out, feat, hyper = port.upscale(img, *scale, return_aux=True)
    np.testing.assert_array_equal(got, out)
    geom = tgeo.ResizeGeometry.create(in_sz, scale_factors=list(scale))
    plain = trs.linear_resize_codes_plain if linear \
        else trs.steering_resize_codes_plain
    f32 = plain(torch.from_numpy(feat), torch.from_numpy(hyper), geom)
    count_ties(got, jax_pred.upscale_dynamic(img, *scale, granularity=g),
               f32.numpy().transpose(1, 2, 0))


@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("case", ["x2-g0", "x2.26-g64", "x0.3-g64"])
def test_net_upscale_dynamic(case, linear):
    in_sz, scale, g = DYNAMIC_CASES[case]
    jax_pred, port = net_pair(linear)
    img = image(*in_sz, seed=len(case) + 1)
    got = port.upscale_dynamic(img, *scale, granularity=g)
    np.testing.assert_array_equal(got, port.upscale(img, *scale))
    assert_net_frames_close(
        jax_pred.upscale_dynamic(img, *scale, granularity=g), got)


def test_upscale_dynamic_falls_back_outside_the_envelope(monkeypatch):
    """Scale 1 and downscales beyond the 1/32 cap (1/40 here) take the
    per-shape path, as lerf_tpu's do; so does a support other than 2."""
    for port in (lut_pair()[1], net_pair()[1],
                 port_of(shared_lut_predictor(), device="cpu", supp_size=4)):
        calls = []
        monkeypatch.setattr(port, "upscale",
                            lambda img, sh, sw, return_aux=False:
                            calls.append((sh, sw)) or "out")
        img = np.zeros((80, 80, 3), np.uint8)
        assert port.upscale_dynamic(img, 1 / 40, 1 / 40) == "out"
        assert port.upscale_dynamic(img, 1.0, 1.0) == "out"
        expect = [(1 / 40, 1 / 40), (1.0, 1.0)]
        if port.supp_size == 4:
            assert port.upscale_dynamic(img, 2.0, 2.0) == "out"
            expect.append((2.0, 2.0))
        assert calls == expect


def test_upscale_dynamic_keeps_the_last_serving_geometries(monkeypatch):
    """One serving geometry a (size, scale), made once and kept for the
    last ``SERVING_CACHE_SIZE`` requests; granularity changes no entry."""
    monkeypatch.setattr(pipeline, "SERVING_CACHE_SIZE", 2)
    port = port_of(shared_lut_predictor(), device="cpu")
    img = image(12, 14, 1)
    first = port.upscale_dynamic(img, 2.5, 2.5)
    ops = port._serving_cache[((12, 14), (2.5, 2.5))][0]
    np.testing.assert_array_equal(
        port.upscale_dynamic(img, 2.5, 2.5, granularity=64), first)
    assert port._serving_cache[((12, 14), (2.5, 2.5))][0] is ops
    for s in (2.0, 3.0):
        port.upscale_dynamic(img, s, s)
    assert list(port._serving_cache) == [((12, 14), (2.0, 2.0)),
                                         ((12, 14), (3.0, 3.0))]


# (image size, scale, granularity): aligned upscales whose bucket is larger
# than the image, a fractional aligned one, and one whose alignment fails
# (the per-shape fallback)
BUCKET_CASES = {"x2-21x26-g16": ((21, 26), (2.0, 2.0), 16),
                "x3-13x17-g64": ((13, 17), (3.0, 3.0), 64),
                "x2.5-18x22-g16": ((18, 22), (2.5, 2.5), 16),
                "x2.5-fallback": ((19, 22), (2.5, 2.5), 16)}


@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("case", sorted(BUCKET_CASES))
def test_lut_upscale_bucketed(case, linear):
    """Bit-equal to the port's ``upscale`` (the port needs no bucket:
    ``upscale_bucketed`` is ``upscale``); against lerf_tpu's bucketed
    frame equal but for ties wherever that frame equals lerf_tpu's own
    ``upscale`` — everywhere for the Gaussian, but lerf_tpu resizes
    LeRF-L on the bucket's grid, an ulp off the image's at ×3, where the
    kernel's jump at |d| = 1 moves whole pixels."""
    in_sz, scale, g = BUCKET_CASES[case]
    jax_pred, port = lut_pair(linear)
    img = image(*in_sz, seed=len(case) + 2)
    got = port.upscale_bucketed(img, *scale, granularity=g)
    out, feat, hyper = port.upscale(img, *scale, return_aux=True)
    np.testing.assert_array_equal(got, out)
    geom = tgeo.ResizeGeometry.create(in_sz, scale_factors=list(scale))
    plain = trs.linear_resize_codes_plain if linear \
        else trs.steering_resize_codes_plain
    f32 = plain(torch.from_numpy(feat), torch.from_numpy(hyper),
                geom).numpy().transpose(1, 2, 0)
    want = np.asarray(jax_pred.upscale_bucketed(img, *scale, granularity=g))
    same = want == np.asarray(jax_pred.upscale(img, *scale))
    if not linear:
        assert same.all()
    count_ties(got[same], want[same], f32[same])


@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_net_upscale_bucketed(linear):
    jax_pred, port = net_pair(linear)
    img = image(21, 26, 5)
    got = port.upscale_bucketed(img, 2.0, 2.0, granularity=16)
    np.testing.assert_array_equal(got, port.upscale(img, 2.0, 2.0))
    assert_net_frames_close(
        jax_pred.upscale_bucketed(img, 2.0, 2.0, granularity=16), got)
    # scale 1 skips the nets on every form
    np.testing.assert_array_equal(port.upscale_bucketed(img, 1, 1, 16), img)


@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("scale", [(2.0, 2.0), (2.5, 2.5), (0.5, 0.5)],
                         ids=str)
def test_lut_upscale_batch(scale, linear):
    """One call for the batch (the frames folded into the channel axis):
    each frame bit-equal to its own ``upscale``, and the batch equal to
    lerf_tpu's but for ties."""
    jax_pred, port = lut_pair(linear)
    imgs = np.stack([image(14, 18, 20 + b) for b in range(3)])
    before = (k1.launches, k2.launches)
    got = port.upscale_batch(imgs, *scale)
    assert (k1.launches, k2.launches) == before
    assert got.dtype == np.uint8 and got.shape[0] == 3
    want = jax_pred.upscale_batch(imgs, *scale)
    for b in range(3):
        out, feat, hyper = port.upscale(imgs[b], *scale, return_aux=True)
        np.testing.assert_array_equal(got[b], out)
        geom = tgeo.ResizeGeometry.create((14, 18), scale_factors=list(scale))
        plain = trs.linear_resize_codes_plain if linear \
            else trs.steering_resize_codes_plain
        f32 = plain(torch.from_numpy(feat), torch.from_numpy(hyper), geom)
        count_ties(got[b], np.asarray(want[b]),
                   f32.numpy().transpose(1, 2, 0))


@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_net_upscale_batch(linear):
    jax_pred, port = net_pair(linear)
    imgs = np.stack([image(12, 15, 30 + b) for b in range(3)])
    got = port.upscale_batch(imgs, 2.0, 2.0)
    for b in range(3):
        np.testing.assert_array_equal(got[b], port.upscale(imgs[b], 2, 2))
    assert_net_frames_close(jax_pred.upscale_batch(imgs, 2.0, 2.0), got)
    # scale 1: the batch passes through, as lerf_tpu's does
    np.testing.assert_array_equal(port.upscale_batch(imgs, 1.0, 1.0), imgs)


# -- entry points --------------------------------------------------------------


def test_run_sr_benchmark_serves_through_the_forms(monkeypatch):
    """``bucket`` alone → ``upscale_bucketed``; ``dynamic`` →
    ``upscale_dynamic`` with the bucket as its granularity; neither →
    ``upscale`` (lerf_tpu's wiring, tests/test_bucketed.py)."""
    from lerf_torch import evaluate

    calls = []

    class Fake:
        def upscale(self, img, sh, sw):
            calls.append("static")
            return img

        def upscale_bucketed(self, img, sh, sw, granularity=0):
            calls.append(f"bucket{granularity}")
            return img

        def upscale_dynamic(self, img, sh, sw, granularity=0):
            calls.append(f"dynamic{granularity}")
            return img

    class Bench:
        def __init__(self, *a, **k):
            pass

        def __len__(self):
            return 1

        def pair(self, i, sh, sw):
            return image(8, 8, 0), image(8, 8, 0), "a.png"

    monkeypatch.setattr(evaluate, "SRBenchmark", Bench)
    for kw in ({}, {"bucket": 16}, {"dynamic": True},
               {"dynamic": True, "bucket": 8}):
        evaluate.run_sr_benchmark(Fake(), "", "Tiny", [(2.0, 2.0)], **kw)
    assert calls == ["static", "bucket16", "dynamic0", "dynamic8"]


def save_bank(path, linear):
    b = shared_lut_predictor(linear=linear).bank
    save_lut_bank(bank_from_arrays(b.stage1, b.stage2, b.inter, b.out_c),
                  str(path), lut_name="LUTft")


@pytest.mark.parametrize("flags", [["--dynamicSR"],
                                   ["--dynamicSR", "--bucket", "16"],
                                   ["--bucket", "16"],
                                   ["--linear"],
                                   ["--linear", "--dynamicSR"]],
                         ids=lambda f: "".join(f).replace("--", "-"))
def test_eval_lut_sr_cli_serving_prints_jax_table(flags, tmp_path, capsys,
                                                  flat_lut_cli):
    from lerf_tpu.cli.eval_lut_sr import main as jax_main
    from lerf_tpu.cli.make_benchmark import main as make_benchmark
    from lerf_torch.cli.eval_lut_sr import main as torch_main

    hr_dir = tmp_path / "rr" / "Tiny" / "HR"
    os.makedirs(hr_dir)
    for i in range(2):
        Image.fromarray(image(24, 32, 10 + i)).save(hr_dir / f"{i}.png")
    make_benchmark(["--hrDir", str(hr_dir), "--scales", "2,2.5",
                    "--platform", "cpu"])
    save_bank(tmp_path / "bank", "--linear" in flags)
    capsys.readouterr()
    args = ["-e", str(tmp_path / "bank"), "--testDir", str(tmp_path / "rr"),
            "--datasets", "Tiny", "--scales", "2,2.5", "--platform", "cpu",
            *flags]
    want = jax_main(args + ["--resultRoot", str(tmp_path / "res_jax")])
    want_out = capsys.readouterr().out
    got = torch_main(args + ["--resultRoot", str(tmp_path / "res_torch")])
    assert capsys.readouterr().out == want_out
    assert got == want


@pytest.mark.parametrize("flags", [["--dynamicSR", "--scale", "2.5"],
                                   ["--bucket", "16", "--scale", "2"],
                                   ["--linear", "--scale", "3"]],
                         ids=["dynamicSR", "bucket", "linear"])
def test_upscale_cli_serving_flags_match_jax(flags, tmp_path, flat_lut_cli):
    from lerf_tpu.cli.upscale import main as jax_main
    from lerf_torch.cli.upscale import main as torch_main

    save_bank(tmp_path / "bank", "--linear" in flags)
    Image.fromarray(image(18, 22, 4)).save(tmp_path / "in.png")
    args = ["-e", str(tmp_path / "bank"), "--input", str(tmp_path / "in.png"),
            "--platform", "cpu", *flags]
    want = jax_main(args + ["--output", str(tmp_path / "jax.png")])
    got = torch_main(args + ["--output", str(tmp_path / "torch.png")])
    np.testing.assert_array_equal(np.array(Image.open(tmp_path / "torch.png")),
                                  got)
    np.testing.assert_array_equal(got, want)
