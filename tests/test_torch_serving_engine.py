"""The port's streaming engine (``lerf_torch.serve``) against lerf_tpu's:
the counterparts of ``tests/test_serving_engine.py``.

A bounded queue of futures must yield in request order, each result
exactly the port's sequential ``warp_dynamic`` / ``upscale_dynamic`` /
``warp_device`` call, at every depth; against lerf_tpu's stream on the
same requests the LUT masks exactly and the LUT frames but for .5
rounding ties (``test_torch_async.py`` tells each tie from an error: here
within one step on < 1 % of pixels), the SRNet frames within one step on
< 1 %.  ``granularity`` (lerf_tpu's shape buckets) changes nothing in the
port.  The lerf_tpu references run the flat table layout; torch runs on
one thread.
"""
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_warp_serving import (MATS, OUT_SZ, assert_net_frames_close,
                                     image, lut_pair, net_pair)

from lerf_tpu.serve import stream_upscale as jax_stream_upscale
from lerf_tpu.serve import stream_warp as jax_stream_warp

from lerf_torch.convert import bank_from_arrays
from lerf_torch.lut.io import save_lut_bank
from lerf_torch.pipeline import LutPredictor, ServingFuture
from lerf_torch.serve import stream_upscale, stream_warp


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread for this module (the CPU twins' many small ops
    stall under the test workers' load otherwise)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_frames_near(want, got):
    """uint8 frames within one step on < 1 % of pixels."""
    d = np.abs(np.asarray(want, np.int32) - np.asarray(got, np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())


def frames(seed, n, shape=(24, 32)):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, shape + (3,), dtype=np.uint8)
            for _ in range(n)]


def bank_dir(tmp_path):
    jax_pred = lut_pair()[0]
    b = jax_pred.bank
    exp = tmp_path / "exp"
    save_lut_bank(bank_from_arrays(b.stage1, b.stage2, b.inter, b.out_c),
                  str(exp), lut_name="LUTft")
    return exp


def test_stream_warp_matches_sequential():
    jax_pred, port = lut_pair()
    imgs = frames(21, 3)
    mats = MATS[:3]
    want = [port.warp_dynamic(f, m, OUT_SZ) for f, m in zip(imgs, mats)]
    for depth in (1, 2, 4):
        got = list(stream_warp(port, zip(imgs, mats), OUT_SZ, depth=depth))
        assert len(got) == len(want)
        for (wo, wm), (go, gm) in zip(want, got):
            np.testing.assert_array_equal(go, wo)
            np.testing.assert_array_equal(gm, wm)
    theirs = list(jax_stream_warp(jax_pred, zip(imgs, mats), OUT_SZ))
    for (to, tm), (wo, wm) in zip(theirs, want):
        np.testing.assert_array_equal(wm, np.asarray(tm))
        assert_frames_near(to, wo)


def test_stream_warp_bucketed_mixed_shapes():
    """Shapes, output sizes and matrices differ a request; the async form
    driven as ``stream_warp`` drives it, with lerf_tpu's bucket
    granularity, equals the sequential calls and the port's ``warp``."""
    from collections import deque

    _, port = lut_pair()
    rng = np.random.RandomState(22)
    cases = [((24, 32), (40, 56)), ((21, 29), (33, 38)),
             ((24, 32), (30, 34))]
    reqs = [(rng.randint(0, 256, i + (3,), dtype=np.uint8), m, o)
            for (i, o), m in zip(cases, MATS)]
    want = [port.warp(f, m, o) for f, m, o in reqs]
    got, q = [], deque()
    for f, m, o in reqs:
        q.append(port.warp_dynamic_async(f, m, o, granularity=16))
        while len(q) > 2:
            got.append(q.popleft().result())
    while q:
        got.append(q.popleft().result())
    for (wo, wm), (go, gm) in zip(want, got):
        np.testing.assert_array_equal(go, wo)
        np.testing.assert_array_equal(gm, wm)


def test_stream_upscale_matches_sequential():
    jax_pred, port = lut_pair()
    scales = [(2.0, 2.0), (1.5, 2.0), (2.0, 2.0)]
    reqs = [(f, sh, sw) for f, (sh, sw) in zip(frames(23, 3), scales)]
    want = [port.upscale_dynamic(f, sh, sw) for f, sh, sw in reqs]
    for depth in (1, 2, 4):
        got = list(stream_upscale(port, reqs, depth=depth))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
    for t, w in zip(jax_stream_upscale(jax_pred, reqs, depth=2), want):
        assert_frames_near(t, w)


def test_net_stream_warp_matches_sequential():
    jax_pred, port = net_pair()
    imgs = frames(24, 2)
    mats = MATS[:2]
    want = [port.warp_dynamic(f, m, OUT_SZ) for f, m in zip(imgs, mats)]
    got = list(stream_warp(port, zip(imgs, mats), OUT_SZ, depth=2))
    theirs = list(jax_stream_warp(jax_pred, zip(imgs, mats), OUT_SZ))
    for (wo, wm), (go, gm), (to, tm) in zip(want, got, theirs):
        np.testing.assert_array_equal(go, wo)
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gm, np.asarray(tm))
        assert_net_frames_close(to, go)


def test_future_result_idempotent():
    _, port = lut_pair()
    img = image(25)
    fut = port.warp_dynamic_async(img, MATS[0], OUT_SZ)
    out1, mask1 = fut.result()
    out2, mask2 = fut.result()
    assert out1 is out2 and mask1 is mask2
    want_out, want_mask = port.warp_dynamic(img, MATS[0], OUT_SZ)
    np.testing.assert_array_equal(want_out, out1)
    np.testing.assert_array_equal(want_mask, mask1)


def test_upscale_cli_streams_directory(tmp_path):
    """Several inputs (a directory, then a glob) with --dynamicSR: the CLI
    streams them through the engine and writes one output an input, each
    equal to the one-image call's."""
    from lerf_torch.cli import upscale as up

    exp = bank_dir(tmp_path)
    src = tmp_path / "frames"
    src.mkdir()
    for i, f in enumerate(frames(26, 3, (12, 14))):
        Image.fromarray(f).save(src / f"f{i}.png")
    dst = tmp_path / "out"
    up.main(["-e", str(exp), "--input", str(src), "--output", str(dst),
             "--scale", "2", "--dynamicSR", "--platform", "cpu"])
    outs = sorted(dst.iterdir())
    assert [p.name for p in outs] == ["f0.png", "f1.png", "f2.png"]
    dst2 = tmp_path / "out2"
    up.main(["-e", str(exp), "--input", str(src / "f*.png"), "--output",
             str(dst2), "--scale", "2", "--dynamicSR", "--platform", "cpu"])
    for p in outs:
        single = up.main(["-e", str(exp), "--input", str(src / p.name),
                          "--output", str(tmp_path / "one.png"),
                          "--scale", "2", "--platform", "cpu"])
        for d in (dst, dst2):
            np.testing.assert_array_equal(
                np.array(Image.open(d / p.name).convert("RGB")), single)


def test_upscale_cli_single_image_warp_mode(tmp_path):
    """--matrix warps one image; the saved png equals ``warp_dynamic``'s
    masked output (out-of-view black)."""
    from lerf_torch.cli import upscale as up

    exp = bank_dir(tmp_path)
    img = image(27)
    Image.fromarray(img).save(tmp_path / "in.png")
    mat = MATS[0]
    out = up.main([
        "-e", str(exp), "--input", str(tmp_path / "in.png"),
        "--output", str(tmp_path / "out.png"),
        "--matrix", ",".join(repr(float(v)) for v in mat.ravel()),
        "--outSize", f"{OUT_SZ[0]}x{OUT_SZ[1]}", "--dynamicWarp",
        "--platform", "cpu"])
    want_out, want_mask = lut_pair()[1].warp_dynamic(img, mat, OUT_SZ)
    want = want_out * want_mask.astype(want_out.dtype)[..., None]
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(
        np.array(Image.open(tmp_path / "out.png").convert("RGB")), want)


def test_async_fallback_resolves_eagerly(monkeypatch):
    """Outside the dynamic envelope (here support 3) the SR async form
    resolves at once through ``upscale``, as lerf_tpu's does; the warp
    forms have no envelope in the port (K5 and its twin take any support)
    and equal ``warp`` there."""
    _, shared = lut_pair()
    port = LutPredictor(shared.bank, supp_size=3, device="cpu")
    img = image(28)
    want = port.warp(img, MATS[0], OUT_SZ)
    got = port.warp_dynamic_async(img, MATS[0], OUT_SZ).result()
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    called = {}
    monkeypatch.setattr(port, "upscale",
                        lambda img, sh, sw, return_aux=False:
                        called.setdefault("yes", "out"))
    fut = port.upscale_dynamic_async(np.zeros((8, 8, 3), np.uint8), 2, 2)
    assert isinstance(fut, ServingFuture)
    assert called.get("yes") and fut.result() == "out"


def test_upscale_cli_form_auto(tmp_path, monkeypatch):
    """--form auto takes the net form when a checkpoint is there and falls
    back to the bank when it cannot be read; --form net keeps the
    error."""
    from lerf_torch.cli import upscale as up

    exp = bank_dir(tmp_path)
    cfg = up.UpscaleConfig(exp_dir=str(exp), form="auto", platform="cpu")
    assert isinstance(up.build_predictor(cfg), LutPredictor)
    assert cfg.form == "lut"
    (exp / "Model_050000.pth").write_bytes(b"not a checkpoint")
    cfg = up.UpscaleConfig(exp_dir=str(exp), form="auto", platform="cpu")
    assert isinstance(up.build_predictor(cfg), LutPredictor)
    monkeypatch.setattr("lerf_torch.cli.eval_model.load_params",
                        lambda c: "params")
    monkeypatch.setattr("lerf_torch.cli.eval_model.predictor_from_params",
                        lambda c, p: ("netpred", p))
    cfg = up.UpscaleConfig(exp_dir=str(exp), form="auto", platform="cpu")
    assert up.build_predictor(cfg) == ("netpred", "params")
    assert cfg.form == "net"
    monkeypatch.setattr("lerf_torch.cli.eval_model.load_params",
                        lambda c: (_ for _ in ()).throw(OSError("gone")))
    cfg = up.UpscaleConfig(exp_dir=str(exp), form="net", platform="cpu")
    with pytest.raises(OSError):
        up.build_predictor(cfg)


def test_stream_warp_device_geometry_matches_sequential():
    """geometry="device" streams through ``warp_device_async``, equal to
    the sequential ``warp_device`` calls (the port's ``warp``)."""
    _, port = lut_pair()
    imgs = frames(28, 2)
    mats = MATS[:2]
    want = [port.warp_device(f, m, OUT_SZ) for f, m in zip(imgs, mats)]
    got = list(stream_warp(port, zip(imgs, mats), OUT_SZ, depth=2,
                           geometry="device"))
    for (wo, wm), (go, gm) in zip(want, got):
        np.testing.assert_array_equal(go, wo)
        np.testing.assert_array_equal(gm, wm)
    with pytest.raises(ValueError, match="geometry"):
        next(stream_warp(port, zip(imgs, mats), OUT_SZ, geometry="devcie"))


def test_stream_warp_device_geometry_bucketed_mixed_shapes():
    """geometry="device" with a granularity over images of two shapes:
    equal to the sequential ``warp_device`` calls."""
    _, port = lut_pair()
    imgs = [frames(29, 1, s)[0] for s in ((24, 32), (21, 29))]
    mats = MATS[:2]
    want = [port.warp_device(f, m, OUT_SZ, granularity=16)
            for f, m in zip(imgs, mats)]
    got = list(stream_warp(port, zip(imgs, mats), OUT_SZ, depth=2,
                           geometry="device", granularity=16))
    for (wo, wm), (go, gm) in zip(want, got):
        np.testing.assert_array_equal(go, wo)
        np.testing.assert_array_equal(gm, wm)
