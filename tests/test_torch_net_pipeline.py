"""lerf_torch.pipeline.NetPredictor (the micro-net form) and the net-form
CLIs against lerf_tpu.

Both packages get the same numpy-seeded nf=8 params (JAX through
``jnp.asarray``, the port through ``lerf_nets_from_arrays``).  The port's
float backend ("auto": K3's plain twin on the CPU) is held to lerf_tpu's
"xla" backend, and the int8 backend ("pallas_int8": K4's plain twin) to
lerf_tpu's int8 XLA reference.  The stages sum the same float32 products
in another order, so a member's ``round(tanh·127)`` can flip at a .5 edge
and a stage level can move by one: feat and hyper codes within 1 on
< 0.5 % of pixels.  The resize link is held exactly: the port's resize fed
lerf_tpu's feat and hyper gives lerf_tpu's uint8 frame.
"""
import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from lerf_tpu.pipeline import NetPredictor as JaxNetPredictor
from test_torch_srnet import assert_close_levels, np_params, torch_state_dict

from lerf_torch.convert import lerf_nets_from_arrays
from lerf_torch.models.imdn import IMDN2
from lerf_torch.ops.geometry import ResizeGeometry
from lerf_torch.ops.kernels.resize import steering_resize
from lerf_torch.pipeline import NetPredictor, _quantize_device

SCALES = [(2.0, 2.0), (4.0, 4.0), (2.5, 2.5), (0.5, 0.5)]
# port backend → the lerf_tpu backend it is held to on the CPU
BACKENDS = {"auto": "xla", "pallas_int8": "pallas_int8"}
_PREDICTORS = {}


def predictors(backend, **kwargs):
    """(lerf_tpu, port) predictors on the same seed-0 nf=8 params, shared
    across tests (each JAX predictor traces once per shape)."""
    key = (backend, tuple(sorted(kwargs.items())))
    if key not in _PREDICTORS:
        params = np_params(nf=8, seed=0)
        jax_pred = JaxNetPredictor.from_srnets(
            {sk: {n: {k: jnp.asarray(v) for k, v in h.items()}
                  for n, h in heads.items()} for sk, heads in params.items()},
            backend=BACKENDS[backend], **kwargs)
        port = NetPredictor.from_srnets(lerf_nets_from_arrays(params),
                                        backend=backend, device="cpu",
                                        **kwargs)
        _PREDICTORS[key] = (jax_pred, port)
    return _PREDICTORS[key]


def image(h=20, w=28, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)) \
        .astype(np.uint8)


def resize_u8(feat, hyper, scale):
    """The port's resize and quantization of float feat / hyper in the
    types lerf_tpu returns → uint8 [oH, oW, C]."""
    geom = ResizeGeometry.create(feat.shape[1:], scale_factors=list(scale))
    out = steering_resize(
        torch.from_numpy(np.asarray(feat).astype(np.int32)),
        torch.from_numpy(np.round(np.asarray(hyper) * 255).astype(np.int32)),
        geom)
    return _quantize_device(out, 255).numpy().transpose(1, 2, 0)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("scale", SCALES, ids=lambda s: f"x{s[0]}")
def test_net_upscale_matches_jax(backend, scale):
    jax_pred, port = predictors(backend)
    img = image()
    want = jax_pred.upscale(img, *scale, return_aux=True)
    got = port.upscale(img, *scale, return_aux=True)
    assert got[0].dtype == np.uint8 and got[0].shape == want[0].shape
    assert got[1].shape == (3, 20, 28) and got[1].dtype == np.float32
    assert got[2].shape == (3, 20, 28, 3) and got[2].dtype == np.float32
    assert_close_levels(want[1], got[1], 1.0)
    assert_close_levels(np.round(np.asarray(want[2]) * 255),
                        np.round(got[2] * 255), 1.0)
    # the resize link alone: fed lerf_tpu's stages, the port's resize
    # gives lerf_tpu's frame
    np.testing.assert_array_equal(resize_u8(want[1], want[2], scale),
                                  want[0])
    # the port's own frame is the resize of its own stages
    np.testing.assert_array_equal(resize_u8(got[1], got[2], scale), got[0])


def test_net_upscale_scale_one_skips_the_nets():
    jax_pred, port = predictors("auto")
    img = image(11, 13, seed=3)
    got = port.upscale(img, 1, 1)
    np.testing.assert_array_equal(got, jax_pred.upscale(img, 1, 1))
    np.testing.assert_array_equal(got, img)
    gray = img[..., 0]
    np.testing.assert_array_equal(port.upscale(gray, 1.0, 1.0),
                                  jax_pred.upscale(gray, 1.0, 1.0))


def test_net_upscale_without_feature_stage_matches_jax():
    jax_pred, port = predictors("auto", two_stage=False)
    img = image(12, 18, seed=4)
    want = jax_pred.upscale(img, 2, 2, return_aux=True)
    got = port.upscale(img, 2, 2, return_aux=True)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_array_equal(got[1], img.transpose(2, 0, 1))
    assert_close_levels(np.round(np.asarray(want[2]) * 255),
                        np.round(got[2] * 255), 1.0)


def test_net_predictor_xla_backend_matches_auto():
    params = lerf_nets_from_arrays(np_params(nf=8, seed=0))
    img = image(9, 14, seed=5)
    a = NetPredictor.from_srnets(params, backend="auto", device="cpu") \
        .upscale(img, 2, 2, return_aux=True)
    x = NetPredictor.from_srnets(params, backend="xla", device="cpu") \
        .upscale(img, 2, 2, return_aux=True)
    assert_close_levels(a[1], x[1], 1.0)
    assert_close_levels(np.round(a[2] * 255), np.round(x[2] * 255), 1.0)


def test_net_predictor_default_device_is_cuda_and_never_falls_back():
    params = lerf_nets_from_arrays(np_params(nf=8, seed=0))
    if torch.cuda.is_available():
        assert NetPredictor.from_srnets(params).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            NetPredictor.from_srnets(params)


@pytest.mark.parametrize("call", [
    lambda p: NetPredictor.from_srnets(p, mesh=object(), device="cpu"),
    lambda p: NetPredictor.from_imdn(IMDN2(nf=8), mesh=object(),
                                     device="cpu"),
    lambda p: NetPredictor.from_srnets(p, device="cpu")
    .warp_dynamic_async(image(), np.eye(3), (8, 8)),
    lambda p: NetPredictor.from_srnets(p, device="cpu")
    .upscale_dynamic_async(image(), 2, 2)],
    ids=["mesh", "from_imdn", "warp_async", "async"])
def test_unported_net_options_raise(call):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call(lerf_nets_from_arrays(np_params(nf=8, seed=0)))


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown backend"):
        NetPredictor.from_srnets(lerf_nets_from_arrays(np_params(nf=8)),
                                 backend="tpu", device="cpu")


# -- CLIs -------------------------------------------------------------------


def net_experiment(tmp_path, seed=0):
    """An experiment directory holding a reference-named state dict."""
    exp = tmp_path / "lerf-net"
    os.makedirs(exp, exist_ok=True)
    torch.save(torch_state_dict(np_params(nf=8, seed=seed)),
               str(exp / "Model_050000.pth"))
    return exp


def tiny_benchmark(tmp_path):
    from lerf_tpu.cli.make_benchmark import main as make_benchmark

    hr_dir = tmp_path / "rr" / "Tiny" / "HR"
    os.makedirs(hr_dir)
    for i in range(2):
        Image.fromarray(image(24, 32, seed=10 + i)).save(hr_dir / f"{i}.png")
    make_benchmark(["--hrDir", str(hr_dir), "--scales", "2",
                    "--platform", "cpu"])
    return tmp_path / "rr"


def test_eval_model_cli_prints_jax_table(tmp_path, capsys):
    from lerf_tpu.cli.eval_model import main as jax_main
    from lerf_torch.cli.eval_model import main as torch_main

    exp = net_experiment(tmp_path)
    rr = tiny_benchmark(tmp_path)
    capsys.readouterr()
    args = ["-e", str(exp), "--testDir", str(rr), "--datasets", "Tiny",
            "--scales", "2", "--twoStage", "--outC", "3", "--nf", "8",
            "--platform", "cpu"]
    want = jax_main(args + ["--resultRoot", str(tmp_path / "res_jax")])
    want_out = capsys.readouterr().out.splitlines()
    got = torch_main(args + ["--resultRoot", str(tmp_path / "res_torch")])
    got_out = capsys.readouterr().out.splitlines()
    assert len(got_out) == len(want_out) == 2
    assert got_out[0] == want_out[0]                     # the header
    assert got_out[1].split("\t")[0] == want_out[1].split("\t")[0]
    (p_want, s_want), = want["Tiny"].values()
    (p_got, s_got), = got["Tiny"].values()
    assert abs(p_got - p_want) <= 0.01 and abs(s_got - s_want) <= 1e-3
    assert os.listdir(tmp_path / "res_torch" / "lerf-net" / "X2.00_2.00"
                      / "Tiny")


def test_eval_model_cli_warp_prints_jax_table(tmp_path, capsys):
    """"warp" in --resultRoot runs the warp benchmark, as lerf_tpu's
    eval_model does: the same table on a synthetic WarpBenchmark tree."""
    from lerf_tpu.cli.eval_model import main as jax_main
    from lerf_torch.cli.eval_model import main as torch_main
    from test_torch_warp import warp_tree

    exp = net_experiment(tmp_path)
    root = warp_tree(tmp_path)
    capsys.readouterr()
    args = ["-e", str(exp), "--testDir", str(root), "--datasets", "Tiny",
            "--twoStage", "--outC", "3", "--nf", "8", "--platform", "cpu"]
    want = jax_main(args + ["--resultRoot", str(tmp_path / "warp_jax")])
    want_out = capsys.readouterr().out.splitlines()
    got = torch_main(args + ["--resultRoot", str(tmp_path / "warp_torch")])
    got_out = capsys.readouterr().out.splitlines()
    assert got_out == want_out and len(got_out) == 2
    assert sorted(got["Tiny"]) == sorted(want["Tiny"]) == ["isc", "osc"]
    for p in ("isc", "osc"):
        assert abs(got["Tiny"][p] - want["Tiny"][p]) <= 0.01
    assert sorted(os.listdir(tmp_path / "warp_torch" / "lerf-net" / "Tiny"
                             / "osc")) == ["0_out.png", "1_out.png"]


@pytest.mark.parametrize("flags,match", [
    (["--model", "IMDN2", "--inC", "3"], None),
    (["--bucket", "8"], None),
    (["--dynamicWarp"], None)],
    ids=["imdn", "bucket", "warp-dynamic"])
def test_eval_model_cli_flags_match_jax_or_exit(flags, match, tmp_path,
                                                capsys):
    """Flags that exited "not ported" now print lerf_tpu's warp table on a
    synthetic WarpBenchmark tree: ``--model IMDN2`` (the IMDN form, on a
    reference-named IMDN2 state dict), and the warp's serving flags
    through ``warp_dynamic`` (mPSNR within 0.01 dB: the SRNet codes of the
    two packages differ by a level on < 0.5 % of pixels, the IMDN frames
    by one at a .5 edge on ≤ 0.1 %)."""
    from lerf_tpu.cli.eval_model import main as jax_main
    from lerf_torch.cli.eval_model import main
    from test_torch_imdn import imdn_experiment
    from test_torch_warp import warp_tree

    exp = (imdn_experiment(tmp_path) if "IMDN2" in flags
           else net_experiment(tmp_path))
    if match is not None:
        with pytest.raises(SystemExit, match=match):
            main(["-e", str(exp), "--platform", "cpu", *flags])
        return
    root = warp_tree(tmp_path)
    capsys.readouterr()
    args = ["-e", str(exp), "--testDir", str(root), "--datasets", "Tiny",
            "--twoStage", "--outC", "3", "--nf", "8", "--platform", "cpu",
            *flags]
    want = jax_main(args + ["--resultRoot", str(tmp_path / "warp_jax")])
    want_out = capsys.readouterr().out.splitlines()
    got = main(args + ["--resultRoot", str(tmp_path / "warp_torch")])
    got_out = capsys.readouterr().out.splitlines()
    assert len(got_out) == len(want_out) == 2
    assert got_out[0] == want_out[0]
    for p in ("isc", "osc"):
        assert abs(got["Tiny"][p] - want["Tiny"][p]) <= 0.01


def test_eval_model_cli_orbax_checkpoint_exits(tmp_path):
    """``ckpt/`` read as lerf_tpu reads it: an empty one falls through to
    ``Model_*.pth``; the port trainer's checkpoint of ``--loadIter`` is
    read first; an orbax step directory (lerf_tpu's trainer's) exits with
    a message naming its writer."""
    import shutil

    from lerf_torch.cli.eval_model import build_predictor, main
    from lerf_torch.config import TestConfig, parse_config
    from lerf_torch.train.checkpoint import CheckpointManager
    from test_torch_train_loop import orbax_step

    exp = net_experiment(tmp_path)
    os.makedirs(exp / "ckpt")
    args = ["-e", str(exp), "--twoStage", "--platform", "cpu"]
    cfg = parse_config(TestConfig, args)
    img = image()

    def upscale_with(seed):
        return NetPredictor.from_srnets(
            lerf_nets_from_arrays(np_params(nf=8, seed=seed)),
            device="cpu").upscale(img, 2, 2)

    np.testing.assert_array_equal(build_predictor(cfg).upscale(img, 2, 2),
                                  upscale_with(0))
    CheckpointManager(str(exp)).save(50000, {"params": lerf_nets_from_arrays(
        np_params(nf=8, seed=1))})
    np.testing.assert_array_equal(build_predictor(cfg).upscale(img, 2, 2),
                                  upscale_with(1))
    shutil.rmtree(exp / "ckpt")
    orbax_step(exp, 50000)
    with pytest.raises(SystemExit, match="orbax checkpoint written by "
                                         "lerf_tpu"):
        main(args)


def upscale_args(tmp_path, exp, *flags):
    Image.fromarray(image()).save(tmp_path / "in.png")
    return ["-e", str(exp), "--input", str(tmp_path / "in.png"),
            "--output", str(tmp_path / "out" / "up.png"), "--scale", "2.5",
            "--twoStage", "--outC", "3", "--platform", "cpu", *flags]


@pytest.mark.parametrize("form", ["net", "auto"])
def test_upscale_cli_net_form_writes_png(form, tmp_path):
    from lerf_torch.cli.upscale import main

    exp = net_experiment(tmp_path)
    out = main(upscale_args(tmp_path, exp, "--form", form))
    written = np.array(Image.open(tmp_path / "out" / "up.png"))
    np.testing.assert_array_equal(written, out)
    port = NetPredictor.from_srnets(
        lerf_nets_from_arrays(np_params(nf=8, seed=0)), device="cpu")
    np.testing.assert_array_equal(out, port.upscale(image(), 2.5, 2.5))


def test_upscale_cli_auto_falls_back_to_lut_bank(tmp_path, capsys):
    from lerf_torch.cli.upscale import main
    from test_torch_pipeline import port_of

    from conftest import shared_lut_predictor
    from lerf_torch.convert import bank_from_arrays
    from lerf_torch.lut.io import save_lut_bank

    b = shared_lut_predictor().bank
    exp = tmp_path / "bank"
    save_lut_bank(bank_from_arrays(b.stage1, b.stage2, b.inter, b.out_c),
                  str(exp), lut_name="LUTft")
    want = port_of(shared_lut_predictor(), device="cpu").upscale(
        image(), 2.5, 2.5)
    # no checkpoint: the LUT bank serves
    out = main(upscale_args(tmp_path, exp, "--form", "auto"))
    np.testing.assert_array_equal(out, want)
    # a checkpoint that cannot be read: the LUT bank serves, with a notice
    (exp / "Model_050000.pth").write_bytes(b"not a checkpoint")
    capsys.readouterr()
    out = main(upscale_args(tmp_path, exp, "--form", "auto"))
    np.testing.assert_array_equal(out, want)
    assert "falling back to the LUT bank" in capsys.readouterr().out
    # an explicit --form net keeps the error
    with pytest.raises(pickle.UnpicklingError):
        main(upscale_args(tmp_path, exp, "--form", "net"))


def test_upscale_cli_auto_never_catches_a_predictor_error(tmp_path,
                                                          monkeypatch):
    from lerf_torch.cli import eval_model, upscale

    def broken(cfg, params):
        raise RuntimeError("CUDA error: launch failed")

    monkeypatch.setattr(eval_model, "predictor_from_params", broken)
    exp = net_experiment(tmp_path)
    with pytest.raises(RuntimeError, match="launch failed"):
        upscale.main(upscale_args(tmp_path, exp, "--form", "auto"))
