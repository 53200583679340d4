"""lerf_torch's IMDN (LeRF-Net) form against lerf_tpu's.

The port's ``IMDN2`` gets lerf_tpu's shared IMDN predictor's variables
(nf 12, ``PRNGKey(0)``; ``tests/conftest.py``), carried across by
``convert.imdn_from_arrays``.  The towers are float32 convolutions summed
in another order than XLA's: the stage-1 feature (0..254) within 1e-3,
the stage-2 hyper maps (0..1) within 1e-5; a uint8 frame may then round
the other way at a .5 edge: off by at most 1 on at most 0.1 % of pixels.
The serving forms are held bit-equal to the port's own ``upscale`` /
``warp`` frame by frame, and the LUT and SRNet forms' batch forms to their
single-frame calls (the batch now folds into the channel axis after the
stages).  Torch runs on one thread (see ``one_torch_thread``).
"""
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from conftest import shared_imdn_predictor
from lerf_tpu.models import convert as jconvert
from lerf_tpu.models import imdn as jimdn
from lerf_tpu.models import imdn_s2d as js2d
from lerf_tpu.pipeline import NetPredictor as JaxNetPredictor

from lerf_torch.convert import (imdn_from_arrays, imdn_tower_state,
                                lerf_nets_from_arrays)
from lerf_torch.models import imdn_s2d
from lerf_torch.models.convert import imdn_from_torch_checkpoint
from lerf_torch.models.imdn import IMDN2, IMDN_RTC, depth_to_space
from lerf_torch.pipeline import LutPredictor, NetPredictor

FEAT_ATOL = 1e-3       # 0..254 feature: float32 conv sums in another order
HYPER_ATOL = 1e-5      # 0..1 hyper maps
U8_SHARE = 0.001       # uint8 pixels that may round the other way (by 1)
MATRICES = {
    "zoom-jitter": np.array([[2.0, 0.1, 1.0], [0.05, 1.9, -1.0],
                             [1e-3, 2e-3, 1.0]]),
    "rotate": np.array([[1.6, -0.5, 6.0], [0.5, 1.6, -3.0],
                        [0.0, 0.0, 1.0]]),
}
WARP_OUT = (30, 36)
_PREDICTORS = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU paths run many small torch ops; with one intra-op
    thread a core they stall whenever the test workers share the cores, so
    this module runs torch on one thread and gives the count back after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_variables():
    return shared_imdn_predictor().params


def port_model():
    model = IMDN2(nf=12)
    model.load_state_dict(imdn_from_arrays(
        jax.tree.map(np.asarray, jax_variables())))
    return model


def predictors(**kwargs):
    """(lerf_tpu, port) IMDN predictors on the shared variables."""
    key = tuple(sorted(kwargs.items()))
    if key not in _PREDICTORS:
        jax_pred = shared_imdn_predictor() if not kwargs else \
            JaxNetPredictor.from_imdn(jimdn.IMDN2(in_c=3, out_c=3, nf=12),
                                      jax_variables(), out_c=3, **kwargs)
        port = NetPredictor.from_imdn(port_model(), device="cpu", **kwargs)
        _PREDICTORS[key] = (jax_pred, port)
    return _PREDICTORS[key]


def image(h=14, w=19, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)) \
        .astype(np.uint8)


def assert_u8_close(want, got):
    assert want.shape == got.shape and got.dtype == np.uint8
    d = np.abs(np.asarray(want, int) - np.asarray(got, int))
    assert d.max() <= 1 and (d > 0).mean() <= U8_SHARE, \
        (d.max(), (d > 0).mean())


def np_imdn_state(nf=8, seed=0):
    """A reference-layout IMDN2 state dict of numpy-seeded weights."""
    rng = np.random.RandomState(seed)
    model = IMDN2(nf=nf)
    return {k: torch.from_numpy(
        (rng.uniform(-1, 1, v.shape)
         / np.sqrt(v[0].numel() if v.dim() == 4 else v.numel()))
        .astype(np.float32)) for k, v in model.state_dict().items()}


def imdn_experiment(tmp_path, nf=8, seed=0):
    """An experiment directory holding a reference-named IMDN2 state
    dict."""
    exp = tmp_path / "lerf-imdn"
    os.makedirs(exp, exist_ok=True)
    torch.save(np_imdn_state(nf, seed), str(exp / "Model_050000.pth"))
    return exp


# -- the modules ---------------------------------------------------------------

@pytest.mark.parametrize("stage,atol", [(1, FEAT_ATOL), (2, HYPER_ATOL)])
def test_imdn2_towers_match_jax(stage, atol):
    x = np.random.RandomState(1).rand(2, 13, 17, 3).astype(np.float32)
    want = np.asarray(jimdn.IMDN2(in_c=3, out_c=3, nf=12).apply(
        jax_variables(), jnp.asarray(x), stage))
    with torch.no_grad():
        got = port_model().predict(
            torch.from_numpy(x.transpose(0, 3, 1, 2)), stage).numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, rtol=0,
                               atol=atol)


def test_imdn_rtc_upscale2_matches_jax():
    rtc = jimdn.IMDN_RTC(in_nc=3, nf=12, out_nc=3, upscale=2)
    var = rtc.init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 3)))
    port = IMDN_RTC(3, 12, 5, 3, upscale=2)
    state = imdn_tower_state("t", jax.tree.map(np.asarray, var)["params"])
    port.load_state_dict({k[2:]: v for k, v in state.items()})
    x = np.random.RandomState(2).rand(1, 9, 11, 3).astype(np.float32)
    want = np.asarray(rtc.apply(var, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    assert got.shape == (1, 3, 18, 22)
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, rtol=0,
                               atol=1e-5)


def test_depth_to_space_is_channel_minor_not_pixel_shuffle():
    x = torch.arange(2 * 12 * 2 * 3, dtype=torch.float32).reshape(2, 12, 2, 3)
    got = depth_to_space(x, 2, 3)
    # channel (i·u + j)·oC + c lands at (h·u + i, w·u + j) of channel c
    for i in range(2):
        for j in range(2):
            for c in range(3):
                torch.testing.assert_close(got[:, c, i::2, j::2],
                                           x[:, (i * 2 + j) * 3 + c],
                                           rtol=0, atol=0)
    assert not torch.equal(got, F.pixel_shuffle(x, 2))


def test_embed_kernel_matches_jax():
    w = np.random.RandomState(3).randn(3, 3, 4, 5).astype(np.float32)
    for b in (2, 3):
        np.testing.assert_array_equal(imdn_s2d.embed_kernel(w, b),
                                      js2d.embed_kernel(w, b))
        np.testing.assert_array_equal(imdn_s2d.embed_bias(w[0, 0, 0], b),
                                      js2d.embed_bias(w[0, 0, 0], b))
    variables = jax.tree.map(np.asarray, jax_variables())
    jax.tree.map(np.testing.assert_array_equal,
                 imdn_s2d.convert_imdn2(variables, 2),
                 jax.tree.map(np.asarray, js2d.convert_imdn2(variables, 2)))
    np.testing.assert_array_equal(
        imdn_s2d.convert_tower(imdn_s2d.tower_arrays(port_model().stage1),
                               2)["imd0"]["c3"]["kernel"],
        js2d.convert_tower(variables["params"]["stage1"], 2)["imd0"]["c3"]
        ["kernel"])


@pytest.mark.parametrize("hw,block", [((16, 20), 2), ((13, 17), 2),
                                      ((11, 14), 3)],
                         ids=["multiple", "ragged", "block3-ragged"])
def test_s2d_backend_matches_base(hw, block):
    model = port_model()
    x = torch.from_numpy(np.random.RandomState(4).rand(3, *hw)
                         .astype(np.float32))
    base = imdn_s2d.make_chw_stage_fns(model, backend="base", device="cpu")
    s2d = imdn_s2d.make_chw_stage_fns(model, backend="s2d", block=block,
                                      device="cpu")
    torch.testing.assert_close(s2d[0](x), base[0](x), rtol=0, atol=FEAT_ATOL)
    torch.testing.assert_close(s2d[1](x), base[1](x), rtol=0,
                               atol=HYPER_ATOL)


def test_hyper_layout_moves_oc_blocks_to_the_trailing_axis():
    """Stage 2's output channel ``o·C + c`` (the reference's [ρ·C, σx·C,
    σy·C]) is hyper[c, ..., o]: a tower whose output channels are distinct
    constants gives each its own place, as lerf_tpu's stage function
    does."""
    model = port_model()
    up = model.stage2.model[2]
    with torch.no_grad():
        up.weight.zero_()
        up.bias.copy_(torch.linspace(-0.9, 0.9, 9))
    _, s2 = imdn_s2d.make_chw_stage_fns(model, backend="base", device="cpu")
    x = torch.rand(3, 5, 6, generator=torch.Generator().manual_seed(0))
    got = s2(x)
    assert got.shape == (3, 5, 6, 3)
    want = torch.linspace(-0.9, 0.9, 9).reshape(3, 3).T / 2 + 0.5  # [c, o]
    torch.testing.assert_close(got, want[:, None, None, :].expand(3, 5, 6, 3),
                               rtol=0, atol=0)
    variables = jax.tree.map(np.asarray, jax_variables())
    variables["params"]["stage2"]["up"]["kernel"] = np.zeros_like(
        variables["params"]["stage2"]["up"]["kernel"])
    variables["params"]["stage2"]["up"]["bias"] = np.linspace(
        -0.9, 0.9, 9).astype(np.float32)
    _, _, js2 = js2d.make_chw_stage_fns(variables, backend="base", nf=12)
    np.testing.assert_allclose(
        np.asarray(js2(variables, jnp.asarray(x.numpy()))), got.numpy(),
        rtol=0, atol=1e-7)


def test_reference_layout_state_dict_round_trips():
    """The port's state-dict names are the reference checkpoint's:
    lerf_tpu's reference reader takes a port state dict back to the same
    variables, and a saved one loads through
    ``imdn_from_torch_checkpoint``."""
    variables = jax.tree.map(np.asarray, jax_variables())
    state = imdn_from_arrays(variables)
    assert set(state) == set(IMDN2(nf=12).state_dict())
    back = {"params": {s: jconvert.imdn_rtc_from_torch(s, state)
                       for s in ("stage1", "stage2")}}
    jax.tree.map(np.testing.assert_array_equal, back, variables)


def test_saved_state_dict_loads_through_the_checkpoint_reader(tmp_path):
    exp = imdn_experiment(tmp_path)
    state = imdn_from_torch_checkpoint(str(exp / "Model_050000.pth"))
    model = IMDN2(nf=8)
    model.load_state_dict(state)                      # strict: every name
    for k, v in np_imdn_state().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)


# -- the predictor against lerf_tpu ---------------------------------------------

@pytest.mark.parametrize("kwargs,scale", [
    ({}, 2.0), ({}, 2.5), ({}, 4.0), ({}, 0.5),
    ({"two_stage": False}, 2.0), ({"linear": True}, 2.0),
    ({"linear": True, "two_stage": False}, 2.5)],
    ids=["x2", "x2.5", "x4", "x0.5", "one-stage", "linear",
         "linear-one-stage"])
def test_imdn_upscale_matches_jax(kwargs, scale):
    jax_pred, port = predictors(**kwargs)
    img = image()
    want = jax_pred.upscale(img, scale, scale, return_aux=True)
    got = port.upscale(img, scale, scale, return_aux=True)
    assert got[1].dtype == np.float32 and got[1].shape == (3, 14, 19)
    assert got[2].dtype == np.float32 and got[2].shape == (3, 14, 19, 3)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=0,
                               atol=FEAT_ATOL)
    np.testing.assert_allclose(got[2], np.asarray(want[2]), rtol=0,
                               atol=HYPER_ATOL)
    assert_u8_close(want[0], got[0])


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_imdn_warp_matches_jax(name, linear):
    jax_pred, port = predictors(**({"linear": True} if linear else {}))
    img = image(13, 17, seed=5)
    want_out, want_mask = jax_pred.warp(img, MATRICES[name], WARP_OUT)
    got_out, got_mask = port.warp(img, MATRICES[name], WARP_OUT)
    np.testing.assert_array_equal(got_mask, np.asarray(want_mask))
    assert_u8_close(want_out, got_out)


def test_imdn_scale_one_skips_the_towers():
    jax_pred, port = predictors()
    img = image(9, 11, seed=6)
    np.testing.assert_array_equal(port.upscale(img, 1, 1), img)
    np.testing.assert_array_equal(port.upscale(img, 1, 1),
                                  jax_pred.upscale(img, 1, 1))


def test_imdn_backends_give_one_frame():
    """"s2d" serves the same frame as "base" (uint8 within a rounding at a
    .5 edge), and "auto" is one of them."""
    _, port = predictors()
    s2d = NetPredictor.from_imdn(port_model(), backend="s2d", device="cpu")
    img = image(15, 18, seed=7)
    assert_u8_close(port.upscale(img, 2.5, 2.5), s2d.upscale(img, 2.5, 2.5))
    assert imdn_s2d.resolve_backend("auto") in ("base", "s2d")
    with pytest.raises(ValueError, match="backend"):
        imdn_s2d.resolve_backend("pallas")


def test_imdn_leaves_the_cudnn_flags_as_they_were():
    flags = (torch.backends.cudnn.enabled, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32)
    _, port = predictors()
    port.upscale(image(8, 9, seed=8), 2, 2)
    assert (torch.backends.cudnn.enabled, torch.backends.cudnn.benchmark,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.allow_tf32) == flags


def test_from_imdn_leaves_the_callers_model_alone():
    model = port_model()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    NetPredictor.from_imdn(model, np_imdn_state(nf=12, seed=9),
                           device="cpu")
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


# -- the serving forms, frame by frame -------------------------------------------

@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_imdn_sr_serving_forms_equal_upscale(linear):
    _, port = predictors(**({"linear": True} if linear else {}))
    imgs = np.stack([image(12, 15, seed=10 + i) for i in range(3)])
    for scale in (2.5, 0.5):
        want = [port.upscale(f, scale, scale) for f in imgs]
        np.testing.assert_array_equal(
            port.upscale_dynamic(imgs[0], scale, scale), want[0])
        np.testing.assert_array_equal(
            port.upscale_batch(imgs, scale, scale), np.stack(want))


@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_imdn_warp_serving_forms_equal_warp(linear):
    _, port = predictors(**({"linear": True} if linear else {}))
    imgs = np.stack([image(13, 17, seed=20 + i) for i in range(3)])
    mats = [MATRICES["zoom-jitter"], MATRICES["rotate"],
            MATRICES["zoom-jitter"] @ np.diag([1.1, 0.9, 1.0])]
    want = [port.warp(f, m, WARP_OUT) for f, m in zip(imgs, mats)]
    for form in (port.warp_dynamic, port.warp_device):
        out, mask = form(imgs[1], mats[1], WARP_OUT)
        np.testing.assert_array_equal(out, want[1][0])
        np.testing.assert_array_equal(mask, want[1][1])
    out, mask = port.warp_batch(imgs, np.stack(mats), WARP_OUT)
    np.testing.assert_array_equal(out, np.stack([w[0] for w in want]))
    np.testing.assert_array_equal(mask, np.stack([w[1] for w in want]))


@pytest.mark.parametrize("form", ["lut", "srnet"])
def test_lut_and_srnet_batch_forms_stay_per_frame(form):
    """The batch folds into the channel axis after the stages now: the LUT
    and SRNet forms' batches stay bit-equal to their frames."""
    from conftest import shared_lut_predictor
    from test_torch_srnet import np_params
    from lerf_torch.convert import bank_from_arrays

    if form == "lut":
        b = shared_lut_predictor().bank
        port = LutPredictor(bank_from_arrays(b.stage1, b.stage2, b.inter,
                                             b.out_c), device="cpu")
    else:
        port = NetPredictor.from_srnets(
            lerf_nets_from_arrays(np_params(nf=8, seed=0)), device="cpu")
    imgs = np.stack([image(10, 13, seed=30 + i) for i in range(3)])
    np.testing.assert_array_equal(
        port.upscale_batch(imgs, 2.5, 2.5),
        np.stack([port.upscale(f, 2.5, 2.5) for f in imgs]))
    mats = [MATRICES["zoom-jitter"], MATRICES["rotate"],
            MATRICES["rotate"] @ np.diag([0.9, 1.1, 1.0])]
    out, mask = port.warp_batch(imgs, np.stack(mats), WARP_OUT)
    for k, (f, m) in enumerate(zip(imgs, mats)):
        want = port.warp(f, m, WARP_OUT)
        np.testing.assert_array_equal(out[k], want[0])
        np.testing.assert_array_equal(mask[k], want[1])


# -- the CLIs --------------------------------------------------------------------

def test_eval_model_cli_imdn_prints_jax_table(tmp_path, capsys):
    from lerf_tpu.cli.eval_model import main as jax_main
    from lerf_torch.cli.eval_model import main as torch_main
    from test_torch_net_pipeline import tiny_benchmark

    exp = imdn_experiment(tmp_path)
    rr = tiny_benchmark(tmp_path)
    capsys.readouterr()
    args = ["-e", str(exp), "--testDir", str(rr), "--datasets", "Tiny",
            "--scales", "2", "--model", "IMDN2", "--inC", "3",
            "--nf", "8", "--twoStage", "--platform", "cpu"]
    want = jax_main(args + ["--resultRoot", str(tmp_path / "res_jax")])
    want_out = capsys.readouterr().out.splitlines()
    got = torch_main(args + ["--resultRoot", str(tmp_path / "res_torch")])
    got_out = capsys.readouterr().out.splitlines()
    assert len(got_out) == len(want_out) == 2
    assert got_out[0] == want_out[0]                     # the header
    for scale, (p_want, s_want) in want["Tiny"].items():
        p_got, s_got = got["Tiny"][scale]
        assert abs(p_got - p_want) <= 0.01 and abs(s_got - s_want) <= 1e-3


def test_eval_model_cli_imdn_without_checkpoint_and_orbax(tmp_path):
    """No checkpoint: the seed-0 model (``torch.Generator``), the same on
    every call; an empty ``ckpt/`` falls through to it, as in lerf_tpu;
    the port trainer's checkpoint of ``--loadIter`` is read; an orbax step
    directory exits with a message naming its writer."""
    import shutil

    from lerf_torch.cli.eval_model import build_predictor
    from lerf_torch.config import TestConfig, parse_config
    from lerf_torch.models.imdn import init_imdn
    from lerf_torch.train.checkpoint import CheckpointManager, host_params
    from test_torch_train_loop import orbax_step

    cfg = parse_config(TestConfig, ["-e", str(tmp_path), "--model", "IMDN2",
                                    "--inC", "3", "--nf", "8",
                                    "--platform", "cpu"])
    img = image(8, 10, seed=11)
    a = build_predictor(cfg).upscale(img, 2, 2, return_aux=True)
    b = build_predictor(cfg).upscale(img, 2, 2, return_aux=True)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])
    os.makedirs(tmp_path / "ckpt")
    c = build_predictor(cfg).upscale(img, 2, 2, return_aux=True)
    np.testing.assert_array_equal(c[1], a[1])
    trained = init_imdn(IMDN2(in_c=3, out_c=3, nf=8),
                        torch.Generator().manual_seed(5))
    CheckpointManager(str(tmp_path)).save(
        cfg.load_iter, {"params": host_params(trained)})
    got = build_predictor(cfg).upscale(img, 2, 2, return_aux=True)
    want = NetPredictor.from_imdn(trained, two_stage=False,
                                  device="cpu").upscale(img, 2, 2,
                                                        return_aux=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[2], a[2])          # another hyper net
    shutil.rmtree(tmp_path / "ckpt")
    orbax_step(tmp_path, cfg.load_iter)
    with pytest.raises(SystemExit, match="orbax checkpoint written by "
                                         "lerf_tpu"):
        build_predictor(cfg)
