"""The port's training loop and CLI on the CPU, alone: the train → transfer →
lutft → resume cycle of tests/test_loop_smoke.py (lerf_tpu's, marked slow)
at its sizes (synthetic DIV2K, crop 8, nf 8, a few steps), in seconds.

A resumed run equals an uninterrupted one bit for bit here: the
checkpoint holds the params, Adam, the scheduler and the sampler's state,
and the CPU's sums run in a fixed order.  Torch runs on one thread
(``one_torch_thread``).
"""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_train_data import write_div2k

from lerf_torch import config
from lerf_torch.cli.train import main as train_main
from lerf_torch.config import TrainConfig
from lerf_torch.lut.io import load_lut_bank
from lerf_torch.pipeline import LutPredictor, NetPredictor
from lerf_torch.train import loop, lutft
from lerf_torch.train.checkpoint import (CheckpointManager,
                                         OrbaxCheckpointError)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """See tests/test_torch_train.py: torch on one thread for the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_root")
    write_div2k(root / "div2k", n=2)
    set5_tree(root / "rr")
    return root


def set5_tree(root, n=2, seed=20):
    """A Set5-layout SR benchmark: HR/{i}.png and its ×2 / ×3 / ×4
    decimations under LR_bicubic/rrLR_X{s}.00_{s}.00."""
    rng = np.random.RandomState(seed)
    hr_dir = root / "Set5" / "HR"
    os.makedirs(hr_dir)
    for i in range(n):
        hr = rng.randint(0, 256, (24, 24, 3), dtype=np.uint8)
        Image.fromarray(hr).save(hr_dir / f"{i}.png")
        for s in (2, 3, 4):
            d = root / "Set5" / "LR_bicubic" / f"rrLR_X{s}.00_{s}.00"
            os.makedirs(d, exist_ok=True)
            Image.fromarray(hr[::s, ::s]).save(d / f"{i}.png")
    return root


def orbax_step(exp, step):
    """A real orbax step directory, written by lerf_tpu's checkpointer."""
    import jax.numpy as jnp

    from lerf_tpu.train.checkpoint import CheckpointManager as JaxManager

    mgr = JaxManager(str(exp))
    mgr.save(step, {"params": {"w": jnp.ones(3)}})
    mgr.close()


def cfg(root, exp, **kw):
    base = dict(exp_dir=str(root / exp), train_dir=str(root / "div2k"),
                val_dir=str(root / "none"), val_w_dir=str(root / "none"),
                scale="4", crop_size=8, batch_size=8, total_iter=6,
                display_step=2, save_step=3, val_step=100, nf=8, out_c=3,
                two_stage=True, platform="cpu")
    base.update(kw)
    return TrainConfig(**base)


def tags(exp):
    with open(os.path.join(exp, "scalars.jsonl")) as f:
        return [json.loads(line)["tag"] for line in f]


def test_train_transfer_lutft_cycle(root, capsys):
    """Train (checkpoints, scalars), transfer the step-6 checkpoint with
    the CLI, fine-tune the bank with ``--lutft``, serve ``LUTft_*.npy``."""
    from lerf_torch.cli.transfer import main as transfer_main

    c = cfg(root, "exp1")
    params = loop.train(c)
    assert sorted(params) == ["s1", "s2"]
    assert CheckpointManager(c.exp_dir).all_steps() == [3, 6]
    assert tags(c.exp_dir).count("loss_Pixel") == 3
    bank = transfer_main(["-e", c.exp_dir, "--loadIter", "6", "--outC", "3",
                          "--platform", "cpu"])
    assert bank.stage1["s"].shape == (17 ** 4, 1)
    tables = train_main(["-e", c.exp_dir, "--trainDir", c.train_dir,
                         "--twoStage", "--outC", "3", "--lutft", "--lr0",
                         "1e-4", "--totalIter", "4", "--cropSize", "8",
                         "--batchSize", "8", "--displayStep", "2",
                         "--valStep", "100", "--nf", "8", "--valDir",
                         c.val_dir, "--valWDir", c.val_w_dir,
                         "--platform", "cpu"])
    ft = load_lut_bank(c.exp_dir, lut_name="LUTft", out_c=3)
    assert ft.stage2["sr0"].shape == (17 ** 4, 3)
    assert ft.stage2["sr0"].dtype == np.int8
    # four steps at lr 1e-4 move the float tables, by less than 1 LSB
    start = lutft.params_from_bank(bank)
    assert any(not torch.equal(tables["s2"][k], start["s2"][k])
               for k in start["s2"])
    pred = LutPredictor.from_config(config.parse_config(
        config.TestConfig, ["-e", c.exp_dir, "--platform", "cpu"]))
    out = pred.upscale(np.zeros((8, 10, 3), np.uint8), 2, 2)
    assert out.shape == (16, 20, 3) and out.dtype == np.uint8


def test_resume_equals_an_uninterrupted_run(root):
    """Resume from step 3 of an 8-step run (the same schedule): the same
    params, Adam state and batches, so the same final params."""
    whole = loop.train(cfg(root, "exp2", total_iter=8))
    resumed = loop.train(cfg(root, "exp2", start_iter=3, total_iter=8))
    for sk in whole:
        for name in whole[sk]:
            for k, v in whole[sk][name].items():
                assert torch.equal(v, resumed[sk][name][k]), (sk, name, k)
    with pytest.raises(FileNotFoundError):
        loop.train(cfg(root, "exp2", start_iter=5, total_iter=8))


def test_cli_reference_flags_validate_and_profile(root):
    """The reference's LeRF-G flags at a small size; validation on a
    Set5-layout tree logs PSNR / SSIM; the profiler window writes a chrome
    trace."""
    exp = str(root / "exp3")
    params = train_main(
        ["-e", exp, "--twoStage", "--outC", "3", "--trainDir",
         str(root / "div2k"), "--valDir", str(root / "rr"), "--valWDir",
         str(root / "none"), "--cropSize", "8", "--batchSize", "4",
         "--totalIter", "11", "--displayStep", "11", "--saveStep", "11",
         "--valStep", "11", "--nf", "8", "--profile_steps", "1",
         "--platform", "cpu"])
    assert {"PSNR_X2/Set5", "SSIM_X4/Set5", "loss_Pixel"} <= set(tags(exp))
    assert os.path.exists(os.path.join(exp, "profile", "trace.json"))
    assert os.path.exists(os.path.join(exp, "opt.json"))
    assert os.path.exists(os.path.join(exp, "code", "train", "loop.py"))
    assert "w6" in params["s2"]["sr0"]


@pytest.mark.parametrize("flags", [["--device_data"],
                                   ["--model", "IMDN2", "--inC", "3"],
                                   ["--linear", "--outC", "1"]],
                         ids=["device_data", "imdn2", "lerf_l"])
def test_cli_trains_other_forms(root, flags):
    exp = str(root / f"exp-{flags[0].strip('-')}")
    params = train_main(
        ["-e", exp, "--twoStage", "--trainDir", str(root / "div2k"),
         "--valDir", str(root / "none"), "--valWDir", str(root / "none"),
         "--cropSize", "8", "--batchSize", "4", "--totalIter", "4",
         "--displayStep", "2", "--saveStep", "2", "--nf", "8",
         "--platform", "cpu", *flags])
    assert CheckpointManager(exp).all_steps() == [2, 4]
    assert all(np.isfinite(v.numpy()).all()
               for v in loop.param_leaves(params).values())


def test_auto_reseed_restarts_a_dead_run(root):
    """A run whose gradients are zero with a high loss (the
    clamp-saturation trap) restarts from the next seed."""
    seeds = []

    def init(generator):
        seeds.append(generator.initial_seed())
        return {"w": torch.zeros(1)}

    def dead_feature(params, x):          # feature 0 whatever the params
        return params["w"] * 0 + torch.zeros_like(x)

    adapter = loop.ModelAdapter(
        init_params=init, stage1_fn=dead_feature,
        stage2_fn=lambda p, x: torch.zeros(x.shape + (3,)),
        make_predictor=None, finalize=lambda params, cfg: None)
    c = cfg(root, "exp-dead", total_iter=50, display_step=25, save_step=100,
            auto_reseed=1)
    loop.train(c, adapter)
    assert seeds == [0, 1]
    with open(os.path.join(c.exp_dir, "train.log")) as f:
        assert "clamp-saturation trap" in f.read()


def test_more_than_one_device_is_not_ported(root):
    with pytest.raises(NotImplementedError, match="item 12"):
        loop.train(cfg(root, "exp-dp", data_axis=2))


def test_trained_checkpoint_serves_and_orbax_is_refused(root):
    """eval_model's predictor reads the trainer's checkpoint of
    ``--loadIter``; lerf_tpu's orbax step directory is refused with a
    message naming its writer."""
    from lerf_torch.cli.eval_model import build_predictor

    c = cfg(root, "exp4", total_iter=3)
    params = loop.train(c)
    test_cfg = config.parse_config(config.TestConfig, [
        "-e", c.exp_dir, "--loadIter", "3", "--twoStage", "--nf", "8",
        "--platform", "cpu"])
    got = build_predictor(test_cfg).upscale(np.zeros((6, 7, 3), np.uint8),
                                            2, 2)
    want = NetPredictor.from_srnets(params, device="cpu").upscale(
        np.zeros((6, 7, 3), np.uint8), 2, 2)
    np.testing.assert_array_equal(got, want)
    orbax_step(c.exp_dir, 9)
    with pytest.raises(OrbaxCheckpointError, match="lerf_tpu"):
        CheckpointManager(c.exp_dir).restore(9)
