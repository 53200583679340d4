"""The port's trainer writes TensorBoard event files beside ``scalars.jsonl``,
as lerf_tpu's does: a short CPU run's event file holds the same tags, steps
and values as its JSON lines, and the same tags as lerf_tpu's run of the
same config.  Torch runs on one thread (``one_torch_thread``)."""
import glob
import json
import os

import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import \
    EventAccumulator

from test_torch_train_data import write_div2k
from test_torch_train_loop import set5_tree

from lerf_torch.config import TrainConfig
from lerf_torch.train import loop


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """See tests/test_torch_train.py: torch on one thread for the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tb_root")
    write_div2k(root / "div2k", n=2)
    set5_tree(root / "rr")
    return root


def run_config(root, exp, val_dir):
    return dict(exp_dir=str(root / exp), train_dir=str(root / "div2k"),
                val_dir=str(val_dir), val_w_dir=str(root / "none"),
                scale="4", crop_size=8, batch_size=8, total_iter=4,
                display_step=2, save_step=100, val_step=4, nf=8, out_c=3,
                two_stage=True, platform="cpu")


def events(exp_dir):
    """{tag: [(step, value)]} of the run's one event file."""
    files = glob.glob(os.path.join(exp_dir, "events.out.tfevents.*"))
    assert len(files) == 1, files
    acc = EventAccumulator(files[0], size_guidance={"scalars": 0})
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def json_lines(exp_dir):
    out = {}
    with open(os.path.join(exp_dir, "scalars.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            out.setdefault(row["tag"], []).append((row["step"], row["value"]))
    return out


def test_event_file_equals_scalars_jsonl(root):
    """Loss, gradient norm and the Set5 validation's PSNR / SSIM: one event
    a JSON line, the value as TensorBoard keeps it (float32)."""
    exp = root / "port-val"
    loop.train(TrainConfig(**run_config(root, "port-val", root / "rr")))
    got, want = events(exp), json_lines(exp)
    assert {"loss_Pixel", "grad_norm", "PSNR_X4/Set5",
            "SSIM_X2/Set5"} <= set(want)
    assert set(got) == set(want)
    for tag, points in want.items():
        assert [s for s, _ in got[tag]] == [s for s, _ in points], tag
        np.testing.assert_array_equal(
            np.float32([v for _, v in got[tag]]),
            np.float32([v for _, v in points]), err_msg=tag)


def test_event_tags_equal_lerf_tpus(root):
    """The same config trained by lerf_tpu and by the port: the same event
    tags, each at the same steps."""
    from lerf_tpu.config import TrainConfig as JaxTrainConfig
    from lerf_tpu.train.loop import train as jax_train

    cfg = run_config(root, "tpu", root / "none")
    jax_train(JaxTrainConfig(**cfg))
    loop.train(TrainConfig(**{**cfg, "exp_dir": str(root / "port")}))
    ref, got = events(root / "tpu"), events(root / "port")
    assert set(got) == set(ref) == {"loss_Pixel", "grad_norm"}
    for tag in ref:
        assert [s for s, _ in got[tag]] == [s for s, _ in ref[tag]], tag
