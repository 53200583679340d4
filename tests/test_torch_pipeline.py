"""lerf_torch.pipeline.LutPredictor and the port's CLIs against lerf_tpu.

On the CPU the port's ``upscale`` must give feat and hyper int32-equal and
the uint8 output equal to lerf_tpu's (the JAX side uses the shared seed-7
predictor, packed8 tables; its values equal the flat layout's).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from conftest import REPO_ROOT, shared_lut_predictor
from lerf_tpu.lut.io import LUTBank as JaxLUTBank
from lerf_tpu.pipeline import LutPredictor as JaxLutPredictor

from lerf_torch.convert import bank_from_arrays
from lerf_torch.lut.io import save_lut_bank
from lerf_torch.pipeline import LutPredictor

SCALES = [(2.0, 2.0), (4.0, 4.0), (2.5, 2.5), (0.5, 0.5)]


def port_of(jax_pred, **kwargs):
    b = jax_pred.bank
    bank = bank_from_arrays(b.stage1, b.stage2, b.inter, b.out_c, b.interval)
    return LutPredictor(bank, stages=b.stages, **kwargs)


def image(h=20, w=28, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)) \
        .astype(np.uint8)


def assert_same_upscale(want, got):
    for name, a, b in zip(("out", "feat", "hyper"), want, got):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("scale", SCALES, ids=lambda s: f"x{s[0]}")
def test_upscale_matches_jax(scale):
    jax_pred = shared_lut_predictor()
    img = image()
    want = jax_pred.upscale(img, *scale, return_aux=True)
    got = port_of(jax_pred, device="cpu").upscale(img, *scale,
                                                  return_aux=True)
    assert got[0].dtype == np.uint8 and got[2].shape == (3, 20, 28, 3)
    assert_same_upscale(want, got)


def test_three_stage_upscale_matches_jax():
    rng = np.random.RandomState(3)

    def lut(oc):
        return rng.randint(-127, 128, (17 ** 4, oc)).astype(np.int8)

    feature = [{m: lut(1) for m in "sct"} for _ in range(2)]
    bank = JaxLUTBank(stage1=feature[-1], inter=feature[:-1], out_c=3,
                      stage2={f"{m}r{r}": lut(3) for m in "sct"
                              for r in (0, 1)})
    jax_pred = JaxLutPredictor(bank, stages=3, table_layout="flat")
    img = image(13, 9, seed=7)
    want = jax_pred.upscale(img, 2.0, 2.0, return_aux=True)
    got = port_of(jax_pred, device="cpu").upscale(img, 2.0, 2.0,
                                                  return_aux=True)
    assert_same_upscale(want, got)


def test_upscale_cli_matches_jax(tmp_path):
    from lerf_torch.cli.upscale import main

    jax_pred = shared_lut_predictor()
    b = jax_pred.bank
    save_lut_bank(bank_from_arrays(b.stage1, b.stage2, b.inter, b.out_c),
                  str(tmp_path / "bank"), lut_name="LUTft")
    img = image()
    Image.fromarray(img).save(tmp_path / "in.png")
    out = main(["-e", str(tmp_path / "bank"), "--input",
                str(tmp_path / "in.png"), "--output",
                str(tmp_path / "out" / "up.png"), "--scale", "2.5",
                "--platform", "cpu"])
    written = np.array(Image.open(tmp_path / "out" / "up.png"))
    np.testing.assert_array_equal(written, out)
    np.testing.assert_array_equal(out, jax_pred.upscale(img, 2.5, 2.5))


@pytest.mark.parametrize("flags", [["--form", "net", "--model", "IMDN2",
                                    "--inC", "3", "--nf", "8", "--twoStage",
                                    "--scale", "2.5"],
                                   ["--matrix", "2,0.1,1,0,2,-1,0,0,1",
                                    "--outSize", "24x32", "--dynamicWarp"],
                                   ["--matrix", "2,0.1,1,0,2,-1,0,0,1",
                                    "--outSize", "24x32", "--bucket", "8"]],
                         ids=["form", "matrix", "matrix-bucket"])
def test_upscale_cli_flags_match_jax_or_exit(flags, tmp_path):
    """Flags that exited "not ported" now run as lerf_tpu's CLI does:
    ``--form net --model IMDN2`` upscales through the IMDN form on a
    reference-named IMDN2 state dict (the same image but for a rounding at
    a .5 edge on ≤ 0.1 % of values), and the warp's serving flags warp
    (``--dynamicWarp`` through ``warp_dynamic``, ``--bucket`` through
    ``warp``), the same image."""
    from lerf_tpu.cli.upscale import main as jax_main
    from lerf_torch.cli.upscale import main

    if "--model" in flags:
        from test_torch_imdn import imdn_experiment

        exp = imdn_experiment(tmp_path)
        Image.fromarray(image(12, 16)).save(tmp_path / "in.png")
        args = ["-e", str(exp), "--input", str(tmp_path / "in.png"),
                "--platform", "cpu", *flags]
        got = main(args + ["--output", str(tmp_path / "out.png")])
        want = jax_main(args + ["--output", str(tmp_path / "jax.png")])
        np.testing.assert_array_equal(
            np.array(Image.open(tmp_path / "out.png")), got)
        assert got.shape == want.shape == (30, 40, 3)
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= 0.001
        return
    b = shared_lut_predictor().bank
    save_lut_bank(bank_from_arrays(b.stage1, b.stage2, b.inter, b.out_c),
                  str(tmp_path / "bank"), lut_name="LUTft")
    Image.fromarray(image(12, 16)).save(tmp_path / "in.png")
    args = ["-e", str(tmp_path / "bank"), "--input", str(tmp_path / "in.png"),
            "--platform", "cpu", *flags]
    got = main(args + ["--output", str(tmp_path / "out.png")])
    want = jax_main(args + ["--output", str(tmp_path / "jax.png")])
    np.testing.assert_array_equal(np.array(Image.open(tmp_path / "out.png")),
                                  got)
    assert got.shape == (24, 32, 3) and got.any()
    np.testing.assert_array_equal(got, want)


def test_eval_lut_sr_cli_prints_jax_table(tmp_path, capsys):
    from lerf_tpu.cli.eval_lut_sr import main as jax_main
    from lerf_tpu.cli.make_benchmark import main as make_benchmark
    from lerf_torch.cli.eval_lut_sr import main as torch_main

    hr_dir = tmp_path / "rr" / "Tiny" / "HR"
    os.makedirs(hr_dir)
    for i in range(2):
        Image.fromarray(image(24, 32, seed=10 + i)).save(hr_dir / f"{i}.png")
    make_benchmark(["--hrDir", str(hr_dir), "--scales", "2",
                    "--platform", "cpu"])
    b = shared_lut_predictor().bank
    save_lut_bank(bank_from_arrays(b.stage1, b.stage2, b.inter, b.out_c),
                  str(tmp_path / "bank"), lut_name="LUTft")
    capsys.readouterr()
    args = ["-e", str(tmp_path / "bank"), "--testDir", str(tmp_path / "rr"),
            "--datasets", "Tiny", "--scales", "2", "--platform", "cpu"]
    want = jax_main(args + ["--resultRoot", str(tmp_path / "res_jax")])
    want_out = capsys.readouterr().out
    got = torch_main(args + ["--resultRoot", str(tmp_path / "res_torch")])
    got_out = capsys.readouterr().out
    assert got_out == want_out and len(got_out.splitlines()) == 2
    assert got == want


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import lerf_torch, lerf_torch.pipeline\n"
            "import lerf_torch.cli.upscale, lerf_torch.cli.eval_lut_sr\n"
            "import lerf_torch.cli.eval_lut_warp, lerf_torch.evaluate\n"
            "import lerf_torch.ops.kernels.warp, lerf_torch.ops.interp_kernels\n"
            "import lerf_torch.cli.eval_model, lerf_torch.models.srnet\n"
            "import lerf_torch.models.convert\n"
            "import lerf_torch.ops.kernels.srnet_ensemble\n"
            "import lerf_torch.ops.kernels.srnet_ensemble_int8\n"
            "import lerf_torch.models.imdn, lerf_torch.models.imdn_s2d\n"
            "import lerf_torch.lut.transfer, lerf_torch.cli.transfer\n"
            "import lerf_torch.cli.train, lerf_torch.train.loop\n"
            "import lerf_torch.train.train_step, lerf_torch.train.lutft\n"
            "import lerf_torch.train.checkpoint, lerf_torch.convert\n"
            "import lerf_torch.data.div2k, lerf_torch.data.device_data\n"
            "import lerf_torch.ops.kernels.resize_bwd\n"
            "import lerf_torch.serve, lerf_torch.serve.engine\n"
            "import lerf_torch.serve.httpd, lerf_torch.cli.serve\n"
            "import lerf_torch.cli.make_benchmark, lerf_torch.ops.resample\n"
            "import lerf_torch.parallel, lerf_torch.parallel.mesh\n"
            "import lerf_torch.parallel.spatial\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'lerf_tpu',\n"
            "                                    'optax', 'orbax', 'flax'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_default_device_is_cuda_and_never_falls_back():
    pred = shared_lut_predictor()
    if torch.cuda.is_available():
        assert port_of(pred).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            port_of(pred)


@pytest.mark.parametrize("kwargs", [{"table_layout": "packed8"},
                                    {"mesh": object()}],
                         ids=lambda k: next(iter(k)))
def test_unported_predictor_options_raise(kwargs):
    """Both options are ported now (this test held their "not ported"
    exits and keeps its name).  ``table_layout``: an unknown layout raises
    ``ValueError`` as lerf_tpu's does, and ``"packed8"`` constructs (its
    results: tests/test_torch_packed.py).  ``mesh=``: an object that is no
    mesh raises ``TypeError``, and over ``["cpu"] * 2`` each frame of
    ``upscale_batch`` equals its ``upscale``."""
    if "mesh" not in kwargs:
        with pytest.raises(ValueError, match="unknown table_layout"):
            port_of(shared_lut_predictor(), device="cpu",
                    table_layout="packed16")
        pred = port_of(shared_lut_predictor(), device="cpu", **kwargs)
        assert pred.table_layout == "packed8"
        return
    from lerf_torch.parallel import make_mesh

    with pytest.raises(TypeError, match="Mesh"):
        port_of(shared_lut_predictor(), device="cpu", **kwargs)
    mesh = make_mesh(devices=["cpu"] * 2)
    pred = port_of(shared_lut_predictor(), mesh=mesh)
    imgs = np.stack([image(seed=s) for s in range(4)])
    got = pred.upscale_batch(imgs, 2, 2)
    for b in range(4):
        np.testing.assert_array_equal(got[b], pred.upscale(imgs[b], 2, 2))


@pytest.mark.parametrize("method", ["upscale_dynamic_async",
                                    "warp_dynamic_async",
                                    "warp_device_async"])
def test_unported_serving_forms_raise(method):
    """The async serving forms, ported now (this test held their "not
    ported" exit and keeps its name): on the CPU the future is resolved at
    dispatch, ``result()`` returns the same objects each time, equal to
    the synchronous form's; against lerf_tpu's async form (its
    ``warp_dynamic_async`` for both warp forms, since its ``warp_device``
    runs float32 geometry) the uint8 frame within one step on < 1 % of
    pixels (.5 rounding ties; ``tests/test_torch_async.py`` tells each tie
    from an error) and the mask exactly."""
    from lerf_torch.pipeline import ServingFuture

    jax_pred = shared_lut_predictor()
    port = port_of(jax_pred, device="cpu")
    img = image()
    if method == "upscale_dynamic_async":
        args = (img, 2.0, 2.0)
        want = (port.upscale_dynamic(*args),)
        theirs = (jax_pred.upscale_dynamic_async(*args).result(),)
    else:
        args = (img, np.array([[1.1, 0.02, 3.0], [0.01, 0.95, -2.0],
                               [1e-4, 2e-5, 1.0]]), (24, 30))
        want = port.warp_dynamic(*args)
        theirs = jax_pred.warp_dynamic_async(*args).result()
    fut = getattr(port, method)(*args)
    assert isinstance(fut, ServingFuture)
    got = fut.result()
    assert fut.result() is got
    got = got if isinstance(got, tuple) else (got,)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    d = np.abs(got[0].astype(int) - np.asarray(theirs[0]).astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 0.01
    if len(got) > 1:
        np.testing.assert_array_equal(got[1], np.asarray(theirs[1]))


@pytest.mark.parametrize("linear", [False, True])
def test_bank_output_channels_must_match_the_form(linear):
    """LeRF-L reads one hyper code a pixel (α), LeRF-G three."""
    with pytest.raises(ValueError, match="out_c"):
        port_of(shared_lut_predictor(not linear), device="cpu",
                linear=linear)
