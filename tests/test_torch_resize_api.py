"""The port's ResizeRight-style ``resize`` (2-D, by_convs and N-D), the
2-D interpolation kernels, ``cli.make_benchmark``,
``evaluate.format_sr_table``, ``imdn_s2d.predict_imdn2_s2d`` and the
several-input exits of ``cli.upscale``, against lerf_tpu on the CPU.

lerf_tpu's ``tests/test_resize_api.py`` holds its ``resize`` to the
reference's vendored ResizeRight (not in this repository: those cases
skip there); here each of its eight cases holds the port to lerf_tpu on
the same float32 input.  Tolerances: float32 outputs (0..255) within atol
1e-3 (the same host float64 taps, float32 sums; a gather's sum may run in
another order than XLA's); the uint8 frames of ``make_benchmark`` equal
but for .5 rounding ties (within one step on < 1 % of pixels); the 2-D
kernels within 1e-6; ``predict_imdn2_s2d`` within 1e-3 (feature 0..254)
and 1e-5 (hyper maps), as ``test_torch_imdn.py`` holds the towers.
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from lerf_tpu.ops import interp_kernels as jik
from lerf_tpu.ops import resize as jax_resize

from lerf_torch.ops import interp_kernels as tik
from lerf_torch.ops import resize

ATOL = 1e-3


def both(img, **kwargs):
    """(lerf_tpu's, the port's) resize of a float32 numpy array."""
    want = np.asarray(jax_resize(jnp.asarray(img), **kwargs))
    got = resize(torch.from_numpy(img), **kwargs)
    assert got.dtype == torch.float32
    got = got.numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    return want, got


@pytest.mark.parametrize("scale", [0.5, 0.25, 1 / 3, 2.0, 1.7])
@pytest.mark.parametrize("kernel", ["cubic", "linear", "lanczos2"])
def test_resize_matches_resize_right(scale, kernel):
    img = (np.random.RandomState(0).rand(3, 24, 36) * 255).astype(np.float32)
    both(img, scale_factors=[scale, scale], interp_method=kernel)


def test_resize_out_shape_spec():
    img = (np.random.RandomState(1).rand(1, 17, 19) * 255) \
        .astype(np.float32)
    _, got = both(img, out_shape=(40, 23))
    assert got.shape == (1, 40, 23)


@pytest.mark.parametrize("scale", [2.0, 1.5, 0.5, 2.0 / 3.0, 1.25])
@pytest.mark.parametrize("kernel", ["cubic", "linear"])
def test_by_convs_matches_reference(scale, kernel):
    img = np.random.RandomState(3).rand(3, 20, 24).astype(np.float32)
    both(img, scale_factors=scale, interp_method=kernel, by_convs=True)


def test_by_convs_matches_gather_path():
    img = torch.from_numpy(
        np.random.RandomState(4).rand(3, 17, 21).astype(np.float32))
    for scale in [2.0, 1.5, 0.5]:
        a = resize(img, scale_factors=scale, by_convs=True)
        b = resize(img, scale_factors=scale)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-4)


def test_by_convs_nonmultiple_output_size():
    img = np.random.RandomState(6).rand(3, 10, 10).astype(np.float32)
    for scale in [1.25, 1.75, 2.5]:
        _, a = both(img, scale_factors=scale, by_convs=True)
        b = resize(torch.from_numpy(img), scale_factors=scale).numpy()
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)


def test_by_convs_irrational_falls_back():
    img = np.random.RandomState(5).rand(16, 16).astype(np.float32)
    _, a = both(img, scale_factors=[1.2345678, 2.0], by_convs=True)
    b = resize(torch.from_numpy(img), scale_factors=[1.2345678, 2.0])
    np.testing.assert_allclose(a, b.numpy(), rtol=1e-4, atol=5e-3)


@pytest.mark.parametrize("kernel", ["cubic", "linear"])
def test_resize_nd_matches_resize_right(kernel):
    vol = (np.random.RandomState(1).rand(7, 24, 36) * 255) \
        .astype(np.float32)
    both(vol, scale_factors=[0.5, 1.3, 2.0], interp_method=kernel)


def test_resize_nd_out_shape_and_by_convs():
    r = np.random.RandomState(2)
    vol = (r.rand(8, 20, 30) * 255).astype(np.float32)
    both(vol, scale_factors=[0.5, 2.0, 1.5], interp_method="cubic",
         by_convs=True)
    batch = (r.rand(2, 8, 20, 30) * 255).astype(np.float32)
    _, got4 = both(batch, out_shape=[4, 10, 45], interp_method="cubic")
    assert got4.shape == (2, 4, 10, 45)
    both(batch, out_shape=[4, 10, 45], pad_mode="edge")
    for kwargs in ({"out_shape": [2, 4, 10, 45]},
                   {"scale_factors": [1.0, 0.5, 2.0, 1.5]}):
        with pytest.raises(ValueError, match="entries"):
            resize(torch.from_numpy(vol), **kwargs)


def test_kernels_2d_match_jax():
    rng = np.random.RandomState(7)
    x = rng.uniform(-4, 4, 257).astype(np.float32)
    y = rng.uniform(-4, 4, 257).astype(np.float32)
    for name in ("cubic", "linear", "box", "lanczos2", "lanczos3"):
        want = np.asarray(jik.get_kernel2d(name)(jnp.asarray(x),
                                                 jnp.asarray(y)))
        fn = tik.get_kernel2d(name)
        assert fn.support_sz == jik.get_kernel2d(name).support_sz
        got = fn(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                   err_msg=name)
    with pytest.raises(ValueError, match="unknown interpolation kernel"):
        tik.get_kernel2d("nearest")


def test_make_benchmark_matches_jax(tmp_path):
    """The rrLR layout and images: lerf_tpu's ``main`` and the port's on
    the same HR pngs write the same files, equal but for .5 ties."""
    from lerf_tpu.cli.make_benchmark import main as jax_main
    from lerf_tpu.data.benchmarks import SRBenchmark

    from lerf_torch.cli.make_benchmark import (downscale, main,
                                               modcrop_rational)

    hr_dir = tmp_path / "MySet" / "HR"
    os.makedirs(hr_dir)
    rng = np.random.RandomState(0)
    for name in ["a.png", "b.png"]:
        Image.fromarray(rng.randint(0, 256, (24, 32, 3), dtype=np.uint8)) \
            .save(hr_dir / name)
    main(["--hrDir", str(hr_dir), "--scales", "2,1.5x2.0", "--platform",
          "cpu"])
    jax_main(["--hrDir", str(hr_dir), "--scales", "2,1.5x2.0",
              "--outDir", str(tmp_path / "jax"), "--platform", "cpu"])
    bench = SRBenchmark(str(tmp_path), "MySet")
    assert len(bench) == 2
    lr, hr, _ = bench.pair(0, 2, 2)
    assert lr.shape == (12, 16, 3) and hr.shape == (24, 32, 3)
    lr2, _, _ = bench.pair(1, 1.5, 2.0)
    assert lr2.shape == (16, 16, 3)
    for sub in ("rrLR_X2.00_2.00", "rrLR_X1.50_2.00"):
        for name in ["a.png", "b.png"]:
            got = np.array(Image.open(tmp_path / "MySet" / "LR_bicubic"
                                      / sub / name))
            want = np.array(Image.open(tmp_path / "jax" / sub / name))
            d = np.abs(got.astype(int) - want.astype(int))
            assert d.max() <= 1 and (d > 0).mean() < 0.01
    hr = rng.randint(0, 256, (25, 31, 3), dtype=np.uint8)
    assert modcrop_rational(hr, 1.5, 2.0).shape == (24, 30, 3)
    lr = downscale(hr, 2, 2, device="cpu")   # uint8 in: cast to float32
    assert lr.dtype == np.uint8 and lr.shape == (12, 15, 3)
    np.testing.assert_array_equal(
        lr, downscale(hr.astype(np.float32), 2, 2, device="cpu"))
    if not torch.cuda.is_available():        # the card is the default
        with pytest.raises(RuntimeError, match="CUDA device was requested"):
            downscale(hr, 2, 2)


def test_format_sr_table_matches_jax():
    from lerf_tpu.evaluate import format_sr_table as jax_table

    from lerf_torch.evaluate import format_sr_table

    scales = [(2.0, 2.0), (1.5, 2.0)]
    results = {"Set5": {(2.0, 2.0): (35.712, 0.94751),
                        (1.5, 2.0): (36.03, 0.9523)},
               "Set14": {(2.0, 2.0): (31.0, 0.9), (1.5, 2.0): (32.1, 0.91)}}
    assert format_sr_table(results, scales) == jax_table(results, scales)


@pytest.mark.parametrize("block", [1, 2])
def test_predict_imdn2_s2d_matches_jax(block):
    import jax

    from conftest import shared_imdn_predictor
    from lerf_tpu.models import imdn_s2d as js2d

    from lerf_torch.models import imdn_s2d

    variables = jax.tree.map(np.asarray, shared_imdn_predictor().params)
    p2 = js2d.convert_imdn2(variables, block)
    x = np.random.RandomState(8).rand(1, 11, 13, 3).astype(np.float32)
    for stage, atol in ((1, 1e-3), (2, 1e-5)):
        want = np.asarray(js2d.predict_imdn2_s2d(p2, jnp.asarray(x), stage,
                                                 block=block))
        got = imdn_s2d.predict_imdn2_s2d(
            imdn_s2d.convert_imdn2(variables, block), torch.from_numpy(x),
            stage, block=block).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_upscale_cli_several_inputs_exits(tmp_path):
    """lerf_tpu's exit messages: several inputs need a serving form, an
    output directory, and at least one match."""
    from test_torch_serving_engine import bank_dir

    from lerf_torch.cli import upscale as up

    exp = bank_dir(tmp_path)
    src = tmp_path / "frames"
    src.mkdir()
    for i in range(2):
        Image.fromarray(np.zeros((6, 7, 3), np.uint8)).save(src / f"{i}.png")
    base = ["-e", str(exp), "--scale", "2", "--platform", "cpu"]
    with pytest.raises(SystemExit, match="--dynamicSR"):
        up.main(base + ["--input", str(src), "--output", str(tmp_path / "o")])
    with pytest.raises(SystemExit, match="directory"):
        up.main(base + ["--input", str(src), "--output",
                        str(tmp_path / "o.png"), "--dynamicSR"])
    with pytest.raises(SystemExit, match="no inputs match"):
        up.main(base + ["--input", str(src / "*.jpg"), "--output",
                        str(tmp_path / "o"), "--dynamicSR"])
