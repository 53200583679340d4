"""The port's CUDA kernels against their plain PyTorch twins.

This file imports neither JAX nor lerf_tpu, so on a machine with a card and
no JAX it runs on its own, without the suite's conftest:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Tests marked ``cuda`` skip without a card.  Tolerances: K2 is int32 and
must be bit-equal; K1 holds atol 1e-3 on 0..255 outputs (the kernel and the
plain twin do the same float32 operations in the same order; their ``exp``
implementations may differ by a few ulp).
"""
import numpy as np
import pytest
import torch

from lerf_torch.lut.io import LUTBank
from lerf_torch.ops import lut_pipeline as lp
from lerf_torch.ops.geometry import ResizeGeometry
from lerf_torch.ops.kernels import lut_stage as k2
from lerf_torch.ops.kernels import resize as k1
from lerf_torch.ops.resample import steering_resize_codes_plain
from lerf_torch.pipeline import LutPredictor

MODES = ("s", "c", "t")
L4 = 17 ** 4
RESIZE_ATOL = 1e-3
# name → (scale, antialias); 0.25 without antialias has negative pads
RESIZE_CASES = {"x2": ((2.0, 2.0), True), "x4": ((4.0, 4.0), True),
                "x1.5x2.0": ((1.5, 2.0), True), "x2.5": ((2.5, 2.5), True),
                "x3.55": ((3.55, 3.55), True), "x0.5-aa": ((0.5, 0.5), True),
                "x0.25-crop": ((0.25, 0.25), False)}
# name → (stage function, split_r, bias, which bank tables)
STAGES = {"stage1": (lp.lut_stage1, False, 0, "stage1"),
          "intermediate": (lp.lut_stage1_intermediate, False, 127, "stage1"),
          "stage2": (lp.lut_stage2, True, 127, "stage2")}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def random_bank(seed=0):
    rng = np.random.RandomState(seed)
    return LUTBank(
        stage1={m: rng.randint(-127, 128, (L4, 1)).astype(np.int8)
                for m in MODES},
        stage2={f"{m}r{r}": rng.randint(-127, 128, (L4, 3)).astype(np.int8)
                for m in MODES for r in (0, 1)},
        out_c=3)


def resize_inputs(shape=(3, 45, 77), seed=3):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randint(0, 256, shape).astype(np.int32)),
            torch.from_numpy(rng.randint(0, 256, shape + (3,))
                             .astype(np.int32)))


def stage_plain(stage, img, tables):
    _, split_r, bias, _ = STAGES[stage]
    den = len(MODES) * (1 if stage == "stage1" else 4) * 16
    out = lp.lut_stage_plain(img, tables, MODES, split_r=split_r, den=den,
                             bias=bias)
    return out if split_r else out[..., 0]


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_lut_stage_wrapper_takes_plain_twin_on_cpu(stage):
    fn, _, _, which = STAGES[stage]
    tables = lp.FlatTables.create(getattr(random_bank(), which))
    img = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (3, 9, 14)).astype(np.int32))
    before = k2.launches
    got = fn(img, tables, MODES)
    assert k2.launches == before
    torch.testing.assert_close(got, stage_plain(stage, img, tables),
                               rtol=0, atol=0)


def test_resize_wrapper_takes_plain_twin_on_cpu():
    feat, codes = resize_inputs((3, 9, 14))
    geom = ResizeGeometry.create((9, 14), scale_factors=[2.5, 2.5])
    before = k1.launches
    got = k1.steering_resize(feat, codes, geom)
    assert k1.launches == before
    torch.testing.assert_close(got, steering_resize_codes_plain(
        feat, codes, geom), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_lut_stage_kernel_matches_plain(stage, cuda_device):
    fn, _, _, which = STAGES[stage]
    tables = lp.FlatTables.create(getattr(random_bank(), which), cuda_device)
    img = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (3, 45, 77)).astype(np.int32)).to(cuda_device)
    before = k2.launches
    got = fn(img, tables, MODES)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    torch.testing.assert_close(got, stage_plain(stage, img, tables),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RESIZE_CASES))
def test_resize_kernel_matches_plain(case, cuda_device):
    scale, aa = RESIZE_CASES[case]
    feat, codes = (t.to(cuda_device) for t in resize_inputs())
    geom = ResizeGeometry.create(feat.shape[1:], scale_factors=list(scale),
                                 antialias=aa)
    before = k1.launches
    got = k1.steering_resize(feat, codes, geom)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    torch.testing.assert_close(got, steering_resize_codes_plain(
        feat, codes, geom), rtol=0, atol=RESIZE_ATOL)


@pytest.mark.cuda
def test_resize_kernel_rejects_mismatched_geometry(cuda_device):
    feat, codes = (t.to(cuda_device) for t in resize_inputs())
    geom = ResizeGeometry.create((46, 77), scale_factors=[2, 2])
    with pytest.raises(ValueError, match="geometry"):
        k1.steering_resize(feat, codes, geom)


@pytest.mark.cuda
def test_upscale_on_card_matches_cpu(cuda_device):
    bank = random_bank()
    img = np.random.RandomState(4).randint(0, 256, (45, 77, 3)) \
        .astype(np.uint8)
    want = LutPredictor(bank, device="cpu").upscale(img, 4, 4,
                                                    return_aux=True)
    before = (k1.launches, k2.launches)
    got = LutPredictor(bank, device=cuda_device).upscale(img, 4, 4,
                                                         return_aux=True)
    assert (k1.launches, k2.launches) == (before[0] + 1, before[1] + 2)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    # a pixel whose float32 value sits at a .5 rounding tie may quantize
    # one step apart; nothing else may differ
    assert np.abs(got[0].astype(int) - want[0].astype(int)).max() <= 1
