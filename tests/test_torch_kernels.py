"""The port's CUDA kernels against their plain PyTorch twins.

This file imports neither JAX nor lerf_tpu, so on a machine with a card and
no JAX it runs on its own, without the suite's conftest:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Tests marked ``cuda`` skip without a card.  Tolerances: K2 is int32 and
must be bit-equal; K1 holds atol 1e-3 on 0..255 outputs (the kernel and the
plain twin do the same float32 operations in the same order; their ``exp``
implementations may differ by a few ulp).  K3 sums the same float32
products in another order, which can move a member's ``round(tanh·127)`` at
a .5 edge: sums within 2 on < 0.5 % of pixels.  K4's hidden int8
arithmetic is bit-equal to its twin by construction and only ``tanhf`` may
differ by an ulp: sums within 1 on < 0.1 %.
"""
import numpy as np
import pytest
import torch

from lerf_torch.convert import lerf_nets_from_arrays
from lerf_torch.lut.io import LUTBank
from lerf_torch.models import srnet
from lerf_torch.ops import lut_pipeline as lp
from lerf_torch.ops.geometry import ResizeGeometry
from lerf_torch.ops.kernels import lut_stage as k2
from lerf_torch.ops.kernels import resize as k1
from lerf_torch.ops.kernels import srnet_ensemble as k3
from lerf_torch.ops.kernels import srnet_ensemble_int8 as k4
from lerf_torch.ops.resample import steering_resize_codes_plain
from lerf_torch.pipeline import LutPredictor, NetPredictor, _quantize_device

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
NET_MEMBERS = srnet.stage_members(MODES)
# name → (nf, oC): the micro-net ensembles K3 / K4 are checked at
NET_CASES = {"nf8-oc1": (8, 1), "nf64-oc1": (64, 1), "nf64-oc3": (64, 3)}


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


def net_params(nf=8, seed=0):
    """Port params from numpy: Kaiming-normal weights, small non-zero
    biases (so the bias paths count)."""
    rng = np.random.RandomState(seed)

    def head(oc):
        fans = [4] + [k * nf for k in range(1, 5)] + [5 * nf]
        p = {}
        for k, (fan_in, out) in enumerate(zip(fans, [nf] * 5 + [oc]), 1):
            p[f"w{k}"] = (rng.randn(fan_in, out) * np.sqrt(2.0 / fan_in)) \
                .astype(np.float32)
            p[f"b{k}"] = (rng.randn(out) * 0.1).astype(np.float32)
        return p

    return lerf_nets_from_arrays(
        {"s1": {f"s1_{m}": head(1) for m in MODES},
         "s2": {f"{m}r{r}": head(3) for m in MODES for r in (0, 1)}})


def net_heads(params, oc):
    """The member-aligned heads of stage 1 (oC 1) or stage 2 (oC 3)."""
    if oc == 1:
        return srnet.stage1_heads(params, 0, MODES)
    return srnet.stage2_heads(params, MODES)


def assert_levels_close(want, got, max_diff, share):
    d = (want.double() - got.double()).abs().cpu()
    assert float(d.max()) <= max_diff, float(d.max())
    assert float((d > 0).double().mean()) < share


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


@pytest.mark.parametrize("oc", [1, 3])
def test_srnet_ensemble_wrapper_takes_plain_twin_on_cpu(oc):
    heads = k3.StackedHeads.create(net_heads(net_params(), oc))
    img = torch.from_numpy(np.random.RandomState(2).rand(2, 7, 10)
                           .astype(np.float32))
    before = k3.launches
    got = k3.ensemble_sum(img, heads, NET_MEMBERS, half=127)
    assert k3.launches == before
    assert got.shape == (2, 7, 10, oc)
    torch.testing.assert_close(got, k3.ensemble_sum_plain(
        img, heads, NET_MEMBERS, half=127), rtol=0, atol=0)


@pytest.mark.parametrize("oc", [1, 3])
def test_srnet_ensemble_int8_wrapper_takes_plain_twin_on_cpu(oc):
    qp = srnet.quantize_lerf_params(net_params())
    heads = k4.QuantHeads.create(net_heads(qp, oc))
    codes = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (2, 7, 10)).astype(np.int32))
    before = k4.launches
    got = k4.ensemble_sum_int8(codes, heads, NET_MEMBERS, half=127)
    assert k4.launches == before
    assert got.shape == (2, 7, 10, oc)
    torch.testing.assert_close(got, k4.ensemble_sum_int8_plain(
        codes, heads, NET_MEMBERS, half=127), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(NET_CASES))
def test_srnet_ensemble_kernel_matches_plain(case, cuda_device):
    nf, oc = NET_CASES[case]
    heads = k3.StackedHeads.create(net_heads(net_params(nf), oc), cuda_device)
    img = torch.from_numpy(np.random.RandomState(5).rand(3, 45, 77)
                           .astype(np.float32)).to(cuda_device)
    before = k3.launches
    got = k3.ensemble_sum(img, heads, NET_MEMBERS, half=127)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    want = k3.ensemble_sum_plain(img, heads, NET_MEMBERS, half=127)
    assert got.shape == want.shape == (3, 45, 77, oc)
    assert_levels_close(want, got, 2, 0.005)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(NET_CASES))
def test_srnet_ensemble_int8_kernel_matches_plain(case, cuda_device):
    nf, oc = NET_CASES[case]
    qp = srnet.quantize_lerf_params(net_params(nf))
    heads = k4.QuantHeads.create(net_heads(qp, oc), cuda_device)
    codes = torch.from_numpy(np.random.RandomState(5).randint(
        0, 256, (3, 45, 77)).astype(np.int32)).to(cuda_device)
    before = k4.launches
    got = k4.ensemble_sum_int8(codes, heads, NET_MEMBERS, half=127)
    torch.cuda.synchronize()
    assert k4.launches == before + 1
    want = k4.ensemble_sum_int8_plain(codes, heads, NET_MEMBERS, half=127)
    assert got.shape == want.shape == (3, 45, 77, oc)
    assert_levels_close(want, got, 1, 0.001)


@pytest.mark.cuda
def test_srnet_kernels_reject_bad_inputs(cuda_device):
    params = net_params()
    heads = k3.StackedHeads.create(net_heads(params, 3), cuda_device)
    img = torch.rand(3, 9, 11, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        k3.ensemble_sum(img.double(), heads, NET_MEMBERS, half=127)
    with pytest.raises(ValueError, match="heads"):
        k3.ensemble_sum(img, k3.StackedHeads.create(net_heads(params, 3)),
                        NET_MEMBERS, half=127)
    qheads = k4.QuantHeads.create(
        net_heads(srnet.quantize_lerf_params(params), 3), cuda_device)
    with pytest.raises(ValueError, match="int32"):
        k4.ensemble_sum_int8((img * 255).to(torch.int64), qheads,
                             NET_MEMBERS, half=127)
    with pytest.raises(ValueError, match="QuantHeads"):
        k4.ensemble_sum_int8((img * 255).to(torch.int32), qheads,
                             NET_MEMBERS[:6], half=127)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["auto", "pallas_int8"])
def test_net_upscale_on_card_matches_cpu(backend, cuda_device):
    params = net_params(nf=64)
    img = np.random.RandomState(6).randint(0, 256, (40, 56, 3)) \
        .astype(np.uint8)
    want = NetPredictor.from_srnets(params, backend=backend,
                                    device="cpu").upscale(
        img, 4, 4, return_aux=True)
    kern = k4 if backend == "pallas_int8" else k3
    before = (k1.launches, kern.launches)
    got = NetPredictor.from_srnets(params, backend=backend,
                                   device=cuda_device).upscale(
        img, 4, 4, return_aux=True)
    assert (k1.launches, kern.launches) == (before[0] + 1, before[1] + 2)
    share = 0.001 if backend == "pallas_int8" else 0.005
    assert_levels_close(torch.from_numpy(want[1]), torch.from_numpy(got[1]),
                        1, share)
    codes = torch.from_numpy(np.round(got[2] * 255).astype(np.int32))
    assert_levels_close(torch.from_numpy(np.round(want[2] * 255)), codes,
                        1, share)
    # the card's uint8 against the plain resize of the card's own stages:
    # only a .5 rounding tie may quantize one step apart
    geom = ResizeGeometry.create(img.shape[:2], scale_factors=[4, 4])
    plain = _quantize_device(steering_resize_codes_plain(
        torch.from_numpy(got[1].astype(np.int32)), codes, geom), 255)
    diff = np.abs(plain.numpy().transpose(1, 2, 0).astype(int)
                  - got[0].astype(int))
    assert diff.max() <= 1


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
