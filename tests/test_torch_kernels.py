"""The port's CUDA kernels against their plain PyTorch twins.

This file imports neither JAX nor lerf_tpu, so on a machine with a card and
no JAX it runs on its own, without the suite's conftest:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Tests marked ``cuda`` skip without a card.  Tolerances: K2 is int32 and
must be bit-equal; K1 holds atol 1e-3 on 0..255 outputs (the kernel and the
plain twin do the same float32 operations in the same order; their ``exp``
implementations may differ by a few ulp).  K3 sums the same float32
products in another order, which can move a member's ``round(tanh·127)`` at
a .5 edge (its 3xTF32 products carry ~2⁻²² relative error, float32's
own): sums within 2 on < 0.5 % of pixels; its bf16 kernel (bf16 heads,
``wgmma``) holds its bf16 twin within the same bound (an activation on a
bf16 rounding edge may round either way under another float32 summation
order), gives the same bits on a second launch, and takes a last tile
that is part empty and 1-3 pixels; both types and K4 also
at nf 96 and 128.  K2's row mode
(lerf_tpu's packed8, packed32 and cells layouts) is bit-equal to flat K2
and to its twin.  K4's hidden int8
arithmetic is bit-equal to its twin by construction and only ``tanhf`` may
differ by an ulp: sums within 1 on < 0.1 %.  K5 holds atol 1e-3 with the
same NaN pattern as its twin (the same float32 operations in the same
order; a window whose four weights all fall below 2^-126 is 0/0 on both),
and its uint8 mode equals its float mode with NaN → 0, quantized; the
geometry K5 derives on the card from the matrix is bit-equal to the
host's (the same float64 operations, one at a time).  The amplified-linear
(LeRF-L) modes of K1 and K5 hold atol 1e-3 against their twins too (no
``exp``: bit-equal as built), K5 at any support, its branch masks equal to
the host's; the SR serving forms on the card are bit-equal to ``upscale``
on the card.  K5's validity mask (written in its own launch, or alone) is
equal to the host's float64 mask; its batch of homographies is bit-equal
to each frame's own call, and the warp serving forms on the card to
``warp`` on the card.  The float modes of K1 and K5 (float32 feature and
hyper maps in [0, 1], the IMDN form's) hold the same tolerances against
lerf_tpu's float ops (``steering_gaussian_resize``, ``steering_gaussian_
warp(u8_inputs=False)`` and their linear and rings forms), with the same
NaN pattern; the IMDN form on the card holds its feature within 1e-3 and
its hyper maps within 1e-5 of the CPU's (cuDNN sums the towers in another
order) and its frames within one level on ≤ 0.1 % of pixels, and its
serving forms are bit-equal to its ``upscale`` / ``warp`` frame by frame.
K1's and K5's bf16 instances (the bf16 IMDN form's) hold their twins, the
plain ops on the same bf16 tensors on the card, within ``BF16_ULPS`` bf16
ulps (the linear modes, float32 after their bf16 steps, within 1e-3), and
a float32 feature with bf16 maps within 1e-3; the bf16 form launches the
bf16 instance once a call and its serving forms are bit-equal to its
frames.  Each native bf16 step those instances run gives the twin's
float32 operation rounded to bf16 over all 2^32 operand pairs
(``lerf_torch/tools/bf16_steps_exhaustive.cu``).
K6 (the training resize's backward) sums each gradient term in a fixed
order, its twin with ``index_add`` (atomics on the card): within 1e-4 of
each gradient's largest value, and a rerun gives the same bits; the
training step on the card holds the CPU's within the tolerances its test
states.  The async serving forms (uint8 staged through pinned memory,
cast on the card, on the predictor's side stream) are bit-equal to the
host-staged path and to their synchronous forms, with requests in
flight, with cache entries evicted under them and from two threads; each
request's spans nest as ``lerf_torch.utils.spans`` lists them, on the
host's track alone.
"""
import math

import numpy as np
import pytest
import torch

from lerf_torch.convert import lerf_nets_from_arrays
from lerf_torch.lut.io import LUTBank
from lerf_torch.models import srnet
from lerf_torch.ops import lut_pipeline as lp
from lerf_torch.ops.geometry import (ResizeGeometry, ResizeOperands,
                                     WarpGeometry, WarpOperands)
from lerf_torch.ops.kernels import lut_stage as k2
from lerf_torch.ops.kernels import resize as k1
from lerf_torch.ops.kernels import srnet_ensemble as k3
from lerf_torch.ops.kernels import srnet_ensemble_int8 as k4
from lerf_torch.ops.kernels import warp as k5
from lerf_torch.ops.resample import (WarpRings, amplified_linear_resize,
                                     amplified_linear_resize_rings,
                                     amplified_linear_warp,
                                     linear_resize_codes_plain,
                                     linear_warp_codes_plain,
                                     nearest_warp_mask_on_device,
                                     quantize_device, resize_rings,
                                     steering_gaussian_resize,
                                     steering_gaussian_resize_rings,
                                     steering_gaussian_warp,
                                     steering_gaussian_warp_rings,
                                     steering_resize_codes_plain,
                                     steering_warp_codes_plain, warp_rings,
                                     warp_rings_on_device,
                                     warp_serving_host_fused)
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
# name → (nf, oC, image shape, members): the micro-net ensembles K3 / K4
# are checked at; they tile 64-256 pixels, so 3×45×77 and 1×13×23 end in
# a ragged tile; nf 8 and 12 pad K4's fan-ins to 32 and the kernels'
# features to 16; 20 members is MAX_MEMBERS
NET_CASES = {"nf8-oc1": (8, 1, (3, 45, 77), 12),
             "nf64-oc1": (64, 1, (3, 45, 77), 12),
             "nf64-oc3": (64, 3, (3, 45, 77), 12),
             "nf8-oc3-m5": (8, 3, (2, 30, 41), 5),
             "nf12-oc1-m20": (12, 1, (2, 30, 41), 20),
             "nf64-oc3-m20-ragged": (64, 3, (1, 13, 23), 20),
             "nf96-oc3": (96, 3, (3, 45, 77), 12),
             "nf128-oc1": (128, 1, (3, 45, 77), 12),
             "nf128-oc3-m20-ragged": (128, 3, (1, 13, 23), 20)}
WARP_ATOL = 1e-3


def jitter_matrix(seed, zoom):
    """``diag(zoom) @ (I + randn · [[.05,.05,4],[.05,.05,4],[1e-4,1e-4,0]])``,
    the projective jitter of bench.py under a zoom (x, y order)."""
    rng = np.random.RandomState(seed)
    scale = np.array([[.05, .05, 4], [.05, .05, 4], [1e-4, 1e-4, 0]])
    return np.diag([zoom[1], zoom[0], 1.0]) @ (np.eye(3)
                                               + rng.randn(3, 3) * scale)


def rotation_matrix(theta, zoom, shift):
    """A rotation by ``theta`` under a zoom, then a shift (x, y order)."""
    c, s = np.cos(theta) * zoom, np.sin(theta) * zoom
    return np.array([[c, -s, shift[0]], [s, c, shift[1]], [0.0, 0.0, 1.0]])


# name → (matrix, feature shape [C, H, W], output size): the warps K5 and
# its on-card geometry are checked at.  "border" sends every output past
# the image's far corner, so every distance is 2 and random codes leave NaN
# windows.  "main" is the main path's homography (the ×4 zoom under the
# projective jitter, seed 0), "zoom2.5" and "pad1" (output (0, 0) above and
# left of the image: pad0 = 1 on both axes) its other full-frame checks;
# "minify16" is a 1/16 minification, whose blocks' footprints exceed the
# shared-memory tile, so K5 takes its direct path there; "rotation" mixes
# blocks of both paths in one launch.
WARP_CASES = {
    "1x1x1": (np.diag([2.0, 2.0, 1.0]), (1, 1, 1), (3, 4)),
    "1x1-13x17": (np.diag([2.0, 2.0, 1.0]), (1, 1, 1), (13, 17)),
    "3x7x9": (jitter_matrix(0, (1.9, 1.9)), (3, 7, 9), (13, 17)),
    "border": (np.array([[1.0, 0.0, -100.0], [0.0, 1.0, -100.0],
                         [0.0, 0.0, 1.0]]), (3, 7, 9), (13, 17)),
    "x2.5-wide": (np.diag([2.5, 2.5, 1.0]), (3, 45, 77), (112, 192)),
    "identity": (np.eye(3), (3, 45, 77), (45, 77)),
    "rotation": (rotation_matrix(0.6, 1.0, (20.0, -6.0)), (3, 40, 56),
                 (60, 84)),
    "minify16": (np.diag([1 / 16, 1 / 16, 1.0]), (3, 320, 640), (20, 40)),
    "main": (jitter_matrix(0, (4.0, 4.0)), (3, 360, 640), (1440, 2560)),
    "zoom2.5": (np.diag([2.5, 2.5, 1.0]), (3, 360, 640), (900, 1600)),
    "pad1": (np.array([[3.6, 0.1, 12.0], [0.05, 3.7, 10.0],
                       [1e-5, 2e-5, 1.0]]), (3, 360, 640), (1440, 2560)),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def random_bank(seed=0, out_c=3):
    """A random bank: LeRF-G's stage 2 gives three codes, LeRF-L's
    (``out_c=1``) one."""
    rng = np.random.RandomState(seed)
    return LUTBank(
        stage1={m: rng.randint(-127, 128, (L4, 1)).astype(np.int8)
                for m in MODES},
        stage2={f"{m}r{r}": rng.randint(-127, 128, (L4, out_c))
                .astype(np.int8) for m in MODES for r in (0, 1)},
        out_c=out_c)


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


def member_case(nf, oc, n_members, seed=0):
    """``n_members`` members over the three modes (mode-major, modes
    repeating past 12), each with its own numpy-drawn head."""
    rng = np.random.RandomState(seed)
    fans = [4] + [k * nf for k in range(1, 5)] + [5 * nf]
    heads = []
    for _ in range(n_members):
        p = {}
        for k, (fan_in, out) in enumerate(zip(fans, [nf] * 5 + [oc]), 1):
            p[f"w{k}"] = (rng.randn(fan_in, out) * np.sqrt(2.0 / fan_in)) \
                .astype(np.float32)
            p[f"b{k}"] = (rng.randn(out) * 0.1).astype(np.float32)
        heads.append(p)
    members = [(MODES[(i // 4) % len(MODES)], i % 4)
               for i in range(n_members)]
    return heads, members


def quantize_heads(heads, seed=0):
    calib = np.random.RandomState(seed).rand(512, 4).astype(np.float32)
    return [k4.quantize_srunit_head(h, calib) for h in heads]


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


@pytest.mark.parametrize("case", sorted(RESIZE_CASES))
def test_resize_uint8_mode_on_cpu_is_the_quantized_twin(case):
    scale, aa = RESIZE_CASES[case]
    feat, codes = resize_inputs()
    geom = ResizeGeometry.create(feat.shape[1:], scale_factors=list(scale),
                                 antialias=aa)
    before = k1.launches
    got = k1.steering_resize(feat, codes, geom, out_dtype=torch.uint8)
    assert k1.launches == before
    assert got.dtype == torch.uint8
    assert torch.equal(got, _quantize_device(
        steering_resize_codes_plain(feat, codes, geom), 255))


def test_resize_uint8_mode_needs_norm_up_to_255():
    feat, codes = resize_inputs((3, 9, 14))
    geom = ResizeGeometry.create((9, 14), scale_factors=[2, 2])
    with pytest.raises(ValueError, match="norm"):
        k1.steering_resize(feat, codes, geom, norm=1023,
                           out_dtype=torch.uint8)
    with pytest.raises(ValueError, match="out_dtype"):
        k1.steering_resize(feat, codes, geom, out_dtype=torch.float16)


# K1's tile choice at the test geometries, the main path's, a deep
# antialiased downscale whose window only a one-output tile holds, and
# deeper ones (S 122 and 128) whose window the kernel walks in strips of rows
TILE_CASES = {**{name: ((45, 77),) + case
                 for name, case in RESIZE_CASES.items()},
              "main-x4": ((360, 640), (4.0, 4.0), True),
              "x1/32-aa": ((360, 640), (1 / 32, 1 / 32), True),
              "x1/61-aa": ((360, 640), (1 / 61, 1 / 61), True),
              "x1/64-aa": ((300, 200), (1 / 64, 1 / 64), True)}
# (input shape, scale) of deep antialiased downscales: S = 128
DEEP_AA = ((3, 300, 200), 1 / 64)


@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_resize_tile_window_holds_every_tile(case):
    in_sz, scale, aa = TILE_CASES[case]
    geom = ResizeGeometry.create(in_sz, scale_factors=list(scale),
                                 antialias=aa)
    rows = geom.fov_x.astype(np.int64) - geom.pad_x[0]
    cols = geom.fov_y.astype(np.int64) - geom.pad_y[0]
    th, tw, wr, wc = k1.pick_tile(rows, cols)
    assert th * -(-tw // 4) <= 256
    assert wr * wc * k1.WINDOW_BYTES <= k1.BLOCK_SMEM_MAX
    # every tile's source columns lie in a window of that width, and its
    # rows in one of that height unless the kernel walks them in strips
    tallest = k1._window_span(rows, th)
    assert wr == tallest or (wr < tallest and geom.support >= 122)
    for start in range(0, cols.shape[0], tw):
        part = cols[start:start + tw]
        assert part.max() - part[0, 0] + 1 <= wc
    if case == "main-x4":
        assert (th, tw) == (16, 32)


def test_resize_operands_pick_a_tile_only_for_a_card():
    geom = ResizeGeometry.create(DEEP_AA[0][1:], scale_factors=[DEEP_AA[1]] * 2)
    assert k1.ResizeOperands.create(geom, "cpu").tile is None


def test_resize_on_cpu_at_a_deep_antialiased_downscale():
    shape, scale = DEEP_AA
    bank = random_bank()
    img = torch.from_numpy(np.random.RandomState(5).randint(
        0, 256, shape).astype(np.int32))
    before = (k1.launches, k2.launches)
    out, feat, hyper = LutPredictor(bank, device="cpu").run_device(
        img, (scale, scale))
    assert (k1.launches, k2.launches) == before
    geom = ResizeGeometry.create(shape[1:], scale_factors=[scale] * 2)
    assert geom.support == 128 and out.shape == (3,) + tuple(geom.out_sz)
    assert torch.equal(out, _quantize_device(
        steering_resize_codes_plain(feat, hyper, geom), 255))


def test_run_device_writes_uint8_on_cpu():
    bank = random_bank()
    img = torch.from_numpy(np.random.RandomState(4).randint(
        0, 256, (3, 9, 14)).astype(np.int32))
    pred = LutPredictor(bank, device="cpu")
    out, feat, hyper = pred.run_device(img, (2.5, 2.5))
    geom = ResizeGeometry.create((9, 14), scale_factors=[2.5, 2.5])
    assert out.dtype == torch.uint8
    assert torch.equal(out, _quantize_device(
        steering_resize_codes_plain(feat, hyper, geom), 255))


def test_padded_tables_round_trip_to_the_flat_table():
    tables = lp.FlatTables.create(random_bank().stage2)
    k, l4, oc = tables.table.shape
    assert tables.cells is None
    assert tables.padded.shape == (k, l4, 4)
    assert tables.padded.dtype == torch.int8
    assert tables.padded.is_contiguous()
    assert torch.equal(tables.padded[..., :oc], tables.table)
    assert not bool(tables.padded[..., oc:].any())


@pytest.mark.parametrize("lat", [17, 5])
def test_cell_rows_hold_each_cells_16_corners(lat):
    rng = np.random.RandomState(lat)
    luts = {m: rng.randint(-127, 128, (lat ** 4, 1)).astype(np.int8)
            for m in MODES}
    tables = lp.FlatTables.create(luts)
    k = len(MODES)
    assert tables.padded is None
    cells = tables.cells
    assert cells.shape == (k, (lat - 1) ** 4, 16) and cells.is_contiguous()
    # every corner of every cell, from the flat table by its 4D index
    n = lat - 1
    abcd = np.stack(np.unravel_index(np.arange(n ** 4), (n,) * 4), -1)
    bits = (np.arange(16)[:, None] >> np.arange(3, -1, -1)) & 1   # a..d
    corner = abcd[:, None, :] + bits[None, :, :]
    flat = np.ravel_multi_index(tuple(np.moveaxis(corner, -1, 0)),
                                (lat,) * 4)
    want = tables.table[:, :, 0].numpy()[:, flat]
    np.testing.assert_array_equal(cells.numpy(), want)


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


def split_weights(seed=7):
    """float32 weights over many binades, with both signs, zeros and values
    that sit at a TF32 rounding tie."""
    rng = np.random.RandomState(seed)
    w = (rng.randn(4096) * np.exp2(rng.randint(-30, 20, 4096))) \
        .astype(np.float32)
    ties = (rng.randint(1 << 10, 1 << 11, 64) * 2 + 1).astype(np.float32) \
        * np.float32(2.0 ** -11)         # 12 significant bits, odd last
    return torch.from_numpy(np.concatenate([w, ties, -ties, [0.0, -0.0]])
                            .astype(np.float32))


def test_tf32_split_hi_and_lo_have_low_13_mantissa_bits_zero():
    hi, lo = k3.tf32_split(split_weights())
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0


def test_tf32_split_sums_to_the_weight():
    w = split_weights()
    hi, lo = k3.tf32_split(w)
    err = (hi.double() + lo.double() - w.double()).abs()
    assert bool((err <= w.double().abs() * 2.0 ** -22).all())
    # hi is the nearest TF32 value (ties away from zero): |w - hi| is at
    # most half a TF32 step of w
    step = torch.frexp(w.double())[1].double().sub(11).exp2()
    assert bool(((w.double() - hi.double()).abs() <= step / 2).all())


def unpack_tf32_frags(frags, layer, nf, fan_in, out):
    """Invert :func:`k3.tf32_frags`: the ``[M, in, out]`` hi and lo and the
    zero padding left over."""
    m, ks, nts = frags.shape[:3]
    dense = frags.reshape(m, ks, nts, 8, 4, 2, 2) \
        .permute(5, 0, 1, 4, 6, 2, 3).reshape(2, m, ks * 8, nts * 8)
    return unpad(dense, layer, nf, -(-nf // 16) * 16, fan_in, out)


def unpack_int8_frags(frags, layer, nf, fan_in, out):
    """Invert :func:`k4.int8_frags`: ``[M, in, out]`` and the padding."""
    m, ks, nts = frags.shape[:3]
    dense = frags.reshape(m, ks, nts, 8, 4, 2, 4) \
        .permute(0, 1, 5, 4, 6, 2, 3).reshape(1, m, ks * 32, nts * 8)
    return unpad(dense, layer, nf, -(-nf // 16) * 16, fan_in, out)


def unpad(dense, layer, nf, nfp, fan_in, out):
    rows = (list(range(fan_in)) if layer == 0 else
            [s * nfp + j for s in range(layer) for j in range(nf)])
    keep = torch.zeros(dense.shape[2:], dtype=torch.bool)
    keep[torch.tensor(rows)[:, None], torch.arange(out)] = True
    return dense[:, :, rows][..., :out], dense[:, :, ~keep]


@pytest.mark.parametrize("nf,oc", [(8, 1), (12, 3), (64, 3)])
def test_k3_fragments_round_trip_to_the_params(nf, oc):
    heads, _ = member_case(nf, oc, 3, seed=4)
    sh = k3.StackedHeads.create(heads)
    for layer, (w, f) in enumerate(zip(sh.w, sh.frags)):
        assert f.shape[-2:] == (32, 4) and f.is_contiguous()
        (hi, lo), pad = unpack_tf32_frags(f, layer, nf, *w.shape[1:])
        want_hi, want_lo = k3.tf32_split(w)
        assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
        assert not bool(pad.any())


@pytest.mark.parametrize("nf,oc", [(8, 1), (12, 3), (64, 3)])
def test_k4_fragments_round_trip_to_the_params(nf, oc):
    heads, _ = member_case(nf, oc, 3, seed=4)
    qh = k4.QuantHeads.create(quantize_heads(heads))
    for layer, (w, f) in enumerate(zip(qh.w, qh.frags)):
        assert f.dtype == torch.int8 and f.shape[-2:] == (32, 8)
        (got,), pad = unpack_int8_frags(f, layer, nf, w.shape[2], w.shape[1])
        assert torch.equal(got, w.transpose(1, 2))
        assert not bool(pad.any())


@pytest.mark.parametrize("kernel", ["float", "int8"])
def test_plain_member_sum_is_order_free(kernel):
    """Permuting the members together with their heads leaves every sum
    bit-identical: each term is an integer below 2²⁴, so float32 adds them
    exactly in any order (what lets a kernel split the members)."""
    heads, members = member_case(8, 3, 12, seed=9)
    perm = np.random.RandomState(3).permutation(len(members))
    rng = np.random.RandomState(8)
    if kernel == "float":
        make, fn = k3.StackedHeads.create, k3.ensemble_sum_plain
        img = torch.from_numpy(rng.rand(2, 9, 13).astype(np.float32))
    else:
        heads = quantize_heads(heads)
        make, fn = k4.QuantHeads.create, k4.ensemble_sum_int8_plain
        img = torch.from_numpy(rng.randint(0, 256, (2, 9, 13))
                               .astype(np.int32))
    got = fn(img, make([heads[i] for i in perm]),
             [members[i] for i in perm], half=127)
    want = fn(img, make(heads), members, half=127)
    assert torch.equal(got, want)


def test_plain_twin_leaves_the_tf32_flag_as_it_was():
    heads = k3.StackedHeads.create(net_heads(net_params(), 1))
    img = torch.zeros(1, 4, 5)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            k3.ensemble_sum_plain(img, heads, NET_MEMBERS, half=127)
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(NET_CASES))
def test_srnet_ensemble_kernel_matches_plain(case, cuda_device):
    nf, oc, shape, n_members = NET_CASES[case]
    heads, members = member_case(nf, oc, n_members)
    heads = k3.StackedHeads.create(heads, cuda_device)
    img = torch.from_numpy(np.random.RandomState(5).rand(*shape)
                           .astype(np.float32)).to(cuda_device)
    before = k3.launches
    got = k3.ensemble_sum(img, heads, members, half=127)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    want = k3.ensemble_sum_plain(img, heads, members, half=127)
    assert got.shape == want.shape == shape + (oc,)
    assert_levels_close(want, got, 2, 0.005)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(NET_CASES))
def test_srnet_ensemble_int8_kernel_matches_plain(case, cuda_device):
    nf, oc, shape, n_members = NET_CASES[case]
    heads, members = member_case(nf, oc, n_members)
    heads = k4.QuantHeads.create(quantize_heads(heads), cuda_device)
    codes = torch.from_numpy(np.random.RandomState(5).randint(
        0, 256, shape).astype(np.int32)).to(cuda_device)
    before = k4.launches
    got = k4.ensemble_sum_int8(codes, heads, members, half=127)
    torch.cuda.synchronize()
    assert k4.launches == before + 1
    want = k4.ensemble_sum_int8_plain(codes, heads, members, half=127)
    assert got.shape == want.shape == shape + (oc,)
    assert_levels_close(want, got, 1, 0.001)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(NET_CASES))
def test_srnet_ensemble_bf16_kernel_matches_plain(case, cuda_device):
    """bf16 heads run K3's bf16 kernel (one launch of its entry,
    ``lerf_srnet_ensemble_bf16``) and hold its twin within K3's bound (an
    activation on a bf16 rounding edge may round either way under another
    float32 summation order); a second launch gives the same bits."""
    nf, oc, shape, n_members = NET_CASES[case]
    bf16_case(nf, oc, shape, n_members, cuda_device)


def bf16_case(nf, oc, shape, n_members, device):
    heads, members = member_case(nf, oc, n_members)
    heads = k3.StackedHeads.create(
        [{k: torch.from_numpy(v).to(torch.bfloat16) for k, v in h.items()}
         for h in heads], device)
    assert heads.dtype == torch.bfloat16
    img = torch.from_numpy(np.random.RandomState(5).rand(*shape)
                           .astype(np.float32)).to(device)
    before = (k3.launches, k3.bf16_launches)
    got = k3.ensemble_sum(img, heads, members, half=127)
    torch.cuda.synchronize()
    assert (k3.launches, k3.bf16_launches) == (before[0] + 1, before[1] + 1)
    want = k3.ensemble_sum_plain(img, heads, members, half=127)
    assert got.shape == want.shape == shape + (oc,)
    assert_levels_close(want, got, 2, 0.005)
    assert torch.equal(got, k3.ensemble_sum(img, heads, members, half=127))


# name → (nf, oC, image shape, members): K3 bf16 at the edges of its grid.
# It tiles 256 pixels up to nf 64 and 128 above: 760 and 380 pixels make 3
# tiles, the last part empty (in each swizzle: nf 64 and 128 the 128-byte,
# nf 32 the 64-byte, nf 48 the 32-byte); then 1-3 pixels.
BF16_EDGE_CASES = {"nf64-oc3-odd-tiles": (64, 3, (1, 20, 38), 12),
                   "nf128-oc1-odd-tiles": (128, 1, (1, 10, 38), 12),
                   "nf32-oc1-odd-tiles": (32, 1, (2, 10, 38), 7),
                   "nf48-oc1-odd-tiles": (48, 1, (1, 20, 38), 12),
                   "nf8-oc1-1px": (8, 1, (1, 1, 1), 12),
                   "nf64-oc3-2px-m5": (64, 3, (1, 1, 2), 5),
                   "nf96-oc3-3px-m20": (96, 3, (3, 1, 1), 20)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BF16_EDGE_CASES))
def test_srnet_ensemble_bf16_kernel_grid_edges(case, cuda_device):
    """A last tile that is part empty, and 1-3 pixels: the same checks as
    every NET_CASES entry."""
    bf16_case(*BF16_EDGE_CASES[case], cuda_device)


# frames for K2's row mode: ragged against its 16 × 32 tile, one pixel,
# one row band, and narrower than one tile
ROWS_SHAPES = [(3, 45, 77), (1, 1, 1), (3, 3, 200), (2, 17, 33), (1, 40, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ROWS_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("layout", ["packed8", "packed32", "cells"])
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_lut_rows_kernel_matches_flat(stage, layout, shape, cuda_device):
    """K2's row mode on lerf_tpu's other layouts: bit-equal to flat K2
    and to the twin on the same layout."""
    fn, split_r, _, which = STAGES[stage]
    luts = getattr(random_bank(), which)
    flat = lp.FlatTables.create(luts, cuda_device)
    tables = lp.stage_tables(luts, layout, MODES, split_r=split_r,
                             device=cuda_device)
    img = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, shape).astype(np.int32)).to(cuda_device)
    before = k2.launches
    got = fn(img, tables, MODES)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    torch.testing.assert_close(got, fn(img, flat, MODES), rtol=0, atol=0)
    torch.testing.assert_close(got, stage_plain(stage, img, tables),
                               rtol=0, atol=0)


def structured_frame(kind):
    """int32 [3, 360, 640] frames on which K2 rows' warps read their slots
    in place: chip_smoke's smooth frame (a box-blurred seeded field),
    constant 4 x 8 blocks, and the smooth frame with a random 100 x 200
    patch and a random row band, whose warps both copy and read in
    place."""
    cs = load_tool("chip_smoke")
    smooth = np.ascontiguousarray(
        cs.smooth_frame().transpose(2, 0, 1).astype(np.int32))
    rng = np.random.RandomState(9)
    if kind == "smooth":
        return smooth
    if kind == "runs":
        return rng.randint(0, 256, (3, 90, 80)).repeat(4, 1).repeat(
            8, 2).astype(np.int32)
    out = smooth.copy()
    out[:, 100:200, 150:350] = rng.randint(0, 256, (3, 100, 200))
    out[:, 300:305] = rng.randint(0, 256, (3, 5, 640))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["smooth", "runs", "mixed"])
@pytest.mark.parametrize("layout", ["packed8", "packed32", "cells"])
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_lut_rows_kernel_on_structured_frames(stage, layout, kind,
                                              cuda_device):
    """K2's row mode where a warp's pixels share cells (its copied slots
    read in place, or a frame that mixes such warps with copying ones):
    bit-equal to flat K2 and to the twin on the same layout."""
    fn, split_r, _, which = STAGES[stage]
    luts = getattr(random_bank(), which)
    flat = lp.FlatTables.create(luts, cuda_device)
    tables = lp.stage_tables(luts, layout, MODES, split_r=split_r,
                             device=cuda_device)
    img = torch.from_numpy(structured_frame(kind)).to(cuda_device)
    got = fn(img, tables, MODES)
    torch.cuda.synchronize()
    assert torch.equal(got, fn(img, flat, MODES))
    assert torch.equal(got, stage_plain(stage, img, tables))


def load_tool(name):
    """A script of the repo (``chip_smoke.py`` at its root, or one under
    ``lerf_torch/tools/``) as a module."""
    import importlib.util
    import os

    from lerf_torch.ops.kernels import _build

    pkg = os.path.dirname(_build.CSRC)
    path = (os.path.join(os.path.dirname(pkg), name + ".py")
            if name == "chip_smoke"
            else os.path.join(pkg, "tools", name + ".py"))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def rows_first_design():
    """K2 rows' first design (``tools/lut_rows_first.cu``), built on its
    own as chip_smoke builds it: ``fn(img, tables, modes, split_r, den,
    bias)``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    cs = load_tool("chip_smoke")
    return cs.k2_rows_first_design(
        cs.start_first_build(cs.K2_ROWS_FIRST, "k2_rows_first"))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed8", "packed32", "cells"])
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_lut_rows_kernel_equals_first_design(stage, layout,
                                             rows_first_design, cuda_device):
    """The kernel and its first design give the same bits, at
    chip_smoke's frame size and on a ragged one."""
    fn, split_r, bias, which = STAGES[stage]
    den = len(MODES) * (1 if stage == "stage1" else 4) * 16
    tables = lp.stage_tables(getattr(random_bank(), which), layout, MODES,
                             split_r=split_r, device=cuda_device)
    for shape in [(3, 360, 640), (2, 17, 33)]:
        img = torch.from_numpy(np.random.RandomState(4).randint(
            0, 256, shape).astype(np.int32)).to(cuda_device)
        got = fn(img, tables, MODES)
        first = rows_first_design(img, tables, MODES, split_r, den, bias)
        torch.cuda.synchronize()
        assert torch.equal(got, first if split_r else first[..., 0])


@pytest.mark.cuda
def test_lut_rows_kernel_launch_refused_raises(cuda_device):
    """A frame taller than CUDA's 65535 row tiles (the slot-copying
    instance's 8-row tiles): the launch is refused and the wrapper raises,
    launching nothing and running no other design; the next launch is not
    disturbed."""
    tables = lp.stage_tables(random_bank().stage2, "cells", MODES,
                             split_r=True, device=cuda_device)
    tall = torch.zeros((1, 8 * 65536, 1), dtype=torch.int32,
                       device=cuda_device)
    before = k2.launches
    with pytest.raises(RuntimeError, match="lut_stage launch"):
        lp.lut_stage2(tall, tables, MODES)
    assert k2.launches == before
    img = torch.from_numpy(np.random.RandomState(5).randint(
        0, 256, (3, 20, 40)).astype(np.int32)).to(cuda_device)
    got = lp.lut_stage2(img, tables, MODES)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    torch.testing.assert_close(got, stage_plain("stage2", img, tables),
                               rtol=0, atol=0)


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
def test_resize_kernel_walks_a_deep_downscale_in_strips(cuda_device):
    shape, scale = DEEP_AA
    feat, codes = (t.to(cuda_device) for t in resize_inputs(shape))
    geom = ResizeGeometry.create(shape[1:], scale_factors=[scale] * 2)
    ops = k1.ResizeOperands.create(geom, cuda_device)
    assert ops.tile[2] < geom.support      # the window is walked in strips
    got = k1.steering_resize(feat, codes, geom, operands=ops)
    got_u8 = k1.steering_resize(feat, codes, geom, operands=ops,
                                out_dtype=torch.uint8)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, steering_resize_codes_plain(
        feat, codes, geom), rtol=0, atol=RESIZE_ATOL)
    assert torch.equal(got_u8, _quantize_device(got, 255))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RESIZE_CASES) + ["x3-odd-width"])
def test_resize_kernel_uint8_equals_its_float_mode_quantized(case,
                                                           cuda_device):
    # x3 from 77 columns gives 231, not a multiple of the 4-byte store
    scale, aa = RESIZE_CASES.get(case, ((3.0, 3.0), True))
    feat, codes = (t.to(cuda_device) for t in resize_inputs())
    geom = ResizeGeometry.create(feat.shape[1:], scale_factors=list(scale),
                                 antialias=aa)
    before = k1.launches
    got = k1.steering_resize(feat, codes, geom, out_dtype=torch.uint8)
    f32 = k1.steering_resize(feat, codes, geom)
    torch.cuda.synchronize()
    assert k1.launches == before + 2
    assert got.dtype == torch.uint8 and got.shape == f32.shape
    assert torch.equal(got, _quantize_device(f32, 255))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 2, 5), (1, 1, 1)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_lut_stage_kernel_matches_plain_below_the_halo(stage, shape,
                                                       cuda_device):
    fn, _, _, which = STAGES[stage]
    tables = lp.FlatTables.create(getattr(random_bank(), which), cuda_device)
    img = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, shape).astype(np.int32)).to(cuda_device)
    got = fn(img, tables, MODES)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, stage_plain(stage, img, tables),
                               rtol=0, atol=0)


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


def warp_case(case, device):
    """Random stage outputs of the case's shape on ``device``, its host
    geometry (the twin's) and its WarpParams (K5's)."""
    matrix, shape, out_sz = WARP_CASES[case]
    rng = np.random.RandomState(8)
    feat = torch.from_numpy(rng.randint(0, 256, shape).astype(np.int32))
    codes = torch.from_numpy(rng.randint(0, 256, shape + (3,))
                             .astype(np.int32))
    geom = WarpGeometry.create(shape[1:], matrix, out_sz)
    params = k5.WarpParams.create(shape[1:], matrix, out_sz)
    return feat.to(device), codes.to(device), geom, params


def test_divide_exact_is_true_division():
    codes = torch.arange(256, dtype=torch.float32)
    want = torch.from_numpy(codes.numpy() / np.float32(255.0))
    assert torch.equal(lp.divide_exact(codes, 255), want)
    assert lp.divide_exact(codes, 255).dtype == torch.float32


@pytest.mark.cuda
def test_divide_exact_on_card_is_the_cpu_quotient(cuda_device):
    codes = torch.arange(256, dtype=torch.float32)
    got = lp.divide_exact(codes.to(cuda_device), 255)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), lp.divide_exact(codes, 255))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WARP_CASES))
def test_warp_geometry_on_card_equals_host_operands(case, cuda_device):
    matrix, shape, out_sz = WARP_CASES[case]
    params = k5.WarpParams.create(shape[1:], matrix, out_sz)
    got = k5.warp_geometry(params, cuda_device)
    torch.cuda.synchronize()
    want = k5.WarpOperands.create(
        WarpGeometry.create(shape[1:], matrix, out_sz), "cpu")
    assert got.pad == want.pad
    assert torch.equal(got.corners.cpu(), want.corners)
    assert torch.equal(got.dis.cpu(), want.dis)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WARP_CASES))
def test_warp_kernel_matches_plain(case, cuda_device):
    feat, codes, geom, params = warp_case(case, cuda_device)
    before = k5.launches
    got = k5.steering_warp(feat, codes, params)
    torch.cuda.synchronize()
    assert k5.launches == before + 1
    want = steering_warp_codes_plain(feat, codes, geom)
    assert got.shape == want.shape == (feat.shape[0],) + geom.out_sz
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    if case == "border":
        assert bool(torch.isnan(want).any())
    torch.testing.assert_close(torch.nan_to_num(got), torch.nan_to_num(want),
                               rtol=0, atol=WARP_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WARP_CASES))
def test_warp_kernel_uint8_equals_its_float_mode_quantized(case,
                                                         cuda_device):
    feat, codes, _, params = warp_case(case, cuda_device)
    got = k5.steering_warp(feat, codes, params, out_dtype=torch.uint8)
    f32 = k5.steering_warp(feat, codes, params)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint8 and got.shape == f32.shape
    assert torch.equal(got, quantize_device(f32, 255, nan_to_zero=True))


@pytest.mark.cuda
def test_warp_kernel_direct_path_matches_plain(cuda_device):
    """Every block of the 1/16 minification reads a footprint larger than
    the shared-memory tile, so each takes the kernel's direct path."""
    feat, codes, geom, params = warp_case("minify16", cuda_device)
    entries = k5.footprint_entries(k5.WarpOperands.create(geom, "cpu"),
                                   geom.in_sz, geom.out_sz, feat.shape[0])
    assert (entries > k5.TILE_ENTRIES).all()
    got = k5.steering_warp(feat, codes, params)
    torch.cuda.synchronize()
    want = steering_warp_codes_plain(feat, codes, geom)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.testing.assert_close(torch.nan_to_num(got), torch.nan_to_num(want),
                               rtol=0, atol=WARP_ATOL)


def test_warp_wrapper_rejects_mismatched_inputs():
    feat, codes, geom, _ = warp_case("3x7x9", "cpu")
    other = WarpGeometry.create((8, 9), np.eye(3), (13, 17))
    with pytest.raises(ValueError, match="geometry"):
        k5.steering_warp(feat, codes, other)
    with pytest.raises(ValueError, match="int32"):
        k5.steering_warp(feat.to(torch.int64), codes, geom)
    with pytest.raises(ValueError, match="int32"):
        k5.steering_warp(feat, codes[..., :2], geom)


@pytest.mark.cuda
def test_warp_kernel_rejects_a_host_geometry(cuda_device):
    feat, codes, geom, _ = warp_case("3x7x9", cuda_device)
    with pytest.raises(ValueError, match="WarpParams"):
        k5.steering_warp(feat, codes, geom)
    with pytest.raises(ValueError, match="CUDA"):
        k5.warp_geometry(k5.WarpParams.create((7, 9), np.eye(3), (13, 17)),
                         "cpu")


@pytest.mark.cuda
def test_warp_on_card_matches_cpu(cuda_device):
    bank = random_bank()
    img = np.random.RandomState(9).randint(0, 256, (45, 77, 3)) \
        .astype(np.uint8)
    matrix = jitter_matrix(1, (4.0, 4.0))
    want = LutPredictor(bank, device="cpu").warp(img, matrix, (180, 308),
                                                 return_aux=True)
    before = (k1.launches, k2.launches, k5.launches)
    got = LutPredictor(bank, device=cuda_device).warp(img, matrix, (180, 308),
                                                      return_aux=True)
    assert (k1.launches, k2.launches, k5.launches) == (
        before[0], before[1] + 2, before[2] + 1)
    np.testing.assert_array_equal(got[1], want[1])      # the mask
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    # a pixel whose float32 value sits at a .5 rounding tie may quantize
    # one step apart; nothing else may differ
    assert np.abs(got[0].astype(int) - want[0].astype(int)).max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["auto", "pallas_int8"])
def test_net_warp_on_card_launches_its_kernels(backend, cuda_device):
    params = net_params(nf=64)
    img = np.random.RandomState(10).randint(0, 256, (40, 56, 3)) \
        .astype(np.uint8)
    kern = k4 if backend == "pallas_int8" else k3
    before = (k1.launches, kern.launches, k5.launches)
    out, mask, feat, hyper = NetPredictor.from_srnets(
        params, backend=backend, device=cuda_device).warp(
        img, jitter_matrix(2, (4.0, 4.0)), (160, 224), return_aux=True)
    assert (k1.launches, kern.launches, k5.launches) == (
        before[0], before[1] + 2, before[2] + 1)
    # the card's uint8 against the plain warp of the card's own stages
    geom = WarpGeometry.create(img.shape[:2], jitter_matrix(2, (4.0, 4.0)),
                               (160, 224))
    codes = torch.from_numpy(np.round(hyper * 255).astype(np.int32))
    plain = quantize_device(steering_warp_codes_plain(
        torch.from_numpy(feat.astype(np.int32)), codes, geom), 255,
        nan_to_zero=True)
    diff = np.abs(plain.numpy().transpose(1, 2, 0).astype(int)
                  - out.astype(int))
    assert out.shape == (160, 224, 3) and mask.shape == (160, 224)
    assert diff.max() <= 1


# -- LeRF-L (linear modes), K5 at any support, the SR serving forms ----------


def alpha_codes(shape, seed=11):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, 256, tuple(shape) + (1,)).astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RESIZE_CASES))
def test_resize_kernel_linear_mode_matches_plain(case, cuda_device):
    """K1's amplified-linear mode against its twin (the same float32
    operations in the same order: atol 1e-3, no exp), its uint8 mode equal
    to its float mode quantized."""
    scale, aa = RESIZE_CASES[case]
    feat, _ = (t.to(cuda_device) for t in resize_inputs())
    codes = alpha_codes(feat.shape).to(cuda_device)
    geom = ResizeGeometry.create(feat.shape[1:], scale_factors=list(scale),
                                 antialias=aa)
    before = k1.launches
    got = k1.steering_resize(feat, codes, geom, linear=True)
    got_u8 = k1.steering_resize(feat, codes, geom, linear=True,
                                out_dtype=torch.uint8)
    torch.cuda.synchronize()
    assert k1.launches == before + 2
    want = linear_resize_codes_plain(feat, codes, geom)
    torch.testing.assert_close(got, want, rtol=0, atol=RESIZE_ATOL)
    assert torch.equal(got_u8, quantize_device(got, 255, nan_to_zero=True))


@pytest.mark.cuda
def test_kernels_reject_codes_of_the_other_mode(cuda_device):
    feat, codes = (t.to(cuda_device) for t in resize_inputs())
    geom = ResizeGeometry.create(feat.shape[1:], scale_factors=[2, 2])
    with pytest.raises(ValueError, match="linear"):
        k1.steering_resize(feat, codes, geom, linear=True)
    with pytest.raises(ValueError, match="Gaussian"):
        k1.steering_resize(feat, codes[..., :1].contiguous(), geom)
    params = k5.WarpParams.create(feat.shape[1:], np.diag([2.0, 2.0, 1.0]),
                                  (90, 154))
    with pytest.raises(ValueError, match="linear"):
        k5.steering_warp(feat, codes, params, linear=True)
    with pytest.raises(ValueError, match="operands"):
        k1.steering_resize(feat, codes, geom, operands=k1.ResizeOperands
                           .create(geom, cuda_device, linear=True))


# the supports K5 is checked at beyond 2, each warp case at each
K5_SUPPORT_CASES = [(case, s) for case in ("3x7x9", "x2.5-wide", "rotation",
                                           "border", "minify16")
                    for s in (3, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,support", K5_SUPPORT_CASES,
                         ids=[f"{c}-s{s}" for c, s in K5_SUPPORT_CASES])
def test_warp_geometry_on_card_at_support(case, support, cuda_device):
    matrix, shape, out_sz = WARP_CASES[case]
    params = k5.WarpParams.create(shape[1:], matrix, out_sz, support=support)
    got = k5.warp_geometry(params, cuda_device)
    torch.cuda.synchronize()
    want = k5.WarpOperands.create(params.geometry(), "cpu")
    assert got.pad == want.pad
    assert torch.equal(got.corners.cpu(), want.corners)
    assert torch.equal(got.dis.cpu(), want.dis)
    assert torch.equal(got.masks.cpu(), want.masks)


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("case,support",
                         [(c, 2) for c in sorted(WARP_CASES)]
                         + K5_SUPPORT_CASES,
                         ids=[f"{c}-s2" for c in sorted(WARP_CASES)]
                         + [f"{c}-s{s}" for c, s in K5_SUPPORT_CASES])
def test_warp_kernel_modes_and_supports_match_plain(case, support, linear,
                                                    cuda_device):
    """K5 in both modes and at supports 2, 3, 4 against its twin: atol
    1e-3, NaN patterns equal, the uint8 mode its float mode quantized."""
    matrix, shape, out_sz = WARP_CASES[case]
    feat, codes, _, _ = warp_case(case, cuda_device)
    if linear:
        codes = alpha_codes(shape).to(cuda_device)
    params = k5.WarpParams.create(shape[1:], matrix, out_sz, support=support)
    geom = params.geometry()
    before = k5.launches
    got = k5.steering_warp(feat, codes, params, linear=linear)
    got_u8 = k5.steering_warp(feat, codes, params, linear=linear,
                              out_dtype=torch.uint8)
    torch.cuda.synchronize()
    assert k5.launches == before + 2
    twin = linear_warp_codes_plain if linear else steering_warp_codes_plain
    want = twin(feat, codes, geom)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.testing.assert_close(torch.nan_to_num(got), torch.nan_to_num(want),
                               rtol=0, atol=WARP_ATOL)
    assert torch.equal(got_u8, quantize_device(got, 255, nan_to_zero=True))


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_folded_batch_equals_per_frame_calls(linear, cuda_device):
    """A batch folded into the channel axis through K2 and K1 (one launch
    each) equals the frames' own calls."""
    bank = random_bank(out_c=1 if linear else 3)
    s1 = lp.FlatTables.create(bank.stage1, cuda_device)
    s2 = lp.FlatTables.create(bank.stage2, cuda_device)
    imgs = torch.from_numpy(np.random.RandomState(12).randint(
        0, 256, (4, 3, 30, 41)).astype(np.int32)).to(cuda_device)
    geom = ResizeGeometry.create((30, 41), scale_factors=[2.5, 2.5])

    def frame(x):
        feat = lp.lut_stage1(x, s1, MODES)
        return k1.steering_resize(feat, lp.lut_stage2(feat, s2, MODES),
                                  geom, linear=linear,
                                  out_dtype=torch.uint8)

    before = (k1.launches, k2.launches)
    folded = frame(imgs.reshape(12, 30, 41))
    torch.cuda.synchronize()
    assert (k1.launches, k2.launches) == (before[0] + 1, before[1] + 2)
    for b in range(4):
        assert torch.equal(folded[3 * b:3 * b + 3], frame(imgs[b]))


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_lut_forms_on_card_match_cpu(linear, cuda_device):
    """Both LUT forms on the card against the CPU path: SR and the warp
    (support 2 and 3), stage codes and masks equal, uint8 one step at most
    (a .5 tie)."""
    bank = random_bank(out_c=1 if linear else 3)
    img = np.random.RandomState(13).randint(0, 256, (45, 77, 3)) \
        .astype(np.uint8)
    matrix = jitter_matrix(1, (4.0, 4.0))
    for support in (2, 3):
        cpu = LutPredictor(bank, linear=linear, supp_size=support,
                           device="cpu")
        card = LutPredictor(bank, linear=linear, supp_size=support,
                            device=cuda_device)
        calls = [lambda p: p.warp(img, matrix, (180, 308), return_aux=True)]
        if support == 2:
            calls.append(lambda p: p.upscale(img, 3.55, 3.55,
                                             return_aux=True))
        for call in calls:
            want, got = call(cpu), call(card)
            for a, b in zip(want[1:], got[1:]):
                np.testing.assert_array_equal(b, a)
            assert np.abs(got[0].astype(int) - want[0].astype(int)).max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_sr_serving_forms_on_card_equal_upscale(linear, cuda_device):
    """The serving forms on the card: each bit-equal to ``upscale`` on the
    card, each call two K2 launches and one K1, the batch included."""
    bank = random_bank(out_c=1 if linear else 3)
    pred = LutPredictor(bank, linear=linear, device=cuda_device)
    img = np.random.RandomState(14).randint(0, 256, (45, 77, 3)) \
        .astype(np.uint8)
    calls = {"dynamic x2.5": (lambda: pred.upscale_dynamic(img, 2.5, 2.5),
                              (2.5, 2.5)),
             "dynamic x3 g64": (lambda: pred.upscale_dynamic(
                 img, 3.0, 3.0, granularity=64), (3.0, 3.0)),
             "dynamic x0.5": (lambda: pred.upscale_dynamic(img, 0.5, 0.5),
                              (0.5, 0.5)),
             "bucketed x2 g64": (lambda: pred.upscale_bucketed(img, 2, 2, 64),
                                 (2.0, 2.0))}
    for name, (call, scale) in calls.items():
        want = pred.upscale(img, *scale)
        before = (k1.launches, k2.launches)
        got = call()
        assert (k1.launches, k2.launches) == (before[0] + 1,
                                              before[1] + 2), name
        np.testing.assert_array_equal(got, want, err_msg=name)
    imgs = np.stack([img, img[::-1].copy(), 255 - img])
    before = (k1.launches, k2.launches)
    got = pred.upscale_batch(imgs, 4, 4)
    assert (k1.launches, k2.launches) == (before[0] + 1, before[1] + 2)
    for b in range(3):
        np.testing.assert_array_equal(got[b], pred.upscale(imgs[b], 4, 4))


# -- K5's validity mask and its batch of homographies ---------------------


def test_warp_mask_on_cpu_is_the_host_mask():
    """``mask_out`` on CPU tensors: the host mask of the warp's matrix
    (``WarpParams.host_mask``), the frame the twin's, no launch; a host
    geometry carries no matrix, so it cannot give the mask."""
    for case in ("3x7x9", "border", "rotation"):
        feat, codes, geom, params = warp_case(case, "cpu")
        mask = torch.zeros(params.out_sz, dtype=torch.bool)
        before = k5.launches
        got = k5.steering_warp(feat, codes, params, mask_out=mask)
        assert k5.launches == before
        twin = steering_warp_codes_plain(feat, codes, geom)
        assert torch.equal(torch.nan_to_num(got, nan=-1.0),
                           torch.nan_to_num(twin, nan=-1.0))
        assert torch.equal(mask, torch.from_numpy(params.host_mask(4)))
        assert mask.any() == (case == "rotation")   # 7×9: all border
        with pytest.raises(ValueError, match="WarpParams"):
            k5.steering_warp(feat, codes, geom, mask_out=mask)


def batch_case(cases, device, linear=False):
    """The cases' stage outputs one frame after another along the channel
    axis, at the first case's sizes, under each case's own matrix."""
    _, shape, out_sz = WARP_CASES[cases[0]]
    feats, codes, warps = [], [], []
    for k, case in enumerate(cases):
        rng = np.random.RandomState(20 + k)
        feats.append(rng.randint(0, 256, shape).astype(np.int32))
        codes.append(rng.randint(0, 256, shape + (1 if linear else 3,))
                     .astype(np.int32))
        warps.append(k5.WarpParams.create(shape[1:], WARP_CASES[case][0],
                                          out_sz))
    return (torch.from_numpy(np.concatenate(feats)).to(device),
            torch.from_numpy(np.concatenate(codes)).to(device), warps)


def test_warp_batch_on_cpu_is_each_frames_twin():
    feat, codes, warps = batch_case(["3x7x9", "border", "1x1x1"], "cpu")
    masks = torch.zeros((3,) + warps[0].out_sz, dtype=torch.bool)
    before = k5.launches
    got = k5.steering_warp_batch(feat, codes, warps, mask_out=masks,
                                 out_dtype=torch.uint8)
    assert k5.launches == before
    for f, w in enumerate(warps):
        mask = torch.zeros(w.out_sz, dtype=torch.bool)
        one = k5.steering_warp(feat[3 * f:3 * f + 3], codes[3 * f:3 * f + 3],
                               w, mask_out=mask, out_dtype=torch.uint8)
        assert torch.equal(got[3 * f:3 * f + 3], one)
        assert torch.equal(masks[f], mask)


def test_warp_batch_wrapper_checks_its_arguments():
    feat, codes, warps = batch_case(["3x7x9", "border"], "cpu")
    with pytest.raises(ValueError, match="frames"):
        k5.steering_warp_batch(feat[:5], codes[:5], warps)
    other = k5.WarpParams.create((7, 9), np.eye(3), (12, 17))
    with pytest.raises(ValueError, match="one output size"):
        k5.steering_warp_batch(feat, codes, [warps[0], other])
    with pytest.raises(ValueError, match="mask_out"):
        k5.steering_warp_batch(feat, codes, warps,
                               mask_out=torch.zeros((1, 13, 17),
                                                    dtype=torch.bool))
    with pytest.raises(ValueError, match="Gaussian"):
        k5.steering_warp_batch(feat, codes[..., :1], warps)
    with pytest.raises(ValueError, match="WarpParams"):
        k5.steering_warp_batch(feat, codes, [warps[0], warps[1].geometry()])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WARP_CASES))
def test_warp_mask_on_card_equals_host(case, cuda_device):
    """K5's validity mask, alone (``warp_mask``) and written in K5's own
    launch at supports 2 and 4 (``mask_out``), equal to the host's float64
    mask; the frame unchanged by asking for it."""
    matrix, shape, out_sz = WARP_CASES[case]
    feat, codes, _, _ = warp_case(case, cuda_device)
    host = torch.from_numpy(k5.WarpParams.create(shape[1:], matrix,
                                                 out_sz).host_mask(4))
    for support in (2, 4):
        params = k5.WarpParams.create(shape[1:], matrix, out_sz,
                                      support=support)
        assert torch.equal(k5.warp_mask(params, cuda_device).cpu(), host)
        mask = torch.zeros(out_sz, dtype=torch.bool, device=cuda_device)
        before = k5.launches
        got = k5.steering_warp(feat, codes, params, mask_out=mask,
                               out_dtype=torch.uint8)
        assert k5.launches == before + 1
        assert torch.equal(mask.cpu(), host)
        assert torch.equal(got, k5.steering_warp(feat, codes, params,
                                                 out_dtype=torch.uint8))
    inv = torch.tensor(np.linalg.inv(matrix), device=cuda_device)
    assert torch.equal(nearest_warp_mask_on_device(
        inv, shape[1:], out_sz, border=4).cpu(), host)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.uint8, torch.float32],
                         ids=["uint8", "float32"])
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_warp_batch_kernel_equals_per_frame(linear, out_dtype, cuda_device):
    """One launch for a batch (up to ``MAX_FRAMES``; 18 frames take two):
    each frame bit-equal to its own K5 call, each mask to the host's."""
    cases = ["x2.5-wide", "identity", "rotation"]
    base = ["x2.5-wide"] * 3
    for names in (cases, base * 6):
        feat, codes, warps = batch_case(names, cuda_device, linear)
        # every frame at the first case's sizes, under its own matrix
        warps = [k5.WarpParams.create(warps[0].in_sz, WARP_CASES[c][0],
                                      warps[0].out_sz) for c in names]
        masks = torch.zeros((len(warps),) + warps[0].out_sz,
                            dtype=torch.bool, device=cuda_device)
        before = k5.launches
        got = k5.steering_warp_batch(feat, codes, warps, linear=linear,
                                     out_dtype=out_dtype, mask_out=masks)
        torch.cuda.synchronize()
        assert k5.launches == before + -(-len(warps) // k5.MAX_FRAMES)
        for f, w in enumerate(warps):
            sl = slice(3 * f, 3 * f + 3)
            one = k5.steering_warp(feat[sl], codes[sl], w, linear=linear,
                                   out_dtype=out_dtype)
            assert torch.equal(torch.nan_to_num(got[sl]),
                               torch.nan_to_num(one)), f
            assert torch.equal(masks[f].cpu(), torch.from_numpy(
                w.host_mask(4))), f


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_warp_serving_forms_on_card_equal_warp(linear, cuda_device):
    """``warp_dynamic``, ``warp_device`` and ``warp_batch`` on the card:
    each frame and mask bit-equal to ``warp`` on the card, each call two K2
    launches and one K5 (the batch too), no K1."""
    bank = random_bank(out_c=1 if linear else 3)
    pred = LutPredictor(bank, linear=linear, device=cuda_device)
    imgs = np.stack([np.random.RandomState(15 + b).randint(
        0, 256, (45, 77, 3)).astype(np.uint8) for b in range(3)])
    mats = [jitter_matrix(b, (4.0, 4.0)) for b in range(3)]
    want = [pred.warp(imgs[b], mats[b], (180, 308)) for b in range(3)]
    for b in range(3):      # a repeated homography: K5 without the mask
        again = pred.warp(imgs[b], mats[b], (180, 308))
        for x, y in zip(want[b], again):
            np.testing.assert_array_equal(y, x)
    for name, call in (("dynamic", pred.warp_dynamic),
                       ("device", pred.warp_device)):
        for b in range(3):
            before = (k1.launches, k2.launches, k5.launches)
            got = call(imgs[b], mats[b], (180, 308))
            assert (k1.launches, k2.launches, k5.launches) == (
                before[0], before[1] + 2, before[2] + 1), name
            for x, y in zip(want[b], got):
                np.testing.assert_array_equal(y, x, err_msg=name)
    before = (k1.launches, k2.launches, k5.launches)
    outs, masks = pred.warp_batch(imgs, np.stack(mats), (180, 308))
    assert (k1.launches, k2.launches, k5.launches) == (
        before[0], before[1] + 2, before[2] + 1)
    for b in range(3):
        np.testing.assert_array_equal(outs[b], want[b][0])
        np.testing.assert_array_equal(masks[b], want[b][1])
    outs, masks = pred.warp_batch(imgs, mats[0], (180, 308),
                                  geometry="device")
    for b in range(3):
        w = pred.warp(imgs[b], mats[0], (180, 308))
        np.testing.assert_array_equal(outs[b], w[0])
        np.testing.assert_array_equal(masks[b], w[1])


def test_probe_variants_apply_to_the_kernel_sources():
    """``tools/probe_lut_kernels.py`` builds each variant by text
    substitution into K1's, K2's and K5's sources: every substituted text
    must be there exactly once."""
    import os

    from lerf_torch.ops.kernels import _build

    probe = load_tool("probe_lut_kernels")
    for kernel, variants in probe.VARIANTS.items():
        with open(os.path.join(_build.CSRC, kernel + ".cu")) as f:
            src = f.read()
        for name, subs in variants.items():
            text = src
            for old, new in subs:
                assert text.count(old) == 1, (kernel, name, old[:60])
                text = text.replace(old, new)


def test_probe_row_variants_apply_to_the_row_sources():
    """``probe_lut_kernels.py --rows`` builds its variants by text
    substitution into K2's source (its row mode) and into its first
    design beside the script: every substituted text must be there
    exactly once."""
    import os

    from lerf_torch.ops.kernels import _build

    probe = load_tool("probe_lut_kernels")
    tools = os.path.join(os.path.dirname(_build.CSRC), "tools")
    for kernel, variants in probe.ROWS_VARIANTS.items():
        path = os.path.join(_build.CSRC, kernel + ".cu")
        if not os.path.exists(path):
            path = os.path.join(tools, kernel + ".cu")
        with open(path) as f:
            src = f.read()
        for name, subs in variants.items():
            text = src
            for old, new in subs:
                assert text.count(old) == 1, (kernel, name, old[:60])
                text = text.replace(old, new)


def test_probe_rings_variants_apply_to_the_rings_sources():
    """``probe_lut_kernels.py --rings`` builds its variants by text
    substitution into K5's source (its rings instance) and into the rings
    instance's first design beside the script: every substituted text
    must be there exactly once."""
    import os

    from lerf_torch.ops.kernels import _build

    probe = load_tool("probe_lut_kernels")
    tools = os.path.join(os.path.dirname(_build.CSRC), "tools")
    assert os.path.exists(os.path.join(tools, probe.RINGS_FIRST))
    for kernel, variants in probe.RINGS_VARIANTS.items():
        path = os.path.join(_build.CSRC, kernel + ".cu")
        if not os.path.exists(path):
            path = os.path.join(tools, kernel + ".cu")
        with open(path) as f:
            src = f.read()
        for name, subs in variants.items():
            text = src
            for old, new in subs:
                assert text.count(old) == 1, (kernel, name, old[:60])
                text = text.replace(old, new)


# -- the float modes: float32 feature and hyper maps in [0, 1] (the IMDN
# form), against lerf_tpu's float ops as twins ------------------------------

def float_inputs(shape=(3, 45, 77), seed=12, oc=3):
    """A float feature in [0, 254] and hyper maps in [0, 1], as the IMDN
    towers give them."""
    rng = np.random.RandomState(seed)
    return (torch.from_numpy((rng.rand(*shape) * 254).astype(np.float32)),
            torch.from_numpy(rng.rand(*shape, oc).astype(np.float32)))


def float_resize_twin(feat, hyper, geom, linear):
    if linear:
        return amplified_linear_resize(feat, hyper[..., 0], geom)
    return steering_gaussian_resize(feat, hyper[..., 0], hyper[..., 1],
                                    hyper[..., 2], geom)


def float_warp_twin(feat, hyper, geom, linear):
    if linear:
        return amplified_linear_warp(feat, hyper[..., 0], geom)
    return steering_gaussian_warp(feat, hyper[..., 0], hyper[..., 1],
                                  hyper[..., 2], geom)


@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_resize_float_mode_takes_float_twins_on_cpu(linear):
    feat, hyper = float_inputs(oc=1 if linear else 3)
    geom = ResizeGeometry.create(feat.shape[1:], scale_factors=[2.5, 2.5])
    got = k1.steering_resize(feat, hyper, geom, linear=linear)
    assert torch.equal(got, float_resize_twin(feat, hyper, geom, linear))
    ops = ResizeOperands.create(feat.shape[1:], scale_factors=[2.5, 2.5])
    got = k1.steering_resize_serving(feat, hyper, ops, linear=linear,
                                     out_dtype=torch.uint8)
    rings = resize_rings(ops, linear=linear)
    want = (amplified_linear_resize_rings(feat, hyper[..., 0], rings,
                                          pad=ops.pad) if linear
            else steering_gaussian_resize_rings(
                feat, hyper[..., 0], hyper[..., 1], hyper[..., 2], rings,
                pad=ops.pad))
    assert torch.equal(got, quantize_device(want, 255, nan_to_zero=linear))


@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_warp_float_mode_takes_float_twins_on_cpu(linear):
    matrix, shape, out_sz = WARP_CASES["border"]
    feat, hyper = float_inputs(shape, oc=1 if linear else 3)
    params = k5.WarpParams.create(shape[1:], matrix, out_sz)
    got = k5.steering_warp(feat, hyper, params, linear=linear)
    want = float_warp_twin(feat, hyper, params.geometry(), linear)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    feats = torch.cat([feat, feat.flip(-1)])
    hypers = torch.cat([hyper, hyper.flip(-2)])
    warps = [params, k5.WarpParams.create(shape[1:], jitter_matrix(
        1, (1.9, 1.9)), out_sz)]
    got = k5.steering_warp_batch(feats, hypers, warps, linear=linear,
                                 out_dtype=torch.uint8)
    for f, w in enumerate(warps):
        want = float_warp_twin(feats[3 * f:3 * f + 3],
                               hypers[3 * f:3 * f + 3], w.geometry(), linear)
        assert torch.equal(got[3 * f:3 * f + 3],
                           quantize_device(want, 255, nan_to_zero=True))


def test_kernels_reject_mixed_input_types():
    """Both inputs int32 (codes) or both float32 (maps): an int feature
    with float maps, or the other way round, raises."""
    feat, codes = resize_inputs()
    ffeat, fhyper = float_inputs()
    geom = ResizeGeometry.create(feat.shape[1:], scale_factors=[2, 2])
    ops = ResizeOperands.create(feat.shape[1:], scale_factors=[2.0, 2.0])
    params = k5.WarpParams.create(feat.shape[1:], np.diag([2.0, 2.0, 1.0]),
                                  (90, 154))
    for f, h in ((feat, fhyper), (ffeat, codes),
                 (ffeat.double(), fhyper.double())):
        with pytest.raises(ValueError, match="one type"):
            k1.steering_resize(f, h, geom)
        with pytest.raises(ValueError, match="one type"):
            k1.steering_resize_serving(f, h, ops)
        with pytest.raises(ValueError, match="one type"):
            k5.steering_warp(f, h, params)
        with pytest.raises(ValueError, match="one type"):
            k5.steering_warp_batch(f, h, [params])


# the K1 float-mode cases: RESIZE_CASES's, and the chip's main scales
FLOAT_RESIZE_CASES = sorted(RESIZE_CASES)


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("case", FLOAT_RESIZE_CASES)
def test_resize_kernel_float_mode_matches_twin(case, linear, cuda_device):
    scale, aa = RESIZE_CASES[case]
    feat, hyper = (t.to(cuda_device)
                   for t in float_inputs(oc=1 if linear else 3))
    geom = ResizeGeometry.create(feat.shape[1:], scale_factors=list(scale),
                                 antialias=aa)
    before = k1.launches
    got = k1.steering_resize(feat, hyper, geom, linear=linear)
    got_u8 = k1.steering_resize(feat, hyper, geom, linear=linear,
                                out_dtype=torch.uint8)
    torch.cuda.synchronize()
    assert k1.launches == before + 2
    want = float_resize_twin(feat, hyper, geom, linear)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.testing.assert_close(torch.nan_to_num(got), torch.nan_to_num(want),
                               rtol=0, atol=RESIZE_ATOL)
    assert torch.equal(got_u8, quantize_device(got, 255, nan_to_zero=linear))


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_resize_serving_float_mode_equals_static_on_card(linear,
                                                         cuda_device):
    feat, hyper = (t.to(cuda_device)
                   for t in float_inputs(oc=1 if linear else 3))
    for scale in (2.5, 4.0):
        geom = ResizeGeometry.create(feat.shape[1:], scale_factors=[scale] * 2)
        ops = ResizeOperands.create(feat.shape[1:], scale_factors=[scale] * 2)
        got = k1.steering_resize_serving(feat, hyper, ops, linear=linear)
        want = k1.steering_resize(feat, hyper, geom, linear=linear)
        torch.cuda.synchronize()
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("case,support",
                         [(c, 2) for c in sorted(WARP_CASES)]
                         + [("rotation", 4), ("x2.5-wide", 4)],
                         ids=lambda v: str(v))
def test_warp_kernel_float_mode_matches_twin(case, support, linear,
                                             cuda_device):
    matrix, shape, out_sz = WARP_CASES[case]
    feat, hyper = (t.to(cuda_device)
                   for t in float_inputs(shape, oc=1 if linear else 3))
    params = k5.WarpParams.create(shape[1:], matrix, out_sz, support=support)
    mask = torch.empty(out_sz, dtype=torch.bool, device=cuda_device)
    before = k5.launches
    got = k5.steering_warp(feat, hyper, params, linear=linear, mask_out=mask)
    got_u8 = k5.steering_warp(feat, hyper, params, linear=linear,
                              out_dtype=torch.uint8)
    torch.cuda.synchronize()
    assert k5.launches == before + 2
    want = float_warp_twin(feat, hyper, params.geometry(), linear)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.testing.assert_close(torch.nan_to_num(got), torch.nan_to_num(want),
                               rtol=0, atol=WARP_ATOL)
    assert torch.equal(got_u8, quantize_device(got, 255, nan_to_zero=True))
    assert np.array_equal(mask.cpu().numpy(), params.host_mask())


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_warp_batch_float_mode_equals_per_frame(linear, cuda_device):
    shape, out_sz = (3, 45, 77), (112, 192)
    feats, hypers = (t.to(cuda_device) for t in float_inputs(
        (12,) + shape[1:], oc=1 if linear else 3))
    warps = [k5.WarpParams.create(shape[1:], jitter_matrix(s, (2.5, 2.5)),
                                  out_sz) for s in range(4)]
    masks = torch.empty((4,) + out_sz, dtype=torch.bool, device=cuda_device)
    before = k5.launches
    got = k5.steering_warp_batch(feats, hypers, warps, linear=linear,
                                 out_dtype=torch.uint8, mask_out=masks)
    torch.cuda.synchronize()
    assert k5.launches == before + 1
    for f, w in enumerate(warps):
        one = k5.steering_warp(feats[3 * f:3 * f + 3],
                               hypers[3 * f:3 * f + 3], w, linear=linear,
                               out_dtype=torch.uint8)
        assert torch.equal(got[3 * f:3 * f + 3], one)
        assert np.array_equal(masks[f].cpu().numpy(), w.host_mask())


def imdn_model(nf=12, seed=0):
    from lerf_torch.models.imdn import IMDN2, init_imdn
    return init_imdn(IMDN2(nf=nf), torch.Generator().manual_seed(seed))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["base", "s2d"])
def test_imdn_on_card_matches_cpu(backend, cuda_device):
    """The IMDN form on the card against the CPU: the towers' float32
    sums run in another order (cuDNN), so the feature within 1e-3, the
    hyper maps within 1e-5 and the frames within one level on ≤ 0.1 %;
    one K1 (SR) or K5 (warp) launch and no other kernel of the port."""
    model = imdn_model()
    img = np.random.RandomState(13).randint(0, 256, (45, 77, 3)) \
        .astype(np.uint8)
    cpu = NetPredictor.from_imdn(model, backend=backend, device="cpu")
    card = NetPredictor.from_imdn(model, backend=backend, device=cuda_device)
    counts = [m.launches for m in (k1, k2, k3, k4, k5)]
    got = card.upscale(img, 4, 4, return_aux=True)
    assert [m.launches for m in (k1, k2, k3, k4, k5)] == \
        [counts[0] + 1] + counts[1:]
    want = cpu.upscale(img, 4, 4, return_aux=True)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-5)
    d = np.abs(got[0].astype(int) - want[0].astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 0.001
    matrix = jitter_matrix(0, (2.0, 2.0))
    counts = [m.launches for m in (k1, k2, k3, k4, k5)]
    out, mask = card.warp(img, matrix, (90, 154))
    assert [m.launches for m in (k1, k2, k3, k4, k5)] == \
        counts[:4] + [counts[4] + 1]
    want_out, want_mask = cpu.warp(img, matrix, (90, 154))
    np.testing.assert_array_equal(mask, want_mask)
    d = np.abs(out.astype(int) - want_out.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 0.001


@pytest.mark.cuda
def test_imdn_serving_forms_on_card_equal_frames(cuda_device):
    pred = NetPredictor.from_imdn(imdn_model(), device=cuda_device)
    imgs = np.random.RandomState(14).randint(0, 256, (4, 40, 56, 3)) \
        .astype(np.uint8)
    want = [pred.upscale(f, 2.5, 2.5) for f in imgs]
    np.testing.assert_array_equal(pred.upscale_batch(imgs, 2.5, 2.5),
                                  np.stack(want))
    np.testing.assert_array_equal(pred.upscale_dynamic(imgs[1], 2.5, 2.5),
                                  want[1])
    mats = [jitter_matrix(s, (2.0, 2.0)) for s in range(4)]
    want = [pred.warp(f, m, (80, 112)) for f, m in zip(imgs, mats)]
    out, mask = pred.warp_batch(imgs, np.stack(mats), (80, 112))
    np.testing.assert_array_equal(out, np.stack([w[0] for w in want]))
    np.testing.assert_array_equal(mask, np.stack([w[1] for w in want]))
    for form in (pred.warp_dynamic, pred.warp_device):
        o, m = form(imgs[2], mats[2], (80, 112))
        np.testing.assert_array_equal(o, want[2][0])
        np.testing.assert_array_equal(m, want[2][1])


@pytest.mark.cuda
def test_imdn_restores_the_cudnn_flags_on_card(cuda_device):
    flags = (torch.backends.cudnn.enabled, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32)
    pred = NetPredictor.from_imdn(imdn_model(), device=cuda_device)
    pred.upscale(np.zeros((16, 20, 3), np.uint8), 2, 2)
    assert (torch.backends.cudnn.enabled, torch.backends.cudnn.benchmark,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.allow_tf32) == flags


# -- the bf16 instances of K1 and K5 (the bf16 IMDN form) -------------------

# K1's and K5's bf16 instances against their twins (the plain ops on the
# same bf16 tensors, on the card): the Gaussian's bf16 quotient within
# BF16_ULPS bf16 ulps (CUDA's expf may round a weight to the other bf16
# neighbour near a tie; at supports other than 2 the warp twin's torch.sum
# adds its float32 terms in another order); the linear mode's float32
# quotient within RESIZE_ATOL / WARP_ATOL
BF16_ULPS = 2


def bf16_inputs(shape=(3, 45, 77), seed=15, oc=3):
    feat, hyper = float_inputs(shape, seed, oc)
    return feat.to(torch.bfloat16), hyper.to(torch.bfloat16)


def assert_bf16_close(got, want, linear, atol):
    """A bf16 instance's float32 output against its twin's."""
    want = want.to(torch.float32)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    got, want = torch.nan_to_num(got), torch.nan_to_num(want)
    if linear:
        torch.testing.assert_close(got, want, rtol=0, atol=atol)
        return
    assert torch.equal(got, got.to(torch.bfloat16).to(torch.float32))

    def bits(t):
        return t.to(torch.bfloat16).view(torch.int16).to(torch.int32)
    assert int((bits(got) - bits(want)).abs().max()) <= BF16_ULPS


@pytest.mark.cuda
def test_native_bf16_steps_are_the_twins_steps(cuda_device):
    """Each native bf16 step K1's and K5's bf16 instances run (the pair
    add, subtract and product, both lanes, and the HFMA2 forms ptxas emits
    for them) gives the twin's float32 operation rounded to bf16, bit for
    bit, over all 2^32 operand pairs (``tools/bf16_steps_exhaustive.cu``,
    built on its own as chip_smoke builds it)."""
    cs = load_tool("chip_smoke")
    steps, _ = cs.bf16_steps_check(cs.start_first_build(cs.BF16_STEPS,
                                                        "bf16_steps"))
    assert list(steps) == list(cs.BF16_STEP_NAMES)
    assert {k: steps[k] for k in cs.BF16_KERNEL_STEPS
            if steps[k]["mismatches"]} == {}


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("case", FLOAT_RESIZE_CASES)
def test_resize_kernel_bf16_matches_twin(case, linear, cuda_device):
    scale, aa = RESIZE_CASES[case]
    feat, hyper = (t.to(cuda_device)
                   for t in bf16_inputs(oc=1 if linear else 3))
    geom = ResizeGeometry.create(feat.shape[1:], scale_factors=list(scale),
                                 antialias=aa)
    before = (k1.launches, k1.bf16_launches)
    got = k1.steering_resize(feat, hyper, geom, linear=linear)
    got_u8 = k1.steering_resize(feat, hyper, geom, linear=linear,
                                out_dtype=torch.uint8)
    torch.cuda.synchronize()
    assert (k1.launches, k1.bf16_launches) == (before[0] + 2, before[1] + 2)
    assert_bf16_close(got, float_resize_twin(feat, hyper, geom, linear),
                      linear, RESIZE_ATOL)
    assert torch.equal(got_u8, quantize_device(got, 255, nan_to_zero=linear))
    ops = ResizeOperands.create(feat.shape[1:], scale_factors=list(scale)) \
        if min(scale) >= 1 else None
    if ops is not None:
        serving = k1.steering_resize_serving(feat, hyper, ops, linear=linear)
        assert torch.equal(torch.nan_to_num(serving), torch.nan_to_num(got))


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("case,support",
                         [(c, 2) for c in sorted(WARP_CASES)]
                         + [("rotation", 4), ("x2.5-wide", 4)],
                         ids=lambda v: str(v))
def test_warp_kernel_bf16_matches_twin(case, support, linear, cuda_device):
    matrix, shape, out_sz = WARP_CASES[case]
    feat, hyper = (t.to(cuda_device)
                   for t in bf16_inputs(shape, oc=1 if linear else 3))
    params = k5.WarpParams.create(shape[1:], matrix, out_sz, support=support)
    mask = torch.empty(out_sz, dtype=torch.bool, device=cuda_device)
    before = k5.bf16_launches
    got = k5.steering_warp(feat, hyper, params, linear=linear, mask_out=mask)
    got_u8 = k5.steering_warp(feat, hyper, params, linear=linear,
                              out_dtype=torch.uint8)
    torch.cuda.synchronize()
    assert k5.bf16_launches == before + 2
    assert_bf16_close(got, float_warp_twin(feat, hyper, params.geometry(),
                                           linear), linear, WARP_ATOL)
    assert torch.equal(got_u8, quantize_device(got, 255, nan_to_zero=True))
    assert np.array_equal(mask.cpu().numpy(), params.host_mask())


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_warp_batch_bf16_equals_per_frame(linear, cuda_device):
    shape, out_sz = (3, 45, 77), (112, 192)
    feats, hypers = (t.to(cuda_device) for t in bf16_inputs(
        (12,) + shape[1:], oc=1 if linear else 3))
    warps = [k5.WarpParams.create(shape[1:], jitter_matrix(s, (2.5, 2.5)),
                                  out_sz) for s in range(4)]
    got = k5.steering_warp_batch(feats, hypers, warps, linear=linear,
                                 out_dtype=torch.uint8)
    for f, w in enumerate(warps):
        one = k5.steering_warp(feats[3 * f:3 * f + 3],
                               hypers[3 * f:3 * f + 3], w, linear=linear,
                               out_dtype=torch.uint8)
        assert torch.equal(got[3 * f:3 * f + 3], one)


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_mixed_types_match_twin_on_card(linear, cuda_device):
    """A float32 feature with bf16 maps (the one-stage bf16 form): the
    maps decoded in bf16, the rest float32, within the float tolerances."""
    feat, _ = float_inputs(oc=1)
    _, hyper = bf16_inputs(oc=1 if linear else 3)
    feat, hyper = feat.to(cuda_device), hyper.to(cuda_device)
    geom = ResizeGeometry.create(feat.shape[1:], scale_factors=[2.5, 2.5])
    got = k1.steering_resize(feat, hyper, geom, linear=linear)
    want = float_resize_twin(feat, hyper, geom, linear)
    assert want.dtype == torch.float32
    torch.testing.assert_close(torch.nan_to_num(got), torch.nan_to_num(want),
                               rtol=0, atol=RESIZE_ATOL)
    params = k5.WarpParams.create(feat.shape[1:], jitter_matrix(
        0, (2.0, 2.0)), (90, 154))
    got = k5.steering_warp(feat, hyper, params, linear=linear)
    want = float_warp_twin(feat, hyper, params.geometry(), linear)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.testing.assert_close(torch.nan_to_num(got), torch.nan_to_num(want),
                               rtol=0, atol=WARP_ATOL)


def bf16_feature_inputs(shape=(3, 45, 77), seed=16, oc=3):
    """A bf16 feature in [0, 254] beside float32 hyper maps in [0, 1]."""
    feat, hyper = float_inputs(shape, seed, oc)
    return feat.to(torch.bfloat16), hyper


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("case", FLOAT_RESIZE_CASES)
def test_resize_kernel_bf16_feature_equals_twin(case, linear, cuda_device):
    """A bf16 feature beside float32 maps (in_type 5): K1 reads the bf16
    feature and widens it, the distances and ``min_scale`` in bf16, the
    rest float32: ``torch.equal`` to the twin (the plain float op on the
    same tensors on the card), float32 and uint8, counted in
    ``bf16_feature_launches``; the serving form equal to the static one."""
    scale, aa = RESIZE_CASES[case]
    feat, hyper = (t.to(cuda_device)
                   for t in bf16_feature_inputs(oc=1 if linear else 3))
    geom = ResizeGeometry.create(feat.shape[1:], scale_factors=list(scale),
                                 antialias=aa)
    before = (k1.launches, k1.bf16_launches, k1.bf16_feature_launches)
    got = k1.steering_resize(feat, hyper, geom, linear=linear)
    got_u8 = k1.steering_resize(feat, hyper, geom, linear=linear,
                                out_dtype=torch.uint8)
    torch.cuda.synchronize()
    assert (k1.launches, k1.bf16_launches, k1.bf16_feature_launches) == (
        before[0] + 2, before[1], before[2] + 2)
    want = float_resize_twin(feat, hyper, geom, linear)
    assert want.dtype == torch.float32 and same(got, want)
    assert torch.equal(got_u8, quantize_device(want, 255,
                                               nan_to_zero=linear))
    if min(scale) >= 1:
        ops = ResizeOperands.create(feat.shape[1:], scale_factors=list(scale))
        serving = k1.steering_resize_serving(feat, hyper, ops, linear=linear)
        assert same(serving, got)


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("case,support",
                         [(c, 2) for c in sorted(WARP_CASES)]
                         + [("rotation", 4), ("x2.5-wide", 4)],
                         ids=lambda v: str(v))
def test_warp_kernel_bf16_feature_equals_twin(case, support, linear,
                                              cuda_device):
    """K5's matrix instance on a bf16 feature beside float32 maps (in_type
    5): the distances cast float64 -> float32 -> bf16, the rest float32;
    ``torch.equal`` to the twin at support 2 (at 4 the twin's ``torch.sum``
    adds in another order: within ``WARP_ATOL``), with its NaN pattern; the
    uint8 mode the float one quantized; the mask the host's."""
    matrix, shape, out_sz = WARP_CASES[case]
    feat, hyper = (t.to(cuda_device) for t in bf16_feature_inputs(
        shape, oc=1 if linear else 3))
    params = k5.WarpParams.create(shape[1:], matrix, out_sz, support=support)
    mask = torch.empty(out_sz, dtype=torch.bool, device=cuda_device)
    before = (k5.launches, k5.bf16_feature_launches)
    got = k5.steering_warp(feat, hyper, params, linear=linear, mask_out=mask)
    got_u8 = k5.steering_warp(feat, hyper, params, linear=linear,
                              out_dtype=torch.uint8)
    torch.cuda.synchronize()
    assert (k5.launches, k5.bf16_feature_launches) == (before[0] + 2,
                                                       before[1] + 2)
    want = float_warp_twin(feat, hyper, params.geometry(), linear)
    assert want.dtype == torch.float32
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    if support == 2:
        assert same(got, want)
    else:
        torch.testing.assert_close(torch.nan_to_num(got),
                                   torch.nan_to_num(want), rtol=0,
                                   atol=WARP_ATOL)
    assert torch.equal(got_u8, quantize_device(got, 255, nan_to_zero=True))
    assert np.array_equal(mask.cpu().numpy(), params.host_mask())


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["base", "s2d"])
def test_imdn_bf16_on_card(backend, cuda_device):
    """The bf16 IMDN form on the card: one K1 (K5) launch a call, the
    instance that takes bf16 maps; the serving forms bit-equal to
    ``upscale`` / ``warp``."""
    from lerf_torch.models.imdn import IMDN2

    model = IMDN2(nf=12, dtype=torch.bfloat16)
    model.load_state_dict(imdn_model().state_dict())
    pred = NetPredictor.from_imdn(model, backend=backend,
                                  device=cuda_device)
    imgs = np.random.RandomState(16).randint(0, 256, (4, 40, 56, 3)) \
        .astype(np.uint8)
    before = (k1.launches, k1.bf16_launches)
    want, feat, hyper = pred.upscale(imgs[0], 2.5, 2.5, return_aux=True)
    assert (k1.launches, k1.bf16_launches) == (before[0] + 1, before[1] + 1)
    assert feat.dtype == torch.bfloat16 and hyper.dtype == torch.bfloat16
    want = [pred.upscale(f, 2.5, 2.5) for f in imgs]
    np.testing.assert_array_equal(pred.upscale_batch(imgs, 2.5, 2.5),
                                  np.stack(want))
    np.testing.assert_array_equal(pred.upscale_dynamic(imgs[1], 2.5, 2.5),
                                  want[1])
    mats = [jitter_matrix(s, (2.0, 2.0)) for s in range(4)]
    before = k5.bf16_launches
    want = [pred.warp(f, m, (80, 112)) for f, m in zip(imgs, mats)]
    assert k5.bf16_launches == before + 4
    out, mask = pred.warp_batch(imgs, np.stack(mats), (80, 112))
    np.testing.assert_array_equal(out, np.stack([w[0] for w in want]))
    for form in (pred.warp_dynamic, pred.warp_device):
        o, m = form(imgs[2], mats[2], (80, 112))
        np.testing.assert_array_equal(o, want[2][0])
        np.testing.assert_array_equal(m, want[2][1])


# -- K6: the steerable resize's backward (training) -------------------------

# name → (LR size, scale, support, antialias, planes): the LeRF training
# geometry (48² → ×4, support 2), support 4, a non-integer scale, an
# antialiased downscale, ×3 and ×8 (K6's shared memory above 48 KB), a
# plane count and size no tile divides, and the frame (360×640 → ×4)
GRAD_CASES = {"x4-s2": ((24, 20), 4.0, 2, False, 3),
              "x4-s4": ((24, 20), 4.0, 4, False, 3),
              "x2.5-s2": ((17, 23), 2.5, 2, False, 3),
              "x0.5-aa": ((32, 36), 0.5, None, True, 3),
              "x3-s2": ((26, 30), 3.0, 2, False, 3),
              "x8-s2": ((20, 36), 8.0, 2, False, 3),
              "x4-odd": ((13, 37), 4.0, 2, False, 7),
              "frame": ((360, 640), 4.0, 2, False, 3)}
# K6 sums each gradient term in a fixed order; its twin scatters with
# index_add (atomics on the card) in another: float32 sums of up to ~64
# terms a pixel, compared relative to each gradient's largest value
GRAD_RTOL = 1e-4


def grad_inputs(case, linear, device, channels=None, seed=0):
    size, scale, support, aa, planes = GRAD_CASES[case]
    channels = channels or planes
    kw = {"support": support} if support else {}
    geom = ResizeGeometry.create(size, scale_factors=[scale] * 2,
                                 antialias=aa, **kw)
    rng = np.random.RandomState(seed)
    oc = 1 if linear else 3
    feat = torch.from_numpy((rng.rand(channels, *size) * 255)
                            .astype(np.float32)).to(device)
    hyper = torch.from_numpy(rng.rand(channels, *size, oc)
                             .astype(np.float32)).to(device)
    g = torch.from_numpy(rng.randn(channels, *geom.out_sz)
                         .astype(np.float32)).to(device)
    return geom, feat, hyper, g


def assert_grads_close(got, want, what):
    for name, a, b in zip(("feature", "hyper"), got, want):
        assert a.shape == b.shape, (what, name)
        err = float((a - b).abs().max()) / float(b.abs().max())
        assert err <= GRAD_RTOL, (what, name, err)


def test_resize_grad_twin_runs_on_cpu():
    """On CPU tensors K6's wrapper is its twin and launches nothing."""
    from lerf_torch.ops.kernels import resize_bwd
    from lerf_torch.ops.resample import steering_resize_grad_plain

    geom, feat, hyper, g = grad_inputs("x2.5-s2", False, "cpu")
    before = resize_bwd.launches
    got = resize_bwd.steering_resize_grad(feat, hyper, g, geom)
    want = steering_resize_grad_plain(feat, hyper, g, geom)
    assert resize_bwd.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("case", GRAD_CASES)
def test_resize_grad_kernel_matches_twin(case, linear, cuda_device):
    """K6 against its twin on the card, and deterministic: a second call
    gives the same bits."""
    from lerf_torch.ops.kernels import resize_bwd
    from lerf_torch.ops.resample import steering_resize_grad_plain

    geom, feat, hyper, g = grad_inputs(case, linear, cuda_device)
    before = resize_bwd.launches
    got = resize_bwd.steering_resize_grad(feat, hyper, g, geom, linear=linear)
    again = resize_bwd.steering_resize_grad(feat, hyper, g, geom,
                                            linear=linear)
    torch.cuda.synchronize()
    assert resize_bwd.launches == before + 2
    want = steering_resize_grad_plain(feat, hyper, g, geom, linear=linear)
    assert_grads_close(got, want, case)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("case", ["x8-s2", "x4-odd", "x0.5-aa"])
def test_resize_grad_same_bits_on_every_tile(case, linear, cuda_device):
    """K6 forced onto each planned tile, at 256 and 512 threads a block
    (x8's 8 × 32 tile takes more than 48 KB of shared memory): the same
    bits as on the tile it picks.  Each output's sums and each pixel's
    lanes run in an order no tile changes."""
    from lerf_torch.ops.kernels import resize_bwd

    geom, feat, hyper, g = grad_inputs(case, linear, cuda_device)
    want = resize_bwd.steering_resize_grad(feat, hyper, g, geom,
                                           linear=linear)
    tiles = [p.tile for p in resize_bwd.GradOperands.create(
        geom, cuda_device, linear=linear).plans]
    assert tiles
    for tile in tiles:
        for threads in (256, 512):
            ops = resize_bwd.GradOperands.create(
                geom, cuda_device, linear=linear, tiles=(tile,),
                threads=threads)
            got = resize_bwd.steering_resize_grad(
                feat, hyper, g, geom, linear=linear, operands=ops)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert torch.equal(a, b), (case, tile, threads)


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("case", ["x4-s2", "x2.5-s2", "x4-s4"])
def test_resize_train_on_card_matches_cpu_autograd(case, linear,
                                                   cuda_device):
    """The training resize on the card (K1 forward, K6 backward) against
    the CPU path (the plain op and its autograd): the output within 1e-3
    on 0..255, the gradients within GRAD_RTOL; one K1 and one K6 launch."""
    from lerf_torch.ops.kernels import resize_bwd

    geom, feat, hyper, g = grad_inputs(case, linear, "cpu", channels=4)
    outs, grads = [], []
    for dev in ("cpu", cuda_device):
        f = feat.clone().to(dev).requires_grad_()
        h = hyper.clone().to(dev).requires_grad_()
        counts = (k1.launches, resize_bwd.launches)
        out = k1.steering_resize_train(f, h, geom, linear=linear)
        out.backward(g.to(dev))
        if dev != "cpu":
            assert (k1.launches, resize_bwd.launches) == \
                (counts[0] + 1, counts[1] + 1)
        outs.append(out.detach().cpu())
        grads.append((f.grad.cpu(), h.grad.cpu()))
    assert float((outs[0] - outs[1]).abs().max()) <= RESIZE_ATOL
    assert_grads_close(grads[1], grads[0], case)


# -- the trainer on the card ------------------------------------------------

def train_setup(linear=False, seed=0, crop=12, nf=8, batch=2):
    """Seeded SRNet params (numpy) and a batch for a training step at a
    small size: ×4, support 2."""
    from lerf_torch.train import train_step as ts

    hp = ts.TrainHParams(scale=4.0, crop_size=crop, linear=linear,
                         total_iter=100, weight_decay=1e-4)
    params = srnet.init_lerf_nets(torch.Generator().manual_seed(seed),
                                  nf=nf, out_c=1 if linear else 3)
    rng = np.random.RandomState(seed)
    im = rng.rand(batch, 1, crop, crop).astype(np.float32)
    lb = rng.rand(batch, 1, 4 * crop, 4 * crop).astype(np.float32)
    return hp, params, im, lb


def copy_params(params, device):
    return {sk: {n: {k: v.clone().to(device) for k, v in h.items()}
                 for n, h in heads.items()} for sk, heads in params.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [False, True], ids=["lerf_g", "lerf_l"])
def test_train_step_on_card_matches_cpu(linear, cuda_device):
    """Two steps on the card (K1 forward, K6 backward, full-float32 dense
    chains) against the CPU's from the same params and batch: the loss and
    gradient norm within 1e-4 relative, the first step's gradient of each
    leaf within 1e-4 of that leaf's largest value (Adam's first step moves
    a parameter by about lr0·sign(g), so the params alone hold little more
    than the signs), the params after Adam within 1e-5 (the dense products
    sum in another order on the card, and the stages' gathers' backward
    adds with atomics); one K1 and one K6 launch a step."""
    from lerf_torch.ops.kernels import resize_bwd
    from lerf_torch.train import train_step as ts

    hp, params, im, lb = train_setup(linear)
    geom = ts.train_geometry(hp)
    runs = {}
    for dev in ("cpu", cuda_device):
        state = ts.TrainState.create(copy_params(params, dev), hp)
        step = ts.make_train_step(geom, hp, device=dev)
        metrics, grads = [], []
        for _ in range(2):
            counts = (k1.launches, resize_bwd.launches)
            state, m = step(state, torch.from_numpy(im).to(dev),
                            torch.from_numpy(lb).to(dev))
            if dev != "cpu":
                assert (k1.launches, resize_bwd.launches) == \
                    (counts[0] + 1, counts[1] + 1)
            metrics.append({k: float(v) for k, v in m.items()})
            grads.append({k: p.grad.detach().cpu().clone() for k, p in
                          ts.param_leaves(state.params).items()})
        runs[str(dev)] = (metrics, grads[0], ts.param_leaves(state.params))
    (m_cpu, g_cpu, p_cpu), (m_card, g_card, p_card) = \
        runs["cpu"], runs[str(cuda_device)]
    for a, b in zip(m_card, m_cpu):
        for k in ("loss", "grad_norm"):
            assert abs(a[k] - b[k]) <= 1e-4 * abs(b[k]), (k, a[k], b[k])
    for name, g in g_cpu.items():
        d = float((g_card[name] - g).abs().max())
        assert d <= 1e-4 * float(g.abs().max()), (name, d)
    for name, p in p_cpu.items():
        d = float((p_card[name].detach().cpu() - p.detach()).abs().max())
        assert d <= 1e-5, (name, d)


@pytest.mark.cuda
def test_imdn_train_step_runs_no_tf32_on_card(cuda_device):
    """IMDN2's training step with TF32 allowed by the caller: no TF32
    kernel in the forward or the backward (the step's scope covers
    ``loss.backward()``), and the caller's flags back after it."""
    from lerf_torch.models.imdn import IMDN2, init_imdn
    from lerf_torch.train import loop
    from lerf_torch.train import train_step as ts

    hp = ts.TrainHParams(scale=4.0, crop_size=16, total_iter=10)
    model = init_imdn(IMDN2(in_c=3, out_c=3, nf=8),
                      torch.Generator().manual_seed(0)).to(cuda_device)
    s1, s2 = loop.imdn_stage_fns(3, 3)
    state = ts.TrainState.create(model, hp)
    step = ts.make_train_step(ts.train_geometry(hp), hp, stage1_fn=s1,
                              stage2_fn=s2, device=cuda_device)
    rng = np.random.RandomState(1)
    im = torch.from_numpy(rng.rand(2, 3, 16, 16).astype(np.float32)) \
        .to(cuda_device)
    lb = torch.from_numpy(rng.rand(2, 3, 64, 64).astype(np.float32)) \
        .to(cuda_device)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        step(state, im, lb)                 # warm up
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            _, m = step(state, im, lb)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()]
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == (True, True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    assert math.isfinite(float(m["loss"]))
    assert any("steering_resize_kernel" in n for n in names)
    assert any("resize_bwd" in n for n in names)
    tf32 = [n for n in names if "tf32" in n.lower() or "1688" in n]
    assert not tf32, tf32


@pytest.mark.cuda
def test_device_dataset_samples_on_card(cuda_device):
    from lerf_torch.data.device_data import DeviceDataset

    rng = np.random.RandomState(0)
    lrs = [rng.randint(0, 256, (16, 20, 3), dtype=np.uint8)
           for _ in range(3)]
    hrs = [lr.repeat(4, 0).repeat(4, 1) for lr in lrs]
    ds = DeviceDataset(lrs, hrs, scale=4, crop_size=8, in_c=1,
                       device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    im, lb = ds.sample_batch(gen, 16)
    assert im.device.type == "cuda" and im.shape == (16, 1, 8, 8)
    assert torch.equal(lb[..., ::4, ::4], im)


# -- the async forms: pinned staging on the predictor's side stream --------


def serving_predictor(form, device):
    if form in ("lut", "lut_linear"):
        linear = form == "lut_linear"
        return LutPredictor(random_bank(out_c=1 if linear else 3),
                            linear=linear, device=device)
    if form == "net_k4":
        return NetPredictor.from_srnets(net_params(nf=8), device=device,
                                        backend="pallas_int8")
    return NetPredictor.from_imdn(imdn_model(), device=device)


def host_staged(pred, img, scale=None, matrix=None, out_sz=None):
    """A frame as the forms made it before they staged through pinned
    memory: the host's layout and cast (``_input``), the device part on
    the current stream, a pageable copy down."""
    x = pred._input(np.ascontiguousarray(img.transpose(2, 0, 1)))
    if matrix is None:
        out = pred.run_device(x, scale)[0]
    else:
        out = pred.run_warp_device(x, matrix, out_sz)[0]
    return out.cpu().numpy().transpose(1, 2, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["lut", "lut_linear", "net_k4", "imdn"])
def test_async_forms_on_card_equal_host_staged_path(form, cuda_device):
    """Each async form's result (uint8 staged up, cast and laid out on the
    card, fetched through pinned memory on the side stream) is bit-equal
    to the host-staged path on the current stream and to its synchronous
    form; one K1 or K5 launch a call."""
    pred = serving_predictor(form, cuda_device)
    rng = np.random.RandomState(16)
    img = rng.randint(0, 256, (45, 77, 3)).astype(np.uint8)
    mat = jitter_matrix(4, (4.0, 4.0))
    want = host_staged(pred, img, (4.0, 4.0))
    before = (k1.launches, k5.launches)
    got = pred.upscale_dynamic_async(img, 4.0, 4.0).result()
    assert (k1.launches, k5.launches) == (before[0] + 1, before[1])
    assert got.flags.c_contiguous and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pred.upscale(img, 4.0, 4.0), want)
    want_w = host_staged(pred, img, matrix=mat, out_sz=(180, 308))
    for name in ("warp_dynamic_async", "warp_device_async"):
        before = (k1.launches, k5.launches)
        out, mask = getattr(pred, name)(img, mat, (180, 308)).result()
        assert (k1.launches, k5.launches) == (before[0], before[1] + 1)
        np.testing.assert_array_equal(out, want_w, err_msg=name)
        np.testing.assert_array_equal(mask, pred.warp(img, mat,
                                                      (180, 308))[1])


@pytest.mark.cuda
def test_async_requests_in_flight_with_cache_eviction(cuda_device,
                                                      monkeypatch):
    """8 distinct frames dispatched before any ``result()``, each checked
    after; then the serving cache (cut to 2) evicted while requests are in
    flight: every result still equals its own synchronous call."""
    from lerf_torch import pipeline

    pred = serving_predictor("lut", cuda_device)
    rng = np.random.RandomState(17)
    imgs = [rng.randint(0, 256, (45, 77, 3)).astype(np.uint8)
            for _ in range(8)]
    want = [pred.upscale(f, 2.5, 2.5) for f in imgs]
    futs = [pred.upscale_dynamic_async(f, 2.5, 2.5) for f in imgs]
    for f, w in zip(futs, want):
        np.testing.assert_array_equal(f.result(), w)
    monkeypatch.setattr(pipeline, "SERVING_CACHE_SIZE", 2)
    scales = [2.0 + 0.25 * i for i in range(8)]
    want = [pred.upscale(f, s, s) for f, s in zip(imgs, scales)]
    futs = [pred.upscale_dynamic_async(f, s, s)
            for f, s in zip(imgs, scales)]
    assert len(pred._serving_cache) == 2
    for f, w in zip(futs, want):
        np.testing.assert_array_equal(f.result(), w)


@pytest.mark.cuda
def test_two_threads_dispatch_through_the_side_stream(cuda_device):
    """Two threads sending requests to one predictor at once: each gets
    its own frames, equal to the synchronous calls."""
    import threading

    pred = serving_predictor("lut", cuda_device)
    rng = np.random.RandomState(18)
    imgs = [rng.randint(0, 256, (45, 77, 3)).astype(np.uint8)
            for _ in range(8)]
    mat = jitter_matrix(5, (4.0, 4.0))
    want_sr = [pred.upscale(f, 4, 4) for f in imgs]
    want_w = [pred.warp(f, mat, (180, 308)) for f in imgs]
    got, errors = {}, []

    def worker(k):
        try:
            for i in range(k, len(imgs), 2):
                got["sr", i] = pred.upscale_dynamic_async(imgs[i], 4, 4)
                got["w", i] = pred.warp_dynamic_async(imgs[i], mat,
                                                      (180, 308))
            for key in [key for key in got if key[1] % 2 == k]:
                got[key] = got[key].result()
        except Exception as e:      # surfaces in the main thread below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for i in range(len(imgs)):
        np.testing.assert_array_equal(got["sr", i], want_sr[i])
        for x, y in zip(want_w[i], got["w", i]):
            np.testing.assert_array_equal(y, x)


@pytest.mark.cuda
def test_on_card_cast_equals_host_cast(cuda_device):
    """The net and IMDN forms' input on the card (uint8 → float32 / 255,
    IEEE division) and the LUT form's (uint8 → int32) equal the host's
    casts bit for bit, for every uint8 value in either layout."""
    values = np.arange(256, dtype=np.uint8)
    img = np.stack([values.reshape(16, 16)] * 3, -1)       # HWC
    for pred in (serving_predictor("net_k4", cuda_device),
                 serving_predictor("lut", cuda_device)):
        chw = np.ascontiguousarray(img.transpose(2, 0, 1))
        want = pred._input(chw).cpu()
        u8 = torch.from_numpy(img).to(cuda_device).movedim(-1, -3)
        got = pred._cast(u8)
        assert got.is_contiguous() and got.dtype == want.dtype
        assert torch.equal(got.cpu(), want)
        assert torch.equal(pred._upload(img).cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["lut", "imdn"])
@pytest.mark.parametrize("call", ["upscale_dynamic_async",
                                  "warp_dynamic_async"])
def test_serving_spans_on_the_card(form, call, cuda_device):
    """Under the profiler on the card each request is one ``lerf.request``
    holding its lock, upload, stages, one ``lerf.resample`` and
    ``lerf.copy_down``, and one ``lerf.result`` holding ``lerf.wait``; the
    spans are host ranges only: no device activity carries a ``lerf.``
    name (a user annotation would be copied onto the device's track)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pred = serving_predictor(form, cuda_device)
    rng = np.random.RandomState(19)
    imgs = [rng.randint(0, 256, (45, 77, 3)).astype(np.uint8)
            for _ in range(3)]
    mat = jitter_matrix(6, (2.0, 2.0))
    send = {"upscale_dynamic_async": lambda img: pred.upscale_dynamic_async(
        img, 2.0, 2.0), "warp_dynamic_async": lambda img: pred
        .warp_dynamic_async(img, mat, (90, 154))}[call]
    send(imgs[0]).result()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        futs = [send(img) for img in imgs]
        for f in futs:
            f.result()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    assert not [e.name() for e in events if e.name().startswith("lerf.")
                and e.device_type() == DeviceType.CUDA]
    found = sorted(((e.name(), e.start_ns(), e.end_ns()) for e in events
                    if e.name().startswith("lerf.")),
                   key=lambda s: (s[1], -s[2]))
    names = [s[0] for s in found]
    for name in ("lerf.request", "lerf.upload", "lerf.stages",
                 "lerf.resample", "lerf.copy_down", "lerf.result",
                 "lerf.wait"):
        assert names.count(name) == 3, name
    parent = {"lerf.upload": "lerf.request", "lerf.stages": "lerf.request",
              "lerf.resample": "lerf.request",
              "lerf.copy_down": "lerf.request", "lerf.wait": "lerf.result",
              "lerf.request": None, "lerf.result": None}
    for name, s, e in found:
        holders = sorted((pe - ps, pn) for pn, ps, pe in found
                         if (pn, ps, pe) != (name, s, e)
                         and ps <= s and e <= pe)
        if name in parent:
            assert (holders[0][1] if holders else None) == parent[name], \
                name
    reqs = [s for s in found if s[0] == "lerf.request"]
    results = [s for s in found if s[0] == "lerf.result"]
    assert all(r[2] <= q[1] for r, q in zip(reqs, results))


# -- windows of output rows (the row-sharded paths' shards) ----------------

WINDOWS = ((0, 90), (0, 23), (23, 45), (45, 68), (68, 90), (7, 33), (89, 90))


def test_warp_rows_on_cpu_are_the_whole_calls_rows():
    """The plain twin of a K5 window is the host geometry's rows: on the
    CPU a window equals the same rows of the whole call, mask included."""
    from lerf_torch.ops.kernels.warp import WarpParams, steering_warp

    feat, codes = resize_inputs((3, 30, 41))
    params = WarpParams.create((30, 41), jitter_matrix(1, (3.0, 3.0)),
                               (90, 123))
    mask = torch.empty((90, 123), dtype=torch.bool)
    whole = steering_warp(feat, codes, params, mask_out=mask)
    for r0, r1 in WINDOWS:
        m = torch.empty((r1 - r0, 123), dtype=torch.bool)
        got = steering_warp(feat, codes, params, mask_out=m, rows=(r0, r1))
        assert torch.equal(got.isnan(), whole[:, r0:r1].isnan())
        assert torch.equal(torch.nan_to_num(got),
                           torch.nan_to_num(whole[:, r0:r1]))
        assert torch.equal(m, mask[r0:r1])
    with pytest.raises(ValueError, match="rows"):
        steering_warp(feat, codes, params, rows=(50, 91))


@pytest.mark.cuda
@pytest.mark.parametrize("support", [2, 4])
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("floats", [False, True], ids=["int32", "float"])
def test_warp_window_bit_equal_to_whole_launch(floats, linear, support,
                                               cuda_device):
    """K5 on a window of output rows: each window (and its mask) is
    ``torch.equal`` to the same rows of the whole launch."""
    from lerf_torch.ops.kernels.warp import WarpParams, steering_warp

    feat, codes = (t.to(cuda_device) for t in resize_inputs((3, 30, 41)))
    if floats:
        feat, codes = feat.float(), codes.float() / 255.0
    codes = codes[..., :1] if linear else codes
    params = WarpParams.create((30, 41), jitter_matrix(1, (3.0, 3.0)),
                               (90, 123), support=support)
    mask = torch.empty((90, 123), dtype=torch.bool, device=cuda_device)
    whole = steering_warp(feat, codes, params, linear=linear, mask_out=mask)
    for r0, r1 in WINDOWS:
        m = torch.empty((r1 - r0, 123), dtype=torch.bool, device=cuda_device)
        got = steering_warp(feat, codes, params, linear=linear, mask_out=m,
                            rows=(r0, r1))
        assert torch.equal(got.isnan(), whole[:, r0:r1].isnan())
        assert torch.equal(torch.nan_to_num(got),
                           torch.nan_to_num(whole[:, r0:r1]))
        assert torch.equal(m, mask[r0:r1])


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [4.0, 2.5, 3.55, 0.5])
def test_resize_window_bit_equal_to_whole_launch(scale, cuda_device):
    """K1 on ``ResizeOperands.rows_window``: each window ``torch.equal`` to
    the same rows of the whole launch, int32 codes and float maps."""
    feat, codes = (t.to(cuda_device) for t in resize_inputs())
    geom = ResizeGeometry.create((45, 77), scale_factors=[scale] * 2)
    ops = k1.ResizeOperands.create(geom, cuda_device)
    oh = geom.out_sz[0]
    for f, c in ((feat, codes), (feat.float(), codes.float() / 255.0)):
        whole = k1.steering_resize(f, c, geom, operands=ops)
        for r0, r1 in ((0, oh), (0, oh // 3), (oh // 3, oh), (1, 2)):
            got = k1.steering_resize(f, c, geom.rows(r0, r1),
                                     operands=ops.rows_window(r0, r1))
            assert torch.equal(got, whole[:, r0:r1])


@pytest.mark.cuda
def test_sharded_lut_on_one_card_bit_equal_to_predictor(cuda_device):
    """``sharded_lut_sr_pipeline`` and ``sharded_lut_warp_pipeline`` on
    ``[cuda:0] * 2`` bit-equal to ``LutPredictor.upscale`` / ``.warp`` on
    the card (the uint8 frame, and the mask)."""
    from lerf_torch.ops.kernels.warp import WarpParams
    from lerf_torch.parallel import (make_mesh, sharded_lut_sr_pipeline,
                                     sharded_lut_warp_pipeline)
    from lerf_torch.pipeline import LutPredictor

    pred = LutPredictor(random_bank(), device=cuda_device)
    frame = np.random.RandomState(4).randint(0, 256, (30, 44, 3)) \
        .astype(np.uint8)
    x = torch.from_numpy(np.ascontiguousarray(frame.transpose(2, 0, 1))
                         .astype(np.int32)).to(cuda_device)
    mesh = make_mesh(devices=["cuda:0"] * 2)
    geom = ResizeGeometry.create((30, 44), scale_factors=[4.0, 4.0])
    got = sharded_lut_sr_pipeline(x, pred._s1, pred._s2, MODES, geom, mesh,
                                  out_dtype=torch.uint8)
    np.testing.assert_array_equal(got.to_host().transpose(1, 2, 0),
                                  pred.upscale(frame, 4.0, 4.0))
    matrix = jitter_matrix(2, (3.0, 3.0))
    frame_w, mask = sharded_lut_warp_pipeline(
        x, pred._s1, pred._s2, MODES, WarpParams.create((30, 44), matrix,
                                                        (90, 132)),
        mesh, out_dtype=torch.uint8, mask=True)
    want, want_mask = pred.warp(frame, matrix, (90, 132))
    np.testing.assert_array_equal(frame_w.to_host().transpose(1, 2, 0), want)
    np.testing.assert_array_equal(mask.to_host(), want_mask)


@pytest.mark.cuda
def test_sharded_imdn_bf16_on_one_card(cuda_device):
    """The bf16 IMDN form sharded on ``[cuda:0] * 2``: bf16 planes through
    the all-gather, K1 / K5 bf16 on each shard's window (one launch a
    shard), each window bit-equal to the whole launch on the gathered
    planes; the frame within the bf16 form's gate of ``upscale`` (cuDNN
    may pick another algorithm for a band's shape)."""
    from lerf_torch.models.imdn import IMDN2
    from lerf_torch.ops.kernels.warp import WarpParams
    from lerf_torch.parallel import (imdn_stages_sharded, make_mesh,
                                     sharded_imdn_sr_pipeline,
                                     sharded_imdn_warp_pipeline)

    model = IMDN2(nf=12, dtype=torch.bfloat16)
    model.load_state_dict(imdn_model().state_dict())
    frame = np.random.RandomState(5).randint(0, 256, (96, 40, 3)) \
        .astype(np.uint8)
    x = torch.from_numpy(np.ascontiguousarray(frame.transpose(2, 0, 1))
                         .astype(np.float32)).to(cuda_device)
    mesh = make_mesh(devices=["cuda:0"] * 2)
    geom = ResizeGeometry.create((96, 40), scale_factors=[2.5, 2.5])
    feat, hyper = imdn_stages_sharded(x, model, mesh, dtype=torch.bfloat16)
    assert feat.dtype == torch.bfloat16 and hyper.dtype == torch.bfloat16
    before = k1.bf16_launches
    got = sharded_imdn_sr_pipeline(x, model, geom, mesh, dtype=torch.bfloat16,
                                   out_dtype=torch.uint8)
    assert k1.bf16_launches == before + 2
    whole = k1.steering_resize(feat.cat(), hyper.cat(), geom,
                               out_dtype=torch.uint8)
    assert torch.equal(got.cat(), whole)
    pred = NetPredictor.from_imdn(model, device=cuda_device)
    d = np.abs(got.to_host().transpose(1, 2, 0).astype(int)
               - pred.upscale(frame, 2.5, 2.5).astype(int))
    assert d.max() <= 33 and (d > 0).mean() <= 0.59
    warp = WarpParams.create((96, 40), jitter_matrix(1, (2.0, 2.0)),
                             (192, 80))
    got, mask = sharded_imdn_warp_pipeline(x, model, warp, mesh,
                                           dtype=torch.bfloat16,
                                           out_dtype=torch.uint8, mask=True)
    whole = k5.steering_warp(feat.cat(), hyper.cat(), warp,
                             out_dtype=torch.uint8)
    assert torch.equal(got.cat(), whole)
    np.testing.assert_array_equal(mask.to_host(), warp.host_mask())


# -- K5's rings instance: the warp's geometry as data ---------------------------

RINGS_SHAPE, RINGS_OUT = (3, 45, 77), (112, 192)


def distortion_grid(in_sz, out_sz, shuffled=False):
    """A smooth barrel distortion of the ×(out / in) zoom as [oH, oW] row
    and column coordinates clipped to [0, in] (``WarpOperands.from_grid``'s
    input, no homography); ``shuffled``: its output rows in a seeded random
    order, so that a block's windows lie far apart (the direct path)."""
    (h, w), (oh, ow) = in_sz, out_sz
    ys, xs = np.meshgrid(np.arange(oh, dtype=np.float64),
                         np.arange(ow, dtype=np.float64), indexing="ij")
    u, v = (ys - (oh - 1) / 2) / oh, (xs - (ow - 1) / 2) / ow
    k = 1.0 + 0.35 * (u * u + v * v)
    gx = ((oh - 1) / 2 + (ys - (oh - 1) / 2) * k) * h / oh
    gy = ((ow - 1) / 2 + (xs - (ow - 1) / 2) * k) * w / ow
    gx, gy = gx.clip(0, h), gy.clip(0, w)
    if shuffled:
        order = np.random.RandomState(4).permutation(oh)
        gx, gy = gx[order], gy[order]
    return gx, gy


def rings_inputs(pair, linear, device, shape=RINGS_SHAPE, seed=12):
    """Stage outputs of one ``k1.IN_TYPES`` pair: int32 feature and codes,
    or a feature and maps in [0, 1] (code / 255) of the pair's types."""
    rng = np.random.RandomState(seed)
    feat = rng.randint(0, 256, shape).astype(np.int32)
    codes = rng.randint(0, 256, shape + (1 if linear else 3,)).astype(np.int32)
    f, c = torch.from_numpy(feat), torch.from_numpy(codes)
    if pair != "int32":
        ft, ct = {"float32": (torch.float32, torch.float32),
                  "bf16": (torch.bfloat16, torch.bfloat16),
                  "mixed": (torch.float32, torch.bfloat16),
                  "bf16_feat": (torch.bfloat16, torch.float32)}[pair]
        f, c = (f.float() / 255).to(ft), (c.float() / 255).to(ct)
    return f.to(device), c.to(device)


def same(a, b):
    return torch.equal(torch.nan_to_num(a.float(), nan=-1.0),
                       torch.nan_to_num(b.float(), nan=-1.0))


def grid_rings(shuffled, linear, shape=RINGS_SHAPE, out_sz=RINGS_OUT,
               dtype=np.float32):
    gx, gy = distortion_grid(shape[1:], out_sz, shuffled)
    return warp_rings(WarpOperands.from_grid(gx, gy, shape[1:], out_sz),
                      linear=linear, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("rings_t", ["float32", "bf16"])
@pytest.mark.parametrize("grid", ["smooth", "shuffled"])
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("pair", ["int32", "float32", "bf16", "mixed",
                                  "bf16_feat"])
def test_warp_rings_kernel_equals_twin(pair, linear, grid, rings_t,
                                       cuda_device):
    """Every input pair, both modes, under float32 and bf16 rings, on a
    smooth grid (every block on the tile) and a shuffled one (about half
    the blocks' footprints exceed the tile: the direct path):
    ``torch.equal`` to the twin on the card, float32 and uint8 (bf16 maps
    under float32 rings: the widened instance; a float32 feature with bf16
    maps and a bf16 feature with float32 maps take float32 weights on the
    rings' own distances under either rings type)."""
    rings = grid_rings(grid == "shuffled", linear,
                       dtype=torch.bfloat16 if rings_t == "bf16"
                       else np.float32)
    feat, codes = rings_inputs(pair, linear, cuda_device)
    before = (k5.launches, k5.rings_launches, k5.bf16_launches,
              k5.bf16_feature_launches)
    got = k5.steering_warp_rings(feat, codes, rings, out_sz=RINGS_OUT,
                                 linear=linear)
    got_u8 = k5.steering_warp_rings(feat, codes, rings, out_sz=RINGS_OUT,
                                    linear=linear, out_dtype=torch.uint8)
    torch.cuda.synchronize()
    bf16 = int(codes.dtype == torch.bfloat16)
    bf16_feat = int(pair == "bf16_feat")
    assert (k5.launches, k5.rings_launches, k5.bf16_launches,
            k5.bf16_feature_launches) == (
        before[0] + 2, before[1] + 2, before[2] + 2 * bf16,
        before[3] + 2 * bf16_feat)
    want = k5.steering_warp_rings_plain(feat, codes, rings, linear=linear)
    assert got.dtype == torch.float32 and got.shape == (3,) + RINGS_OUT
    assert same(got, want.reshape(got.shape))
    assert torch.equal(got_u8, quantize_device(got, 255, nan_to_zero=True))
    direct = k5.rings_footprint_entries(
        rings, RINGS_SHAPE[1:], RINGS_OUT, RINGS_SHAPE[0]) > k5.TILE_ENTRIES
    # the shuffled grid's launch mixes both paths
    assert (0.3 < direct.mean() < 0.7) if grid == "shuffled" \
        else not direct.any()


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("case", ["3x7x9", "border", "rotation", "minify16",
                                  "pad1"])
def test_warp_rings_kernel_equals_matrix_instance(case, linear, cuda_device):
    """Under a homography the rings instance, on the host's rings, is K5's
    matrix instance bit for bit."""
    matrix, shape, out_sz = WARP_CASES[case]
    feat, codes, _, params = warp_case(case, cuda_device)
    codes = codes[..., :1].contiguous() if linear else codes
    rings, _ = warp_serving_host_fused(shape[1:], matrix, out_sz,
                                       linear=linear, native=False)
    got = k5.steering_warp_rings(feat, codes, rings, out_sz=out_sz,
                                 linear=linear, out_dtype=torch.uint8)
    want = k5.steering_warp(feat, codes, params, linear=linear,
                            out_dtype=torch.uint8)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", ["int32", "bf16", "bf16_rings"])
def test_warp_rings_kernel_reads_both_pad_rows(pair, cuda_device):
    """Ring values 0 and H + 1 (W + 1): the pad past each edge, as the
    twin reads it, through the tile and the direct path (bf16 maps under
    float32 rings, the widened instance, and under bf16 rings)."""
    _, h, w = shape = (3, 7, 9)
    feat, codes = rings_inputs(pair.split("_")[0], False, cuda_device,
                               shape)
    rng = np.random.RandomState(3)
    n = 40 * 24
    for ring_x, ring_y in (
            (np.r_[0, 0, np.arange(1, h + 1), h + 1, h + 1],
             np.r_[0, 0, np.arange(1, w + 1), w + 1, w + 1]),
            (rng.randint(0, h + 2, h + 4), rng.randint(0, w + 2, w + 4))):
        rings = WarpRings(ring_x.astype(np.int32), ring_y.astype(np.int32),
                          rng.randint(0, (h + 3) * (w + 3), n)
                          .astype(np.int32),
                          rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32),
                          rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32))
        if pair == "bf16_rings":
            rings = rings._replace(
                dis_x=torch.from_numpy(rings.dis_x).bfloat16(),
                dis_y=torch.from_numpy(rings.dis_y).bfloat16())
        got = k5.steering_warp_rings(feat, codes, rings, out_sz=(40, 24))
        want = k5.steering_warp_rings_plain(feat, codes, rings)
        torch.cuda.synchronize()
        assert same(got, want.reshape(got.shape))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["3x7x9", "border", "rotation", "main",
                                  "pad1", "minify16"])
def test_warp_rings_on_device_equals_host_rings(case, cuda_device):
    """One launch of the rings geometry kernel, counted; its rings equal
    to the host's and to its plain twin run on the card."""
    from lerf_torch.ops.geometry import warp_rings_operands_plain

    matrix, shape, out_sz = WARP_CASES[case]
    inv = torch.from_numpy(np.linalg.inv(matrix)).to(cuda_device)
    before = k5.rings_geometry_launches
    got = warp_rings_on_device(inv, shape[1:], out_sz)
    torch.cuda.synchronize()
    assert k5.rings_geometry_launches == before + 1
    want = warp_rings(WarpOperands.create(shape[1:], matrix, out_sz))
    twin = warp_rings_operands_plain(np.linalg.inv(matrix), shape[1:],
                                     out_sz, cuda_device)
    for name, a, b, c in zip(want._fields[:5], got[:5], want[:5], twin):
        assert a.device.type == "cuda" and c.device.type == "cuda", name
        assert torch.equal(a.cpu(), torch.from_numpy(b)), name
        assert torch.equal(a, c), name


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_warp_rings_bf16_maps_follow_the_rings_type(linear, cuda_device):
    """The rings warps on bf16 maps, as lerf_tpu promotes them: under
    float32 rings a float32 output, K5's matrix instance on the feature
    widened to float32 beside the bf16 maps; under bf16 rings its bf16
    instance, a bf16 output (the linear mode's float32, as its float32
    branch masks promote it)."""
    from lerf_torch.ops.resample import amplified_linear_warp_rings

    matrix, shape, out_sz = WARP_CASES["rotation"]
    feat, codes = rings_inputs("bf16", linear, cuda_device, shape)
    params = k5.WarpParams.create(shape[1:], matrix, out_sz)
    maps = [codes[..., k] for k in range(codes.shape[-1])]
    for dtype, want_feat in ((np.float32, feat.float()),
                             (torch.bfloat16, feat)):
        rings, _ = warp_serving_host_fused(shape[1:], matrix, out_sz,
                                           linear=linear, dtype=dtype)
        warp = (amplified_linear_warp_rings if linear
                else steering_gaussian_warp_rings)
        got = warp(feat, *maps, rings, out_sz=out_sz)
        want = k5.steering_warp(want_feat, codes, params, linear=linear)
        torch.cuda.synchronize()
        # the linear mode's float32 branch masks promote its output
        assert got.dtype == (torch.bfloat16 if dtype is torch.bfloat16
                             and not linear else torch.float32)
        assert same(got, want)


# (feature / maps pair, rings type) of each in_type of the rings entry:
# int32, float32, bf16 under bf16 rings, a float32 feature with bf16 maps
# (under either rings type), bf16 under float32 rings (the widened
# instance), a bf16 feature with float32 maps (under either rings type)
RINGS_IN_TYPES = {"int32": ("int32", np.float32),
                  "float32": ("float32", np.float32),
                  "bf16": ("bf16", torch.bfloat16),
                  "mixed": ("mixed", np.float32),
                  "mixed_bf16_rings": ("mixed", torch.bfloat16),
                  "bf16_wide": ("bf16", np.float32),
                  "bf16_feat": ("bf16_feat", np.float32),
                  "bf16_feat_bf16_rings": ("bf16_feat", torch.bfloat16)}


def persistent_blocks(device):
    """The rings instance's persistent blocks on the card (its grid for an
    output of more tiles than it holds)."""
    return k5.rings_grid((16 * 4096, 32), device)


def pad_rings(linear, dtype, out_sz=(48, 64)):
    """Rings whose windows read both pad rows and columns: ring maps with
    0 and H + 1 (W + 1) at both ends, and per 16 x 32 tile the corners at
    the top-left pads, at the bottom-right ones, or both (by tile); random
    distances, and in the linear mode their branch masks."""
    _, h, w = RINGS_SHAPE
    rng = np.random.RandomState(5)
    n = out_sz[0] * out_sz[1]
    ii, jj = np.meshgrid(np.arange(out_sz[0]), np.arange(out_sz[1]),
                         indexing="ij")
    kind = ((ii // 16 + jj // 32) % 3).ravel()
    kind = np.where(kind == 2, rng.randint(0, 2, n), kind)
    cx = np.where(kind == 0, rng.randint(0, 2, n),
                  rng.randint(h + 1, h + 3, n))
    cy = np.where(kind == 0, rng.randint(0, 2, n),
                  rng.randint(w + 1, w + 3, n))
    dis = [rng.uniform(-1.5, 1.5, (n, 2)) for _ in range(2)]
    rings = WarpRings(
        np.r_[0, 0, np.arange(1, h + 1), h + 1, h + 1].astype(np.int32),
        np.r_[0, 0, np.arange(1, w + 1), w + 1, w + 1].astype(np.int32),
        (cx * (w + 3) + cy).astype(np.int32),
        *[d.astype(np.float32) for d in dis])
    if linear:
        def masks(d):
            return (((-1 <= d) & (d < 0)).astype(np.float32),
                    ((0 <= d) & (d <= 1)).astype(np.float32))
        rings = rings._replace(masks_x=masks(dis[0]), masks_y=masks(dis[1]))
    if dtype is torch.bfloat16:
        rings = rings._replace(
            dis_x=torch.from_numpy(rings.dis_x).bfloat16(),
            dis_y=torch.from_numpy(rings.dis_y).bfloat16())
    return rings, out_sz


def edge_rings(case, linear, dtype, blocks):
    """The rings and output size of one of the persistent kernel's edge
    cases (``test_warp_rings_pipeline_edges``); ``blocks``: its grid."""
    if case == "pads":
        return pad_rings(linear, dtype)
    _, h, w = RINGS_SHAPE
    out_sz = {"unaligned_rows": (32, 61), "ragged_tiles": (37, 70),
              "one_tile": (16, 32), "grid_plus_one": (16, 32 * (blocks + 1)),
              "alternating": (64, 32 * blocks)}[case]
    # the x4 zoom of the image's top-left part for the small frames, the
    # whole image for the wide ones
    small = case in ("unaligned_rows", "ragged_tiles", "one_tile")
    gx, gy = distortion_grid((out_sz[0] / 4, out_sz[1] / 4) if small
                             else (h, w), out_sz)
    if case == "alternating":
        # block b walks tiles (0, b), (1, b), (2, b), (3, b): the odd tile
        # rows' outputs read the whole image (the direct path)
        rng = np.random.RandomState(6)
        wide = np.zeros(out_sz, bool)
        wide[16:32] = wide[48:64] = True
        gx, gy = gx.copy(), gy.copy()
        gx[wide] = rng.uniform(0, h, wide.sum())
        gy[wide] = rng.uniform(0, w, wide.sum())
    return warp_rings(WarpOperands.from_grid(gx, gy, (h, w), out_sz),
                      linear=linear, dtype=dtype), out_sz


@pytest.mark.cuda
@pytest.mark.parametrize("in_type", sorted(RINGS_IN_TYPES))
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("case", ["unaligned_rows", "ragged_tiles",
                                  "one_tile", "grid_plus_one",
                                  "alternating", "pads"])
def test_warp_rings_pipeline_edges(case, linear, in_type, cuda_device):
    """The persistent rings kernel's edges, ``torch.equal`` to the twin on
    the card, float32 and uint8, for every in_type and both modes: an odd
    OW (rows whose rings start off a 16-byte boundary), ragged tiles (OH %
    16, OW % 32), a frame of one tile, one tile more than the persistent
    grid, tiles that alternate between the shared and the direct path in
    each block's walk, and windows on both pad rows and columns, through
    the shared and the direct path."""
    pair, dtype = RINGS_IN_TYPES[in_type]
    feat, codes = rings_inputs(pair, linear, cuda_device)
    blocks = persistent_blocks(cuda_device)
    rings, out_sz = edge_rings(case, linear, dtype, blocks)
    got = k5.steering_warp_rings(feat, codes, rings, out_sz=out_sz,
                                 linear=linear)
    got_u8 = k5.steering_warp_rings(feat, codes, rings, out_sz=out_sz,
                                    linear=linear, out_dtype=torch.uint8)
    want = k5.steering_warp_rings_plain(feat, codes, rings, linear=linear)
    torch.cuda.synchronize()
    assert same(got, want.reshape(got.shape))
    assert torch.equal(got_u8, quantize_device(got, 255, nan_to_zero=True))
    tiles = (-(-out_sz[0] // 16)) * (-(-out_sz[1] // 32))
    if case == "grid_plus_one":
        assert tiles == blocks + 1
    direct = k5.rings_footprint_entries(
        rings, RINGS_SHAPE[1:], out_sz, RINGS_SHAPE[0]) > k5.TILE_ENTRIES
    if case == "alternating":
        assert not direct[0::2].any() and direct[1::2].all()
    elif case != "pads":
        assert not direct.any()
    else:
        assert direct.any() and not direct.all()


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_warp_rings_bits_view(offset, cuda_device):
    """The linear mode's branch bits as a view ``offset`` bytes into a
    larger buffer (as a shard's slab of them is): the words at either end
    of the array reach outside it, so the kernel loads those bytes alone;
    ``torch.equal`` to the same rings with their own bits tensor."""
    feat, codes = rings_inputs("int32", True, cuda_device)
    rings, out_sz = edge_rings("ragged_tiles", True, np.float32, 1)
    dr = k5.upload_rings(rings, cuda_device, linear=True)
    n = dr.bits.numel()
    buf = torch.full((n + 8,), 0xff, dtype=torch.uint8, device=cuda_device)
    buf[offset:offset + n] = dr.bits
    view = dr._replace(bits=buf[offset:offset + n])
    for out_dtype in (torch.float32, torch.uint8):
        want = k5.steering_warp_rings(feat, codes, dr, out_sz=out_sz,
                                      linear=True, out_dtype=out_dtype)
        got = k5.steering_warp_rings(feat, codes, view, out_sz=out_sz,
                                     linear=True, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert same(got, want)


@pytest.mark.cuda
def test_warp_rings_kernel_rejects_wrong_rings(cuda_device):
    from lerf_torch.ops.kernels import _build

    rings = grid_rings(False, False, (3, 7, 9), (13, 17))
    feat, codes = rings_inputs("int32", False, cuda_device, (3, 7, 9))
    short = rings._replace(ring_y=rings.ring_y[:-1])
    with pytest.raises(ValueError, match="ring_x"):
        k5.steering_warp_rings(feat, codes, short, out_sz=(13, 17))
    dev = k5.upload_rings(rings, cuda_device)
    with pytest.raises(ValueError, match="ring_x"):
        k5.steering_warp_rings(feat, codes, dev._replace(
            ring_x=dev.ring_x[:-1]), out_sz=(13, 17))
    with pytest.raises(ValueError, match="linear DeviceRings"):
        k5.steering_warp_rings(feat, codes[..., :1].contiguous(), dev,
                               out_sz=(13, 17), linear=True)
    out = torch.empty((3, 13, 17), device=cuda_device)
    args = [feat.data_ptr(), codes.data_ptr(), out.data_ptr(),
            dev.ring_x.data_ptr(), 7 + 4, dev.ring_y.data_ptr(), 9 + 4,
            dev.corner.data_ptr(), dev.dis_x.data_ptr(), dev.dis_y.data_ptr(),
            0, 3, 7, 9, 13, 17, 0, 10.0, 255.0, 0,
            torch.cuda.current_stream().cuda_stream, 0]
    lib = _build.library()
    assert lib.lerf_steering_warp_rings(*args) == 0
    for k, bad in ((4, 7 + 3), (6, 9 + 5)):
        wrong = list(args)
        wrong[k] = bad
        assert lib.lerf_steering_warp_rings(*wrong) != 0


@pytest.mark.cuda
def test_warp_rings_sharded_on_one_card(cuda_device):
    """The sharded rings warp on ``[cuda:0] × 2``, each shard its window of
    corners and distances, bit-equal to the rings warp unsharded."""
    from lerf_torch.parallel import make_mesh
    from lerf_torch.parallel.spatial import (
        steering_gaussian_warp_rings_sharded)

    rings = grid_rings(False, False)
    feat, codes = rings_inputs("int32", False, cuda_device)
    img = feat.float()
    maps = [codes[..., k].float() / 255 for k in range(3)]
    want = steering_gaussian_warp_rings(img, *maps, rings, u8_inputs=True)
    mesh = make_mesh(devices=["cuda:0"] * 2)
    for out_sz in (None, RINGS_OUT):
        before = k5.rings_launches
        got = steering_gaussian_warp_rings_sharded(img, *maps, rings, mesh,
                                                   out_sz=out_sz)
        assert k5.rings_launches == before + 2
        assert same(got.cat(), want)


@pytest.mark.cuda
def test_rings_grid_reads_the_kernels_block_count(cuda_device, monkeypatch):
    """The rings instance's persistent blocks an SM come from the library
    (``lerf_rings_blocks_per_sm``, which returns ``kRingsBlocks``): the
    value the source sets, the grid of a frame larger than it, and a
    library reporting another count changes the grid (nothing in Python
    restates it)."""
    import os
    import re

    from lerf_torch.ops.kernels import _build

    with open(os.path.join(_build.CSRC, "steering_warp.cu")) as f:
        blocks = int(re.search(r"constexpr int kRingsBlocks = (\d+);",
                               f.read()).group(1))
    assert k5.rings_blocks_per_sm() == blocks
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert persistent_blocks(cuda_device) == sms * blocks
    assert k5.rings_grid((16, 32 * 3), cuda_device) == 3
    monkeypatch.setattr(_build.library(), "lerf_rings_blocks_per_sm",
                        lambda: blocks + 2)
    assert persistent_blocks(cuda_device) == sms * (blocks + 2)


# the float pairs of the sharded float ops: (feature, maps) types
SHARDED_FLOAT_PAIRS = {"float32": (torch.float32, torch.float32),
                       "bf16": (torch.bfloat16, torch.bfloat16),
                       "mixed": (torch.float32, torch.bfloat16),
                       "bf16_feat": (torch.bfloat16, torch.float32)}


@pytest.mark.cuda
@pytest.mark.parametrize("pair", sorted(SHARDED_FLOAT_PAIRS))
@pytest.mark.parametrize("op", ["resize", "warp", "resize_rings",
                                "warp_rings"])
def test_sharded_float_ops_on_one_card(op, pair, cuda_device):
    """The four sharded float ops on ``[cuda:0] × 2`` for every float pair:
    the sources keep their types, each shard launches its pair's instance
    (one launch a shard), and the output, in lerf_tpu's type (bf16 where
    the feature and the maps are, and the rings warp's rings too), is
    bit-equal to the same kernel's unsharded launch."""
    from lerf_torch.ops.geometry import ResizeOperands as ServingOperands
    from lerf_torch.parallel import make_mesh
    from lerf_torch.parallel import spatial as sp

    ft, mt = SHARDED_FLOAT_PAIRS[pair]
    feat, hyper = float_inputs()
    feat, hyper = feat.to(cuda_device, ft), hyper.to(cuda_device, mt)
    maps = [hyper[..., k] for k in range(3)]
    hw = feat.shape[1:]
    mesh = make_mesh(devices=["cuda:0"] * 2)
    out_t = torch.bfloat16 if ft == mt == torch.bfloat16 else torch.float32
    mod = k5 if "warp" in op else k1
    if op == "resize":
        geom = ResizeGeometry.create(hw, scale_factors=[2.5, 2.5])
        want = k1.steering_resize(feat, hyper, geom)

        def call():
            return sp.steering_gaussian_resize_sharded(feat, *maps, geom,
                                                       mesh)
    elif op == "resize_rings":
        ops = ServingOperands.create(hw, scale_factors=[1.93, 2.0])
        want = k1.steering_resize_serving(feat, hyper, ops)

        def call():
            return sp.steering_gaussian_resize_rings_sharded(feat, *maps,
                                                             ops, mesh)
    elif op == "warp":
        params = k5.WarpParams.create(hw, jitter_matrix(0, (2.5, 2.5)),
                                      (112, 192))
        want = k5.steering_warp(feat, hyper, params)

        def call():
            return sp.steering_gaussian_warp_sharded(feat, *maps, params,
                                                     mesh)
    else:
        rings = grid_rings(False, False, dtype=torch.bfloat16
                           if mt == torch.bfloat16 else np.float32)
        want = k5.steering_warp_rings(feat, hyper, rings)

        def call():
            return sp.steering_gaussian_warp_rings_sharded(
                feat, *maps, rings, mesh, u8_inputs=False, out_sz=RINGS_OUT)
    before = mod.launches
    got = call()
    torch.cuda.synchronize()
    assert mod.launches == before + 2
    assert got.dtype == out_t
    assert same(got.cat(), want.reshape(got.shape))
