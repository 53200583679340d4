"""The warp's geometry as data ("rings") against lerf_tpu on the CPU.

Same numpy-seeded inputs through both packages, 12×16 → 40×52 under three
homographies and two maps given as grids (``WarpOperands.from_grid``: a
smooth radial distortion, and the same with its output rows shuffled), and
12×16 → 37×61 (an odd width and a height off the card's 16-row tiles:
K5's rings instance's ragged tiles and unaligned rows) under one
homography and the radial grid.
Held bit-equal: ``WarpOperands``, ``warp_rings`` (both modes), the
validity mask, ``warp_serving_host`` and ``warp_serving_host_fused``
(numpy, and the C library at 1, 2 and 7 threads), the packed operand and
its split.  The rings warps: against lerf_tpu's within
``tests/test_torch_warp.py``'s tolerance (float32 ``exp`` differs by a few
ulp: atol 1e-3 with NaN patterns equal where the window's largest weight is
at least e^-50, a convex combination of the window or NaN below; uint8
frames equal but at .5 ties), and bit-equal to the port's own matrix warps
(float32, u8 codes, bf16) and to K5's rings twin.  Torch runs on one
thread (``one_torch_thread``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lerf_tpu.ops import geometry as jgeo
from lerf_tpu.ops import resample as jrs
from test_torch_kernels import distortion_grid
from test_torch_warp import (ATOL, assert_close_with_nans, count_ties,
                             jitter_matrix)

import lerf_torch.native as native
import lerf_torch.parallel as tp
from lerf_torch.lut.io import LUTBank
from lerf_torch.ops import geometry as tgeo
from lerf_torch.ops import resample as trs
from lerf_torch.ops.kernels import warp as k5

IN_SZ = (12, 16)
OUT_SZ = (40, 52)
MATRICES = {
    "jitter": jitter_matrix(0, (3.3, 3.25)),
    # output (0, 0) maps above and left of the image: pad0 = 1, and the
    # far side reaches distances of 2 (NaN windows under random codes)
    "pad1": np.array([[3.0, 0.1, 5.0], [0.05, 3.2, 4.0], [2e-3, 1e-3, 1.0]]),
    "rotate": np.array([[2.9, -0.8, 6.0], [0.8, 2.9, -4.0], [0.0, 0.0, 1.0]]),
}
GRIDS = ("radial", "shuffled")
# an odd width and a height off the 16-row tiles, at a case's map
RAGGED_OUT = (37, 61)
RAGGED = {"jitter_ragged": "jitter", "radial_ragged": "radial"}
CASES = sorted(MATRICES) + list(GRIDS) + sorted(RAGGED)


def base_of(case):
    """The map a case warps by (a matrix's name or a grid's)."""
    return RAGGED.get(case, case)


def out_of(case):
    return RAGGED_OUT if case in RAGGED else OUT_SZ


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU twins run many small torch ops; under the suite's
    workers a thread a core stalls them, so this module runs torch on one
    thread and gives the count back after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def radial_grid(shuffled=False, out_sz=OUT_SZ):
    """The card tests' barrel distortion at this file's sizes, and its
    row-shuffled form."""
    return distortion_grid(IN_SZ, out_sz, shuffled)


def operands(case):
    """(lerf_tpu's, the port's) WarpOperands of a case."""
    base, out_sz = base_of(case), out_of(case)
    if base in MATRICES:
        m = MATRICES[base]
        return (jgeo.WarpOperands.create(IN_SZ, m, out_sz),
                tgeo.WarpOperands.create(IN_SZ, m, out_sz))
    gx, gy = radial_grid(base == "shuffled", out_sz)
    return (jgeo.WarpOperands.from_grid(gx, gy, IN_SZ, out_sz),
            tgeo.WarpOperands.from_grid(gx, gy, IN_SZ, out_sz))


def stage_inputs(seed=0, c=3):
    """int feature and hyper codes, as the stages would produce them."""
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (c,) + IN_SZ).astype(np.int32),
            rng.randint(0, 256, (c,) + IN_SZ + (3,)).astype(np.int32))


def assert_rings_equal(got, want):
    for name, g, w in zip(trs.WarpRings._fields, got, want):
        if w is None:
            assert g is None, name
            continue
        for a, b in (zip(g, w) if isinstance(w, tuple) else [(g, w)]):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)


# -- geometry as data --------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_warp_operands_bit_equal(case):
    j, t = operands(case)
    assert (t.in_sz, t.out_sz, t.support) == (j.in_sz, j.out_sz, j.support)
    for f in ("ring_x", "ring_y", "corner", "dis_x", "dis_y"):
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_warp_operands_support_2_only():
    with pytest.raises(ValueError, match="support-2"):
        tgeo.WarpOperands.create(IN_SZ, MATRICES["jitter"], OUT_SZ,
                                 support=4)


@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("case", CASES)
def test_warp_rings_bit_equal(case, linear):
    j, t = operands(case)
    assert_rings_equal(trs.warp_rings(t, linear=linear),
                       jrs.warp_rings(j, linear=linear))


@pytest.mark.parametrize("case", CASES)
def test_warp_rings_bf16_bit_equal(case):
    """``dtype=torch.bfloat16`` (numpy has no bf16): the distances as bf16
    tensors, the values of lerf_tpu's ``dtype=jnp.bfloat16`` rings; the
    fused host precompute gives the same rings."""
    j, t = operands(case)
    got = trs.warp_rings(t, dtype=torch.bfloat16)
    want = jrs.warp_rings(j, dtype=jnp.bfloat16)
    assert trs.rings_dtype(got) == torch.bfloat16
    for f in ("dis_x", "dis_y"):
        np.testing.assert_array_equal(
            getattr(got, f).float().numpy(),
            np.asarray(getattr(want, f)).astype(np.float32), err_msg=f)
    if case in MATRICES:
        fused, _ = trs.warp_serving_host_fused(
            IN_SZ, MATRICES[case], OUT_SZ, dtype=torch.bfloat16)
        assert_rings_equal([a.float() if isinstance(a, torch.Tensor)
                            else a for a in fused[:5]],
                           [a.float() if isinstance(a, torch.Tensor)
                            else a for a in got[:5]])


@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_rings_out_dtype_is_the_plain_forms(linear):
    """The type the card's rings warp returns (``rings_out_dtype``) is the
    plain form's, for every feature, maps and rings type and the codes."""
    _, t_ops = operands("jitter")
    feat, codes = stage_inputs(seed=5)
    for rt in (np.float32, torch.bfloat16):
        rings = trs.warp_rings(t_ops, linear=linear, dtype=rt)
        for u8, ft, ht in ((True, torch.float32, torch.float32),
                           (False, torch.float32, torch.float32),
                           (False, torch.bfloat16, torch.bfloat16),
                           (False, torch.float32, torch.bfloat16),
                           (False, torch.bfloat16, torch.float32)):
            args = warp_args(feat, codes, u8, linear, "torch")
            args = [args[0].to(ft)] + [a.to(ht) for a in args[1:]]
            plain = rings_warp(trs, args, rings, u8, linear)
            assert trs.rings_out_dtype(args[0], args[1:], rings,
                                       linear=linear,
                                       u8_inputs=u8) == plain.dtype


def test_rings_dtype_takes_float32_and_bf16_only():
    _, t = operands("jitter")
    assert trs.rings_dtype(trs.warp_rings(t)) == torch.float32
    rings64 = trs.warp_rings(t, dtype=np.float64)
    with pytest.raises(ValueError, match="float32 or bf16"):
        trs.rings_dtype(rings64)
    feat, codes = stage_inputs()
    with pytest.raises(ValueError, match="float32 or bf16"):
        trs.steering_gaussian_warp_rings(
            *warp_args(feat, codes, True, False, "torch"), rings64,
            u8_inputs=True)


@pytest.mark.parametrize("case", CASES)
def test_mask_from_grid_bit_equal(case):
    base, out_sz = base_of(case), out_of(case)
    if base in MATRICES:
        gx, gy = tgeo._warp_grid(MATRICES[base], IN_SZ, out_sz)
    else:
        gx, gy = radial_grid(base == "shuffled", out_sz)
    np.testing.assert_array_equal(trs._mask_from_grid(gx, gy, IN_SZ),
                                  jrs._mask_from_grid(gx, gy, IN_SZ))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_warp_serving_host_bit_equal(name):
    (t_ops, t_mask), (j_ops, j_mask) = (
        mod.warp_serving_host(IN_SZ, MATRICES[name], OUT_SZ)
        for mod in (trs, jrs))
    np.testing.assert_array_equal(t_mask, j_mask)
    assert isinstance(t_ops, tgeo.WarpOperands)
    for f in ("ring_x", "ring_y", "corner", "dis_x", "dis_y"):
        np.testing.assert_array_equal(getattr(t_ops, f), getattr(j_ops, f))


@pytest.mark.parametrize("how", ["numpy", "native1", "native2", "native7"])
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_fused_host_precompute_bit_equal(name, linear, how, monkeypatch):
    """The fused sweep, numpy and the C library at 1, 2 and 7 threads,
    against lerf_tpu's numpy sweep and the separate passes."""
    if how != "numpy":
        monkeypatch.setenv("LERF_NATIVE_THREADS", how[len("native"):])
    m = MATRICES[name]
    rings, mask = trs.warp_serving_host_fused(
        IN_SZ, m, OUT_SZ, linear=linear, native=how != "numpy")
    want, want_mask = jrs.warp_serving_host_fused(IN_SZ, m, OUT_SZ,
                                                  linear=linear,
                                                  native=False)
    assert_rings_equal(rings, want)
    np.testing.assert_array_equal(mask, want_mask)
    assert_rings_equal(rings, trs.warp_rings(
        tgeo.WarpOperands.create(IN_SZ, m, OUT_SZ), linear=linear))
    np.testing.assert_array_equal(
        mask, trs.nearest_warp_mask_host(IN_SZ, m, OUT_SZ))


def test_native_threads_reads_its_variable(monkeypatch):
    monkeypatch.setenv("LERF_NATIVE_THREADS", "3")
    assert native.native_threads() == 3
    monkeypatch.delenv("LERF_NATIVE_THREADS")
    assert native.native_threads() >= 1


def test_get_warp_lib_builds_into_build_and_raises_without_a_compiler(
        monkeypatch, tmp_path):
    """The library lands under the repository's ``build/``; a compiler
    that cannot run (a fresh build key: the compiler is part of it) raises
    with what went wrong, and nothing falls back to numpy."""
    lib = native.get_warp_lib()
    path = native._library_path(native._compiler())
    assert lib._name == path and path.startswith(native.BUILD_ROOT)
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    assert native._library_path(native._compiler()) != path
    with pytest.raises(RuntimeError, match="no-such-cc"):
        native.get_warp_lib()
    with pytest.raises(RuntimeError, match="no-such-cc"):
        trs.warp_serving_host_fused(IN_SZ, MATRICES["jitter"], OUT_SZ)
    rings, _ = trs.warp_serving_host_fused(IN_SZ, MATRICES["jitter"],
                                           OUT_SZ, native=False)
    assert rings.corner.shape == (OUT_SZ[0] * OUT_SZ[1],)


def test_get_warp_lib_raises_with_the_compilers_output(monkeypatch,
                                                       tmp_path):
    cc = tmp_path / "cc"
    cc.write_text("#!/bin/sh\necho 'broken compiler here' >&2\nexit 3\n")
    cc.chmod(0o755)
    monkeypatch.setenv("CC", str(cc))
    with pytest.raises(RuntimeError, match="broken compiler here"):
        native.get_warp_lib()


# -- the packed operand ------------------------------------------------------


@pytest.mark.parametrize("u8", [True, False], ids=["u8", "float"])
def test_rings_planes_pack_and_split_match_lerf_tpu(u8):
    _, t_ops = operands("pad1")
    rings = trs.warp_rings(t_ops)
    feat, codes = stage_inputs(seed=2)
    hyper = codes.astype(np.float32) / np.float32(255.0)
    img = feat.astype(np.float32)
    maps = [hyper[..., k] for k in range(3)]
    t_planes = trs.gauss_rings_planes(
        torch.from_numpy(img), *map(torch.from_numpy, maps), max_sigma=10.0,
        u8_inputs=u8)
    j_planes = jrs.gauss_rings_planes(
        jnp.asarray(img), *map(jnp.asarray, maps), max_sigma=10.0,
        u8_inputs=u8)
    for a, b in zip(t_planes, j_planes):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    j_rings = jax.tree.map(jnp.asarray, jrs.warp_rings(operands("pad1")[0]))
    packed = trs.pack_rings_operand(t_planes, rings)
    want = jrs.pack_rings_operand(j_planes, j_rings)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want))
    rows = packed[torch.from_numpy(rings.corner.astype(np.int64))]
    for got_b, want_b in zip(trs.split_rings_rows(rows, 4, 3),
                             jrs.split_rings_rows(np.asarray(rows), 4, 3)):
        for a, b in zip(got_b, want_b):
            np.testing.assert_array_equal(a.numpy(), b)


# -- the rings warps ----------------------------------------------------------


def window_stats(rings, feat, codes):
    """Per output [C, N]: the largest weight of its window in float64 (the
    same decoded float32 hyper values) and the window's value range."""
    hyp = torch.from_numpy(codes).to(torch.float32) / 255.0
    r, sx, sy = trs.decode_gaussian_hyper(hyp[..., 0], hyp[..., 1],
                                          hyp[..., 2], 10.0)
    planes = [trs.pad2d(torch.from_numpy(feat).double(), (1, 1), (1, 1))] + [
        trs.pad2d(p.double(), (1, 1), (1, 1), "edge") for p in (r, sx, sy)]
    gathered = trs._rowpack_warp_gather_rings(planes, rings)
    dx = torch.from_numpy(rings.dis_x.astype(np.float64))
    dy = torch.from_numpy(rings.dis_y.astype(np.float64))
    w, x = [], []
    for b, (s, t) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        xv, rv, sxv, syv = gathered[b]
        w.append(trs.steering_gaussian_weight(rv, sxv, syv, dx[:, s:s + 1],
                                              dy[:, t:t + 1]))
        x.append(xv)
    w, x = torch.stack(w), torch.stack(x)
    return (w.amax(0).T.numpy(), x.amin(0).T.numpy(), x.amax(0).T.numpy())


def assert_rings_warp_matches(got, want, rings, feat, codes):
    """``tests/test_torch_warp.py``'s ``assert_warp_matches`` on [C, N]."""
    wmax, lo, hi = window_stats(rings, feat, codes)
    well = wmax >= np.exp(-50.0)
    assert_close_with_nans(got[well], want[well])
    gone = wmax < 2.0 ** -150
    assert np.isnan(got[gone]).all() and np.isnan(want[gone]).all()
    band = ~well & ~gone
    for v in (got, want):
        ok = np.isnan(v) | ((v >= lo - ATOL) & (v <= hi + ATOL))
        assert ok[band].all()
    assert well.mean() > 0.6, well.mean()


def quantized(x):
    return np.clip(np.round(np.nan_to_num(x, nan=0.0)), 0, 255) \
        .astype(np.uint8)


def warp_args(feat, codes, u8, linear, lib, bf16=False):
    """lerf_tpu's or the port's inputs: u8 integers, or a float feature
    with hyper maps code / 255 (``bf16``: both rounded to bf16)."""
    if u8:
        img, maps = feat, [codes[..., k] for k in range(3)]
    else:
        hyper = codes.astype(np.float32) / np.float32(255.0)
        img, maps = feat.astype(np.float32), [hyper[..., k]
                                              for k in range(3)]
    maps = maps[:1] if linear else maps
    if lib == "jax":
        def conv(a):
            return jnp.asarray(a, jnp.bfloat16) if bf16 else jnp.asarray(a)
    else:
        def conv(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.to(torch.bfloat16) if bf16 else t
    return [conv(img)] + [conv(m) for m in maps]


def rings_warp(mod, args, rings, u8, linear):
    if linear:
        return mod.amplified_linear_warp_rings(*args, rings, u8_inputs=u8)
    return mod.steering_gaussian_warp_rings(*args, rings, u8_inputs=u8)


@pytest.mark.parametrize("u8", [True, False, "bf16"],
                         ids=["u8", "float", "bf16"])
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("case", CASES)
def test_rings_warp_matches_lerf_tpu(case, linear, u8):
    """Float32 rings: u8 codes, float32 maps, and bf16 ones, which both
    packages decode in bf16 and then weight, sum and divide in float32
    (lerf_tpu promotes the bf16 maps against the float32 distances)."""
    bf16, u8 = u8 == "bf16", u8 is True
    j_ops, t_ops = operands(case)
    feat, codes = stage_inputs(seed=1)
    want = np.asarray(rings_warp(
        jrs, warp_args(feat, codes, u8, linear, "jax", bf16),
        jax.tree.map(jnp.asarray, jrs.warp_rings(j_ops, linear=linear)),
        u8, linear))
    rings = trs.warp_rings(t_ops, linear=linear)
    got = rings_warp(trs, warp_args(feat, codes, u8, linear, "torch", bf16),
                     rings, u8, linear).numpy()
    out_sz = out_of(case)
    assert got.dtype == np.float32 and got.shape == want.shape == (
        3, out_sz[0] * out_sz[1])
    if linear:      # no exponential: the same float32 operations
        assert_close_with_nans(got, want, atol=ATOL)
    else:
        assert_rings_warp_matches(got, want, rings, feat, codes)
    count_ties(quantized(got), quantized(want), np.nan_to_num(want, nan=0.0))
    if case == "pad1":
        assert np.isnan(want).any()      # the case holds NaN windows


# the pairs of one float32 and one bf16 input: (feature, maps) types
MIXED_PAIRS = {"f32_feat_bf16_maps": (torch.float32, torch.bfloat16),
               "bf16_feat_f32_maps": (torch.bfloat16, torch.float32)}


@pytest.mark.parametrize("rings_t", ["float32", "bf16"])
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("pair", sorted(MIXED_PAIRS))
def test_rings_warp_mixed_pairs_match_lerf_tpu(pair, linear, rings_t):
    """A float32 feature with bf16 maps and a bf16 feature with float32
    maps, under float32 and bf16 rings, both modes: lerf_tpu's packed
    operand is float32 wherever one plane is, so its weights, sums and
    output are float32 on the rings' own distances.  The port's rings
    warp (``ops.resample``), K5's rings wrapper and the sharded rings warp
    on a CPU mesh of 3 (Gaussian: lerf_tpu's sharded form takes that mode
    alone) return float32, the latter two bit-equal to the first, all
    within ``test_rings_warp_matches_lerf_tpu``'s tolerance of lerf_tpu's
    rings warp."""
    ft, mt = MIXED_PAIRS[pair]
    j_ops, t_ops = operands("jitter")
    feat, codes = stage_inputs(seed=4)
    args = warp_args(feat, codes, False, linear, "torch")
    args = [args[0].to(ft)] + [a.to(mt) for a in args[1:]]
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    jargs = [jnp.asarray(a.float().numpy(), jdt[a.dtype]) for a in args]
    bf16 = rings_t == "bf16"
    want = np.asarray(rings_warp(
        jrs, jargs, jax.tree.map(jnp.asarray, jrs.warp_rings(
            j_ops, linear=linear, dtype=jnp.bfloat16 if bf16 else np.float32)),
        False, linear))
    rings = trs.warp_rings(t_ops, linear=linear,
                           dtype=torch.bfloat16 if bf16 else np.float32)
    got = rings_warp(trs, args, rings, False, linear)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    codes_t = torch.stack(args[1:], -1)
    kern = k5.steering_warp_rings(args[0], codes_t, rings, linear=linear)
    assert torch.equal(torch.nan_to_num(kern, nan=-1.0),
                       torch.nan_to_num(got, nan=-1.0))
    if not linear:
        sharded = tp.steering_gaussian_warp_rings_sharded(
            *args, rings, tp.make_mesh(devices=["cpu"] * 3), u8_inputs=False,
            out_sz=OUT_SZ)
        assert sharded.dtype == torch.float32
        assert torch.equal(torch.nan_to_num(sharded.cat(), nan=-1.0),
                           torch.nan_to_num(got, nan=-1.0))
    got = got.numpy()
    if linear:
        assert_close_with_nans(got, want, atol=ATOL)
    else:
        assert_rings_warp_matches(got, want, trs.warp_rings(t_ops), feat,
                                  codes)


@pytest.mark.parametrize("dtype", ["u8", "float32", "bf16", "bf16_maps"])
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_rings_warp_bit_equal_to_matrix_warp(name, linear, dtype):
    """The rings warp through ``warp_serving_host_fused``'s rings is the
    port's matrix warp of the same homography, bit for bit, with out_sz.
    bf16 inputs: through bf16 rings, the bf16 matrix warp; through float32
    rings (``bf16_maps``), the matrix warp of the feature widened to
    float32 beside the bf16 maps, float32 weights either way."""
    m = MATRICES[name]
    rings, _ = trs.warp_serving_host_fused(
        IN_SZ, m, OUT_SZ, linear=linear,
        dtype=torch.bfloat16 if dtype == "bf16" else np.float32)
    geom = tgeo.WarpGeometry.create(IN_SZ, m, OUT_SZ)
    feat, codes = stage_inputs(seed=3)
    args = warp_args(feat, codes, dtype == "u8", linear, "torch")
    if dtype.startswith("bf16"):
        args = [a.to(torch.bfloat16) / (255 if k == 0 else 1)
                for k, a in enumerate(args)]
    margs = [args[0].float()] + args[1:] if dtype == "bf16_maps" else args
    kw = {"u8_inputs": dtype == "u8"}
    if linear:
        got = trs.amplified_linear_warp_rings(*args, rings, out_sz=OUT_SZ,
                                              **kw)
        want = trs.amplified_linear_warp(*margs, geom, **kw)
    else:
        got = trs.steering_gaussian_warp_rings(*args, rings, out_sz=OUT_SZ,
                                               **kw)
        want = trs.steering_gaussian_warp(*margs, geom, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(torch.nan_to_num(got.float(), nan=-1.0),
                       torch.nan_to_num(want.float(), nan=-1.0))


# -- K5's rings twin and wrapper on the CPU ---------------------------------


@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("case", CASES)
def test_rings_wrapper_takes_plain_twin_on_cpu(case, linear):
    """On CPU tensors ``steering_warp_rings`` is its twin; the int32 twin is
    the u8 rings warp, and under a homography K5's matrix twin."""
    _, t_ops = operands(case)
    rings = trs.warp_rings(t_ops, linear=linear)
    feat, codes = stage_inputs(seed=6)
    codes = codes[..., :1] if linear else codes
    ft, ct = torch.from_numpy(feat), torch.from_numpy(codes)
    got = k5.steering_warp_rings(ft, ct, rings, out_sz=out_of(case),
                                 linear=linear)
    twin = k5.steering_warp_rings_plain(ft, ct, rings, linear=linear)
    assert torch.equal(torch.nan_to_num(got, nan=-1.0),
                       torch.nan_to_num(twin.reshape(got.shape), nan=-1.0))
    u8 = rings_warp(trs, [ft] + [ct[..., k] for k in range(ct.shape[-1])],
                    rings, True, linear)
    assert torch.equal(torch.nan_to_num(twin, nan=-1.0),
                       torch.nan_to_num(u8, nan=-1.0))
    got_u8 = k5.steering_warp_rings(ft, ct, rings, linear=linear,
                                    out_dtype=torch.uint8)
    assert got_u8.dtype == torch.uint8 and torch.equal(
        got_u8, trs.quantize_device(twin, 255, nan_to_zero=True))
    if case in MATRICES:
        params = k5.WarpParams.create(IN_SZ, MATRICES[case], OUT_SZ)
        want = k5.steering_warp(ft, ct, params, linear=linear)
        assert torch.equal(torch.nan_to_num(got, nan=-1.0),
                           torch.nan_to_num(want, nan=-1.0))


def test_rings_wrapper_float_types_on_cpu():
    """Every float pair under either rings type: the twin is the float
    rings warp, equal to K5's matrix twin where their distances agree.
    bf16 maps beside a bf16 feature under float32 rings: the matrix twin
    of the feature widened (float32 weights), under bf16 rings its bf16
    twin; a bf16 feature beside float32 maps: under float32 rings the
    matrix twin of the feature widened, under bf16 rings the matrix twin
    itself (its distances in the feature's bf16); a float32 feature beside
    bf16 maps under bf16 rings: float32 weights on the bf16 distances
    widened, the same warp through float32 rings of those values.  A bf16
    feature beside int32 codes is no pair the wrapper takes."""
    _, t_ops = operands("jitter")
    rings = trs.warp_rings(t_ops)
    rings16 = trs.warp_rings(t_ops, dtype=torch.bfloat16)
    widened = rings16._replace(dis_x=rings16.dis_x.float().numpy(),
                               dis_y=rings16.dis_y.float().numpy())
    params = k5.WarpParams.create(IN_SZ, MATRICES["jitter"], OUT_SZ)
    feat, codes = stage_inputs(seed=7)
    f32 = torch.from_numpy(feat).float() / 255
    h32 = torch.from_numpy(codes).float() / 255
    f16, h16 = f32.bfloat16(), h32.bfloat16()

    def matrix(*args):
        return k5.steering_warp(*args, params)

    # (feature, maps, rings, what the wrapper's output must equal)
    for ft, ht, r, want in (
            (f32, h32, rings, matrix(f32, h32)),
            (f32, h16, rings, matrix(f32, h16)),
            (f16, h16, rings, matrix(f16.float(), h16)),
            (f16, h16, rings16, matrix(f16, h16)),
            (f16, h32, rings, matrix(f16.float(), h32)),
            (f16, h32, rings16, matrix(f16, h32)),
            (f32, h16, rings16, k5.steering_warp_rings(
                f32, h16, widened, out_sz=OUT_SZ))):
        got = k5.steering_warp_rings(ft, ht, r, out_sz=OUT_SZ)
        assert got.dtype == torch.float32
        assert torch.equal(torch.nan_to_num(got, nan=-1.0),
                           torch.nan_to_num(want, nan=-1.0))
    with pytest.raises(ValueError, match="one type"):
        k5.steering_warp_rings(f16, torch.from_numpy(codes), rings,
                               out_sz=OUT_SZ)


def test_rings_wrapper_rejects_wrong_rings():
    _, t_ops = operands("jitter")
    rings = trs.warp_rings(t_ops)
    feat, codes = (torch.from_numpy(a) for a in stage_inputs())
    short = rings._replace(ring_x=rings.ring_x[:-1])
    with pytest.raises(ValueError, match="ring_x"):
        k5.steering_warp_rings(feat, codes, short)
    with pytest.raises(ValueError, match="ring_x"):
        k5.steering_warp_rings(feat[:, :-1], codes[:, :-1], rings)
    with pytest.raises(ValueError, match="out_sz"):
        k5.steering_warp_rings(feat, codes, rings, out_sz=(OUT_SZ[0], 3))
    with pytest.raises(ValueError, match="linear=True"):
        k5.steering_warp_rings(feat, codes[..., :1], rings, linear=True)


def test_rings_read_both_pad_rows():
    """Ring values 0 and H + 1 (W + 1) read the ±1 pad: feature 0, the
    codes of the first or last row (column).  Outputs whose four
    neighbours all lie on the pad warp to 0 / Σ w = 0."""
    h, w = IN_SZ
    feat, codes = (torch.from_numpy(a) for a in stage_inputs(seed=8))
    n = 6
    for rx, ry in (([h + 1] * (h + 4), list(range(w + 4))),
                   ([0] * (h + 4), list(range(w + 4))),
                   (list(range(h + 4)), [w + 1] * (w + 4))):
        rings = trs.WarpRings(np.asarray(rx, np.int32),
                              np.asarray(ry, np.int32),
                              np.arange(n, dtype=np.int32) * 2,
                              np.full((n, 2), 0.25, np.float32),
                              np.full((n, 2), -0.5, np.float32))
        got = k5.steering_warp_rings_plain(feat, codes, rings)
        finite = torch.isfinite(got)
        assert finite.any() and (got[finite] == 0).all()


# -- the rings on the device, the packed bits, the sharded warp, LUTBank ----


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_warp_rings_on_device_cpu_is_the_host_rings(name):
    """On the CPU, from the inverse alone: the host's rings bit for bit
    (lerf_tpu's float32 rings are not), and lerf_tpu's own warp of them
    within the bound lerf_tpu holds its device rings to
    (``tests/test_dynamic_warp.py::test_warp_device_geometry_close_to_host``)."""
    m = MATRICES[name]
    inv = np.linalg.inv(m)
    got = trs.warp_rings_on_device(inv, IN_SZ, OUT_SZ)
    assert all(isinstance(a, torch.Tensor) for a in got[:5])
    assert got.masks_x is None
    host = trs.warp_rings(tgeo.WarpOperands.create(IN_SZ, m, OUT_SZ))
    assert_rings_equal([a.numpy() for a in got[:5]], host[:5])
    assert torch.equal(trs.warp_rings_on_device(torch.from_numpy(inv),
                                                IN_SZ, OUT_SZ).corner,
                       got.corner)
    feat, codes = stage_inputs(seed=9)
    args = warp_args(feat, codes, True, False, "jax")

    def warp(rings):
        return quantized(np.asarray(jrs.steering_gaussian_warp_rings(
            *args, jax.tree.map(jnp.asarray, rings), u8_inputs=True)))

    want = warp(jrs.warp_rings_on_device(jnp.asarray(inv, jnp.float32),
                                         IN_SZ, OUT_SZ))
    diff = np.abs(warp(jrs.WarpRings(*(a.numpy() for a in got[:5])))
                  .astype(int)
                  - want.astype(int))
    assert (diff > 1).mean() < 5e-3 and (diff != 0).mean() < 5e-2


def test_warp_rings_on_device_refuses_a_bucket_frame():
    with pytest.raises(ValueError, match="shape buckets"):
        trs.warp_rings_on_device(np.eye(3), IN_SZ, OUT_SZ, in_frame=(16, 16))


def test_branch_byte_is_the_windows_bit_layout():
    """The linear mode's bits on the card: each distance's two branch bits
    (negative bit 0, positive bit 1), rows from bit 0, columns from bit 4,
    as K5's ``Window`` reads them; equal to ``branch_bits`` of the
    distances."""
    _, t_ops = operands("pad1")
    rings = trs.warp_rings(t_ops, linear=True)
    got = k5._branch_byte(rings.masks_x, rings.masks_y)
    bx = trs.branch_bits(t_ops.dis_x).astype(np.int64)
    by = trs.branch_bits(t_ops.dis_y).astype(np.int64)
    want = bx[:, 0] | bx[:, 1] << 2 | by[:, 0] << 4 | by[:, 1] << 6
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)
    # CPU tensor masks pack the same, on the host
    np.testing.assert_array_equal(k5._branch_byte(
        [torch.from_numpy(m) for m in rings.masks_x],
        [torch.from_numpy(m) for m in rings.masks_y]), want)
    assert len(np.unique(want)) > 3


@pytest.mark.parametrize("rows", [False, True], ids=["flat", "out_sz"])
@pytest.mark.parametrize("n", [2, 3])
def test_rings_sharded_bit_equal_on_cpu_mesh(n, rows):
    """The sharded rings warp on a CPU mesh: each shard's slice of the
    corners and distances, bit-equal to the rings warp unsharded."""
    _, t_ops = operands("jitter")
    rings = trs.warp_rings(t_ops)
    feat, codes = stage_inputs(seed=10)
    img = torch.from_numpy(feat).float()
    maps = [torch.from_numpy(codes[..., k]).float() / 255 for k in range(3)]
    want = trs.steering_gaussian_warp_rings(img, *maps, rings,
                                            u8_inputs=True)
    got = tp.steering_gaussian_warp_rings_sharded(
        img, *maps, rings, tp.make_mesh(devices=["cpu"] * n),
        out_sz=OUT_SZ if rows else None)
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(np.nan_to_num(got.to_host(), nan=-1.0),
                                  np.nan_to_num(want.numpy(), nan=-1.0))


def test_lut_bank_lattice_size():
    bank = LUTBank(stage1={}, stage2={}, out_c=3)
    assert bank.lattice_size == 17
    assert LUTBank(stage1={}, stage2={}, out_c=3,
                   interval=3).lattice_size == 33
