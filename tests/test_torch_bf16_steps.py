"""The operation order of K1's and K5's bf16 instances, emulated on the CPU.

The kernels (``lerf_torch/csrc/steering_resize.cu``, ``steering_warp.cu``)
run the plain twin's bf16 steps as native bf16 pair operations
(``__hmul2_rn``, ``__hadd2_rn``, ``__hsub2_rn``), each rounded once to
nearest even.  On the card each such step gives the twin's float32
operation rounded to bf16 bit for bit, over all 2^32 operand pairs and in
both lanes (``lerf_torch/tools/bf16_steps_exhaustive.cu``, a card test in
``test_torch_kernels.py``), so here a bf16 torch operation (float32, then
rounded) stands for each pair operation lane by lane.  What this module
holds is the rest of the design, which the card cannot show on a wrong
case alone: the pairing (K1: outputs 2k and 2k + 1 of a thread's row; K5:
a thread's rows i and i + 8; the window entries transposed into a pair a
field), the distances rounded to bf16 once a thread (float64 → float32 →
bf16; K1's antialias product with ``min_scale`` in bf16 rounded once more),
the order of the twelve steps, the sums (K1 and K5 at support 2 one
rounded bf16 add each; K5 at any other support float32 sums of rounded
products; the linear modes float32 after ``a x`` and ``lin(a, x)``), the
flush of K5's Gaussian weight on the float32 ``exp`` before its rounding
(below ``K_KEEP`` = 2^-126 - 2^-134), and the quotient.

Each emulation is held BIT-EQUAL to the port's plain twins
(``ops.resample.steering_gaussian_resize`` / ``amplified_linear_resize`` /
``steering_gaussian_warp`` / ``amplified_linear_warp`` on bf16 tensors)
and to lerf_tpu's bf16 resize and warp, NaN windows included, on ragged
shapes at ×4, ×2.5, ×0.5 and ×0.4 (antialiased, supports 4 and 5), and
the warp at supports 2 and 4 under two homographies, both weights.  The
exceptions are the warp's float32 sums at support 4, which the kernel
adds s-major, t-minor and the others in other orders: the port's linear
twin (``torch.sum``) within 1e-4 (measured: one float32 ulp on under 1 %
of values), and lerf_tpu's warp (XLA's reduce), the Gaussian's bf16
quotient within 1 bf16 ulp on at most 0.1 % of values and the linear
within 1e-4, the gates ``test_torch_imdn_bf16.py`` holds the plain warp
to.  Inputs: a feature in [0, 254] and maps in [0, 1] from numpy seeds,
rounded to bf16.  Torch runs on one thread (``one_torch_thread``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lerf_tpu.ops import geometry as jgeo
from lerf_tpu.ops import resample as jres

from lerf_torch.ops import geometry as tgeo
from lerf_torch.ops import resample as tres

BF = torch.bfloat16
MAX_SIGMA = 10.0
# K5's flush of its Gaussian weight, on the float32 exp e: bf16(e) <
# FLT_MIN exactly where e < 2^-126 - 2^-134 (the midpoint rounds to even,
# up to FLT_MIN)
K_KEEP = float.fromhex("0x1.fep-127")
F32_TINY = float(np.finfo(np.float32).tiny)
# lerf_tpu's warp at support 4 against the port's (float32 sums in another
# order): (bf16 ulps, share) of the Gaussian, the linear's float32 atol
GAUSS_S4_TOL = (1, 0.001)
LINEAR_S4_ATOL = 1e-4
MATRICES = {
    "zoom-jitter": np.array([[2.0, 0.1, 1.0], [0.05, 1.9, -1.0],
                             [1e-3, 2e-3, 1.0]]),
    "rotate": np.array([[1.6, -0.5, 6.0], [0.5, 1.6, -3.0],
                        [0.0, 0.0, 1.0]]),
}
SHAPES = [(3, 13, 17), (2, 9, 22)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small torch ops: one intra-op thread while the test workers
    share the cores, the count given back after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def inputs(shape, oc, seed=5):
    """A bf16 feature in [0, 254] and bf16 maps [C, H, W, oc] in [0, 1]."""
    rng = np.random.RandomState(seed)
    feat = torch.from_numpy((rng.rand(*shape) * 254).astype(np.float32))
    hyper = torch.from_numpy(rng.rand(*shape, oc).astype(np.float32))
    return feat.to(BF), hyper.to(BF)


def j(t):
    """A torch tensor as lerf_tpu's array of the same type."""
    a = jnp.asarray(t.to(torch.float32).numpy())
    return a.astype(jnp.bfloat16) if t.dtype == BF else a


def to_np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def assert_same(got, want):
    """Bit-equal, NaN where the other is NaN."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.nan_to_num(got), np.nan_to_num(want))


def assert_s4_close(got, want, linear):
    """lerf_tpu's warp at support 4: within its float32 sums' order."""
    got, want = to_np(got), to_np(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    got, want = np.nan_to_num(got), np.nan_to_num(want)
    if linear:
        np.testing.assert_allclose(got, want, rtol=0, atol=LINEAR_S4_ATOL)
        return

    def bits(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(BF) \
            .view(torch.int16).to(torch.int32).numpy()
    ulps = np.abs(bits(got) - bits(want))
    assert ulps.max() <= GAUSS_S4_TOL[0] \
        and (ulps > 0).mean() <= GAUSS_S4_TOL[1]


# -- the pair operations ------------------------------------------------------

def lanes(a, b):
    """A bf16 pair: lane 0 from ``a``, lane 1 from ``b`` (the last axis)."""
    return torch.stack([a, b], -1)


def lows(x, y):
    """``__lows2bfloat162``: (x.lo, y.lo)."""
    return lanes(x[..., 0], y[..., 0])


def highs(x, y):
    """``__highs2bfloat162``: (x.hi, y.hi)."""
    return lanes(x[..., 1], y[..., 1])


def dist_bf16(d64, m=None):
    """The kernels' distance: float64 → float32 (the device arrays, or
    K5's ``__double2float_rn``) → bf16, then K1's antialias product with
    the bf16 ``min_scale`` rounded once more."""
    d = torch.from_numpy(np.ascontiguousarray(d64)).to(torch.float32).to(BF)
    return d if m is None else d * m


def gauss_pair(p0, p1, dx, dy, flush):
    """``add_pair`` (K1) / ``weight_pair`` (K5): entries [..., 4] = (n, 2ρ,
    σx, σy) of lanes 0 and 1 transposed into pairs, the twelve steps, expf
    in float32 and one rounding (K5: flushed below ``K_KEEP`` first).
    Returns (w, n)."""
    lo0, hi0, lo1, hi1 = p0[..., :2], p0[..., 2:], p1[..., :2], p1[..., 2:]
    n, two_rho = lows(lo0, lo1), highs(lo0, lo1)
    sx, sy = lows(hi0, hi1), highs(hi0, hi1)
    a = sx * dx
    b = sy * dy
    xn = a * a
    yn = b * b
    xy = (a * sy) * dy
    e = ((xn - two_rho * xy) + yn) * -0.5
    w = torch.exp(e.to(torch.float32))
    if flush:
        w = torch.where(w < K_KEEP, torch.zeros_like(w), w)
    return w.to(BF), n


def linear_pair(alpha, dxy, bx, by):
    """The linear weight of one output: (α dx, α dy) one pair product, the
    branch values α x + 1 and 1 - α x one pair add each, picked per axis on
    the branch bits; clip and product in float32."""
    ax = lanes(alpha, alpha) * dxy
    neg, pos = ax + 1.0, 1.0 - ax

    def pick(bits, lane):
        zero = torch.zeros_like(neg[..., lane], dtype=torch.float32)
        return torch.where(torch.as_tensor((bits & 1) != 0),
                           neg[..., lane].to(torch.float32),
                           torch.where(torch.as_tensor((bits & 2) != 0),
                                       pos[..., lane].to(torch.float32),
                                       zero))
    return (torch.clamp(pick(bx, 0), min=0)
            * torch.clamp(pick(by, 1), min=0))


def entries(feat, hyper, pad_x, pad_y, linear):
    """The decoded window entries of the padded image [C, Hp, Wp, 4 or 2]
    in bf16, as the kernels decode them: the feature constant-padded, the
    maps decoded (h·2 - 1, 2ρ exact, h·max_sigma with max_sigma in bf16)
    and edge-padded."""
    ms = tres.in_type(MAX_SIGMA, BF)
    rho = hyper[..., 0] * 2.0 - 1.0
    planes = [rho] if linear else [rho * 2.0, hyper[..., 1] * ms,
                                   hyper[..., 2] * ms]
    fp = tres.pad2d(feat, pad_x, pad_y)
    return torch.stack([fp] + [tres.pad2d(p, pad_x, pad_y, "edge")
                               for p in planes], -1)


# -- K1 -------------------------------------------------------------------------

def k1_bf16(feat, hyper, geom: tgeo.ResizeGeometry, linear):
    """K1's bf16 instance, pair by pair: bf16 [C, OH, OW] (the Gaussian)
    or float32 (linear)."""
    C = feat.shape[0]
    OH, OW = geom.out_sz
    S = geom.support
    e = entries(feat, hyper, geom.pad_x, geom.pad_y, linear)
    # a thread's outputs 2k and 2k + 1: the lanes (an odd width's last
    # column repeats in lane 1 and is dropped)
    cols = np.minimum(np.arange(OW + OW % 2), OW - 1)
    c0, c1 = torch.from_numpy(cols[0::2]), torch.from_numpy(cols[1::2])
    fov_x = torch.from_numpy(geom.fov_x.astype(np.int64))
    fov_y = torch.from_numpy(geom.fov_y.astype(np.int64))
    m = tres.in_type(geom.min_scale, BF)
    if linear:
        m64 = geom.min_scale if geom.antialias else 1.0
        dx = dist_bf16(m64 * geom.dis_x)                   # [OH, S]
        dy = dist_bf16(m64 * geom.dis_y)                   # [OW, S]
        bx = tres.branch_bits(m64 * geom.dis_x).astype(np.int64)
        by = tres.branch_bits(m64 * geom.dis_y).astype(np.int64)
        wn = ws = torch.zeros(C, OH, OW, dtype=torch.float32)
        for s in range(S):
            for t in range(S):
                p = e.index_select(1, fov_x[:, s]) \
                    .index_select(2, fov_y[:, t])            # [C, OH, OW, 2]
                dxy = lanes(dx[:, s, None].expand(OH, OW),
                            dy[None, :, t].expand(OH, OW))
                w = linear_pair(p[..., 1], dxy, bx[:, s, None],
                                by[None, :, t])
                if geom.antialias:
                    w = m * w
                wn = wn + w * p[..., 0].to(torch.float32)
                ws = ws + w
        return wn / ws
    scale = m if geom.antialias else None
    dx = dist_bf16(geom.dis_x, scale)                      # [OH, S]
    dy = dist_bf16(geom.dis_y, scale)                      # [OW, S]
    wn = ws = torch.zeros(C, OH, len(c0), 2, dtype=BF)
    for s in range(S):
        rows = e.index_select(1, fov_x[:, s])
        dxp = lanes(dx[:, s], dx[:, s])[:, None]           # (dx, dx)
        for t in range(S):
            p0 = rows.index_select(2, fov_y[c0, t])
            p1 = rows.index_select(2, fov_y[c1, t])
            dyp = lanes(dy[c0, t], dy[c1, t])              # (dy_2k, dy_2k+1)
            w, n = gauss_pair(p0, p1, dxp, dyp, flush=False)
            if geom.antialias:
                w = lanes(torch.tensor(m, dtype=BF),
                          torch.tensor(m, dtype=BF)) * w
            wn = wn + w * n
            ws = ws + w
    return (wn / ws).reshape(C, OH, -1)[..., :OW]


# -- K5 -------------------------------------------------------------------------

def k5_bf16(feat, hyper, geom: tgeo.WarpGeometry, linear):
    """K5's bf16 instance, pair by pair: bf16 [C, OH, OW] (the Gaussian)
    or float32 (linear)."""
    C = feat.shape[0]
    OH, OW = geom.out_sz
    S = geom.support
    e = entries(feat, hyper, geom.pad_x, geom.pad_y, linear) \
        .reshape(C, -1, 2 if linear else 4)
    # a thread's rows i and i + 8 of a 16-row tile: the lanes (past the
    # bottom edge lane 1 repeats lane 0 and is not written)
    r0 = np.array([i for i in range(OH) if i % 16 < 8])
    r1 = np.where(r0 + 8 < OH, r0 + 8, r0)
    lin = torch.from_numpy(geom.lin_idx.astype(np.int64))  # [S, S, OH, OW]

    def at(rows, s, t):
        return e.index_select(1, lin[s, t][rows].reshape(-1)) \
            .reshape(C, len(rows), OW, -1)

    dxs = [lanes(dist_bf16(geom.dis_x[r0, :, s]),
                 dist_bf16(geom.dis_x[r1, :, s])) for s in range(S)]
    dys = [lanes(dist_bf16(geom.dis_y[r0, :, t]),
                 dist_bf16(geom.dis_y[r1, :, t])) for t in range(S)]
    if linear:
        bits_x = tres.branch_bits(geom.dis_x).astype(np.int64)
        bits_y = tres.branch_bits(geom.dis_y).astype(np.int64)
        wn = [torch.zeros(C, len(r0), OW) for _ in range(2)]
        ws = [torch.zeros(C, len(r0), OW) for _ in range(2)]
        for s in range(S):
            for t in range(S):
                for k, (rows, pick) in enumerate(((r0, lows),
                                                  (r1, highs))):
                    p = at(rows, s, t)
                    w = linear_pair(p[..., 1], pick(dxs[s], dys[t]),
                                    bits_x[rows, :, s], bits_y[rows, :, t])
                    wn[k] = wn[k] + w * p[..., 0].to(torch.float32)
                    ws[k] = ws[k] + w
        q = [wn[k] / ws[k] for k in range(2)]
    else:
        wn = ws = torch.zeros(C, len(r0), OW, 2, dtype=BF)
        wn32 = ws32 = torch.zeros(C, len(r0), OW, 2)
        for s in range(S):
            for t in range(S):
                w, n = gauss_pair(at(r0, s, t), at(r1, s, t), dxs[s], dys[t],
                                  flush=True)
                if S == 2:
                    wn = wn + w * n
                    ws = ws + w
                else:
                    wn32 = wn32 + (w * n).to(torch.float32)
                    ws32 = ws32 + w.to(torch.float32)
        if S != 2:
            wn, ws = wn32.to(BF), ws32.to(BF)
        q = [(wn / ws)[..., k] for k in range(2)]
    out = torch.empty(C, OH, OW, dtype=q[0].dtype)
    out[:, r1] = q[1]
    out[:, r0] = q[0]               # lane 0 wins where lane 1 repeats it
    return out


# -- the tests ------------------------------------------------------------------

def twin_resize(feat, hyper, geom, linear):
    if linear:
        return tres.amplified_linear_resize(feat, hyper[..., 0], geom)
    return tres.steering_gaussian_resize(
        feat, *(hyper[..., k] for k in range(3)), geom)


def jax_resize(feat, hyper, shape, scale, linear):
    jg = jgeo.ResizeGeometry.create(shape, scale_factors=[scale] * 2)
    if linear:
        return jres.amplified_linear_resize(j(feat), j(hyper[..., 0]), jg)
    return jres.steering_gaussian_resize(
        j(feat), *(j(hyper[..., k]) for k in range(3)), jg)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("scale", [4.0, 2.5, 0.5, 0.4])
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_k1_bf16_order_is_the_twins(linear, scale, shape):
    """K1's bf16 pairing and order equal the plain twin and lerf_tpu's
    bf16 resize bit for bit (×0.5 and ×0.4: antialiased, supports 4 and
    5, ``min_scale`` 0.4 no bf16 value)."""
    feat, hyper = inputs(shape, 1 if linear else 3)
    geom = tgeo.ResizeGeometry.create(shape[1:], scale_factors=[scale] * 2)
    got = k1_bf16(feat, hyper, geom, linear)
    want = twin_resize(feat, hyper, geom, linear)
    assert got.dtype == want.dtype == (torch.float32 if linear else BF)
    assert_same(got, want)
    assert_same(got, jax_resize(feat, hyper, shape[1:], scale, linear))


@pytest.mark.parametrize("support", [2, 4])
@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_k5_bf16_order_is_the_twins(linear, name, support):
    """K5's bf16 pairing (rows i and i + 8; a 21-row output leaves lane 1
    past the edge) and order equal the plain twin bit for bit, the NaN
    windows included, and so the uint8 frame under the validity mask
    (the linear mode at support 4: its float32 sums within
    ``LINEAR_S4_ATOL``, the twin's ``torch.sum`` adding them in another
    order); and lerf_tpu's bf16 warp (at support 4 within its float32
    sums' order)."""
    shape, out_sz = (3, 13, 17), (21, 30)
    feat, hyper = inputs(shape, 1 if linear else 3, seed=6)
    geom = tgeo.WarpGeometry.create(shape[1:], MATRICES[name], out_sz,
                                    support=support)
    jg = jgeo.WarpGeometry.create(shape[1:], MATRICES[name], out_sz,
                                  support=support)
    got = k5_bf16(feat, hyper, geom, linear)
    if linear:
        want = tres.amplified_linear_warp(feat, hyper[..., 0], geom)
        jax = jres.amplified_linear_warp(j(feat), j(hyper[..., 0]), jg)
    else:
        maps = [hyper[..., k] for k in range(3)]
        want = tres.steering_gaussian_warp(feat, *maps, geom)
        jax = jres.steering_gaussian_warp(j(feat), *map(j, maps), jg)
    assert got.dtype == want.dtype == (torch.float32 if linear else BF)
    if linear and support != 2:
        assert_s4_close(got, want, linear)
    else:
        assert_same(got, want)
    mask = tres.nearest_warp_mask(shape[1:], tgeo.WarpGeometry.create(
        shape[1:], MATRICES[name], out_sz, support=1), dtype=torch.uint8)
    assert 0 < int(mask.sum()) < mask.numel()
    if not linear or support == 2:
        assert torch.equal(
            tres.quantize_device(got.float(), 255, nan_to_zero=True) * mask,
            tres.quantize_device(want.float(), 255, nan_to_zero=True) * mask)
    if support == 2:
        assert_same(got, jax)
    else:
        assert_s4_close(got, jax, linear)


def test_k5_flush_threshold_is_the_bf16_flush():
    """``e < K_KEEP`` on the float32 exp is ``bf16(e) < FLT_MIN`` (the
    twin's flush of its bf16 weight), for every float32 in [0, 2^-125)
    and the NaNs."""
    step = 1 << 22
    for lo in range(0, 1 << 24, step):
        e = torch.arange(lo, lo + step, dtype=torch.int32) \
            .view(torch.float32)
        assert torch.equal(e < K_KEEP, e.to(BF) < F32_TINY)
    nan = torch.tensor([float("nan")])
    assert not bool(nan < K_KEEP) and not bool(nan.to(BF) < F32_TINY)
