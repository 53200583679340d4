"""The warp serving forms — ``warp_dynamic``, ``warp_device`` and
``warp_batch`` — and the validity mask from the inverse alone, the port
against lerf_tpu on the CPU, as ``tests/test_dynamic_warp.py`` and
``test_batch_serving.py`` pin lerf_tpu.

Tolerances: the validity mask exactly; every serving form against the
port's own ``warp`` exactly (on the CPU each takes K5's plain twin on a
host geometry made for the call, and PyTorch compiles nothing per shape or
matrix, so a serving form changes no value); against lerf_tpu's
``warp_dynamic`` (its own ``warp``, bit for bit) the LUT stages and the
mask exactly, uint8 frames equal but for .5 rounding ties, and the
micro-net forms' frames within one step on < 1 % of pixels (their stage
codes differ by one level on < 0.5 %, ``test_torch_net_pipeline.py``).
lerf_tpu's ``warp_device`` derives its geometry in float32 and is not its
own ``warp``: the port's (float64, K5's on a card) is held within the
bounds lerf_tpu holds its own to (``test_dynamic_warp.py:376-397``).

The lerf_tpu references run the LUT bank in its flat table layout, which
lerf_tpu holds bit-equal to its default packed layout and which XLA's CPU
backend compiles several times faster; torch runs on one thread here, as
in ``test_torch_sr_serving.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import shared_lut_predictor
from lerf_tpu.ops import resample as jrs
from lerf_tpu.pipeline import LutPredictor as JaxLutPredictor
from lerf_tpu.pipeline import NetPredictor as JaxNetPredictor
from test_torch_pipeline import port_of
from test_torch_srnet import np_params
from test_torch_warp import count_ties

from lerf_torch import pipeline
from lerf_torch.convert import lerf_nets_from_arrays
from lerf_torch.ops import geometry as tgeo
from lerf_torch.ops import resample as trs
from lerf_torch.ops.kernels import warp as k5
from lerf_torch.pipeline import NetPredictor

IN_SZ = (24, 32)
OUT_SZ = (40, 56)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU twins run many small torch ops; with one intra-op
    thread a core they stall whenever the test workers share the cores
    (80× slower under load), so this module runs torch on one thread and
    gives the count back after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def matrices():
    """Projective matrices over the quirk space at these sizes: pads 0 / 1
    a side, out-of-view regions (NaN windows), strong perspective, a pure
    zoom (zero pads) and random jitters."""
    rng = np.random.RandomState(3)
    mats = [
        np.array([[1.1, 0.02, 3.0], [0.01, 0.95, -2.0], [1e-4, 2e-5, 1.0]]),
        np.array([[0.7, -0.1, 10.0], [0.2, 1.3, -5.0], [5e-4, -2e-4, 1.0]]),
        np.diag([1.7, 1.7, 1.0]),
    ]
    for _ in range(3):
        mats.append(np.diag([1.7, 1.7, 1.0]) @ (
            np.eye(3) + rng.randn(3, 3) * np.array(
                [[.05, .05, 4.0], [.05, .05, 4.0], [1e-4, 1e-4, 0.0]])))
    return mats


MATS = matrices()


def image(seed, shape=IN_SZ):
    return np.random.RandomState(seed).randint(0, 256, shape + (3,)) \
        .astype(np.uint8)


# -- the validity mask from the inverse alone ----------------------------------

# MATS and a minification whose grid reaches the input's far edge (the
# clip of the nearest index to in - 1)
MASK_MATS = MATS + [np.diag([0.5, 0.5, 1.0])]


@pytest.mark.parametrize("border", [0, 4])
@pytest.mark.parametrize("k", range(len(MASK_MATS)))
def test_warp_mask_plain_is_the_host_mask(k, border):
    """K5's mask in its reduced form (one clipped nearest index an axis,
    tested against the white rows; ``geometry.warp_mask_plain``, the plain
    twin of the card's) equals the host's box warp of the white frame, and
    the support-1 geometry it rests on has no leading pad."""
    m = MASK_MATS[k]
    host = trs.nearest_warp_mask_host(IN_SZ, m, OUT_SZ, border=border)
    got = tgeo.warp_mask_plain(np.linalg.inv(m), IN_SZ, OUT_SZ, border)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), host)
    geom = tgeo.WarpGeometry.create(IN_SZ, m, OUT_SZ, support=1)
    assert geom.pad_x[0] == geom.pad_y[0] == 0
    assert 0 < host.sum() < host.size or border == 0


def test_nearest_warp_mask_on_device_from_the_inverse_on_cpu():
    """From the inverse alone, for CPU tensors (and arrays): the host mask
    of the matrix, bit for bit; lerf_tpu's float32 in-program mask within
    its own bound of it."""
    for m in MATS:
        inv = np.linalg.inv(m)
        host = trs.nearest_warp_mask_host(IN_SZ, m, OUT_SZ, border=4)
        for arg in (torch.from_numpy(inv), inv):
            got = trs.nearest_warp_mask_on_device(arg, IN_SZ, OUT_SZ,
                                                  border=4)
            assert got.dtype == torch.bool and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), host)
        theirs = np.asarray(jrs.nearest_warp_mask_on_device(
            jnp.asarray(inv, jnp.float32), IN_SZ, OUT_SZ, border=4))
        assert (theirs != host).mean() < 2e-3


# -- predictors ----------------------------------------------------------------

_REF = {}


def lut_pair(linear=False):
    """(lerf_tpu flat-layout, port) LUT predictors of the shared bank, one
    pair a form for the module."""
    if ("lut", linear) not in _REF:
        jax_pred = JaxLutPredictor(shared_lut_predictor(linear).bank,
                                   linear=linear, table_layout="flat")
        _REF["lut", linear] = (jax_pred, port_of(jax_pred, device="cpu",
                                                 linear=linear))
    return _REF["lut", linear]


def net_pair(linear=False):
    """(lerf_tpu, port) micro-net predictors, seed-0 nf=8 params (one-output
    stage-2 heads for LeRF-L), lerf_tpu's xla backend against the port's
    K3 twin."""
    if ("net", linear) not in _REF:
        params = np_params(nf=8, seed=0, out_c=1 if linear else 3)
        _REF["net", linear] = (
            JaxNetPredictor.from_srnets(
                {sk: {n: {k: jnp.asarray(v) for k, v in h.items()}
                      for n, h in heads.items()}
                 for sk, heads in params.items()},
                linear=linear, backend="xla"),
            NetPredictor.from_srnets(lerf_nets_from_arrays(params),
                                     linear=linear, device="cpu"))
    return _REF["net", linear]


def assert_net_frames_close(want, got):
    d = np.abs(np.asarray(want, np.int32) - np.asarray(got, np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())


def assert_same_warp(want, got):
    """Every output of the port's own ``warp`` (frame, mask, aux) equal."""
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b, a)


def plain_frame(feat, hyper, matrix, linear):
    """The float32 twin frame [oH, oW, C] of the port's stage outputs (NaN
    → 0), for telling .5 ties from errors."""
    geom = tgeo.WarpGeometry.create(IN_SZ, matrix, OUT_SZ)
    plain = trs.linear_warp_codes_plain if linear \
        else trs.steering_warp_codes_plain
    codes = hyper[..., :1] if linear else hyper
    return np.nan_to_num(plain(torch.from_numpy(feat),
                               torch.from_numpy(np.ascontiguousarray(codes)),
                               geom).numpy()).transpose(1, 2, 0)


@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_lut_warp_dynamic(linear):
    """Bit-equal to the port's ``warp`` (frame, mask, feat, hyper) at every
    matrix, granularity 0 and 16 alike, and equal to lerf_tpu's
    ``warp_dynamic`` but for ties, the mask and stages exactly."""
    jax_pred, port = lut_pair(linear)
    img = image(8 + linear)
    before = k5.launches
    for m in MATS[:3]:
        want = port.warp(img, m, OUT_SZ, return_aux=True)
        got = port.warp_dynamic(img, m, OUT_SZ, return_aux=True)
        assert_same_warp(want, got)
        assert_same_warp(want[:2], port.warp_dynamic(img, m, OUT_SZ,
                                                     granularity=16))
        theirs = jax_pred.warp_dynamic(img, m, OUT_SZ, return_aux=True)
        np.testing.assert_array_equal(got[1], theirs[1])
        np.testing.assert_array_equal(got[2], np.asarray(theirs[2]))
        np.testing.assert_array_equal(got[3], np.asarray(theirs[3]))
        count_ties(got[0], np.asarray(theirs[0]),
                   plain_frame(got[2], got[3], m, linear))
    assert k5.launches == before          # CPU tensors take the plain twin


@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_net_warp_dynamic(linear):
    jax_pred, port = net_pair(linear)
    img = image(10 + linear)
    for m in MATS[:2]:
        want = port.warp(img, m, OUT_SZ, return_aux=True)
        got = port.warp_dynamic(img, m, OUT_SZ, return_aux=True)
        assert_same_warp(want, got)
        assert_same_warp(want[:2], port.warp_dynamic(img, m, OUT_SZ,
                                                     granularity=16))
        out, mask = jax_pred.warp_dynamic(img, m, OUT_SZ)
        np.testing.assert_array_equal(got[1], mask)
        assert_net_frames_close(out, got[0])


def test_lut_warp_device_matches_jax():
    """``warp_device``: the port's ``warp`` bit for bit, lerf_tpu's ``warp``
    but for ties (the mask exactly), and within lerf_tpu's bounds of its
    own float32 ``warp_device``."""
    jax_pred, port = lut_pair()
    img = image(9)
    want = jax_pred.warp(img, MATS[0], OUT_SZ)
    got = port.warp_device(img, MATS[0], OUT_SZ)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    out, _, feat, hyper = port.warp(img, MATS[0], OUT_SZ, return_aux=True)
    np.testing.assert_array_equal(got[0], out)
    count_ties(got[0], np.asarray(want[0]),
               plain_frame(feat, hyper, MATS[0], False))
    for m in MATS[:3]:
        got_out, got_mask = port.warp_device(img, m, OUT_SZ, granularity=16)
        assert_same_warp(port.warp(img, m, OUT_SZ), (got_out, got_mask))
        dev_out, dev_mask = jax_pred.warp_device(img, m, OUT_SZ)
        assert (got_mask != dev_mask).mean() < 2e-3, m
        both = (got_mask & dev_mask)[:, :, None]
        diff = np.abs(got_out.astype(np.int32) - dev_out.astype(np.int32))
        diff = diff * both
        assert (diff > 1).mean() < 5e-3, (m, (diff > 1).mean())
        assert (diff != 0).mean() < 5e-2, (m, (diff != 0).mean())


def test_net_warp_device_close_to_jax_device():
    """The net form's ``warp_device`` is its ``warp``, and within lerf_tpu's
    bounds of lerf_tpu's own device-geometry warp (stage codes apart by one
    level on < 0.5 % on top)."""
    jax_pred, port = net_pair()
    img = image(15)
    m = MATS[0]
    got_out, got_mask = port.warp_device(img, m, OUT_SZ)
    assert_same_warp(port.warp(img, m, OUT_SZ), (got_out, got_mask))
    dev_out, dev_mask = jax_pred.warp_device(img, m, OUT_SZ)
    assert (got_mask != dev_mask).mean() < 2e-3
    both = (got_mask & dev_mask)[:, :, None]
    diff = np.abs(got_out.astype(np.int32) - dev_out.astype(np.int32))
    diff = diff * both
    assert (diff > 1).mean() < 5e-3, (diff > 1).mean()
    assert (diff != 0).mean() < 5e-2, (diff != 0).mean()


@pytest.mark.parametrize("geometry", ["host", "device"])
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_lut_warp_batch(linear, geometry):
    """Distinct per-frame homographies, and one shared matrix broadcast:
    each frame (output and mask) bit-equal to its own ``warp``, both
    geometries alike (lerf_tpu's ``test_batch_serving.py:90-137``)."""
    _, port = lut_pair(linear)
    imgs = np.stack([image(20 + b) for b in range(3)])
    mats = np.stack(MATS[:3])
    for ms in (mats, MATS[4]):
        outs, masks = port.warp_batch(imgs, ms, OUT_SZ, geometry=geometry)
        assert outs.shape == (3,) + OUT_SZ + (3,) and outs.dtype == np.uint8
        assert masks.shape == (3,) + OUT_SZ and masks.dtype == np.bool_
        for b in range(3):
            m = ms[b] if ms.ndim == 3 else ms
            assert_same_warp(port.warp(imgs[b], m, OUT_SZ),
                             (outs[b], masks[b]))


def test_net_warp_batch_matches_single():
    _, port = net_pair()
    imgs = np.stack([image(30 + b) for b in range(2)])
    outs, masks = port.warp_batch(imgs, np.stack(MATS[:2]), OUT_SZ)
    for b in range(2):
        assert_same_warp(port.warp(imgs[b], MATS[b], OUT_SZ),
                         (outs[b], masks[b]))


def test_warp_batch_rejects_an_unknown_geometry():
    _, port = lut_pair()
    with pytest.raises(ValueError, match="geometry"):
        port.warp_batch(np.stack([image(1)]), MATS[0], OUT_SZ,
                        geometry="bogus")


def test_async_warp_forms_raise_item_11():
    """The async warp forms, ported now (this test held their "item 11"
    exit and keeps its name): each future's frame and mask equal the
    port's ``warp``; against lerf_tpu's ``warp_dynamic_async`` the mask
    exactly, the LUT frame but for .5 ties of the port's float32 twin, the
    micro-net frame within one step on < 1 % of pixels."""
    img = image(1)
    for (jax_pred, port), net in ((lut_pair(), False), (net_pair(), True)):
        want = port.warp(img, MATS[0], OUT_SZ, return_aux=True)
        theirs = jax_pred.warp_dynamic_async(img, MATS[0], OUT_SZ).result()
        for name in ("warp_dynamic_async", "warp_device_async"):
            got = getattr(port, name)(img, MATS[0], OUT_SZ).result()
            assert_same_warp(want[:2], got)
            np.testing.assert_array_equal(got[1], np.asarray(theirs[1]))
            if net:
                assert_net_frames_close(theirs[0], got[0])
            else:
                count_ties(got[0], np.asarray(theirs[0]),
                           plain_frame(want[2], want[3], MATS[0], False))


def test_warp_serving_at_support_3_is_the_static_warp():
    """At a support other than the deploy form's 2 (where lerf_tpu falls
    back to ``warp``) the serving forms are the port's ``warp`` too."""
    port = port_of(shared_lut_predictor(), device="cpu", supp_size=3)
    img = image(3)
    want = port.warp(img, MATS[2], OUT_SZ, return_aux=True)
    assert_same_warp(want, port.warp_dynamic(img, MATS[2], OUT_SZ,
                                             return_aux=True))
    outs, masks = port.warp_batch(img[None], MATS[2], OUT_SZ)
    assert_same_warp(want[:2], (outs[0], masks[0]))


def test_warp_dynamic_keeps_no_geometry_a_matrix():
    """A serving form serves a new matrix every request: on the CPU it
    keeps nothing per matrix (the static ``warp`` keeps its last
    :data:`~lerf_torch.pipeline.WARP_CACHE_SIZE` geometries)."""
    port = port_of(shared_lut_predictor(), device="cpu")
    for k in range(pipeline.WARP_CACHE_SIZE + 1):
        port.warp_dynamic(image(2), MATS[0] * (1 + k), OUT_SZ)
    assert len(port._warp_cache) == 0
