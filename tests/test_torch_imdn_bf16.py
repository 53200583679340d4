"""The IMDN (LeRF-Net) form's bf16 compute type against lerf_tpu's.

lerf_tpu's ``IMDN2(dtype=jnp.bfloat16)`` keeps its parameters float32 and
computes in bf16: each conv casts its input, kernel and bias to bf16 and
adds the bias after the convolution; the towers' feature and hyper maps
stay bf16, the feature is divided by ``norm`` in bf16, and the resize and
warp run in ``img.dtype``, every operation rounded to bf16.  The port's
``IMDN2(dtype=torch.bfloat16)`` does the same; its towers get lerf_tpu's
variables (nf 12, ``PRNGKey(0)``, the suite's shared IMDN predictor's)
through ``convert.imdn_from_arrays``, its inputs come from numpy seeds.

Gates, from lerf_tpu's own bf16 "base" (flax's convs) against its bf16
"s2d" (the space-to-depth re-embedding) on these inputs (24×32 frames of
seeds 0 and 1; ×2, ×2.5, ×0.5 and the two warps), as the bf16 K3 gate
was set from lerf_tpu's own spread:

* the towers: the feature (0..254) within 2.0 (2 bf16 ulps at 128..254)
  on at most 8 % of values (lerf_tpu: 2.0, 7.2 %), the hyper maps (0..1)
  within 3/256 on at most 38 % (lerf_tpu: 3/256, 37.8 %);
* the uint8 frames end to end: lerf_tpu's largest level gap, on at most
  lerf_tpu's largest share of differing pixels plus 5 points: the
  Gaussian 33 levels on 59 % (lerf_tpu: 33 at ×2.5, 54 % at ×0.5), the
  linear kernel 3 on 18 % (lerf_tpu: 3, 13 %), the one-stage form 113 on
  20 % (lerf_tpu: 113 under the rotation, 15 % at ×0.5).  A bf16 ulp of
  a hyper map moves a far neighbour's weight by a large factor, so a
  nearly empty window's quotient swings by tens of levels.

The port's plain bf16 resize and warp are held BIT-EQUAL to lerf_tpu's
(op by op, each rounded to bf16) on lerf_tpu's own bf16 feature and maps
carried across, but for the warp at support 4, whose window sums are
``torch.sum`` against XLA's reduce, float32 terms added in other orders
(the float32 warp's own gap): the Gaussian's bf16 quotient within 1 bf16
ulp on at most 0.1 % of pixels (2 of 6720 here), the linear's float32
within 1e-4.  The serving forms are held
bit-equal to the port's own ``upscale`` / ``warp``.  Torch runs on one
thread (``one_torch_thread``).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from conftest import shared_imdn_predictor
from lerf_tpu.models import imdn as jimdn
from lerf_tpu.models import imdn_s2d as js2d
from lerf_tpu.ops import geometry as jgeo
from lerf_tpu.ops import resample as jres
from lerf_tpu.pipeline import NetPredictor as JaxNetPredictor

from lerf_torch.convert import imdn_from_arrays
from lerf_torch.models import imdn_s2d
from lerf_torch.models.imdn import IMDN2, Conv
from lerf_torch.ops import geometry as tgeo
from lerf_torch.ops import resample as tres
from lerf_torch.ops.kernels import resize as k1
from lerf_torch.ops.kernels import warp as k5
from lerf_torch.pipeline import NetPredictor

BF16 = torch.bfloat16
FEAT_BF16_TOL = (2.0, 0.08)         # (max abs, share differing)
HYPER_BF16_TOL = (3 / 256, 0.38)
U8_BF16_TOL = {"gauss": (33, 0.59), "linear": (3, 0.18),
               "one-stage": (113, 0.20)}
# the warp at support 4: float32 sums in another order; (bf16 ulps, share)
# of the Gaussian's bf16 quotient, and the linear's float32 atol
GAUSS_S4_TOL = (1, 0.001)
LINEAR_S4_ATOL = 1e-4
# a float32 feature beside bf16 maps: float32 weights, whose exp differs
# from XLA's by a few ulp (the float32 form's own gap)
MIXED_ATOL = 1e-3
MATRICES = {
    "zoom-jitter": np.array([[2.0, 0.1, 1.0], [0.05, 1.9, -1.0],
                             [1e-3, 2e-3, 1.0]]),
    "rotate": np.array([[1.6, -0.5, 6.0], [0.5, 1.6, -3.0],
                        [0.0, 0.0, 1.0]]),
}
WARP_OUT = (40, 56)
_JAX = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU paths run many small torch ops; with one intra-op
    thread a core they stall whenever the test workers share the cores, so
    this module runs torch on one thread and gives the count back after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_variables():
    return shared_imdn_predictor().params


def port_model(dtype=BF16):
    model = IMDN2(nf=12, dtype=dtype)
    model.load_state_dict(imdn_from_arrays(
        jax.tree.map(np.asarray, jax_variables())))
    return model


def jax_predictor(**kwargs):
    """lerf_tpu's bf16 IMDN predictor on the shared variables, one a set
    of options for the module."""
    key = tuple(sorted(kwargs.items()))
    if key not in _JAX:
        _JAX[key] = JaxNetPredictor.from_imdn(
            jimdn.IMDN2(in_c=3, out_c=3, nf=12, dtype=jnp.bfloat16),
            jax_variables(), out_c=3, **kwargs)
    return _JAX[key]


def image(h=24, w=32, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)) \
        .astype(np.uint8)


def to_np(a) -> np.ndarray:
    """A bf16 (or float) torch tensor or JAX / numpy array as float32."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def to_torch_bf16(a) -> torch.Tensor:
    """lerf_tpu's bf16 values as a torch bf16 tensor (exact)."""
    return torch.from_numpy(to_np(a)).to(BF16)


def within(got, want, tol, what):
    """|got - want| within ``tol`` = (max, share of values that differ)."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert d.max() <= tol[0] and (d > 0).mean() <= tol[1], \
        (what, float(d.max()), float((d > 0).mean()))


def bf16_ulps(got, want):
    """|got - want| in bf16 ulps, elementwise (bf16 values, same sign)."""
    def bits(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(BF16) \
            .view(torch.int16).to(torch.int32).numpy()
    return np.abs(bits(got) - bits(want))


def assert_same(got, want):
    """Bit-equal, NaN where the other is NaN."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.nan_to_num(got), np.nan_to_num(want))


# -- (a) the towers --------------------------------------------------------

def test_bf16_conv_adds_its_bias_after_the_convolution():
    """A bf16 conv casts input, kernel and bias to bf16 and adds the bias
    after the bias-free convolution, in bf16 (flax's ``nn.Conv``); float32
    stays ``nn.Conv2d`` itself."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(1, 4, 9, 11).astype(np.float32))
    conv = Conv(4, 6, 3, BF16)
    with torch.no_grad():
        got = conv(x)
        want = F.conv2d(x.to(BF16), conv.weight.to(BF16), None,
                        padding=1) + conv.bias.to(BF16)[:, None, None]
    assert got.dtype == BF16 and torch.equal(got, want)
    assert conv.weight.dtype == torch.float32
    conv32 = Conv(4, 6, 3)
    conv32.load_state_dict(conv.state_dict())
    with torch.no_grad():
        assert torch.equal(conv32(x), F.conv2d(x, conv.weight, conv.bias,
                                               padding=1))


def stage_inputs(seed):
    """(stage-1 input [C, H, W] in [0, 1] float32, stage-2 input: lerf_tpu's
    bf16 feature of it divided by 255 in bf16)."""
    x = image(seed=seed).transpose(2, 0, 1).astype(np.float32) / 255
    _, s1, _ = js2d.make_chw_stage_fns(
        jax_variables(), backend="base", nf=12, dtype=jnp.bfloat16,
        model=jimdn.IMDN2(in_c=3, out_c=3, nf=12, dtype=jnp.bfloat16))
    return x, np.asarray(s1(jax_variables(), jnp.asarray(x)) / 255.0)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("form", ["module", "base", "s2d"])
@pytest.mark.parametrize("stage", [1, 2])
def test_bf16_towers_match_jax(stage, form, seed):
    """IMDN2(dtype=bf16) (the module's ``predict``, and the form's stage
    functions for base and s2d) against lerf_tpu's bf16 towers of the same
    form, within the towers' gate."""
    x1, x2 = stage_inputs(seed)
    x = x1 if stage == 1 else x2
    jm = jimdn.IMDN2(in_c=3, out_c=3, nf=12, dtype=jnp.bfloat16)
    if form == "module":
        want = jm.apply(jax_variables(), jnp.asarray(x.transpose(1, 2, 0))
                        [None], stage)[0]
        with torch.no_grad():
            got = port_model().predict(torch.from_numpy(to_np(x))[None],
                                       stage)[0].permute(1, 2, 0)
    else:
        v2, s1, s2 = js2d.make_chw_stage_fns(
            jax_variables(), backend=form, nf=12, dtype=jnp.bfloat16,
            model=jm)
        want = (s1 if stage == 1 else s2)(v2, jnp.asarray(x))
        t1, t2 = imdn_s2d.make_chw_stage_fns(port_model(), backend=form,
                                             device="cpu")
        got = (t1 if stage == 1 else t2)(torch.from_numpy(to_np(x)))
    assert got.dtype == BF16
    within(to_np(got), to_np(want),
           FEAT_BF16_TOL if stage == 1 else HYPER_BF16_TOL,
           f"stage {stage} {form}")


def test_stage_fns_take_the_models_type_and_keep_float32_as_it_was():
    """``make_chw_stage_fns`` defaults to ``model.dtype``; ``dtype=`` picks
    another; a float32 model's stages are the module's float32 forward."""
    x = torch.from_numpy(image(13, 17, seed=2).transpose(2, 0, 1)
                         .astype(np.float32) / 255)
    m32 = port_model(torch.float32)
    s1, _ = imdn_s2d.make_chw_stage_fns(m32, backend="base", device="cpu")
    s1b, _ = imdn_s2d.make_chw_stage_fns(m32, backend="base", device="cpu",
                                         dtype=BF16)
    with torch.no_grad():
        want = m32.predict(x[None], 1)[0]
    got = s1(x)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
    assert s1b(x).dtype == BF16
    sb, _ = imdn_s2d.make_chw_stage_fns(port_model(), backend="s2d",
                                        device="cpu")
    assert sb(x).dtype == BF16


# -- (b) the plain bf16 resize and warp, bit-equal -----------------------------

def jax_stages(seed=0, h=24, w=32):
    """lerf_tpu's bf16 feature [C, H, W] and hyper maps [C, H, W, 3] of a
    seeded frame (its two-stage ``_stages``), as torch bf16 tensors."""
    img = jnp.asarray(image(h, w, seed).transpose(2, 0, 1)
                      .astype(np.float32) / 255)
    feat, hyper = jax_predictor()._stages(img)
    assert feat.dtype == jnp.bfloat16 and hyper.dtype == jnp.bfloat16
    return to_torch_bf16(feat), to_torch_bf16(hyper)


def j(t):
    return jnp.asarray(to_np(t)).astype(
        jnp.bfloat16 if t.dtype == BF16 else jnp.float32)


@pytest.mark.parametrize("scale", [2.0, 2.5, 0.5, 0.4])
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_plain_bf16_resize_is_jax_bit_for_bit(linear, scale):
    """The plain resize on bf16 tensors is lerf_tpu's bf16 resize bit for
    bit, ×0.4 included: there ``min_scale`` is no bf16 value, and lerf_tpu
    multiplies by its bf16 rounding (``jnp.asarray(min_scale, bf16)``)."""
    feat, hyper = jax_stages()
    geom = tgeo.ResizeGeometry.create(feat.shape[1:],
                                      scale_factors=[scale] * 2)
    jg = jgeo.ResizeGeometry.create(feat.shape[1:], scale_factors=[scale] * 2)
    if linear:
        want = jres.amplified_linear_resize(j(feat), j(hyper[..., 0]), jg)
        got = tres.amplified_linear_resize(feat, hyper[..., 0], geom)
    else:
        want = jres.steering_gaussian_resize(
            j(feat), *(j(hyper[..., k]) for k in range(3)), jg)
        got = tres.steering_gaussian_resize(
            feat, *(hyper[..., k] for k in range(3)), geom)
    assert str(got.dtype).endswith(str(want.dtype))
    assert_same(got, want)


@pytest.mark.parametrize("support", [2, 4])
@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_plain_bf16_warp_is_jax_bit_for_bit(linear, name, support):
    """The plain warp on bf16 tensors is lerf_tpu's bf16 warp (the
    float-row warp, ``u8_inputs=False``) bit for bit, the NaN pattern
    included; at support 4 within ``GAUSS_S4_TOL`` / ``LINEAR_S4_ATOL``."""
    feat, hyper = jax_stages()
    m = MATRICES[name]
    geom = tgeo.WarpGeometry.create(feat.shape[1:], m, WARP_OUT,
                                    support=support)
    jg = jgeo.WarpGeometry.create(feat.shape[1:], m, WARP_OUT,
                                  support=support)
    if linear:
        want = jres.amplified_linear_warp(j(feat), j(hyper[..., 0]), jg)
        got = tres.amplified_linear_warp(feat, hyper[..., 0], geom)
    else:
        want = jres.steering_gaussian_warp(
            j(feat), *(j(hyper[..., k]) for k in range(3)), jg)
        got = tres.steering_gaussian_warp(
            feat, *(hyper[..., k] for k in range(3)), geom)
    if support == 2:
        assert_same(got, want)
        return
    got, want = to_np(got), to_np(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    got, want = np.nan_to_num(got), np.nan_to_num(want)
    if linear:
        np.testing.assert_allclose(got, want, rtol=0, atol=LINEAR_S4_ATOL)
    else:
        ulps = bf16_ulps(got, want)
        assert ulps.max() <= GAUSS_S4_TOL[0] \
            and (ulps > 0).mean() <= GAUSS_S4_TOL[1], (ulps.max(),
                                                       (ulps > 0).mean())


@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_plain_resize_and_warp_of_bf16_maps_beside_a_float32_feature(
        linear):
    """A float32 feature with bf16 maps (the one-stage bf16 form): the
    maps decoded in bf16, the rest promoted to float32, as lerf_tpu
    promotes them; within ``MIXED_ATOL`` (float32 ``exp``)."""
    _, hyper = jax_stages()
    feat = torch.from_numpy(image().transpose(2, 0, 1).astype(np.float32))
    geom = tgeo.ResizeGeometry.create(feat.shape[1:], scale_factors=[2.5] * 2)
    jg = jgeo.ResizeGeometry.create(feat.shape[1:], scale_factors=[2.5] * 2)
    m = MATRICES["zoom-jitter"]
    wg = tgeo.WarpGeometry.create(feat.shape[1:], m, WARP_OUT)
    jw = jgeo.WarpGeometry.create(feat.shape[1:], m, WARP_OUT)
    if linear:
        pairs = [(jres.amplified_linear_resize(j(feat), j(hyper[..., 0]),
                                               jg),
                  k1.steering_resize(feat, hyper[..., :1], geom,
                                     linear=True)),
                 (jres.amplified_linear_warp(j(feat), j(hyper[..., 0]), jw),
                  tres.amplified_linear_warp(feat, hyper[..., 0], wg))]
    else:
        maps = [hyper[..., k] for k in range(3)]
        pairs = [(jres.steering_gaussian_resize(j(feat), *map(j, maps), jg),
                  k1.steering_resize(feat, hyper, geom)),
                 (jres.steering_gaussian_warp(j(feat), *map(j, maps), jw),
                  tres.steering_gaussian_warp(feat, *maps, wg))]
    for want, got in pairs:
        assert got.dtype == torch.float32
        got, want = to_np(got), to_np(want)
        assert np.array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                                   rtol=0, atol=MIXED_ATOL)


# -- (c) the form end to end, and its serving forms ------------------------------

_PORT = {}


def port_predictor(**kwargs):
    key = tuple(sorted(kwargs.items()))
    if key not in _PORT:
        _PORT[key] = NetPredictor.from_imdn(port_model(), device="cpu",
                                            **kwargs)
    return _PORT[key]


@pytest.mark.parametrize("call", ["x2", "x2.5", "x0.5", "warp"])
@pytest.mark.parametrize("backend", ["base", "s2d"])
def test_bf16_form_matches_jax(backend, call):
    """``from_imdn(IMDN2(dtype=bf16))`` against lerf_tpu's bf16 form:
    the uint8 frame within the Gaussian's gate, the mask equal, and (SR)
    ``return_aux``'s bf16 feature within the towers' gate."""
    jax_pred = jax_predictor(backend=backend)
    port = port_predictor(backend=backend)
    img = image()
    if call == "warp":
        m = MATRICES["zoom-jitter"]
        want, want_mask = jax_pred.warp(img, m, WARP_OUT)
        got, got_mask = port.warp(img, m, WARP_OUT)
        np.testing.assert_array_equal(got_mask, np.asarray(want_mask))
    else:
        s = float(call[1:])
        want, wf, wh = jax_pred.upscale(img, s, s, return_aux=True)
        got, gf, gh = port.upscale(img, s, s, return_aux=True)
        assert gf.dtype == BF16 and gh.dtype == BF16
        assert tuple(gh.shape) == (3, 24, 32, 3)
        within(to_np(gf), to_np(wf), FEAT_BF16_TOL, "feat")
    assert got.dtype == np.uint8 and got.shape == np.asarray(want).shape
    within(got, np.asarray(want), U8_BF16_TOL["gauss"], call)


@pytest.mark.parametrize("two_stage", [True, False],
                         ids=["two-stage", "one-stage"])
def test_bf16_linear_and_one_stage_forms_match_jax(two_stage):
    """The amplified-linear bf16 form (within the linear gate) and the
    one-stage form (``two_stage=False``: a float32 feature beside bf16
    maps, within the Gaussian's)."""
    kw = {"linear": True} if two_stage else {"two_stage": False}
    jax_pred, port = jax_predictor(**kw), port_predictor(**kw)
    img = image(seed=1)
    tol = U8_BF16_TOL["linear" if two_stage else "one-stage"]
    want, wf, wh = jax_pred.upscale(img, 2.5, 2.5, return_aux=True)
    got, gf, gh = port.upscale(img, 2.5, 2.5, return_aux=True)
    within(got, np.asarray(want), tol, "upscale")
    assert gh.dtype == BF16
    assert (gf.dtype == BF16) == two_stage
    m = MATRICES["rotate"]
    want, want_mask = jax_pred.warp(img, m, WARP_OUT)
    got, got_mask = port.warp(img, m, WARP_OUT)
    np.testing.assert_array_equal(got_mask, np.asarray(want_mask))
    within(got, np.asarray(want), tol, "warp")


@pytest.mark.parametrize("kw", [{}, {"linear": True}, {"two_stage": False}],
                         ids=["gauss", "linear", "one-stage"])
def test_bf16_serving_forms_equal_upscale_and_warp(kw):
    """Every serving form of the bf16 form is bit-equal to ``upscale`` /
    ``warp`` of the same predictor, frame by frame."""
    port = port_predictor(**kw)
    imgs = np.stack([image(12, 15, seed=10 + i) for i in range(3)])
    for scale in (2.5, 0.5):
        want = [port.upscale(f, scale, scale) for f in imgs]
        np.testing.assert_array_equal(
            port.upscale_dynamic(imgs[0], scale, scale), want[0])
        np.testing.assert_array_equal(
            port.upscale_dynamic_async(imgs[1], scale, scale).result(),
            want[1])
        np.testing.assert_array_equal(
            port.upscale_bucketed(imgs[2], scale, scale), want[2])
        np.testing.assert_array_equal(
            port.upscale_batch(imgs, scale, scale), np.stack(want))
    mats = [MATRICES["zoom-jitter"], MATRICES["rotate"],
            MATRICES["zoom-jitter"] @ np.diag([1.1, 0.9, 1.0])]
    want = [port.warp(f, m, (30, 36)) for f, m in zip(imgs, mats)]
    for form in (port.warp_dynamic, port.warp_device):
        out, mask = form(imgs[1], mats[1], (30, 36))
        np.testing.assert_array_equal(out, want[1][0])
        np.testing.assert_array_equal(mask, want[1][1])
    out, mask = port.warp_dynamic_async(imgs[2], mats[2], (30, 36)).result()
    np.testing.assert_array_equal(out, want[2][0])
    out, mask = port.warp_batch(imgs, np.stack(mats), (30, 36))
    np.testing.assert_array_equal(out, np.stack([w[0] for w in want]))
    np.testing.assert_array_equal(mask, np.stack([w[1] for w in want]))


def test_bf16_stream_serving_equals_upscale():
    """The streaming engine over the bf16 form gives ``upscale_dynamic``'s
    frames, which are ``upscale``'s."""
    from lerf_torch.serve import stream_upscale

    port = port_predictor()
    imgs = [image(12, 15, seed=20 + i) for i in range(3)]
    got = list(stream_upscale(port, [(f, 2.5, 2.5) for f in imgs]))
    for f, g in zip(imgs, got):
        np.testing.assert_array_equal(g, port.upscale(f, 2.5, 2.5))


def test_float32_form_keeps_float32():
    """The float32 model's form stays float32 end to end: its aux are
    numpy float32, as before the bf16 type."""
    port = NetPredictor.from_imdn(port_model(torch.float32), device="cpu")
    _, feat, hyper = port.upscale(image(10, 12), 2, 2, return_aux=True)
    assert feat.dtype == np.float32 and hyper.dtype == np.float32


# -- (d) the sharded bf16 towers and pipelines --------------------------------

@pytest.mark.parametrize("form", ["band", "exchange"])
def test_sharded_bf16_form_matches_single_device(form):
    """The row-sharded bf16 towers (band: replicated input and 44-row
    halos; exchange: row-sharded input and one halo exchange) against the
    single-device bf16 towers within the towers' gate, and the sharded SR
    pipeline (one all-gather of the bf16 planes, kept bf16, K1's bf16
    twin on each window) against ``upscale`` within the frame gate."""
    from lerf_torch import parallel as tp

    model = port_model()
    mesh = tp.make_mesh(devices=["cpu"] * 2)
    img = image(88, 16, seed=4)
    x = torch.from_numpy(img.transpose(2, 0, 1).astype(np.float32))
    pred = port_predictor()
    want, wf, wh = pred.upscale(img, 2.0, 2.0, return_aux=True)
    if form == "band":
        feat, hyper = tp.imdn_stages_sharded(x, model, mesh,
                                             dtype=BF16)
    else:
        feat, hyper = tp.imdn_stages_sharded_exchange(
            [x[:, :44], x[:, 44:]], model, mesh, dtype=BF16)
    assert feat.dtype == BF16 and hyper.dtype == BF16
    within(to_np(feat.to_host()), to_np(wf), FEAT_BF16_TOL, "feat")
    within(to_np(hyper.to_host()), to_np(wh), HYPER_BF16_TOL, "hyper")
    if form == "band":
        geom = tgeo.ResizeGeometry.create((88, 16), scale_factors=[2, 2])
        got = tp.sharded_imdn_sr_pipeline(
            x, model, geom, mesh, dtype=BF16,
            out_dtype=torch.uint8).to_host().transpose(1, 2, 0)
        within(got, want, U8_BF16_TOL["gauss"], "sharded SR")


# -- (f) K1's and K5's wrappers on bf16 inputs, on the CPU ----------------------

def bf16_inputs(oc, seed=5, shape=(3, 20, 28)):
    rng = np.random.RandomState(seed)
    feat = torch.from_numpy((rng.rand(*shape) * 254).astype(np.float32))
    hyper = torch.from_numpy(rng.rand(*shape, oc).astype(np.float32))
    return feat.to(BF16), hyper.to(BF16)


@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_k1_bf16_wrapper_takes_the_bf16_twins_on_cpu(linear):
    """K1's wrapper on bf16 inputs on the CPU: the plain bf16 resize, its
    result widened to float32 (uint8: quantized); the serving geometry's
    rings resize bit-equal to it, as ``upscale_dynamic`` needs."""
    feat, hyper = bf16_inputs(1 if linear else 3)
    for scale in (2.5, 0.5):
        geom = tgeo.ResizeGeometry.create(feat.shape[1:],
                                          scale_factors=[scale] * 2)
        got = k1.steering_resize(feat, hyper, geom, linear=linear)
        want = (tres.amplified_linear_resize(feat, hyper[..., 0], geom)
                if linear else tres.steering_gaussian_resize(
                    feat, *(hyper[..., k] for k in range(3)), geom))
        assert got.dtype == torch.float32
        assert_same(got, want)
        got_u8 = k1.steering_resize(feat, hyper, geom, linear=linear,
                                    out_dtype=torch.uint8)
        assert torch.equal(got_u8, tres.quantize_device(
            want, 255, nan_to_zero=linear))
        ops = (tgeo.ResizeOperands.create if scale >= 1
               else tgeo.ResizeOperands.create_any)(
            feat.shape[1:], scale_factors=[scale] * 2)
        serving = k1.steering_resize_serving(feat, hyper, ops, linear=linear)
        assert_same(serving, got)


@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
def test_k5_bf16_wrapper_takes_the_bf16_twins_on_cpu(linear):
    """K5's wrapper on bf16 inputs on the CPU: the plain bf16 warp at
    supports 2 and 4, widened; a batch frame by frame; a window of rows
    the geometry's rows."""
    feat, hyper = bf16_inputs(1 if linear else 3)
    m = MATRICES["rotate"]
    for support in (2, 4):
        params = k5.WarpParams.create(feat.shape[1:], m, WARP_OUT,
                                      support=support)
        got = k5.steering_warp(feat, hyper, params, linear=linear)
        geom = params.geometry()
        want = (tres.amplified_linear_warp(feat, hyper[..., 0], geom)
                if linear else tres.steering_gaussian_warp(
                    feat, *(hyper[..., k] for k in range(3)), geom))
        assert got.dtype == torch.float32
        assert_same(got, want)
        rows = k5.steering_warp(feat, hyper, params, linear=linear,
                                rows=(7, 19))
        assert_same(rows, got[:, 7:19])
    warps = [k5.WarpParams.create(feat.shape[1:], mm, WARP_OUT)
             for mm in MATRICES.values()]
    feats = torch.cat([feat, feat.flip(-1)])
    hypers = torch.cat([hyper, hyper.flip(-2)])
    got = k5.steering_warp_batch(feats, hypers, warps, linear=linear,
                                 out_dtype=torch.uint8)
    for f, w in enumerate(warps):
        one = k5.steering_warp(feats[3 * f:3 * f + 3],
                               hypers[3 * f:3 * f + 3], w, linear=linear,
                               out_dtype=torch.uint8)
        assert torch.equal(got[3 * f:3 * f + 3], one)


def test_kernels_refuse_bf16_feature_with_float32_maps():
    """A bf16 feature beside float32 maps, both modes: K1's and K5's
    wrappers (their plain twins on the CPU) return lerf_tpu's float32
    result, the distances and ``min_scale`` in bf16 (``img.dtype``), the
    maps decoded and the rest computed in float32, within ``MIXED_ATOL``
    (float32 ``exp``) and with its NaN pattern: the resize at ×2.5 and at
    the antialiased ×0.4 (``min_scale`` no bf16 value), the warp at
    supports 2 and 4.  A bf16 feature beside int32 codes is still no pair
    of types they take."""
    feat, hyper = bf16_inputs(3)
    hyper = hyper.float()
    for linear in (False, True):
        h = hyper[..., :1].contiguous() if linear else hyper
        maps = [h[..., k] for k in range(h.shape[-1])]
        pairs = []
        for scale in (2.5, 0.4):
            geom = tgeo.ResizeGeometry.create(feat.shape[1:],
                                              scale_factors=[scale] * 2)
            jg = jgeo.ResizeGeometry.create(feat.shape[1:],
                                            scale_factors=[scale] * 2)
            want = (jres.amplified_linear_resize(j(feat), j(maps[0]), jg)
                    if linear else jres.steering_gaussian_resize(
                        j(feat), *map(j, maps), jg))
            pairs.append((k1.steering_resize(feat, h, geom, linear=linear),
                          want))
        for support in (2, 4):
            params = k5.WarpParams.create(feat.shape[1:], MATRICES["rotate"],
                                          WARP_OUT, support=support)
            jw = jgeo.WarpGeometry.create(feat.shape[1:], MATRICES["rotate"],
                                          WARP_OUT, support=support)
            want = (jres.amplified_linear_warp(j(feat), j(maps[0]), jw)
                    if linear else jres.steering_gaussian_warp(
                        j(feat), *map(j, maps), jw))
            pairs.append((k5.steering_warp(feat, h, params, linear=linear),
                          want))
        for got, want in pairs:
            assert got.dtype == torch.float32 and want.dtype == jnp.float32
            got, want = to_np(got), to_np(want)
            assert np.array_equal(np.isnan(got), np.isnan(want))
            np.testing.assert_allclose(np.nan_to_num(got),
                                       np.nan_to_num(want), rtol=0,
                                       atol=MIXED_ATOL)
    geom = tgeo.ResizeGeometry.create(feat.shape[1:], scale_factors=[2, 2])
    params = k5.WarpParams.create(feat.shape[1:], MATRICES["rotate"],
                                  WARP_OUT)
    codes = hyper.to(torch.int32)
    with pytest.raises(ValueError, match="one type"):
        k1.steering_resize(feat, codes, geom)
    with pytest.raises(ValueError, match="one type"):
        k5.steering_warp(feat, codes, params)
