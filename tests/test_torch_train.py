"""The port's training step (lerf_torch.train.train_step) and K6's plain twin
against lerf_tpu.

Same numpy-seeded inputs and lerf_tpu's own initial params, carried across
(``convert.lerf_nets_from_arrays`` / ``train_state_from_arrays``), at
lerf_tpu's test sizes (crop 8, nf 8, ×2, tests/test_train.py).  One
module-scoped lerf_tpu reference holds every value the tests compare, so
XLA compiles each function once.  Tolerances, with their reasons:

- ``cosine_lr``: within 1e-10 of lerf_tpu's float32 schedule.
- The stages: the same float32 operations, the dense products summed in
  another order (XLA:CPU's dot against torch's matmul), which can move a
  ``round(tanh·127)`` at a .5 edge: the stage codes equal, or within one
  level on < 0.5 % of pixels (the SRNet form's parity).
- Loss within 1e-6 relative; every head's gradient within 1e-4 of that
  head's largest (measured: 1.6e-6).  The port's ``srnet.clip`` has
  ``jnp.clip``'s gradient, halved where a rounded stage value lands on a
  bound.
- Adam: params within 1e-5 after one and three steps (measured 2.4e-7),
  the gradient norm within 1e-5 relative.
- K6's twin (the gradient written out) against ``torch.autograd`` of the
  plain op within 1e-5 of each gradient's largest value, and against
  ``jax.grad`` of lerf_tpu's op within 1e-4 (float32 sums in other
  orders).  The linear kernel's clip at lin = 0: ``torch.clamp`` passes
  the gradient, ``jnp.clip`` halves it; at these inputs no weight lands on
  a tie with a nonzero slope (an off-branch neighbour has lin = 0 and
  slope 0).

Torch runs on one thread (``one_torch_thread``).
"""
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from lerf_tpu.models import srnet as jsrnet
from lerf_tpu.ops import resample as jrs
from lerf_tpu.ops.geometry import ResizeGeometry as JaxGeometry
from lerf_tpu.train import train_step as jts

from lerf_torch.convert import lerf_nets_from_arrays, train_state_from_arrays
from lerf_torch.models import srnet
from lerf_torch.ops import resample as trs
from lerf_torch.ops.geometry import ResizeGeometry
from lerf_torch.train import train_step as ts

CROP, NF, SCALE = 8, 8, 2.0
# name → (linear, two_stage)
FORMS = {"lerf_g": (False, True), "lerf_g-one_stage": (False, False),
         "lerf_l": (True, True), "lerf_l-one_stage": (True, False)}
# the forms with their own params: LeRF-G's three hyper outputs, LeRF-L's one
STAGE_FORMS = ("lerf_g", "lerf_l")
WEIGHT_DECAYS = (0.0, 1e-2)
ADAM_STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU paths run many small torch ops; with one intra-op
    thread a core they stall whenever the test workers share the cores, so
    this module runs torch on one thread and gives the count back after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def hparams(form, weight_decay=0.0, lr1=1e-4):
    linear, two_stage = FORMS[form]
    kw = dict(scale=SCALE, crop_size=CROP, total_iter=100, linear=linear,
              two_stage=two_stage, weight_decay=weight_decay, lr1=lr1)
    return jts.TrainHParams(**kw), ts.TrainHParams(**kw)


def jax_params(form):
    """lerf_tpu's seed-0 params of the form (numpy; callers copy them)."""
    return _jax_params(1 if FORMS[form][0] else 3)


@functools.lru_cache(maxsize=None)
def _jax_params(out_c):
    init = jax.jit(functools.partial(jsrnet.init_lerf_nets, nf=NF,
                                     out_c=out_c))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


def batch(seed=0, b=2):
    r = np.random.RandomState(seed)
    im = r.rand(b, 1, CROP, CROP).astype(np.float32)
    lb = r.rand(b, 1, int(CROP * SCALE), int(CROP * SCALE)).astype(np.float32)
    return im, lb


def jax_geometry():
    return JaxGeometry.create((CROP, CROP), scale_factors=[SCALE] * 2,
                              support=2, antialias=False)


def leaves(tree):
    return ts.param_leaves(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def reference():
    """lerf_tpu's values: per form the loss, gradients and stage outputs
    from the seed-0 params; for LeRF-G per weight decay the params, Adam
    moments and gradient norms after each of ADAM_STEPS steps."""
    im, lb = batch()
    jim, jlb = jnp.asarray(im), jnp.asarray(lb)
    ref, vgs = {}, {}
    for form in FORMS:
        jhp, _ = hparams(form)
        vgs[form] = jax.jit(jax.value_and_grad(
            jts.make_loss_fn(jax_geometry(), jhp)))
        loss, grads = vgs[form](jax_params(form), jim, jlb)
        ref[form] = {"loss": float(loss), "grads": leaves(grads)}

    @jax.jit
    def stages(p, x):
        feat = jsrnet.predict_stage1(p, x)
        return feat, jsrnet.predict_stage2(p, feat / 255.0)

    for form in STAGE_FORMS:
        ref["stages", form] = tuple(
            np.asarray(a) for a in stages(jax_params(form), jim))
    vg = vgs["lerf_g"]              # the loss does not depend on the decay
    for wd in WEIGHT_DECAYS:
        jhp, _ = hparams("lerf_g", wd)
        tx = jts.make_optimizer(jhp)
        params = jax.tree.map(jnp.asarray, jax_params("lerf_g"))
        opt_state = tx.init(params)

        @jax.jit
        def update(grads, opt_state, params):
            upd, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, upd), opt_state, \
                optax.global_norm(grads)

        steps = []
        for _ in range(ADAM_STEPS):
            _, grads = vg(params, jim, jlb)
            params, opt_state, gnorm = update(grads, opt_state, params)
            adam = [s for s in opt_state
                    if isinstance(s, optax.ScaleByAdamState)][0]
            steps.append({"params": jax.tree.map(np.asarray, params),
                          "mu": jax.tree.map(np.asarray, adam.mu),
                          "nu": jax.tree.map(np.asarray, adam.nu),
                          "count": int(adam.count),
                          "grad_norm": float(gnorm)})
        ref["adam", wd] = steps
    return ref


def assert_params_close(got, want, atol, what):
    got, want = ts.param_leaves(got), ts.param_leaves(want)
    assert sorted(got) == sorted(want), what
    for k in want:
        d = np.abs(got[k].detach().cpu().numpy() - want[k]).max()
        assert d <= atol, (what, k, d)


@pytest.mark.parametrize("lr1", [1e-4, -1.0])
def test_cosine_lr_matches_lerf_tpu(lr1):
    jhp, hp = hparams("lerf_g", lr1=lr1)
    sched, factor = jts.cosine_lr(jhp), ts.cosine_lr(hp)
    for i in (0, 1, 13, 50, 99, 100):
        assert abs(hp.lr0 * factor(i) - float(sched(jnp.asarray(i)))) < 1e-10
    want = hp.lr0 * ((1 + math.cos(13 * math.pi / 100)) / 2 * 0.9 + 0.1) \
        if lr1 > 0 else hp.lr0 * ((1 + math.cos(13 * math.pi / 100)) / 2
                                  * 0.8 + 0.2)
    assert abs(hp.lr0 * factor(13) - want) < 1e-15


def test_scheduler_steps_the_learning_rate():
    """The optimizer's lr follows the schedule step by step: the first
    update uses lr(0), as optax's count does."""
    _, hp = hparams("lerf_g")
    state = ts.TrainState.create(lerf_nets_from_arrays(
        jax_params("lerf_g")), hp)
    factor = ts.cosine_lr(hp)
    for i in range(4):
        assert state.optimizer.param_groups[0]["lr"] == hp.lr0 * factor(i)
        state.optimizer.step()
        state.scheduler.step()


@pytest.mark.parametrize("form", STAGE_FORMS)
def test_stage_codes_match_lerf_tpu(form, reference):
    """The differentiable stages' forward: lerf_tpu's codes, or one level
    off on < 0.5 % of pixels."""
    im, _ = batch()
    params = lerf_nets_from_arrays(jax_params(form))
    feat = srnet.predict_stage1(params, torch.from_numpy(im))
    hyper = srnet.predict_stage2(params, feat / 255.0)
    want_feat, want_hyper = reference["stages", form]
    for got, want in ((feat.numpy(), want_feat),
                      (hyper.numpy() * 255, want_hyper * 255)):
        d = np.abs(np.round(got) - np.round(want))
        assert d.max() <= 1 and (d > 0).mean() < 0.005, form


@pytest.mark.parametrize("form", FORMS)
def test_loss_and_grads_match_lerf_tpu(form, reference):
    _, hp = hparams(form)
    im, lb = batch()
    params = lerf_nets_from_arrays(jax_params(form))
    flat = ts.param_leaves(params)
    for p in flat.values():
        p.requires_grad_(True)
    loss = ts.make_loss_fn(ts.train_geometry(hp), hp)(
        params, torch.from_numpy(im), torch.from_numpy(lb))
    loss.backward()
    ref = reference[form]
    assert abs(loss.item() - ref["loss"]) <= 1e-6 * ref["loss"]
    heads = {}
    for name, want in ref["grads"].items():
        g = flat[name].grad
        # a head the loss does not reach (stage 1 without two_stage) has
        # no gradient in torch and zeros in JAX
        got = np.zeros_like(want) if g is None else g.numpy()
        head = name.rsplit("/", 1)[0]
        scale = max(np.abs(w).max() for k, w in ref["grads"].items()
                    if k.rsplit("/", 1)[0] == head)
        heads[head] = max(heads.get(head, 0.0),
                          np.abs(got - want).max() / max(scale, 1e-30))
        if scale == 0:
            assert np.all(got == 0), name
    assert max(heads.values()) <= 1e-4, heads
    if FORMS[form][1]:          # both stages train: BPDA reaches stage 1
        assert all(np.abs(flat[k].grad.numpy()).sum() > 0
                   for k in flat if k.startswith("s1/"))


@pytest.mark.parametrize("weight_decay", WEIGHT_DECAYS)
def test_adam_steps_match_lerf_tpu(weight_decay, reference):
    _, hp = hparams("lerf_g", weight_decay)
    im, lb = (torch.from_numpy(a) for a in batch())
    state = ts.TrainState.create(lerf_nets_from_arrays(
        jax_params("lerf_g")), hp)
    step = ts.make_train_step(ts.train_geometry(hp), hp, device="cpu")
    for k, want in enumerate(reference["adam", weight_decay]):
        state, metrics = step(state, im, lb)
        assert state.step == k + 1
        assert abs(float(metrics["grad_norm"]) - want["grad_norm"]) \
            <= 1e-5 * want["grad_norm"]
        if k in (0, ADAM_STEPS - 1):
            assert_params_close(state.params, want["params"], 1e-5,
                                f"step {k + 1}")


def test_train_state_from_arrays_continues_lerf_tpu(reference):
    """lerf_tpu's state after one Adam step (params, μ, ν, count) carried
    across: the port's next two steps give lerf_tpu's params."""
    wd = WEIGHT_DECAYS[1]
    _, hp = hparams("lerf_g", wd)
    steps = reference["adam", wd]
    first = steps[0]
    state = train_state_from_arrays(first["params"], first["mu"],
                                    first["nu"], first["count"], hp)
    assert state.step == 1
    jhp, _ = hparams("lerf_g", wd)
    assert abs(state.optimizer.param_groups[0]["lr"]
               - float(jts.cosine_lr(jhp)(jnp.asarray(1)))) < 1e-10
    step = ts.make_train_step(ts.train_geometry(hp), hp, device="cpu")
    im, lb = (torch.from_numpy(a) for a in batch())
    for want in steps[1:]:
        state, _ = step(state, im, lb)
    assert_params_close(state.params, steps[-1]["params"], 1e-5, "resumed")


def test_full_float32_restores_the_flags():
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    with ts.full_float32():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark) == flags


# -- K6's plain twin ---------------------------------------------------------

# name → (LR size, scale, support, antialias): integer and non-integer
# scales, supports 2 and 4, an antialiased downscale and one whose pads
# are negative (a crop)
GRAD_CASES = {"x2-s2": ((7, 9), 2.0, 2, False),
              "x2.5-s2": ((7, 9), 2.5, 2, False),
              "x3-s4": ((6, 8), 3.0, 4, False),
              "x2.5-s4": ((6, 8), 2.5, 4, False),
              "x0.5-aa": ((12, 10), 0.5, None, True),
              "x0.25-crop": ((12, 16), 0.25, 2, False)}
JAX_GRAD_CASES = ("x2-s2", "x2.5-s2", "x3-s4")


def grad_case(case, linear, seed=3):
    size, scale, support, aa = GRAD_CASES[case]
    kw = dict(scale_factors=[scale] * 2, antialias=aa)
    if support:
        kw["support"] = support
    rng = np.random.RandomState(seed)
    oc = 1 if linear else 3
    feat = (rng.rand(2, *size) * 255).astype(np.float32)
    hyper = rng.rand(2, *size, oc).astype(np.float32)
    geom = ResizeGeometry.create(size, **kw)
    g = rng.randn(2, *geom.out_sz).astype(np.float32)
    return geom, JaxGeometry.create(size, **kw), feat, hyper, g


def plain_resize(feat, hyper, geom, linear):
    if linear:
        return trs.amplified_linear_resize(feat, hyper[..., 0], geom)
    return trs.steering_gaussian_resize(feat, hyper[..., 0], hyper[..., 1],
                                        hyper[..., 2], geom)


def rel_err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("case", GRAD_CASES)
def test_resize_grad_twin_matches_autograd(case, linear):
    geom, _, feat, hyper, g = grad_case(case, linear)
    f = torch.from_numpy(feat).requires_grad_()
    h = torch.from_numpy(hyper).requires_grad_()
    plain_resize(f, h, geom, linear).backward(torch.from_numpy(g))
    got = trs.steering_resize_grad_plain(
        torch.from_numpy(feat), torch.from_numpy(hyper), torch.from_numpy(g),
        geom, linear=linear)
    assert rel_err(got[0], f.grad) <= 1e-5
    assert rel_err(got[1], h.grad) <= 1e-5
    # the hyper maps pad by edge copies: a border pixel gathers the pads'
    # hyper gradient too (nonzero wherever a window reaches past the edge)
    if min(geom.pad_x) > 0:
        assert np.abs(got[1][:, 0].numpy()).sum() > 0


@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("case", JAX_GRAD_CASES)
def test_resize_grad_twin_matches_jax_grad(case, linear):
    geom, jgeom, feat, hyper, g = grad_case(case, linear)

    def objective(f, h):
        if linear:
            out = jrs.amplified_linear_resize(f, h[..., 0], jgeom)
        else:
            out = jrs.steering_gaussian_resize(f, h[..., 0], h[..., 1],
                                               h[..., 2], jgeom)
        return jnp.sum(out * g)

    want = jax.jit(jax.grad(objective, argnums=(0, 1)))(
        jnp.asarray(feat), jnp.asarray(hyper))
    got = trs.steering_resize_grad_plain(
        torch.from_numpy(feat), torch.from_numpy(hyper), torch.from_numpy(g),
        geom, linear=linear)
    assert rel_err(got[0], want[0]) <= 1e-4
    assert rel_err(got[1], want[1]) <= 1e-4


def test_resize_train_on_cpu_is_the_plain_op():
    """On CPU tensors the training resize is the plain op (no kernel
    launch) and its gradients are autograd's."""
    from lerf_torch.ops.kernels import resize as k1
    from lerf_torch.ops.kernels import resize_bwd

    geom, _, feat, hyper, g = grad_case("x2.5-s2", False)
    counts = (k1.launches, resize_bwd.launches)
    f = torch.from_numpy(feat).requires_grad_()
    h = torch.from_numpy(hyper).requires_grad_()
    out = k1.steering_resize_train(f, h, geom)
    out.backward(torch.from_numpy(g))
    assert (k1.launches, resize_bwd.launches) == counts
    want = plain_resize(torch.from_numpy(feat), torch.from_numpy(hyper),
                        geom, False)
    assert torch.equal(out.detach(), want)
    assert h.grad is not None and f.grad is not None
