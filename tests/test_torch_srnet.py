"""lerf_torch micro-net (SRNet) modules against lerf_tpu: the pixel MLP, the
K3 and K4 plain twins (through the K3/K4 wrappers on CPU tensors), the
stages, the int8 host prep and the checkpoint conversion.

Weights and inputs are drawn from numpy seeds and handed to both packages
(JAX through ``jnp.asarray``, the port through ``lerf_nets_from_arrays``).

Tolerances are the JAX package's own (tests/test_srnet_kernel.py,
tests/test_srnet_kernel_int8.py), for the same reason: identical math in
another float32 summation order, so a member's ``round(tanh·127)`` can
flip at a .5 edge — ensemble sums within 2 on < 0.5 % of pixels, stage
levels within 1 on < 0.5 %.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lerf_tpu.lut import transfer as jtransfer
from lerf_tpu.models import convert as jconvert
from lerf_tpu.models import srnet as js
from lerf_tpu.ops.pallas import srnet_kernel_int8 as jk4
from lerf_tpu.ops.pallas.srnet_kernel import \
    ensemble_sum_on_image as jax_ensemble_sum

from lerf_torch.convert import lerf_nets_from_arrays
from lerf_torch.lut import transfer as ttransfer
from lerf_torch.models import convert as tconvert
from lerf_torch.models import srnet as ts
from lerf_torch.ops.kernels import srnet_ensemble as k3
from lerf_torch.ops.kernels import srnet_ensemble_int8 as k4

MODES = ("s", "c", "t")
MEMBERS = [(m, r) for m in MODES for r in range(4)]
LAYER_BIASES = ("b1", "b2", "b3", "b4", "b5", "b6")


def np_head(rng, nf, oc):
    """One SRUnit's float32 params: Kaiming-normal weights and small random
    biases (non-zero, so the bias paths are exercised)."""
    fans = [4] + [k * nf for k in range(1, 5)] + [5 * nf]
    outs = [nf] * 5 + [oc]
    p = {}
    for k, (fan_in, out) in enumerate(zip(fans, outs), start=1):
        p[f"w{k}"] = (rng.randn(fan_in, out) * np.sqrt(2.0 / fan_in)) \
            .astype(np.float32)
        p[f"b{k}"] = (rng.randn(out) * 0.1).astype(np.float32)
    return p


def np_params(nf=8, seed=0, out_c=3, stages=2):
    rng = np.random.RandomState(seed)
    return {"s1": {f"s{s + 1}_{m}": np_head(rng, nf, 1)
                   for s in range(stages - 1) for m in MODES},
            "s2": {f"{m}r{r}": np_head(rng, nf, out_c)
                   for m in MODES for r in (0, 1)}}


def both(params):
    """(JAX params, port params) from one numpy pytree."""
    return jax.tree.map(jnp.asarray, params), lerf_nets_from_arrays(params)


def heads_for(params, oc):
    if oc == 1:
        return [params["s1"][f"s1_{m}"] for m, _ in MEMBERS]
    return [params["s2"][f"{m}r{r % 2}"] for m, r in MEMBERS]


def assert_close_levels(want, got, max_diff, share=0.005):
    d = np.abs(np.asarray(want, np.float64) - np.asarray(got, np.float64))
    assert d.max() <= max_diff, d.max()
    assert (d > 0).mean() < share, (d > 0).mean()


def test_round_ste_rounds_forward_and_passes_gradient():
    x = torch.tensor([0.4, 1.5, 2.5, -0.6], requires_grad=True)
    y = js.round_ste(jnp.asarray(x.detach().numpy()))
    out = ts.round_ste(x)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(y))
    out.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(4, np.float32))


@pytest.mark.parametrize("nf", [8, 64])
def test_apply_srunit_matches_jax(nf):
    head = np_head(np.random.RandomState(nf), nf, 3)
    x4 = np.random.RandomState(1).rand(300, 4).astype(np.float32)
    want = js.apply_srunit(jax.tree.map(jnp.asarray, head), jnp.asarray(x4))
    got = ts.apply_srunit({k: torch.from_numpy(v) for k, v in head.items()},
                          torch.from_numpy(x4))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_srunit_on_image_matches_jax():
    head = np_head(np.random.RandomState(2), 8, 3)
    img = np.random.RandomState(3).rand(2, 7, 11).astype(np.float32)
    for mode, r in (("s", 0), ("c", 1), ("t", 3)):
        want = js.srunit_on_image(jax.tree.map(jnp.asarray, head),
                                  jnp.asarray(img), mode, r)
        got = ts.srunit_on_image(
            {k: torch.from_numpy(v) for k, v in head.items()},
            torch.from_numpy(img), mode, r)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


def test_init_lerf_nets_layout_matches_jax():
    want = js.init_lerf_nets(jax.random.PRNGKey(0), nf=8, out_c=3,
                             stages=3)
    got = ts.init_lerf_nets(torch.Generator().manual_seed(0), nf=8,
                            out_c=3, stages=3)
    assert set(got) == set(want)
    for sk in want:
        assert set(got[sk]) == set(want[sk])
        for name, head in want[sk].items():
            for k, v in head.items():
                assert tuple(got[sk][name][k].shape) == v.shape, (sk, name, k)
                assert got[sk][name][k].dtype == torch.float32
    # the reference's init: zero biases, Kaiming-normal weights
    assert float(got["s2"]["sr0"]["b3"].abs().max()) == 0.0
    std = float(got["s2"]["sr0"]["w5"].std())
    assert abs(std - np.sqrt(2.0 / 32)) < 0.05


@pytest.mark.parametrize("nf,shape,oc", [
    (8, (2, 24, 40), 3), (8, (1, 17, 23), 1), (8, (3, 9, 130), 3),
    (64, (1, 9, 13), 3)], ids=lambda v: str(v))
def test_k3_twin_matches_jax_kernel_and_xla(nf, shape, oc):
    jp, tp = both(np_params(nf=nf, seed=nf, out_c=oc))
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    before = k3.launches
    got = k3.ensemble_sum_on_image(heads_for(tp, oc), torch.from_numpy(x),
                                   MEMBERS, half=127)
    assert k3.launches == before          # a CPU tensor takes the twin
    assert tuple(got.shape) == shape + (oc,)
    kernel = jax_ensemble_sum(heads_for(jp, oc), jnp.asarray(x), MEMBERS,
                              half=127, block_n=256, interpret=True)
    outs = js.ensemble_on_image(lambda i: heads_for(jp, oc)[i],
                                jnp.asarray(x), MEMBERS)
    xla = jnp.sum(jnp.round(outs * 127), axis=0)
    assert_close_levels(kernel, got.numpy(), 2.0)
    assert_close_levels(xla, got.numpy(), 2.0)


@pytest.mark.parametrize("backend", ["xla", "auto"])
def test_predict_stages_match_jax_xla(backend):
    jp, tp = both(np_params(nf=8, seed=4))
    x = np.random.RandomState(5).rand(3, 12, 20).astype(np.float32)
    f1 = js.predict_stage1(jp, jnp.asarray(x), backend="xla")
    got1 = ts.predict_stage1(tp, torch.from_numpy(x), backend=backend)
    assert_close_levels(f1, got1.numpy(), 1.0)
    x2 = np.asarray(f1) / 255.0
    h2 = js.predict_stage2(jp, jnp.asarray(x2), backend="xla")
    got2 = ts.predict_stage2(tp, torch.from_numpy(x2), backend=backend)
    assert got2.shape == (3, 12, 20, 3)
    assert_close_levels(np.round(np.asarray(h2) * 255), got2.numpy() * 255,
                        1.0)
    codes = ts.predict_stage2_codes(tp, torch.from_numpy(x2), backend=backend)
    assert codes.dtype == torch.int32
    np.testing.assert_array_equal(
        codes.numpy().astype(np.float32) / np.float32(255), got2.numpy())


def test_three_stage_predict_matches_jax():
    jp, tp = both(np_params(nf=8, seed=6, stages=3))
    x = np.random.RandomState(7).rand(1, 10, 14).astype(np.float32)
    for backend in ("xla", "pallas"):
        want = js.predict(jp, jnp.asarray(x), 1, stages=3, backend="xla")
        got = ts.predict(tp, torch.from_numpy(x), 1, stages=3,
                         backend=backend)
        assert_close_levels(want, got.numpy(), 1.0)


def test_resolve_backend():
    assert ts.resolve_backend("auto") == "pallas"
    for name in ("xla", "pallas", "pallas_int8"):
        assert ts.resolve_backend(name) == name
    with pytest.raises(ValueError, match="unknown backend"):
        ts.resolve_backend("tpu")


@pytest.mark.parametrize("interval", [4, 3])
def test_lattice_inputs_equal(interval):
    np.testing.assert_array_equal(ttransfer.lattice_1d(interval),
                                  jtransfer.lattice_1d(interval))
    got = ttransfer.lattice_inputs(interval)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jtransfer.lattice_inputs(interval))


def test_quantize_srunit_head_and_stack_equal():
    heads = [np_head(np.random.RandomState(s), 8, 3) for s in range(3)]
    calib = jtransfer.lattice_inputs(4)
    want = [jk4.quantize_srunit_head(h, calib) for h in heads]
    got = [k4.quantize_srunit_head(h, calib) for h in heads]
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    for w, g in zip(jk4.stack_qheads(want), k4.stack_qheads(got)):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("nf", [8, 64])
def test_quantize_lerf_params_equal(nf):
    jp, tp = both(np_params(nf=nf, seed=8))
    want = js.quantize_lerf_params(jp)
    got = ts.quantize_lerf_params(tp)
    for sk in ("s1", "s2"):
        assert set(got[sk]) == set(want[sk])
        for name in want[sk]:
            for k, v in want[sk][name].items():
                np.testing.assert_array_equal(got[sk][name][k], v,
                                              err_msg=f"{sk}/{name}/{k}")


@pytest.mark.parametrize("shape,oc", [((2, 13, 21), 3), ((1, 11, 9), 1)])
def test_k4_twin_matches_jax_ref(shape, oc):
    jp, tp = both(np_params(nf=8, seed=9, out_c=oc))
    qj, qt = js.quantize_lerf_params(jp), ts.quantize_lerf_params(tp)
    img = (np.random.RandomState(10).randint(0, 256, shape) / 255.0) \
        .astype(np.float32)
    want = jk4.ensemble_sum_on_image_int8_ref(heads_for(qj, oc),
                                              jnp.asarray(img), MEMBERS,
                                              half=127)
    before = k4.launches
    got = k4.ensemble_sum_on_image_int8(heads_for(qt, oc),
                                        torch.from_numpy(img), MEMBERS,
                                        half=127)
    assert k4.launches == before          # a CPU tensor takes the twin
    # not bit-equal by contract: XLA:CPU contracts the float32 requant
    # acc·c + b into one FMA, the port rounds the product and the sum
    # separately (as the kernel does), so a rare int8 activation lands one
    # step apart and moves that member's round(tanh·127)
    assert_close_levels(want, got.numpy(), 2.0)


def test_k4_twin_matches_member_emulation():
    """The twin against a per-member numpy emulation of the quantized
    chain: int64 dots, the float32 requant as two roundings."""
    _, tp = both(np_params(nf=8, seed=11))
    qheads = heads_for(ts.quantize_lerf_params(tp), 3)
    codes = np.random.RandomState(12).randint(0, 256, (1, 6, 9))
    got = k4.ensemble_sum_int8(torch.from_numpy(codes.astype(np.int32)),
                               k4.QuantHeads.create(qheads), MEMBERS,
                               half=127).numpy()
    x4 = k4.sample_x4q(torch.from_numpy(codes.astype(np.int32)),
                       MEMBERS).numpy().astype(np.int64)
    acc = np.zeros((3, x4.shape[-1]), np.float32)
    for q, x in zip(qheads, x4):
        def layer(k, h):
            v = (q[f"w{k}"].astype(np.int64) @ h).astype(np.float32)
            return v * q[f"c{k}"] + q[f"b{k}"]
        h = np.clip(np.round(layer(1, x)), 0, 127).astype(np.int64)
        for k in range(2, 6):
            h = np.concatenate(
                [h, np.clip(np.round(layer(k, h)), 0, 127).astype(np.int64)])
        acc += np.round(np.tanh(layer(6, h)) * np.float32(127))
    want = acc.T.reshape(1, 6, 9, 3)
    assert_close_levels(want, got, 1.0)


def torch_state_dict(params, stages=2):
    """A reference-named SRNetsSWF2 state dict from port-layout params."""
    sd = {}

    def put(prefix, head):
        nf = head["w1"].shape[1]
        convs = {"conv1": head["w1"].T.reshape(nf, 1, 2, 2)}
        for k in range(2, 6):
            convs[f"conv{k}.conv1"] = head[f"w{k}"].T[..., None, None]
        convs["conv6"] = head["w6"].T[..., None, None]
        for (name, w), b in zip(convs.items(), LAYER_BIASES):
            sd[f"{prefix}.model.{name}.conv.weight"] = torch.tensor(w)
            sd[f"{prefix}.model.{name}.conv.bias"] = torch.tensor(head[b])

    for name, head in params["s1"].items():
        s, m = name.split("_")
        put(f"{s}_{m}r0", head)
    for name, head in params["s2"].items():
        put(f"s{stages}_{name}", head)
    return sd


def test_state_dict_conversion_matches_jax():
    params = np_params(nf=8, seed=13)
    sd = torch_state_dict(params)
    want = jconvert.lerf_nets_from_torch_state_dict(sd)
    got = tconvert.lerf_nets_from_torch_state_dict(sd)
    for sk in ("s1", "s2"):
        assert set(got[sk]) == set(want[sk])
        for name in want[sk]:
            for k, v in want[sk][name].items():
                assert got[sk][name][k].dtype == torch.float32
                np.testing.assert_array_equal(got[sk][name][k].numpy(), v)
                np.testing.assert_array_equal(got[sk][name][k].numpy(),
                                              params[sk][name][k])


def test_saved_checkpoint_loads_through_both(tmp_path):
    params = np_params(nf=8, seed=14)
    path = str(tmp_path / "Model_050000.pth")
    torch.save(torch_state_dict(params), path)
    want = jconvert.load_reference_checkpoint(path)
    got = tconvert.load_reference_checkpoint(path)
    for sk in ("s1", "s2"):
        for name in want[sk]:
            for k, v in want[sk][name].items():
                np.testing.assert_array_equal(got[sk][name][k].numpy(), v)


def test_lerf_nets_from_arrays_checks_keys_and_shapes():
    params = np_params(nf=8, seed=15)
    got = lerf_nets_from_arrays(params)
    assert got["s2"]["tr1"]["w6"].shape == (40, 3)
    with pytest.raises(ValueError, match="s1, s2"):
        lerf_nets_from_arrays({"s1": params["s1"]})
    bad = np_params(nf=8, seed=15)
    bad["s2"]["sr0"]["w4"] = bad["s2"]["sr0"]["w4"][:-1]
    with pytest.raises(ValueError, match="w4"):
        lerf_nets_from_arrays(bad)
    bad = np_params(nf=8, seed=15)
    del bad["s1"]["s1_c"]["b2"]
    with pytest.raises(ValueError, match="keys"):
        lerf_nets_from_arrays(bad)
