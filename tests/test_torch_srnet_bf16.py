"""K3's bf16 compute type and nf up to 128 against lerf_tpu, on the CPU.

lerf_tpu's Pallas K3 computes in the heads' own type (``dt =
heads[0]["w1"].dtype``, ``lerf_tpu/models/srnet.py``): with bf16 heads it
rounds the samples and every hidden activation to bf16 and sums bf16
products in float32.  The port carries bf16 heads across as bf16
(``lerf_nets_from_arrays``, ``StackedHeads``) and its K3 twin computes
the same way; lerf_tpu's kernel runs here in interpret mode.  The "xla"
chain stays float32 on the bf16 values (JAX's promotion), and the int8
backend quantizes from those values.

Tolerances are lerf_tpu's own: its float kernel against XLA (sums within 2
on < 0.5 %, ``tests/test_srnet_kernel.py``), stage levels within 1 on
< 0.5 %, and bf16 against float32 within 12 levels.  An activation on a
bf16 rounding edge may round the other way under another float32 summation
order; on these inputs the twin and lerf_tpu's interpret kernel agree in
every sum.  Torch runs on one thread (``one_torch_thread``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lerf_tpu.models import srnet as js
from lerf_tpu.ops.pallas import srnet_kernel_int8 as jk4
from lerf_tpu.ops.pallas.srnet_kernel import \
    ensemble_sum_on_image as jax_ensemble_sum
from test_torch_srnet import (MEMBERS, assert_close_levels, heads_for,
                              np_head, np_params)

from lerf_torch.convert import lerf_nets_from_arrays
from lerf_torch.models import srnet as ts
from lerf_torch.ops.kernels import srnet_ensemble as k3
from lerf_torch.ops.kernels import srnet_ensemble_int8 as k4
from lerf_torch.ops.kernels.resize import BLOCK_SMEM_MAX
from lerf_torch.pipeline import NetPredictor

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU paths run many small torch ops; with one intra-op
    thread a core they stall whenever the test workers share the cores, so
    this module runs torch on one thread and gives the count back after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_bf16(tree):
    """numpy leaves rounded to bf16, as JAX holds them (``np.asarray`` of a
    JAX bf16 array: an ml_dtypes bfloat16 array)."""
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                        tree)


def bf16_params(nf=8, seed=1, out_c=3):
    return to_bf16(np_params(nf=nf, seed=seed, out_c=out_c))


def as_f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def jax_kernel_sum(heads, x, half=127):
    """lerf_tpu's Pallas K3 in interpret mode through ``_ensemble_pred``,
    in the heads' own compute type."""
    return np.asarray(js._ensemble_pred(
        jax.tree.map(jnp.asarray, heads), jnp.asarray(x), MEMBERS, half,
        backend="pallas", interpret=True))


def port_sum(heads, x, half=127):
    """The port's K3 path: heads stacked as the predictor stacks them, the
    wrapper on a CPU tensor (its twin)."""
    before = k3.launches
    got = ts._ensemble_pred(ts.prepare_heads(heads, "pallas", CPU),
                            torch.from_numpy(x), MEMBERS, half,
                            backend="pallas")
    assert k3.launches == before
    return got.numpy()


def image(shape, seed=2):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("oc", [1, 3])
def test_bf16_heads_run_in_bf16_not_float32(oc):
    """The fault: bf16 heads were widened to float32, so the port matched
    lerf_tpu's float32 kernel, which differs from its bf16 kernel in most
    sums.  Now the heads stay bf16 and the port matches the bf16 kernel."""
    p = bf16_params(seed=1, out_c=oc)
    tp = lerf_nets_from_arrays(p)
    for sk in tp:
        for name, head in tp[sk].items():
            for k, v in head.items():
                assert v.dtype == torch.bfloat16, (sk, name, k)
                np.testing.assert_array_equal(           # bit for bit
                    v.view(torch.int16).numpy(),
                    p[sk][name][k].view(np.int16))
    assert ts.prepare_heads(heads_for(tp, oc), "pallas", CPU).dtype \
        == torch.bfloat16
    x = image((2, 24, 40))
    want = jax_kernel_sum(heads_for(p, oc), x)
    f32 = jax_kernel_sum(heads_for(as_f32(p), oc), x)
    got = port_sum(heads_for(tp, oc), x)
    assert_close_levels(want, got, 2.0)
    # the two compute types are told apart: float32 misses the bound
    assert (np.abs(want - f32) > 0).mean() > 0.1


@pytest.mark.parametrize("nf,shape,oc", [
    (8, (2, 24, 40), 3), (8, (1, 17, 23), 1), (64, (1, 9, 13), 3),
    (64, (1, 9, 13), 1)], ids=lambda v: str(v))
def test_bf16_twin_matches_jax_bf16_kernel(nf, shape, oc):
    p = bf16_params(nf=nf, seed=nf, out_c=oc)
    x = image(shape, seed=nf)
    want = jax_kernel_sum(heads_for(p, oc), x)
    got = k3.ensemble_sum_on_image(heads_for(lerf_nets_from_arrays(p), oc),
                                   torch.from_numpy(x), MEMBERS, half=127)
    assert got.shape == shape + (oc,)
    assert_close_levels(want, got.numpy(), 2.0)


def test_from_srnets_bf16_matches_jax_stage_codes():
    """``NetPredictor.from_srnets`` on bf16 params: the feature and hyper
    codes are lerf_tpu's bf16 kernel's stage codes (feat =
    clip(round(Σ/3)), hyper = clip(round(Σ/12 + 127))), and the resize
    runs on them."""
    p = bf16_params(nf=8, seed=3)
    pred = NetPredictor.from_srnets(lerf_nets_from_arrays(p), device="cpu")
    img = np.random.RandomState(4).randint(0, 256, (12, 16, 3)) \
        .astype(np.uint8)
    out, feat, hyper = pred.upscale(img, 2, 2, return_aux=True)
    assert out.shape == (24, 32, 3) and out.dtype == np.uint8
    x = img.transpose(2, 0, 1).astype(np.float32) / np.float32(255)
    s1 = jax_kernel_sum(heads_for(p, 1), x)[..., 0]
    want_feat = np.clip(np.round(s1 / np.float32(3)), 0, 255)
    assert_close_levels(want_feat, feat, 1.0)
    s2 = jax_kernel_sum(heads_for(p, 3),
                        want_feat.astype(np.float32) / np.float32(255))
    want_hyper = np.clip(np.round(s2 / np.float32(12) + 127), 0, 255)
    assert_close_levels(want_hyper, np.round(hyper * 255), 1.0)


@pytest.mark.parametrize("stage", [1, 2])
def test_xla_chain_runs_float32_on_bf16_values(stage):
    """``backend="xla"`` with bf16 heads: the float32 chain on their
    values (JAX promotes a float32 × bf16 product), where it used to raise
    on the mixed types; the same numbers as float32 heads of those
    values."""
    p = bf16_params(nf=8, seed=5)
    x = image((2, 10, 14), seed=6)
    jp = jax.tree.map(jnp.asarray, p)
    fn = {1: (js.predict_stage1, ts.predict_stage1),
          2: (js.predict_stage2, ts.predict_stage2)}[stage]
    want = np.asarray(fn[0](jp, jnp.asarray(x), backend="xla"))
    got = fn[1](lerf_nets_from_arrays(p), torch.from_numpy(x),
                backend="xla")
    same = fn[1](lerf_nets_from_arrays(as_f32(p)), torch.from_numpy(x),
                 backend="xla")
    assert torch.equal(got, same)
    scale = 1.0 if stage == 1 else 255.0
    assert_close_levels(np.round(want * scale), np.round(got.numpy() * scale),
                        1.0)


def test_int8_backend_quantizes_from_bf16_values():
    p = bf16_params(nf=8, seed=7)
    want = js.quantize_lerf_params(jax.tree.map(jnp.asarray, p))
    got = ts.quantize_lerf_params(lerf_nets_from_arrays(p))
    f32 = ts.quantize_lerf_params(lerf_nets_from_arrays(as_f32(p)))
    for sk in ("s1", "s2"):
        for name in want[sk]:
            for k, v in want[sk][name].items():
                np.testing.assert_array_equal(got[sk][name][k], v)
                np.testing.assert_array_equal(f32[sk][name][k], v)


@pytest.mark.parametrize("nf", [8, 64])
def test_bf16_within_12_levels_of_float32(nf):
    """lerf_tpu's bound between its two compute types, on the port's two
    K3 types: float32 heads and the same heads rounded to bf16."""
    heads = [np_head(np.random.RandomState(s), nf, 3) for s in range(12)]
    x = torch.from_numpy(image((1, 16, 24), seed=3))
    f32 = k3.ensemble_sum(x, k3.StackedHeads.create(heads), MEMBERS,
                          half=127)
    bf = k3.ensemble_sum(x, k3.StackedHeads.create(to_bf16(heads)), MEMBERS,
                         half=127)
    d = (f32 - bf).abs()
    assert float(d.max()) <= 12.0 and float((d > 0).double().mean()) > 0.1


@pytest.mark.parametrize("nf", [96, 128])
@pytest.mark.parametrize("kind", ["float32", "bf16", "int8"])
def test_wide_twins_match_jax_kernels(kind, nf):
    """nf 96 and 128 (the card's kernels now take them): each twin against
    lerf_tpu's interpret kernel of the same type."""
    oc = 3 if nf == 96 else 1
    p = np_params(nf=nf, seed=nf, out_c=oc)
    x = image((1, 8, 12), seed=nf)
    if kind == "int8":
        jq = js.quantize_lerf_params(jax.tree.map(jnp.asarray, p))
        tq = ts.quantize_lerf_params(lerf_nets_from_arrays(p))
        codes = np.round(x * 255) / np.float32(255)
        want = np.asarray(jk4.ensemble_sum_on_image_int8(
            heads_for(jq, oc), jnp.asarray(codes), MEMBERS, half=127,
            interpret=True))
        got = k4.ensemble_sum_on_image_int8(
            heads_for(tq, oc), torch.from_numpy(codes), MEMBERS, half=127)
        assert_close_levels(want, got.numpy(), 2.0)
        return
    if kind == "bf16":
        p = to_bf16(p)
    want = np.asarray(jax_ensemble_sum(
        heads_for(jax.tree.map(jnp.asarray, p), oc), jnp.asarray(x), MEMBERS,
        half=127, compute_dtype=jnp.bfloat16 if kind == "bf16"
        else jnp.float32, block_n=256, interpret=True))
    got = k3.ensemble_sum_on_image(heads_for(lerf_nets_from_arrays(p), oc),
                                   torch.from_numpy(x), MEMBERS, half=127)
    assert_close_levels(want, got.numpy(), 2.0)


def test_nf_above_128_raises_naming_the_limit():
    heads = [np_head(np.random.RandomState(s), 144, 1) for s in range(12)]
    for dt in (np.float32, None):
        sh = k3.StackedHeads.create(heads if dt else to_bf16(heads))
        with pytest.raises(ValueError, match=r"1\.\.128.*bytes of shared"):
            k3._check_heads(sh, 12, CPU)
    qh = k4.QuantHeads.create([k4.quantize_srunit_head(
        h, np.random.RandomState(0).rand(64, 4).astype(np.float32))
        for h in heads])
    with pytest.raises(ValueError, match=r"1\.\.128.*bytes of shared"):
        k4._check_heads(qh, 12, CPU)
    for nf in (8, 64, 96, 128):         # every instance fits a block
        for dt in (torch.float32, torch.bfloat16):
            assert k3.smem_bytes(nf, dt) <= BLOCK_SMEM_MAX
        assert k4.smem_bytes(nf) <= BLOCK_SMEM_MAX
    assert k3.tile_pixels(64) == 128 and k3.tile_pixels(128) == 64
    assert k3.tile_pixels(128, torch.bfloat16) == 128
    assert k3.tile_pixels(64, torch.bfloat16) == 256


def unswizzle_image(image, layer, nf, fan_in, out):
    """Invert :func:`k3.bf16_images` by the byte address the ``wgmma``
    swizzle gives each element of a K-major block (rows of ``2 wb`` bytes,
    at an atom-aligned address: bits 4.. XOR bits 7..): ``[M, in, out]``
    and the padding."""
    m, nkb, rows, wb = image.shape
    row_bytes = 2 * wb
    n, k = np.meshgrid(np.arange(rows), np.arange(wb), indexing="ij")
    logical = n * row_bytes + 2 * k
    phys = logical ^ (((logical >> 7) & (row_bytes // 16 - 1)) << 4)
    flat = image.view(torch.int16).numpy().reshape(m, nkb, rows * wb)
    dense = flat[:, :, phys // 2].transpose(0, 1, 3, 2) \
        .reshape(m, nkb * wb, rows)                       # [M, Kp, Np]
    nfp = -(-nf // 16) * 16
    keep_rows = (list(range(fan_in)) if layer == 0 else
                 [s * nfp + j for s in range(layer) for j in range(nf)])
    keep = np.zeros(dense.shape[1:], dtype=bool)
    keep[np.array(keep_rows)[:, None], np.arange(out)] = True
    dense = torch.from_numpy(np.ascontiguousarray(dense)) \
        .view(torch.bfloat16)
    return dense[:, keep_rows][..., :out], dense[:, torch.from_numpy(~keep)]


@pytest.mark.parametrize("nf,oc", [(8, 1), (12, 3), (64, 3), (128, 1),
                                   (16, 3), (48, 1), (96, 3)])
def test_bf16_fragments_round_trip_to_the_params(nf, oc):
    """The bf16 kernel's weight images (:func:`k3.bf16_images`): unswizzled
    by the hardware's address map they give back every weight, and the
    padding (segments, head columns, layer 1's k-step) is zero."""
    heads = to_bf16([np_head(np.random.RandomState(s), nf, oc)
                     for s in range(3)])
    sh = k3.StackedHeads.create(heads)
    assert sh.dtype == torch.bfloat16
    for b in sh.b:
        assert b.dtype == torch.float32
    nfp = -(-nf // 16) * 16
    for layer, (w, f) in enumerate(zip(sh.w, sh.frags)):
        wb = 16 if layer == 0 else next(v for v in (64, 32, 16)
                                        if nfp % v == 0)
        assert f.dtype == torch.bfloat16
        assert f.shape == (3, 1 if layer == 0 else layer * nfp // wb,
                           nfp if layer < 5 else 8, wb)
        got, pad = unswizzle_image(f, layer, nf, *w.shape[1:])
        assert torch.equal(got, w)
        assert not bool(pad.float().abs().sum())
