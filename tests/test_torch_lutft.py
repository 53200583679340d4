"""LUT fine-tuning (lerf_torch.train.lutft) against lerf_tpu.train.lutft and
the port's int deploy path.

Random int8 banks from numpy seeds (lerf_tpu's tests/test_lutft.py).
Tolerances, with their reasons:

- ``simplex4d_ste`` and the stages' forward: the same float32 operations
  in the same order on integer-valued inputs: equal to lerf_tpu's.
- Gradients against ``jax.grad``: the tables' gradients are sums of many
  float32 products scattered into the tables (``index_add`` here, XLA's
  scatter-add there), in other orders: within 1e-5 of each table's
  largest gradient.  On a card ``index_add`` adds with float atomics, in
  an order that changes from run to run (no global deterministic flag is
  set); the CPU's order is fixed.
- The fine-tune forward against the int deploy path (int32 stages, one
  division at the end): the float path rounds each member after /q, like
  the reference (model.py:408), so the two may differ by one level on a
  share of pixels (< 25 %, lerf_tpu's bound), never by more.

Torch runs on one thread (``one_torch_thread``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lerf_tpu.lut.io import LUTBank as JaxBank
from lerf_tpu.train import lutft as jlutft

from lerf_torch.convert import bank_from_arrays
from lerf_torch.ops import lut_pipeline as lp
from lerf_torch.train import lutft

L4 = 17 ** 4
MODES = ("s", "c", "t")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """See tests/test_torch_train.py: torch on one thread for the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_tables(seed=0, out_c=3):
    rng = np.random.RandomState(seed)
    s1 = {m: rng.randint(-127, 128, (L4, 1)).astype(np.int8) for m in MODES}
    s2 = {f"{m}r{r}": rng.randint(-127, 128, (L4, out_c)).astype(np.int8)
          for m in MODES for r in (0, 1)}
    return s1, s2


def banks(seed=0):
    s1, s2 = random_tables(seed)
    return (bank_from_arrays(s1, s2, out_c=3),
            JaxBank(stage1=s1, stage2=s2, out_c=3))


def torch_params(jparams):
    return {g: {k: torch.from_numpy(np.array(v)) for k, v in t.items()}
            for g, t in jparams.items()}


def test_params_from_bank_match_and_roundtrip():
    bank, jbank = banks(4)
    params = lutft.params_from_bank(bank)
    jparams = jlutft.params_from_bank(jbank)
    for g in ("s1", "s2"):
        for k, v in jparams[g].items():
            assert torch.equal(params[g][k], torch.from_numpy(np.array(v)))
    back = lutft.bank_from_params(params, out_c=3)
    for m in MODES:
        np.testing.assert_array_equal(back.stage1[m], bank.stage1[m])
        for r in (0, 1):
            np.testing.assert_array_equal(back.stage2[f"{m}r{r}"],
                                          bank.stage2[f"{m}r{r}"])


def test_bank_from_params_requantizes_as_lerf_tpu():
    """Trained (off-lattice, out of range) tables quantize as lerf_tpu's."""
    bank, jbank = banks(5)
    rng = np.random.RandomState(6)
    jparams = jax.tree.map(
        lambda v: np.asarray(v) + rng.randn(*np.shape(v)).astype(np.float32)
        * 0.05, jlutft.params_from_bank(jbank))
    got = lutft.bank_from_params(torch_params(jparams), out_c=3)
    want = jlutft.bank_from_params(jparams, out_c=3)
    for k in want.stage2:
        np.testing.assert_array_equal(got.stage2[k], want.stage2[k])
    for k in want.stage1:
        np.testing.assert_array_equal(got.stage1[k], want.stage1[k])


def test_params_from_bank_rejects_three_stage_banks():
    s1, s2 = random_tables(7)
    bank = bank_from_arrays(s1, s2, inter=[s1], out_c=3)
    with pytest.raises(NotImplementedError):
        lutft.params_from_bank(bank)


def test_simplex4d_ste_matches_lerf_tpu():
    """Forward equal; gradients to the table and to the inputs within
    1e-5 of their largest."""
    rng = np.random.RandomState(8)
    lut = (rng.randint(-127, 128, (L4, 2)) / 127.0).astype(np.float32)
    abcd = [rng.randint(0, 256, (5, 7)).astype(np.float32) for _ in range(4)]
    g = rng.randn(5, 7, 2).astype(np.float32)

    def jfn(lut, *x):
        return jnp.sum(jlutft.simplex4d_ste(lut, *x) * g)

    jout = jlutft.simplex4d_ste(jnp.asarray(lut), *map(jnp.asarray, abcd))
    jgrads = jax.grad(jfn, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(lut), *map(jnp.asarray, abcd))
    t = [torch.from_numpy(a).requires_grad_() for a in [lut] + abcd]
    out = lutft.simplex4d_ste(*t)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    (out * torch.from_numpy(g)).sum().backward()
    for x, want in zip(t, jgrads):
        want = np.asarray(want)
        err = np.abs(x.grad.numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-5


def test_stages_and_table_gradients_match_lerf_tpu():
    bank, jbank = banks(2)
    rng = np.random.RandomState(3)
    x = rng.rand(1, 8, 8).astype(np.float32)

    def jloss(p):
        feat = jlutft.predict_stage1(p, jnp.asarray(x))
        hyper = jlutft.predict_stage2(p, feat / 255.0)
        return jnp.mean(feat ** 2) + jnp.mean(hyper ** 2), (feat, hyper)

    jparams = jlutft.params_from_bank(jbank)
    (_, (jfeat, jhyper)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jparams)
    params = lutft.params_from_bank(bank)
    for t in params.values():
        for v in t.values():
            v.requires_grad_(True)
    feat = lutft.predict_stage1(params, torch.from_numpy(x))
    hyper = lutft.predict_stage2(params, feat / 255.0)
    np.testing.assert_array_equal(feat.detach().numpy(), np.asarray(jfeat))
    np.testing.assert_array_equal(hyper.detach().numpy(), np.asarray(jhyper))
    (torch.mean(feat ** 2) + torch.mean(hyper ** 2)).backward()
    for g in ("s1", "s2"):
        for k, want in jgrads[g].items():
            want = np.asarray(want)
            got = params[g][k].grad.numpy()
            assert np.abs(want).sum() > 0, (g, k)
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= 1e-5, (g, k, err)


def test_forward_matches_int_deploy_path():
    """Float-STE stages on int8-derived tables against the port's exact
    int pipeline (tests/test_lutft.py:23-57)."""
    bank, _ = banks(0)
    params = lutft.params_from_bank(bank)
    img_u8 = np.random.RandomState(1).randint(0, 256, (1, 12, 14)) \
        .astype(np.int32)
    s1 = lp.FlatTables.create(bank.stage1)
    s2 = lp.FlatTables.create(bank.stage2)
    feat_int = lp.lut_stage1(torch.from_numpy(img_u8), s1, MODES)
    feat_ft = lutft.predict_stage1(
        params, torch.from_numpy(img_u8.astype(np.float32) / 255.0))
    d = (feat_ft - feat_int).abs()
    assert float(d.max()) <= 1.0 and float((d > 0).float().mean()) < 0.25
    hyper_int = lp.lut_stage2(feat_int, s2, MODES)
    hyper_ft = lutft.predict_stage2(params, feat_int.float() / 255.0)
    d = (hyper_ft * 255 - hyper_int).abs()
    assert float(d.max()) <= 1.0 + 1e-4
    assert float((d > 0.5).float().mean()) < 0.25
