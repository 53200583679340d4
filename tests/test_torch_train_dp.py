"""The port's data-parallel training step on the CPU, and the two entry
points that now default to the card.

``make_train_step(..., mesh=)`` on ``["cpu"] * 2`` and ``* 4`` against the
port's single-device step from the same params and batches (lerf_tpu's
seed-0 LeRF-G params, ``tests/test_torch_train.py``'s sizes: crop 8, nf
8, ×2): the loss, the gradient norm and every parameter within 1e-6
relative (the shards' gradients summed in another order; a parameter
against the params' largest magnitude), over three Adam steps; against
lerf_tpu's ``make_train_step(mesh=make_mesh(2))`` within the training
parity's tolerance of ``tests/test_torch_train.py`` (loss 1e-6 relative,
gradient norm 1e-5 relative, params within 1e-5).  The IMDN form's step (an ``nn.Module``,
copied to each other device) the same way against its one-device step.
``cli.train --data_axis 2 --platform cpu`` trains over two CPU shards.
Torch runs on one thread.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_train import batch, hparams, jax_geometry, jax_params
from test_torch_train_data import write_div2k

from lerf_tpu.parallel import make_mesh as jax_mesh
from lerf_tpu.parallel import replicate as jax_replicate
from lerf_tpu.parallel import shard_batch as jax_shard_batch
from lerf_tpu.train import train_step as jts

import lerf_torch.parallel as tp
from lerf_torch.convert import lerf_nets_from_arrays
from lerf_torch.train import train_step as ts

DP_RTOL = 1e-6
STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """See tests/test_torch_train.py: torch on one thread for the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_steps(params, hp, mesh, batches, **fns):
    state = ts.TrainState.create(params, hp)
    step = ts.make_train_step(ts.train_geometry(hp), hp, device="cpu",
                              mesh=mesh, **fns)
    metrics = []
    for im, lb in batches:
        state, m = step(state, im, lb)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def leaves(params):
    return {k: v.detach() for k, v in ts.param_leaves(params).items()}


def assert_steps_close(got, want, rtol, atol_scale, what):
    (gs, gm), (ws, wm) = got, want
    assert gs.step == ws.step == STEPS
    for a, b in zip(gm, wm):
        assert abs(a["loss"] - b["loss"]) <= rtol * abs(b["loss"]), what
        assert abs(a["grad_norm"] - b["grad_norm"]) \
            <= max(rtol, 1e-6) * b["grad_norm"], what
    g, w = leaves(gs.params), leaves(ws.params)
    scale = max(float(v.abs().max()) for v in w.values())
    for k in w:
        d = float((g[k] - w[k]).abs().max())
        assert d <= atol_scale * scale, (what, k, d, scale)


def lerf_g_batches(b):
    return [tuple(torch.from_numpy(a) for a in batch(seed, b))
            for seed in range(STEPS)]


@pytest.mark.parametrize("n", [2, 4])
def test_dp_step_matches_single_device(n):
    _, hp = hparams("lerf_g")
    batches = lerf_g_batches(4)
    one = run_steps(lerf_nets_from_arrays(jax_params("lerf_g")), hp, None,
                    batches)
    dp = run_steps(lerf_nets_from_arrays(jax_params("lerf_g")), hp,
                   tp.make_mesh(devices=["cpu"] * n), batches)
    assert_steps_close(dp, one, DP_RTOL, DP_RTOL, f"x{n}")


def test_dp_step_matches_lerf_tpu_sharded_step():
    jhp, hp = hparams("lerf_g")
    batches = lerf_g_batches(4)
    tx = jts.make_optimizer(jhp)
    jmesh = jax_mesh(2)
    jstep = jts.make_train_step(tx, jax_geometry(), jhp, mesh=jmesh,
                                donate=False)
    jstate = jax_replicate(jts.TrainState.create(
        jax.tree.map(jnp.asarray, jax_params("lerf_g")), tx), jmesh)
    jmetrics = []
    for im, lb in batches:
        jstate, m = jstep(jstate, *jax_shard_batch(
            (jnp.asarray(im.numpy()), jnp.asarray(lb.numpy())), jmesh))
        jmetrics.append({k: float(v) for k, v in m.items()})
    state, metrics = run_steps(lerf_nets_from_arrays(jax_params("lerf_g")),
                               hp, tp.make_mesh(devices=["cpu"] * 2),
                               batches)
    for a, b in zip(metrics, jmetrics):
        assert abs(a["loss"] - b["loss"]) <= 1e-6 * b["loss"]
        assert abs(a["grad_norm"] - b["grad_norm"]) <= 1e-5 * b["grad_norm"]
    want = ts.param_leaves(jax.tree.map(np.asarray, jstate.params))
    got = leaves(state.params)
    for k, w in want.items():
        assert float(np.abs(got[k].numpy() - w).max()) <= 1e-5, k


def test_dp_step_imdn_module_matches_single_device():
    """The IMDN2 form's params are an ``nn.Module``: the other devices'
    copies are the module's; over ``["cpu"] * 2`` one step against one
    device's: the loss and the gradient norm within 1e-6 relative, every
    gradient within 1e-6 of the largest (conv backward sums over another
    split of the batch; a leaf whose gradients cancel to ~1e-6 reads its
    own last bits at 2e-5 of itself), the params after Adam within the
    training parity's 1e-5 wherever the gradient is above 100× Adam's
    eps; below, Adam's first step ``lr·g / (|g| + eps)`` turns the
    gradient's last bits into up to ``lr`` of step, and such a parameter
    is held within one step, ``lr``."""
    from lerf_torch.models.imdn import IMDN2, init_imdn
    from lerf_torch.train import loop

    hp = ts.TrainHParams(scale=2.0, crop_size=8, total_iter=100)
    s1, s2 = loop.imdn_stage_fns(3, 3)
    rng = np.random.RandomState(3)
    batches = [(torch.from_numpy(rng.rand(2, 3, 8, 8).astype(np.float32)),
                torch.from_numpy(rng.rand(2, 3, 16, 16).astype(np.float32)))
               for _ in range(STEPS)]

    def model():
        return init_imdn(IMDN2(nf=8), torch.Generator().manual_seed(0))

    (s_one, m_one), (s_dp, m_dp) = (
        run_steps(model(), hp, mesh, batches[:1], stage1_fn=s1,
                  stage2_fn=s2)
        for mesh in (None, tp.make_mesh(devices=["cpu"] * 2)))
    for key in ("loss", "grad_norm"):
        assert abs(m_dp[0][key] - m_one[0][key]) <= DP_RTOL * m_one[0][key]
    one, dp = (ts.param_leaves(s.params) for s in (s_one, s_dp))
    g_max = max(float(p.grad.abs().max()) for p in one.values())
    for k, p in one.items():
        assert float((dp[k].grad - p.grad).abs().max()) \
            <= DP_RTOL * g_max, k
        d = (dp[k] - p).detach().abs()
        live = p.grad.abs() > 100 * 1e-8
        assert not bool(live.any()) or float(d[live].max()) <= 1e-5, k
        assert float(d.max()) <= hp.lr0, k


def test_dp_step_batch_must_divide():
    _, hp = hparams("lerf_g")
    state = ts.TrainState.create(lerf_nets_from_arrays(jax_params("lerf_g")),
                                 hp)
    step = ts.make_train_step(ts.train_geometry(hp), hp,
                              mesh=tp.make_mesh(devices=["cpu"] * 4))
    im, lb = lerf_g_batches(6)[0]
    with pytest.raises(ValueError, match="divide"):
        step(state, im, lb)


def test_cli_train_data_axis_two(tmp_path):
    from lerf_torch.cli.train import main

    write_div2k(tmp_path / "div2k", n=2)
    exp = tmp_path / "exp"
    params = main(["-e", str(exp), "--twoStage", "--outC", "3",
                   "--trainDir", str(tmp_path / "div2k"),
                   "--valDir", str(tmp_path / "none"),
                   "--valWDir", str(tmp_path / "none"),
                   "--cropSize", "8", "--batchSize", "4", "--nf", "8",
                   "--totalIter", "3", "--displayStep", "1",
                   "--saveStep", "100", "--valStep", "100",
                   "--data_axis", "2", "--platform", "cpu"])
    with open(exp / "train.log") as f:
        log = f.read()
    assert "mesh: 2 × cpu" in log and "Iter:     3" in log
    assert all(torch.isfinite(v).all()
               for v in ts.param_leaves(params).values())


# -- the entry points that default to the card ------------------------------


def test_make_train_step_defaults_to_the_card():
    _, hp = hparams("lerf_g")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        ts.make_train_step(ts.train_geometry(hp), hp)
    assert callable(ts.make_train_step(ts.train_geometry(hp), hp,
                                       device="cpu"))


def test_device_dataset_defaults_to_the_card():
    from lerf_torch.data.device_data import DeviceDataset

    img = np.zeros((8, 8, 3), np.uint8)
    hr = np.zeros((32, 32, 3), np.uint8)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceDataset([img], [hr], scale=4, crop_size=8)
    assert DeviceDataset([img], [hr], scale=4, crop_size=8,
                         device="cpu").device.type == "cpu"
