"""lerf_torch.parallel's mesh on the CPU: ``make_mesh``, ``shard_batch``,
``replicate``, ``RowShards``, the two collectives and their counters,
``maybe_init_distributed``, and the predictors' ``mesh=`` (``upscale_batch``
split across ``["cpu"] * 2`` and ``* 4``, each frame bit-equal to its
``upscale``).  lerf_tpu's ``__all__`` is exported name for name.  Torch
runs on one thread.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lerf_torch.parallel as tp
from lerf_torch.parallel import mesh as pm

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """See tests/test_torch_train.py: torch on one thread for the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_exports_lerf_tpu_all():
    from lerf_tpu import parallel as jp
    assert set(jp.__all__) <= set(tp.__all__)
    for name in tp.__all__:
        assert getattr(tp, name) is not None, name
    assert tp.DATA_AXIS == jp.DATA_AXIS == "data"


def test_make_mesh_devices_repeats_and_types():
    mesh = tp.make_mesh(devices=["cpu"] * 8)
    assert mesh.size == 8 and mesh.distinct == (torch.device("cpu"),)
    assert mesh.streams == (None,) * 8
    assert tp.make_mesh(3, devices=["cpu"] * 8).size == 3
    with pytest.raises(ValueError, match="need 9 devices, have 8"):
        tp.make_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="at least one"):
        tp.make_mesh(devices=[])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tp.make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            tp.make_mesh(devices=["cpu", "cuda:0"])


def test_row_ranges_cover_the_rows():
    assert tp.row_ranges(10, 3) == [(0, 4), (4, 7), (7, 10)]
    assert tp.row_ranges(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    for n, k in ((37, 8), (360, 4), (7, 7)):
        r = tp.row_ranges(n, k)
        assert r[0][0] == 0 and r[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(r, r[1:]))
        assert max(b - a for a, b in r) - min(b - a for a, b in r) <= 1


def test_shard_batch_splits_evenly_and_raises():
    mesh = tp.make_mesh(devices=["cpu"] * 4)
    x = torch.arange(8 * 3).reshape(8, 3)
    y = np.arange(8 * 2).reshape(8, 2)
    parts = tp.shard_batch({"x": x, "y": (y, x)}, mesh)
    assert len(parts) == 4
    for i, part in enumerate(parts):
        assert torch.equal(part["x"], x[2 * i:2 * i + 2])
        assert torch.equal(part["y"][0], torch.from_numpy(y[2 * i:2 * i + 2]))
        assert torch.equal(part["y"][1], part["x"])
    with pytest.raises(ValueError, match="divide"):
        tp.shard_batch(torch.zeros(6, 2), mesh)


def test_replicate_one_copy_per_distinct_device():
    from lerf_torch.ops.lut_pipeline import FlatTables

    mesh = tp.make_mesh(devices=["cpu"] * 3)
    t = FlatTables.create({"s": np.ones((17 ** 4, 1), np.int8)})
    reps = tp.replicate({"t": t, "w": torch.ones(3)}, mesh)
    assert len(reps) == 3
    assert reps[0] is reps[1] is reps[2]
    assert reps[0]["t"].table is t.table          # already there: no copy


def test_row_shards_to_host_and_cat():
    mesh = tp.make_mesh(devices=["cpu"] * 3)
    whole = torch.arange(2 * 10 * 4, dtype=torch.float32).reshape(2, 10, 4)
    ranges = tp.row_ranges(10, mesh.size)
    shards = tp.RowShards([whole[:, a:b] for a, b in ranges], ranges, 10)
    assert shards.shape == (2, 10, 4) and shards.dtype == torch.float32
    np.testing.assert_array_equal(shards.to_host(), whole.numpy())
    assert torch.equal(shards.cat(), whole)
    flat = tp.RowShards([whole.reshape(2, -1)[:, a * 4:b * 4]
                         for a, b in ranges],
                        [(a * 4, b * 4) for a, b in ranges], 40, axis=-1)
    np.testing.assert_array_equal(flat.to_host(), whole.reshape(2, 40))


def test_collectives_and_their_counts():
    """One stacked tensor a shard to every shard: one call plus n·(n-1)
    moves; the halo exchange: one call plus one move a direction across
    each interior boundary, the ends taking none."""
    mesh = tp.make_mesh(devices=["cpu"] * 4)
    whole = torch.arange(4 * 12 * 3).reshape(4, 12, 3)
    ranges = tp.row_ranges(12, 4)
    slabs = [whole[:, a:b] for a, b in ranges]
    pm.transfers = 0
    pm.collectives.clear()
    got = tp.all_gather_rows(slabs, mesh)
    assert all(torch.equal(g, whole) for g in got)
    assert pm.transfers == 1 + 4 * 3
    halos = tp.exchange_halos(slabs, 2, mesh)
    assert pm.transfers == 13 + 1 + 2 * 3
    assert dict(pm.collectives) == {"all_gather_rows": 1,
                                    "exchange_halos": 1}
    assert halos[0][0] is None and halos[-1][1] is None
    for i in range(1, 4):
        assert torch.equal(halos[i][0], slabs[i - 1][:, -2:])
        assert torch.equal(halos[i - 1][1], slabs[i][:, :2])
    with pytest.raises(ValueError, match="halo"):
        tp.exchange_halos(slabs, 4, mesh)


def test_maybe_init_distributed_no_op_and_gloo_world_of_one():
    """Without ``LERF_DISTRIBUTED`` a no-op; with it a ``gloo`` world of
    one (the caller gives the address, ``env://``), in a process of its
    own."""
    assert "LERF_DISTRIBUTED" not in os.environ
    assert tp.maybe_init_distributed() is False
    code = ("import torch.distributed as dist\n"
            "import lerf_torch.parallel as tp\n"
            "assert tp.maybe_init_distributed() is True\n"
            "assert tp.maybe_init_distributed() is True\n"
            "assert dist.get_backend() == 'gloo'\n"
            "assert dist.get_world_size() == 1 and dist.get_rank() == 0\n"
            "mesh = tp.make_mesh(devices=['cpu'] * 2)\n"
            "assert mesh.size == 2\n"
            "dist.destroy_process_group()\n")
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, LERF_DISTRIBUTED="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               RANK="0", WORLD_SIZE="1", CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- the predictors' mesh= ---------------------------------------------------------


def frames(n=4, h=12, w=14, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3)) \
        .astype(np.uint8)


def lut_bank():
    from lerf_torch.lut.io import LUTBank

    rng = np.random.RandomState(7)
    modes = ("s", "c", "t")
    return LUTBank(
        stage1={m: rng.randint(-127, 128, (17 ** 4, 1)).astype(np.int8)
                for m in modes},
        stage2={f"{m}r{r}": rng.randint(-127, 128, (17 ** 4, 3))
                .astype(np.int8) for m in modes for r in (0, 1)},
        out_c=3, inter=[])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("form", ["lut", "srnet", "imdn"])
def test_mesh_predictor_upscale_batch_bit_equal_per_frame(form, n):
    """lerf_tpu's data-parallel scale-out: the batch split across the
    shards, no collective, each frame bit-equal to ``upscale``; the other
    forms run on the mesh's first device; a batch that does not divide
    raises."""
    from lerf_torch.models import srnet
    from lerf_torch.models.imdn import IMDN2, init_imdn
    from lerf_torch.pipeline import LutPredictor, NetPredictor

    mesh = tp.make_mesh(devices=["cpu"] * n)
    if form == "lut":
        pred = LutPredictor(lut_bank(), mesh=mesh)
    elif form == "srnet":
        pred = NetPredictor.from_srnets(srnet.init_lerf_nets(
            torch.Generator().manual_seed(0), nf=8, out_c=3), mesh=mesh)
    else:
        pred = NetPredictor.from_imdn(init_imdn(
            IMDN2(nf=8), torch.Generator().manual_seed(0)), mesh=mesh)
    assert pred.device == mesh.devices[0] and pred.mesh is mesh
    imgs = frames()
    pm.collectives.clear()
    got = pred.upscale_batch(imgs, 2, 2)
    assert not pm.collectives
    assert got.shape == (4, 24, 28, 3) and got.dtype == np.uint8
    for b in range(4):
        np.testing.assert_array_equal(got[b], pred.upscale(imgs[b], 2, 2))
    with pytest.raises(ValueError, match="divide"):
        pred.upscale_batch(frames(n=n + 1), 2, 2)
