"""lerf_torch's network → LUT transfer against lerf_tpu's.

Both packages get the same numpy-seeded SRNet params (JAX through
``jnp.asarray``, the port through ``convert.lerf_nets_from_arrays``).  A
head's float32 chain sums its products in another order in the two, so
``round(clip(out)·127)`` can flip at a .5 edge: the int8 tables are equal
on at least 99.9 % of entries and never more than 1 LSB apart (the
rounding ties ``tests/test_models.py`` allows).
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lerf_tpu.lut import transfer as jtransfer
from test_torch_srnet import np_params, torch_state_dict

from lerf_torch import config
from lerf_torch.convert import lerf_nets_from_arrays
from lerf_torch.lut import transfer
from lerf_torch.pipeline import LutPredictor

EQUAL_SHARE = 0.999
NF = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_tables_close(want, got):
    """Two banks' tables: the same keys and shapes, int8, ≥ 99.9 % equal,
    ≤ 1 LSB apart."""
    pairs = [(want.stage1, got.stage1), (want.stage2, got.stage2)] + list(
        zip(want.inter, got.inter))
    assert len(want.inter) == len(got.inter)
    n = same = 0
    for w, g in pairs:
        assert sorted(w) == sorted(g)
        for k in w:
            a, b = np.asarray(w[k]), np.asarray(g[k])
            assert a.shape == b.shape and b.dtype == np.int8, k
            d = np.abs(a.astype(int) - b.astype(int))
            assert d.max() <= 1, (k, d.max())
            n, same = n + d.size, same + int((d == 0).sum())
    assert same / n >= EQUAL_SHARE, same / n


@pytest.mark.parametrize("stages,out_c", [(2, 3), (3, 3), (2, 1)],
                         ids=["2-stage", "3-stage", "lerf-l"])
def test_transfer_matches_jax(stages, out_c):
    params = np_params(nf=NF, seed=1, out_c=out_c, stages=stages)
    want = jtransfer.transfer_to_lut(
        {sk: {n: {k: jnp.asarray(v) for k, v in h.items()}
              for n, h in heads.items()} for sk, heads in params.items()},
        stages=stages, out_c=out_c)
    got = transfer.transfer_to_lut(lerf_nets_from_arrays(params),
                                   stages=stages, out_c=out_c, device="cpu")
    assert got.stages == stages and got.out_c == out_c
    assert got.stage2["sr0"].shape == (17 ** 4, out_c)
    assert_tables_close(want, got)


def test_quantize_head_matches_jax():
    # values on and around the .5 edges of ·127, and outside [-1, 1]
    k = np.arange(-130, 131, dtype=np.float64)
    out = np.concatenate([k / 127, (k + 0.5) / 127, (k + 0.4999) / 127,
                          np.random.RandomState(2).uniform(-1.5, 1.5, 999)]
                         ).astype(np.float32)
    got = transfer.quantize_head(out)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, jtransfer.quantize_head(out))


def test_lattice_matches_jax():
    for interval in (4, 5):
        np.testing.assert_array_equal(transfer.lattice_inputs(interval),
                                      jtransfer.lattice_inputs(interval))


def test_transfer_default_device_is_cuda():
    params = lerf_nets_from_arrays(np_params(nf=NF, seed=1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            transfer.transfer_to_lut(params)


def test_transfer_cli_writes_jax_files_and_lines(tmp_path, capsys):
    """``cli.transfer`` on a reference-named ``Model_000000.pth``: the same
    files, shapes and printed lines as lerf_tpu's, tables within 1 LSB; the
    bank serves through ``LutPredictor.from_config``."""
    from lerf_tpu.cli.transfer import main as jax_main
    from lerf_tpu.lut.io import load_lut_bank as jax_load
    from lerf_torch.cli.transfer import main

    dirs = {}
    for name in ("jax", "torch"):
        dirs[name] = tmp_path / name
        os.makedirs(dirs[name])
        torch.save(torch_state_dict(np_params(nf=NF, seed=3)),
                   str(dirs[name] / "Model_000000.pth"))
    args = ["--loadIter", "0", "--outC", "3", "--platform", "cpu"]
    capsys.readouterr()
    jax_main(["-e", str(dirs["jax"]), *args])
    want_out = capsys.readouterr().out.splitlines()
    got_bank = main(["-e", str(dirs["torch"]), *args])
    got_out = capsys.readouterr().out.splitlines()
    assert got_out == want_out and len(got_out) == 9
    assert sorted(os.listdir(dirs["torch"])) == sorted(os.listdir(dirs["jax"]))
    for f in os.listdir(dirs["jax"]):
        if f.endswith(".npy"):
            a, b = np.load(dirs["jax"] / f), np.load(dirs["torch"] / f)
            assert a.shape == b.shape and b.dtype == np.int8 == a.dtype, f
    assert_tables_close(jax_load(str(dirs["jax"]), lut_name="LUT"),
                        got_bank)

    cfg = config.parse_config(config.TestConfig, [
        "-e", str(dirs["torch"]), "--lutName", "LUT", "--platform", "cpu"])
    pred = LutPredictor.from_config(cfg)
    img = np.random.RandomState(4).randint(0, 256, (9, 12, 3)) \
        .astype(np.uint8)
    out = pred.upscale(img, 2, 2)
    assert out.shape == (18, 24, 3) and out.dtype == np.uint8


def test_transfer_cli_orbax_checkpoint_exits(tmp_path):
    from lerf_torch.cli.transfer import main

    os.makedirs(tmp_path / "ckpt")
    with pytest.raises(SystemExit, match="item 10"):
        main(["-e", str(tmp_path), "--platform", "cpu"])
