"""lerf_torch LUT stages (the plain twin of kernel K2 and the K2 wrapper on
CPU tensors) against lerf_tpu: int32 bit-equal on non-square inputs."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import shared_lut_predictor
from lerf_tpu.lut.io import load_lut_bank as jax_load_lut_bank
from lerf_tpu.lut.io import save_lut_bank as jax_save_lut_bank
from lerf_tpu.ops import lut_pipeline as jlp
from lerf_tpu.ops import simplex as jsx

from lerf_torch.convert import bank_from_arrays
from lerf_torch.lut.io import load_lut_bank, save_lut_bank
from lerf_torch.ops import lut_pipeline as tlp
from lerf_torch.ops import simplex as tsx
from lerf_torch.ops.kernels import lut_stage as k2

MODES = ("s", "c", "t")


def bank():
    return shared_lut_predictor().bank


@pytest.mark.parametrize("bit_of", [(8, 4, 2, 1), (1, 2, 4, 8), (4, 8, 1, 2)])
def test_simplex_weights16_equal(bit_of):
    # fractions drawn from 0..3 so that ties between roles are frequent
    rng = np.random.RandomState(3)
    fr = [rng.randint(0, 4, (7, 9)).astype(np.int32) * 5 for _ in range(4)]
    want = jsx.simplex_weights16(*map(jnp.asarray, fr), 16, bit_of=bit_of)
    got = tsx.simplex_weights16(*map(torch.from_numpy, fr), 16,
                                bit_of=bit_of)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy().sum(-1), 16)


@pytest.mark.parametrize("den", [3, 16, 48, 192])
def test_round_half_even_div_equal(den):
    rng = np.random.RandomState(den)
    num = np.concatenate([rng.randint(0, 255 * den, 500),
                          np.arange(0, 40) * den + den // 2,   # .5 ties
                          [0, 255 * den]]).astype(np.int32)
    want = jsx.round_half_even_div(jnp.asarray(num), den)
    got = tsx.round_half_even_div(torch.from_numpy(num), den)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.round(num / den))


def test_simplex4d_stacked_tables_equal():
    rng = np.random.RandomState(5)
    lut = rng.randint(-127, 128, (2 * 17 ** 4, 3)).astype(np.int32)
    abcd = [rng.randint(0, 256, (2, 6, 10)).astype(np.int32)
            for _ in range(4)]
    off = np.array([0, 17 ** 4], np.int32).reshape(2, 1, 1)
    want = jsx.simplex4d(jnp.asarray(lut), *map(jnp.asarray, abcd),
                         lut_offset=jnp.asarray(off))
    got = tsx.simplex4d(torch.from_numpy(lut.astype(np.int8)),
                        *map(torch.from_numpy, abcd),
                        lut_offset=torch.from_numpy(off))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


STAGES = {
    "stage1": (jlp.lut_stage1, tlp.lut_stage1, "stage1"),
    "intermediate": (jlp.lut_stage1_intermediate,
                     tlp.lut_stage1_intermediate, "stage1"),
    "stage2": (jlp.lut_stage2, tlp.lut_stage2, "stage2"),
}


@pytest.mark.parametrize("shape", [(3, 11, 17), (2, 16, 9)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_lut_stage_bit_equal(stage, shape):
    jax_fn, torch_fn, which = STAGES[stage]
    tables = getattr(bank(), which)
    img = np.random.RandomState(sum(shape)).randint(
        0, 256, shape).astype(np.int32)
    want = jax.jit(lambda x, t: jax_fn(x, t, MODES))(
        jnp.asarray(img), {k: jnp.asarray(v.astype(np.int32))
                           for k, v in tables.items()})
    before = k2.launches
    got = torch_fn(torch.from_numpy(img), tlp.FlatTables.create(tables),
                   MODES)
    assert k2.launches == before          # CPU tensors take the plain twin
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_member_descriptors_follow_rotated_offsets():
    keys = tuple(sorted(bank().stage2))
    desc = tlp.member_descriptors(MODES, True, keys)
    assert desc.shape == (12, 9)
    for row, (mode, r, key) in zip(desc, jlp.ensemble_members(MODES, True)):
        offs = [v for o in jlp.MODE_OFFSETS[mode]
                for v in jlp.rotate_offset(o, r)]
        assert list(row[:8]) == offs and keys[row[8]] == key


def test_bank_round_trip_between_packages(tmp_path):
    jb = bank()
    tb = bank_from_arrays(jb.stage1, jb.stage2, jb.inter, jb.out_c,
                          jb.interval)
    save_lut_bank(tb, str(tmp_path / "torch"), lut_name="LUT")
    jax_save_lut_bank(jb, str(tmp_path / "jax"), lut_name="LUT")
    back_j = jax_load_lut_bank(str(tmp_path / "torch"), lut_name="LUT")
    back_t = load_lut_bank(str(tmp_path / "jax"), lut_name="LUT")
    for got in (back_j, back_t):
        for key in jb.stage2:
            np.testing.assert_array_equal(got.stage2[key], jb.stage2[key])
        for key in jb.stage1:
            np.testing.assert_array_equal(got.stage1[key], jb.stage1[key])
    assert sorted(os.listdir(tmp_path / "torch")) \
        == sorted(os.listdir(tmp_path / "jax"))
    with pytest.raises(ValueError, match="int8"):
        bank_from_arrays({"s": np.full((17 ** 4, 1), 300)}, jb.stage2)
