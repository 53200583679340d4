"""The port's packed8 / packed32 / cells LUT table layouts against lerf_tpu:
rotation groups, packed rows and cell rows array-equal, the packed and
cell ensembles bit-equal at intervals 3, 4 and 5, banded stages bit-equal
to unbanded, ``LutPredictor(table_layout=...)`` SR and warp bit-equal to
lerf_tpu's predictor with the same layout, and K2's row-mode member table
(what the kernel reads on the card) evaluated here the way the kernel
reads it, bit-equal to the plain stage.  All int32: every comparison is
exact.  Torch runs on one thread (``one_torch_thread``)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import shared_lut_predictor
from lerf_tpu.ops import lut_pipeline as jlp
from lerf_tpu.ops import simplex as jsx
from lerf_tpu.pipeline import LutPredictor as JaxLutPredictor

from lerf_torch.convert import bank_from_arrays
from lerf_torch.ops import lut_pipeline as tlp
from lerf_torch.ops import simplex as tsx
from lerf_torch.ops.kernels import lut_stage as k2
from lerf_torch.pipeline import LutPredictor

MODES = ("s", "c", "t")
LAYOUTS = ("packed8", "packed32", "cells")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU paths run many small torch ops; with one intra-op
    thread a core they stall whenever the test workers share the cores, so
    this module runs torch on one thread and gives the count back after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rand_luts(modes, oc, split_r, interval=4, seed=0):
    """int8 ``[L⁴, oC]`` tables keyed like a stage's (by mode, or r0 / r1)."""
    rng = np.random.RandomState(seed)
    n = ((1 << (8 - interval)) + 1) ** 4
    keys = [f"{m}r{r}" for m in modes for r in (0, 1)] if split_r \
        else list(modes)
    return {k: rng.randint(-127, 128, (n, oc)).astype(np.int8) for k in keys}


def as_jax(luts, dtype=np.int32):
    return {k: jnp.asarray(v.astype(dtype)) for k, v in luts.items()}


def image(shape, seed=3):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.int32)


@pytest.mark.parametrize("mode", ["s", "d", "c", "t", "y"])
def test_group_rotations_equal(mode):
    want = jlp.group_rotations(mode)
    got = tlp.group_rotations(mode)
    assert got == want
    for g in got:                     # and reproduce every rotated offset
        for r, delta, perm in zip(g["rots"], g["deltas"], g["perms"]):
            assert [(delta[0] + g["canon"][perm[k]][0],
                     delta[1] + g["canon"][perm[k]][1]) for k in range(4)] \
                == [tlp.rotate_offset(off, r)
                    for off in tlp.MODE_OFFSETS[mode]]


@pytest.mark.parametrize("modes,split_r,oc,dtype,max_row_bytes", [
    (MODES, False, 1, np.int8, 128),
    (MODES, True, 3, np.int8, 128),
    (MODES, True, 3, np.int32, 128),
    (("s", "d", "y"), False, 1, np.int32, 64),
    (("s",), True, 3, np.int8, 1024),
    (("c",), True, 3, np.int8, 16),
], ids=["s1-int8", "s2-int8", "s2-int32", "sdy-int32-64B", "s-int8-1KB",
        "c-int8-16B"])
def test_build_packed_tables_equal(modes, split_r, oc, dtype, max_row_bytes):
    luts = rand_luts(modes, oc, split_r, interval=5, seed=oc)
    cast = {k: v.astype(dtype) for k, v in luts.items()}
    want = jlp.build_packed_tables(as_jax(cast, dtype), modes,
                                   split_r=split_r, interval=5,
                                   max_row_bytes=max_row_bytes)
    got = tlp.build_packed_tables(cast, modes, split_r=split_r, interval=5,
                                  max_row_bytes=max_row_bytes)
    assert list(got.groups) == list(want.groups) and got.interval == 5
    for mode in modes:
        assert len(got.groups[mode]) == len(want.groups[mode])
        for g, w in zip(got.groups[mode], want.groups[mode]):
            assert g.table.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
            np.testing.assert_array_equal(g.table.numpy(),
                                          np.asarray(w["table"]))
            assert (g.oc, g.rots, g.canon, g.deltas, g.perms) == (
                w["oc"], w["rots"], w["canon"], w["deltas"], w["perms"])
            assert g.table.shape[1] * g.table.element_size() \
                <= max(max_row_bytes, oc * 16 * np.dtype(dtype).itemsize)


# interval 3 (L = 33) keeps to one mode and one channel: its tables are
# 1.2M entries, its packed rows 1M cells
INTERVAL_CASES = {3: (("s",), False, 1), 4: (MODES, True, 3),
                  5: (("s", "d", "y"), False, 1)}


@pytest.mark.parametrize("interval,dtype", [
    (3, np.int8), (4, np.int8), (4, np.int32), (5, np.int8), (5, np.int32)],
    ids=["3-packed8", "4-packed8", "4-packed32", "5-packed8", "5-packed32"])
def test_lut_ensemble_packed_equal(interval, dtype):
    modes, split_r, oc = INTERVAL_CASES[interval]
    luts = rand_luts(modes, oc, split_r, interval=interval, seed=interval)
    cast = {k: v.astype(dtype) for k, v in luts.items()}
    img = image((2, 9, 13), seed=interval)
    jp = jlp.build_packed_tables(as_jax(cast, dtype), modes, split_r=split_r,
                                 interval=interval)
    want = np.asarray(jlp.lut_ensemble_packed(jnp.asarray(img), jp, modes,
                                              interval=interval))
    flat = np.asarray(jlp.lut_ensemble(jnp.asarray(img), as_jax(luts), modes,
                                       interval=interval, split_r=split_r))
    np.testing.assert_array_equal(want, flat)
    tp = tlp.build_packed_tables(cast, modes, split_r=split_r,
                                 interval=interval)
    got = tlp.lut_ensemble(torch.from_numpy(img), tp, modes,
                           interval=interval, split_r=split_r)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("interval", sorted(INTERVAL_CASES))
def test_simplex4d_cells_equal(interval):
    modes, split_r, oc = INTERVAL_CASES[interval]
    luts = rand_luts(modes, oc, split_r, interval=interval, seed=interval)
    key = sorted(luts)[0]
    want_cells = jsx.build_cell_table(
        jnp.asarray(luts[key].astype(np.int32)), interval)
    cells = tsx.build_cell_table(luts[key].astype(np.int32), interval)
    np.testing.assert_array_equal(cells, np.asarray(want_cells))
    abcd = [image((2, 7, 11), seed=interval + k) for k in range(4)]
    want = jsx.simplex4d_cells(jnp.asarray(cells), *map(jnp.asarray, abcd),
                               interval=interval)
    got = tsx.simplex4d_cells(torch.from_numpy(cells),
                              *map(torch.from_numpy, abcd), interval=interval)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and the whole cell-table ensemble
    img = image((2, 9, 13), seed=interval)
    want = jlp.lut_ensemble(
        jnp.asarray(img), {k: jnp.asarray(jsx.build_cell_table(
            v.astype(np.int32), interval)) for k, v in luts.items()},
        modes, interval=interval, split_r=split_r)
    got = tlp.lut_ensemble(torch.from_numpy(img),
                           tlp.CellTables.create(luts, interval=interval),
                           modes, interval=interval, split_r=split_r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


STAGES = {"stage1": (jlp.lut_stage1, tlp.lut_stage1, False, 1),
          "intermediate": (jlp.lut_stage1_intermediate,
                           tlp.lut_stage1_intermediate, False, 1),
          "stage2": (jlp.lut_stage2, tlp.lut_stage2, True, 3)}


@pytest.mark.parametrize("layout", ("flat",) + LAYOUTS)
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_banded_stage_equals_unbanded(stage, layout):
    """A band target of 3 rows' pixels runs 6 bands with their halos; the
    result is the unbanded stage's, and lerf_tpu's banded stage's."""
    jax_fn, fn, split_r, oc = STAGES[stage]
    luts = rand_luts(MODES, oc, split_r, seed=oc)
    tables = tlp.stage_tables(luts, layout, MODES, split_r=split_r)
    img = image((2, 17, 10))
    target = 2 * 3 * 10
    whole = fn(torch.from_numpy(img), tables, MODES)
    banded = fn(torch.from_numpy(img), tables, MODES, band_target=target)
    assert torch.equal(whole, banded)
    want = jax_fn(jnp.asarray(img), as_jax(luts), MODES, band_target=target)
    np.testing.assert_array_equal(banded.numpy(), np.asarray(want))


def test_banded_rows_splits_into_bands():
    calls = []

    def fn(part):
        calls.append(part.shape[-2])
        return part[..., None]

    img = torch.arange(2 * 17 * 4).reshape(2, 17, 4)
    out = tlp._banded_rows(img, fn, 1, target=2 * 3 * 4)
    assert len(calls) == 6 and max(calls) <= 3 + 2 * tlp.MAX_PAD
    assert torch.equal(out[..., 0], img)


def emulate_rows(img, tables, modes, split_r, interval):
    """K2's row mode as the kernel reads it, in numpy: each member's
    descriptor row and slot pointer from ``row_members`` (offsets clamped
    to the image, cell index from the roles' MSBs weighed by (L-1)^(3 -
    perm), the descending sort of (fraction, role) keys, corners by
    role-permuted bits, the values at slot + cell·row bytes + (channel ·
    cstride + corner · bstride) · value bytes).  Returns the member sum,
    int64 [C, H, W, oC]."""
    members, ptrs, esize, oc = k2.row_members(tables, modes, split_r,
                                              torch.device("cpu"))
    if isinstance(tables, tlp.PackedTables):
        stores = [g.table for m in modes for g in tables.groups[m]]
    else:
        stores = [tables.table]
    c, h, w = img.shape
    q, cells = 1 << interval, 1 << (8 - interval)
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    acc = np.zeros((c, h, w, oc), np.int64)
    for d, ptr in zip(members, ptrs):
        store = next(t for t in stores
                     if t.data_ptr() <= int(ptr) < t.data_ptr()
                     + t.numel() * t.element_size())
        flat = store.numpy().reshape(-1)
        base = (int(ptr) - store.data_ptr()) // esize
        v = [img[:, np.clip(ii + d[2 * k], 0, h - 1),
                 np.clip(jj + d[2 * k + 1], 0, w - 1)] for k in range(4)]
        perm = d[8:12]
        cell = sum((v[k] >> interval) * cells ** (3 - perm[k])
                   for k in range(4))
        keys = np.stack([((v[k] & (q - 1)) << 6) | (k << 4)
                         | (1 << (3 - perm[k])) for k in range(4)], -1)
        keys = -np.sort(-keys, axis=-1)              # rank 0 = largest
        vt = keys >> 6
        corners = np.concatenate(
            [np.zeros_like(vt[..., :1]), np.cumsum(keys & 15, -1)], -1)
        wts = np.concatenate([q - vt[..., :1], vt[..., :-1] - vt[..., 1:],
                              vt[..., -1:]], -1)
        rstride, cs, bs = d[12] // esize, d[13], d[14]
        for ch in range(oc):
            idx = base + cell[..., None] * rstride + ch * cs + corners * bs
            acc[..., ch] += (wts * flat[idx]).sum(-1)
    return acc


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_row_members_read_as_the_kernel_reads_them(stage, layout):
    """The member table K2's row mode gets, read the kernel's way, sums to
    the plain ensemble; every member's offsets are its rotated offsets."""
    _, _, split_r, oc = STAGES[stage]
    luts = rand_luts(MODES, oc, split_r, seed=5)
    tables = tlp.stage_tables(luts, layout, MODES, split_r=split_r)
    members, ptrs, esize, got_oc = k2.row_members(
        tables, MODES, split_r, torch.device("cpu"))
    assert got_oc == oc and esize == (1 if layout == "packed8" else 4)
    assert members.shape == (12, 16) and ptrs.shape == (12,)
    want_offs = sorted(tuple(v for off in tlp.MODE_OFFSETS[m]
                             for v in tlp.rotate_offset(off, r))
                       for m in MODES for r in range(4))
    assert sorted(tuple(d[:8]) for d in members) == want_offs
    assert k2.row_members(tables, MODES, split_r,
                          torch.device("cpu"))[0] is members   # cached
    img = image((2, 11, 14), seed=7)
    want = tlp.lut_ensemble(torch.from_numpy(img), tables, MODES,
                            split_r=split_r)
    np.testing.assert_array_equal(emulate_rows(img, tables, MODES, split_r, 4),
                                  want.numpy())


def jax_bank():
    return shared_lut_predictor().bank


def port_bank():
    b = jax_bank()
    return bank_from_arrays(b.stage1, b.stage2, b.inter, b.out_c, b.interval)


WARP_M = np.array([[1.9, 0.1, 0.5], [-0.05, 2.1, 0.3], [0.001, 0.0005, 1.0]])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_lut_predictor_layout_matches_jax(layout):
    """SR (×2) and warp on a tiny frame: bit-equal to lerf_tpu's predictor
    with the same layout (its packed programs compile 6–7× slower on
    XLA:CPU than flat ones, hence the size), and to the port's flat
    predictor, stages included."""
    img = np.random.RandomState(0).randint(0, 256, (8, 10, 3)) \
        .astype(np.uint8)
    jp = JaxLutPredictor(jax_bank(), table_layout=layout)
    tp = LutPredictor(port_bank(), table_layout=layout, device="cpu")
    flat = LutPredictor(port_bank(), device="cpu")
    want = jp.upscale(img, 2, 2, return_aux=True)
    got = tp.upscale(img, 2, 2, return_aux=True)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, np.asarray(a))
    for a, b in zip(flat.upscale(img, 2, 2, return_aux=True), got):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jp.warp(img, WARP_M, (16, 20)),
                    tp.warp(img, WARP_M, (16, 20))):      # frame, mask
        np.testing.assert_array_equal(b, np.asarray(a))


def test_lut_predictor_layouts_replicate_over_a_mesh():
    """With ``mesh=``, each layout is on every distinct device, and the
    batch form over two CPU shards equals frame-by-frame ``upscale``."""
    from lerf_torch.parallel import make_mesh

    mesh = make_mesh(devices=["cpu"] * 2)
    pred = LutPredictor(port_bank(), table_layout="packed8", mesh=mesh)
    assert isinstance(pred._tables[torch.device("cpu")][1],
                      tlp.PackedTables)
    imgs = np.stack([np.random.RandomState(s).randint(0, 256, (6, 7, 3))
                     .astype(np.uint8) for s in range(2)])
    got = pred.upscale_batch(imgs, 2, 2)
    for b in range(2):
        np.testing.assert_array_equal(got[b], pred.upscale(imgs[b], 2, 2))


def test_unknown_layout_raises():
    with pytest.raises(ValueError, match="unknown table_layout"):
        tlp.stage_tables(rand_luts(MODES, 1, False), "packed4", MODES,
                         split_r=False)
