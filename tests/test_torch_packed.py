"""The port's packed8 / packed32 / cells LUT table layouts against lerf_tpu:
rotation groups, packed rows and cell rows array-equal, the packed and
cell ensembles bit-equal at intervals 3, 4 and 5, banded stages bit-equal
to unbanded, ``LutPredictor(table_layout=...)`` SR and warp bit-equal to
lerf_tpu's predictor with the same layout, and K2's row-mode plan (what
the kernel reads on the card) evaluated here the way the kernel reads it,
each member's slot in place or copied whole by its warp, bit-equal to the
plain stage and to lerf_tpu's ensemble.  All int32: every comparison is
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


def member_blend(v, perm, q):
    """A member's corners (bits raised in rank order, by role-permuted
    bits) and weights from its 4 role-order samples, as the kernel's
    sorting network orders the (fraction, role, corner bit) keys."""
    keys = np.stack([((v[k] & (q - 1)) << 6) | (k << 4)
                     | (1 << (3 - perm[k])) for k in range(4)], -1)
    keys = -np.sort(-keys, axis=-1)              # rank 0 = largest
    vt = keys >> 6
    corners = np.concatenate(
        [np.zeros_like(vt[..., :1]), np.cumsum(keys & 15, -1)], -1)
    wts = np.concatenate([q - vt[..., :1], vt[..., :-1] - vt[..., 1:],
                          vt[..., -1:]], -1)
    return corners, wts


def emulate_rows(img, tables, modes, split_r, interval, slotted=None):
    """K2's row mode as the kernel reads it, in numpy, on the plan
    ``row_members`` ships (or with every member's slots copied,
    ``slotted`` 1, or none, 0): each member's offsets clamped to the image,
    its cell from the roles' MSBs weighed by (L-1)^(3 - perm), the
    descending sort of (fraction, role) keys, corners by role-permuted
    bits, the values at slot + cell·row bytes + (channel · cstride +
    corner · bstride) · value bytes.  A copied member's warp (32 columns of
    a tile row, lanes past the frame's edge on edge-clamped samples)
    copies its slots' 16 × oC values alone and reads them there when its
    pixels lie on more than 16 runs of cells, else reads them in place.
    Returns the member sum, int64 [C, H, W, oC], and the (member, warp)
    reads that copied and that read a copied member's slots in place."""
    plan = k2.row_members(tables, modes, split_r, torch.device("cpu"))
    members = plan.members.copy()
    if slotted is not None:
        members[:, 15] = slotted
    if isinstance(tables, tlp.PackedTables):
        stores = [g.table for m in modes for g in tables.groups[m]]
    else:
        stores = [tables.table]
    c, h, w = img.shape
    wp = -(-w // 32) * 32
    q, cells, oc = 1 << interval, 1 << (8 - interval), plan.oc
    ii, jj = np.meshgrid(np.arange(h), np.arange(wp), indexing="ij")
    acc = np.zeros((c, h, wp, oc), np.int64)
    n_copied = n_direct = 0
    for d, ptr in zip(members, plan.slots):
        store = next(t for t in stores
                     if t.data_ptr() <= int(ptr) < t.data_ptr()
                     + t.numel() * t.element_size())
        flat = store.numpy().reshape(-1)
        base = (int(ptr) - store.data_ptr()) // plan.esize
        v = [img[:, np.clip(ii + d[2 * k], 0, h - 1),
                 np.clip(jj + d[2 * k + 1], 0, w - 1)] for k in range(4)]
        perm = d[8:12]
        cell = sum((v[k] >> interval) * cells ** (3 - perm[k])
                   for k in range(4))
        corners, wts = member_blend(v, perm, q)
        rows = base + cell[..., None] * (d[12] // plan.esize)
        cs, bs = d[13], d[14]
        if d[15]:
            runs = 1 + (np.diff(cell.reshape(c, h, wp // 32, 32), axis=-1)
                        != 0).sum(-1)
            n_copied += int((runs > 16).sum())
            n_direct += int((runs <= 16).sum())
            copy = np.repeat(runs > 16, 32, axis=-1)[..., None]
            slots = flat[rows + np.arange(16 * oc)]   # a slot copied whole
        for ch in range(oc):
            idx = ch * cs + corners * bs
            vals = flat[rows + idx]
            if d[15]:
                assert idx.max() < 16 * oc
                vals = np.where(copy, np.take_along_axis(slots, idx, -1),
                                vals)
            acc[..., ch] += (wts * vals).sum(-1)
    return acc[:, :, :w], n_copied, n_direct


def slotted_cases(layout):
    """The copy plans the kernel takes on a layout: as shipped, none, and
    (int32 rows) every member's slots copied."""
    return (None, 0) if layout == "packed8" else (None, 0, 1)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_row_members_read_as_the_kernel_reads_them(stage, layout):
    """The plan K2's row mode gets, read the kernel's way, sums to the
    plain ensemble, with its members' slots copied as shipped (the int32
    layouts' stage-2 slots), none or all; every member's offsets are its
    rotated offsets."""
    _, _, split_r, oc = STAGES[stage]
    luts = rand_luts(MODES, oc, split_r, seed=5)
    tables = tlp.stage_tables(luts, layout, MODES, split_r=split_r)
    plan = k2.row_members(tables, MODES, split_r, torch.device("cpu"))
    assert plan.oc == oc and plan.esize == (1 if layout == "packed8" else 4)
    assert plan.members.shape == (12, 16) and plan.slots.shape == (12,)
    assert list(plan.members[:, 15]) == [
        int(layout != "packed8" and stage == "stage2")] * 12
    want_offs = sorted(tuple(v for off in tlp.MODE_OFFSETS[m]
                             for v in tlp.rotate_offset(off, r))
                       for m in MODES for r in range(4))
    assert sorted(tuple(d[:8]) for d in plan.members) == want_offs
    assert k2.row_members(tables, MODES, split_r,
                          torch.device("cpu")) is plan          # cached
    img = image((2, 11, 14), seed=7)
    want = tlp.lut_ensemble(torch.from_numpy(img), tables, MODES,
                            split_r=split_r)
    for slotted in slotted_cases(layout):
        np.testing.assert_array_equal(
            emulate_rows(img, tables, MODES, split_r, 4, slotted)[0],
            want.numpy())


def smooth(shape, seed):
    """A seeded uniform field box-blurred (15 pixels) and stretched to
    0..255: neighbouring pixels share lattice cells, as in photographs."""
    c, h, w = shape
    a = np.random.RandomState(seed).randint(0, 256, (c, h + 14, w + 14))
    s = np.pad(a, ((0, 0), (1, 0), (1, 0))).cumsum(1).cumsum(2)
    b = s[:, 15:, 15:] - s[:, :-15, 15:] - s[:, 15:, :-15] + s[:, :-15, :-15]
    b = b - b.min()
    return (b * 255 // max(b.max(), 1)).astype(np.int32)


def ragged_frame(kind, shape, seed):
    if kind == "random":
        return image(shape, seed)
    if kind == "smooth":
        return smooth(shape, seed)
    if kind == "runs":          # constant 4 × 8 blocks
        c, h, w = shape
        blocks = image((c, -(-h // 4), -(-w // 8)), seed)
        return np.ascontiguousarray(
            blocks.repeat(4, 1).repeat(8, 2)[:, :h, :w])
    out = smooth(shape, seed)   # "mixed": a smooth warp, random warps
    out[..., 32:] = image(shape, seed)[..., 32:]
    return out


# (frame kind, shape): frames that are not multiples of the kernel's
# 8 × 32 and 16 × 32 tiles (a frame narrower than one tile, one row, a
# ragged last warp) with border anchors (delta −3) on every side; random
# frames, whose warps copy their slots, smooth and run-structured ones,
# whose warps read in place, and a frame that mixes both
RAGGED_CASES = {"random-21x45": ("random", (2, 21, 45)),
                "random-5x9": ("random", (1, 5, 9)),
                "random-1x40": ("random", (1, 1, 40)),
                "smooth-21x45": ("smooth", (2, 21, 45)),
                "runs-11x14": ("runs", (2, 11, 14)),
                "mixed-9x70": ("mixed", (1, 9, 70))}


@pytest.mark.parametrize("case", sorted(RAGGED_CASES))
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_rows_read_on_ragged_frames(stage, layout, case):
    """The row mode's read, then the stage epilogue, on ragged random,
    smooth and mixed frames: bit-equal to the plain stage on the layout,
    whether the members' slots are copied as shipped, none or all; on the
    mixed frame the copied members' warps both copy and read in place."""
    _, _, split_r, oc = STAGES[stage]
    kind, shape = RAGGED_CASES[case]
    luts = rand_luts(MODES, oc, split_r, seed=11)
    tables = tlp.stage_tables(luts, layout, MODES, split_r=split_r)
    img = ragged_frame(kind, shape, seed=13)
    den, bias = (48, 0) if stage == "stage1" else (192, 127)
    want = tlp.lut_stage_plain(torch.from_numpy(img), tables, MODES,
                               split_r=split_r, den=den, bias=bias)
    acc, n_copied, n_direct = emulate_rows(img, tables, MODES, split_r, 4)
    got = tlp.stage_epilogue(torch.from_numpy(acc).to(torch.int32), den,
                             bias, 255)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    for slotted in slotted_cases(layout)[1:]:
        again, copied, direct = emulate_rows(img, tables, MODES, split_r, 4,
                                             slotted)
        np.testing.assert_array_equal(again, acc)
        if slotted and kind == "mixed":
            assert copied > 0 and direct > 0
        if slotted and kind == "random" and shape[-1] >= 32:
            assert copied > 0       # a warp on 32 of the frame's pixels
    if kind == "mixed" and n_copied + n_direct:
        assert n_copied > 0 and n_direct > 0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_rows_read_on_lerf_tpu_tables(layout):
    """The row mode's read on lerf_tpu's own tables
    (``build_packed_tables``, ``build_cell_table``): bit-equal to
    lerf_tpu's ensemble on them, with the slots copied as shipped, none or
    all, at a frame with border anchors on every side."""
    split_r, oc = (False, 1) if layout == "packed32" else (True, 3)
    luts = rand_luts(MODES, oc, split_r, seed=17)
    img = image((1, 7, 10), seed=19)
    if layout == "cells":
        cells = {k: np.asarray(jsx.build_cell_table(
            jnp.asarray(v.astype(np.int32)), 4)) for k, v in luts.items()}
        keys = tuple(sorted(cells))
        tables = tlp.CellTables(keys=keys, table=torch.from_numpy(
            np.stack([cells[k] for k in keys])).contiguous())
        want = jlp.lut_ensemble(jnp.asarray(img), {k: jnp.asarray(v) for
                                                   k, v in cells.items()},
                                MODES, split_r=split_r)
    else:
        dt = np.int8 if layout == "packed8" else np.int32
        jp = jlp.build_packed_tables(
            as_jax({k: v.astype(dt) for k, v in luts.items()}, dt), MODES,
            split_r=split_r)
        tables = tlp.PackedTables(groups={
            m: tuple(tlp.PackedGroup(
                table=torch.from_numpy(np.array(w["table"])),
                oc=w["oc"], rots=w["rots"], canon=w["canon"],
                deltas=w["deltas"], perms=w["perms"])
                for w in jp.groups[m]) for m in MODES})
        want = jlp.lut_ensemble_packed(jnp.asarray(img), jp, MODES)
    for slotted in slotted_cases(layout):
        got = emulate_rows(img, tables, MODES, split_r, 4, slotted)[0]
        np.testing.assert_array_equal(got, np.asarray(want))


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
