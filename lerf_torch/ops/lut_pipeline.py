"""LUT-ensemble stages (the LeRF-G deploy path), plain twin of kernel K2.

Reference semantics: ``resample/eval_lut_sr.py:541-628`` — each stage rotates
the image 4×, pads bottom/right per sampling mode, runs 4D-simplex LUT
interpolation for every mode, rotates back and averages; stage 2 uses
separate r0/r1 tables for even/odd rotations because the Gaussian hyper
parameters are not rotation-equivariant (σx/σy swap under 90°).

As in ``lerf_tpu/ops/lut_pipeline.py``, the *sampling offsets* rotate
instead of the image: ``rot_back(LUT(rot(img)))`` equals sampling the 4
mode neighbours at inverse-rotated offsets from an all-sides edge-padded
image.  All stage arithmetic is int32 with exact round-half-even division,
so the stage outputs are bit-identical to the reference.

The table layouts are lerf_tpu's (``LutPredictor(table_layout=)``):
:class:`FlatTables` (``"flat"``): the stage's flat ``[L⁴, oC]`` int8
tables stacked in key order, beside the copies K2 reads (padded corner
words for oC = 3, 16-corner cell rows for oC = 1); :class:`PackedTables`
(``"packed8"`` / ``"packed32"``): rotation-group rows, the members of a
mode whose rotations sample one pixel set side by side in one row of
int8 or int32 (:func:`build_packed_tables`); :class:`CellTables`
(``"cells"``): one int32 row of 16 corners a cell and member
(:func:`~lerf_torch.ops.simplex.build_cell_table`).  The public stage
functions (:func:`lut_stage1`, :func:`lut_stage1_intermediate`,
:func:`lut_stage2`) take any of them and run through the K2 wrapper
(:mod:`lerf_torch.ops.kernels.lut_stage`): the kernel on a CUDA tensor
(its row mode for the packed and cell layouts), :func:`lut_stage_plain`
on a CPU tensor.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .simplex import (build_cell_table, round_half_even_div, simplex4d,
                      simplex4d_cells, simplex_weights16)

# neighbor (row, col) offsets per sampling mode, in the rotated frame,
# role order (a, b, c, d) — eval_lut_sr.py:31-81
MODE_OFFSETS = {
    "s": ((0, 0), (0, 1), (1, 0), (1, 1)),
    "d": ((0, 0), (0, 2), (2, 0), (2, 2)),
    "y": ((0, 0), (1, 1), (1, 2), (2, 1)),
    "c": ((0, 0), (0, 1), (0, 2), (0, 3)),
    "t": ((0, 0), (1, 1), (2, 2), (3, 3)),
}

# bottom/right pad per mode in the reference (eval_lut_sr.py:12-18); the
# all-sides pad uses the max over modes
MODE_PAD = {"s": 1, "d": 2, "y": 2, "c": 3, "t": 3}
MAX_PAD = 3
TABLE_LAYOUTS = ("flat", "packed8", "packed32", "cells")


def rotate_offset(off, r: int):
    """Offset transform equivalent to rot90(img, r) → sample → rot90 back:
    r=0 (i,j); r=1 (j,-i); r=2 (-i,-j); r=3 (-j,i)."""
    i, j = off
    if r % 4 == 0:
        return (i, j)
    if r % 4 == 1:
        return (j, -i)
    if r % 4 == 2:
        return (-i, -j)
    return (-j, i)


def edge_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Indices that edge-pad an axis of length ``n`` by ``lo``/``hi``."""
    return torch.arange(-lo, n + hi, device=device).clamp_(0, n - 1)


def _pad_all_sides(img: torch.Tensor, pad: int = MAX_PAD):
    """Edge-pad the trailing two dims by ``pad`` on every side, the border
    rows and columns repeated by ``expand`` + ``cat``: the values of an
    ``edge_index`` gather, and a backward that sums the copies without
    atomics, so a training step's gradients come out the same on every
    run on a card."""
    def axis(x, dim):
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = pad
        return torch.cat([x.narrow(dim, 0, 1).expand(shape), x,
                          x.narrow(dim, n - 1, 1).expand(shape)], dim)

    return axis(axis(img, -2), -1)


def _sample4(xpad: torch.Tensor, h: int, w: int, mode: str, r: int,
             pad: int = MAX_PAD):
    """The 4 mode-geometry neighbors for rotation r, as slices."""
    outs = []
    for off in MODE_OFFSETS[mode]:
        oi, oj = rotate_offset(off, r)
        outs.append(xpad[..., pad + oi:pad + oi + h, pad + oj:pad + oj + w])
    return outs


def ensemble_members(modes: Sequence[str], split_r: bool):
    """[(mode, rotation, lut_key)] for the 4·len(modes) ensemble members:
    the mode's r0 table at every rotation, or (``split_r``) r0 at 0/2 and
    r1 at 1/3 (eval_lut_sr.py:580-619)."""
    out = []
    for mode in modes:
        for r in range(4):
            out.append((mode, r, f"{mode}r{r % 2}" if split_r else mode))
    return out


@dataclasses.dataclass(frozen=True)
class FlatTables:
    """One stage's LUTs on the device: ``table[k]`` is the flat int8
    ``[L⁴, oC]`` table of ``keys[k]`` (keys sorted).  K2 reads copies laid
    out for its loads, made here once: for oC = 3 ``padded`` ``[K, L⁴, 4]``
    (each corner's values in one aligned 4-byte word, the fourth byte
    zero), for oC = 1 ``cells`` (:func:`cell_rows`).  The plain twin reads
    ``table``."""
    keys: Tuple[str, ...]
    table: torch.Tensor           # int8 [K, L⁴, oC], contiguous
    padded: Optional[torch.Tensor] = None   # int8 [K, L⁴, 4], oC = 3
    cells: Optional[torch.Tensor] = None    # int8 [K, (L-1)⁴, 16], oC = 1

    @classmethod
    def create(cls, luts: Dict[str, np.ndarray], device="cpu"):
        keys = tuple(sorted(luts))
        stacked = np.stack([np.asarray(luts[k]).astype(np.int8)
                            for k in keys])
        table = torch.from_numpy(stacked).to(device).contiguous()
        if table.shape[-1] == 3:
            return cls(keys=keys, table=table, padded=torch.nn.functional
                       .pad(table, (0, 1)).contiguous())
        return cls(keys=keys, table=table, cells=cell_rows(table))


def cell_rows(table: torch.Tensor) -> torch.Tensor:
    """int8 ``[K, L⁴, 1]`` → ``[K, (L-1)⁴, 16]``: row ``cell`` of table k
    holds the 16 corners of the MSB cell ``((a·(L-1) + b)·(L-1) + c)·(L-1)
    + d``, corner ``bits`` at the entry raised by role a if bit 3 is set,
    b if bit 2, c if bit 1, d if bit 0 (the JAX package's packed rows for
    one output channel)."""
    k, l4, _ = table.shape
    lat = round(l4 ** 0.25)
    if lat ** 4 != l4:
        raise ValueError(f"table of {l4} entries is not an L⁴ lattice")
    a = torch.arange(lat - 1, device=table.device)
    cell = (((a[:, None, None, None] * lat + a[None, :, None, None]) * lat
             + a[None, None, :, None]) * lat + a[None, None, None, :])
    bits = torch.arange(16, device=table.device)
    raise_ = sum(((bits >> (3 - r)) & 1) * lat ** (3 - r) for r in range(4))
    return table[:, :, 0][:, cell.reshape(-1, 1) + raise_].contiguous()


def member_offsets(members) -> np.ndarray:
    """int32 ``[M, 8]``: per ``(mode, rotation)`` member the 4 rotated
    (row, col) sample offsets in role order."""
    return np.asarray([[v for off in MODE_OFFSETS[mode]
                        for v in rotate_offset(off, r)]
                       for mode, r in members], np.int32).reshape(-1, 8)


def member_descriptors(modes: Sequence[str], split_r: bool,
                       keys: Sequence[str]) -> np.ndarray:
    """int32 ``[M, 9]``: per member the 4 rotated (row, col) sample offsets
    in role order, then the index of its table in ``keys``.  Read-only and
    cached: K2's wrapper asks for it at every launch, on the host path of
    a frame."""
    return _member_descriptors(tuple(modes), bool(split_r), tuple(keys))


@functools.lru_cache(maxsize=64)
def _member_descriptors(modes, split_r, keys):
    members = ensemble_members(modes, split_r)
    index = [[keys.index(key)] for _, _, key in members]
    desc = np.concatenate(
        [member_offsets([(m, r) for m, r, _ in members]),
         np.asarray(index, np.int32)], axis=1)
    desc.flags.writeable = False
    return desc


def stack_ensemble_inputs(img: torch.Tensor, modes: Sequence[str],
                          split_r: bool, tables: FlatTables):
    """The batched-ensemble operands: per-role neighbour stacks
    [M, ..., H, W], the stacked LUT [K·L⁴, oC] and per-member flat table
    offsets — so the whole mode×rotation ensemble is ONE simplex call."""
    k, l4, oc = tables.table.shape
    lut_offset, a, b, c, d = ensemble_roles(img, modes, split_r,
                                            tables.keys, l4)
    return tables.table.reshape(k * l4, oc), lut_offset, a, b, c, d


def ensemble_roles(img: torch.Tensor, modes: Sequence[str], split_r: bool,
                   keys: Sequence[str], l4: int):
    """Each ensemble member's 4 neighbours of every pixel as per-role
    stacks [M, ..., H, W] from the edge-padded image, and each member's
    offset into the tables of ``keys`` stacked in that order (its table's
    index · ``l4``), int32 [M, 1, ...]."""
    h, w = img.shape[-2], img.shape[-1]
    xpad = _pad_all_sides(img)
    members = ensemble_members(modes, split_r)
    roles = [[], [], [], []]
    offs = []
    for mode, r, key in members:
        for role, sm in zip(roles, _sample4(xpad, h, w, mode, r)):
            role.append(sm)
        offs.append(list(keys).index(key) * l4)
    a, b, c, d = (torch.stack(role, dim=0) for role in roles)
    lut_offset = torch.tensor(offs, dtype=torch.int32,
                              device=img.device).reshape(
        (len(members),) + (1,) * img.ndim)
    return lut_offset, a, b, c, d


# ---------------------------------------------------------------------------
# packed rotation-group tables and cell rows (lerf_tpu's other layouts)
# ---------------------------------------------------------------------------
#
# Rotation-ensemble members of one mode often sample the SAME pixel set with
# permuted (a, b, c, d) roles: all 4 rotations of the 2×2 modes (s, d), the
# pairs {0, 2} / {1, 3} of the collinear modes (c, t).  Members sharing a
# pixel set share the lattice cell of that set, so their 16-corner rows sit
# side by side in one row of a packed table, each member's slot holding ITS
# table's values at ITS role-permuted coordinates.  Rows are laid out
# [member, channel, corner bits] with corner bits in canonical position
# space (bit 3 - m for canonical sample m); the blend weighs the corners by
# role-permuted bits (``simplex_weights16(bit_of=...)``).


def group_rotations(mode: str):
    """Group the 4 rotations of ``mode`` by translated-pixel-set equality.

    Returns a list of groups ``{"canon", "rots", "deltas", "perms"}``:
    member rotation ``rots[i]`` samples role k at ``p + deltas[i] +
    canon[perms[i][k]]`` for every output pixel p (lerf_tpu's
    ``group_rotations``)."""
    offs = MODE_OFFSETS[mode]
    groups: List[dict] = []
    for r in range(4):
        o = [rotate_offset(off, r) for off in offs]
        mi = min(p[0] for p in o)
        mj = min(p[1] for p in o)
        norm = [(p[0] - mi, p[1] - mj) for p in o]
        for g in groups:
            if set(norm) == set(g["canon"]):
                g["rots"].append(r)
                g["deltas"].append((mi, mj))
                g["perms"].append(tuple(g["canon"].index(norm[k])
                                        for k in range(4)))
                break
        else:
            groups.append({"canon": tuple(norm), "rots": [r],
                           "deltas": [(mi, mj)], "perms": [(0, 1, 2, 3)]})
    return groups


@dataclasses.dataclass(frozen=True)
class PackedGroup:
    """One (sub-)group of a mode's rotations: ``table`` ``[(L-1)⁴, G·oC·16]``
    int8 or int32 (member i's channel c at lanes ``(i·oC + c)·16 ..
    +15``, corner bits in canonical position space), and the static
    geometry: member rotations, the canonical pixel set, each member's
    anchor offset and role permutation."""
    table: torch.Tensor
    oc: int
    rots: Tuple[int, ...]
    canon: Tuple[Tuple[int, int], ...]
    deltas: Tuple[Tuple[int, int], ...]
    perms: Tuple[Tuple[int, ...], ...]


@dataclasses.dataclass(frozen=True)
class PackedTables:
    """``groups[mode]``: the mode's :class:`PackedGroup` s, in the order
    :func:`build_packed_tables` makes them (lerf_tpu's ``PackedTables``:
    tensors and static group metadata; each member's table, r0 / r1 or
    the mode's one, is baked into its slot)."""
    groups: Dict[str, Tuple[PackedGroup, ...]]
    interval: int = 4
    _rows: dict = dataclasses.field(default_factory=dict, init=False,
                                    compare=False, repr=False)


def build_packed_tables(luts: Dict[str, np.ndarray], modes: Sequence[str],
                        *, split_r: bool = False, interval: int = 4,
                        dtype=None, max_row_bytes: int = 128,
                        device="cpu") -> PackedTables:
    """Host-side: flat ``[L⁴, oC]`` tables → packed rotation-group rows,
    as lerf_tpu's ``build_packed_tables`` (numpy ``dtype``, default the
    tables' own; groups whose packed row would exceed ``max_row_bytes``
    split into sub-groups: more rows, the same values), the tables then
    placed on ``device``.

    ``luts`` keyed by mode (``split_r=False``) or ``f"{mode}r{0|1}"`` with
    the r0 table at rotations 0/2 and r1 at 1/3 (eval_lut_sr.py:580-619).
    """
    L = (1 << (8 - interval)) + 1
    B = L - 1
    out: Dict[str, Tuple[PackedGroup, ...]] = {}
    for mode in modes:
        groups = []
        for g in group_rotations(mode):
            parts = []
            for r, perm in zip(g["rots"], g["perms"]):
                key = f"{mode}r{r % 2}" if split_r else mode
                lut5 = np.asarray(luts[key]).reshape(L, L, L, L, -1)
                oc = lut5.shape[-1]
                dt = np.dtype(dtype or lut5.dtype)
                member = np.empty((B, B, B, B, oc, 16), dt)
                # inv[m] = which role axis holds canonical coordinate m
                inv = [perm.index(m) for m in range(4)]
                for bits in range(16):
                    raise_m = [(bits >> (3 - m)) & 1 for m in range(4)]
                    sl = tuple(slice(raise_m[perm[k]], B + raise_m[perm[k]])
                               for k in range(4))
                    member[..., bits] = np.transpose(lut5[sl], inv + [4])
                parts.append(member.reshape(B ** 4, oc * 16))
            chunk = max(1, max_row_bytes // (oc * 16 * dt.itemsize))
            for lo in range(0, len(parts), chunk):
                hi = lo + chunk
                table = np.ascontiguousarray(
                    np.concatenate(parts[lo:hi], axis=1))
                groups.append(PackedGroup(
                    table=torch.from_numpy(table).to(device), oc=oc,
                    rots=tuple(g["rots"][lo:hi]), canon=g["canon"],
                    deltas=tuple(g["deltas"][lo:hi]),
                    perms=tuple(g["perms"][lo:hi])))
        out[mode] = tuple(groups)
    return PackedTables(groups=out, interval=interval)


def lut_ensemble_packed(img: torch.Tensor, packed: PackedTables,
                        modes: Sequence[str], *, interval: int = 4):
    """Σ of q×simplex outputs over modes × 4 rotations, packed-table form:
    one row gather a rotation group on the group's anchor grid; member i
    at pixel p reads the row at anchor ``p + deltas[i]``, its fractions in
    role order and its corners by role-permuted bits.  Bit-equal to
    :func:`lut_ensemble` on the flat tables (lerf_tpu's
    ``lut_ensemble_packed``)."""
    q = 1 << interval
    B = 1 << (8 - interval)
    h, w = img.shape[-2], img.shape[-1]
    xpad = _pad_all_sides(img)
    out = None
    for mode in modes:
        for g in packed.groups[mode]:
            u0 = min(d[0] for d in g.deltas)
            v0 = min(d[1] for d in g.deltas)
            ha = h + max(d[0] for d in g.deltas) - u0
            wa = w + max(d[1] for d in g.deltas) - v0
            # canonical sample planes over the anchor grid
            planes = [xpad[..., MAX_PAD + u0 + ci:MAX_PAD + u0 + ci + ha,
                           MAX_PAD + v0 + cj:MAX_PAD + v0 + cj + wa]
                      for ci, cj in g.canon]
            iv = [p // q for p in planes]
            cell = ((iv[0] * B + iv[1]) * B + iv[2]) * B + iv[3]
            rows = g.table.index_select(0, cell.reshape(-1)).reshape(
                cell.shape + (-1,)).to(torch.int32)
            for gi, (delta, perm) in enumerate(zip(g.deltas, g.perms)):
                su, sv = delta[0] - u0, delta[1] - v0
                win = (Ellipsis, slice(su, su + h), slice(sv, sv + w))
                fr = [planes[perm[k]][win] % q for k in range(4)]
                bit_of = tuple(1 << (3 - perm[k]) for k in range(4))
                w16 = simplex_weights16(*fr, q, bit_of=bit_of)
                chans = []
                for c_ in range(g.oc):
                    lane0 = (gi * g.oc + c_) * 16
                    c16 = rows[win + (slice(lane0, lane0 + 16),)]
                    chans.append(torch.sum(w16 * c16, dim=-1,
                                           dtype=torch.int32))
                member = torch.stack(chans, dim=-1)
                out = member if out is None else out + member
    return out


@dataclasses.dataclass(frozen=True)
class CellTables:
    """One stage's cell-major tables: ``table[k]`` int32 ``[(L-1)⁴, 16,
    oC]`` of ``keys[k]`` (keys sorted), row ``cell`` holding the cell's 16
    corners, corner ``bits`` raised by role a if bit 3 is set ... d if bit
    0 (lerf_tpu's ``build_cell_table``): one row read a member and
    pixel."""
    keys: Tuple[str, ...]
    table: torch.Tensor           # int32 [K, (L-1)⁴, 16, oC], contiguous
    interval: int = 4
    _rows: dict = dataclasses.field(default_factory=dict, init=False,
                                    compare=False, repr=False)

    @classmethod
    def create(cls, luts: Dict[str, np.ndarray], device="cpu",
               interval: int = 4):
        keys = tuple(sorted(luts))
        stacked = np.stack([build_cell_table(
            np.asarray(luts[k]).astype(np.int32), interval) for k in keys])
        return cls(keys=keys, table=torch.from_numpy(stacked).to(device)
                   .contiguous(), interval=interval)


def stage_tables(luts: Dict[str, np.ndarray], layout: str,
                 modes: Sequence[str], *, split_r: bool, interval: int = 4,
                 device="cpu"):
    """One stage's tables on ``device`` in ``layout`` (``TABLE_LAYOUTS``,
    lerf_tpu's ``LutPredictor`` choices): :class:`FlatTables`, packed rows
    of int8 (``"packed8"``) or int32 (``"packed32"``), or
    :class:`CellTables`."""
    if layout == "flat":
        return FlatTables.create(luts, device)
    if layout in ("packed8", "packed32"):
        dt = np.int8 if layout == "packed8" else np.int32
        return build_packed_tables(
            {k: np.asarray(v).astype(dt) for k, v in luts.items()}, modes,
            split_r=split_r, interval=interval, device=device)
    if layout == "cells":
        return CellTables.create(luts, device, interval)
    raise ValueError(f"unknown table_layout {layout!r}")


def lut_ensemble(img: torch.Tensor, tables, modes: Sequence[str], *,
                 interval: int = 4, split_r: bool = False):
    """Σ of q×simplex outputs over modes × 4 rotations.

    ``img``: int32 [..., H, W] with values 0..255; ``tables`` any layout
    (:class:`FlatTables`, :class:`PackedTables` — built with the members'
    tables baked in, so ``split_r`` is not read — or :class:`CellTables`).
    Returns int32 [..., H, W, oC] (scale: q × avg-numerator).
    """
    if isinstance(tables, PackedTables):
        return lut_ensemble_packed(img, tables, modes, interval=interval)
    if isinstance(tables, CellTables):
        k, n_cells, _, oc = tables.table.shape
        cell_offset, a, b, c, d = ensemble_roles(img, modes, split_r,
                                                 tables.keys, n_cells)
        s = simplex4d_cells(tables.table.reshape(k * n_cells, 16, oc),
                            a, b, c, d, interval=interval,
                            cell_offset=cell_offset)
        return torch.sum(s, dim=0, dtype=torch.int32)
    flat_lut, lut_offset, a, b, c, d = stack_ensemble_inputs(
        img, modes, split_r, tables)
    s = simplex4d(flat_lut, a, b, c, d, interval=interval,
                  lut_offset=lut_offset)
    return torch.sum(s, dim=0, dtype=torch.int32)


# Large CPU inputs run the stage ensembles in horizontal bands, as lerf_tpu
# does (its gather engine slows past ~0.7M rows a gather): each band
# carries a MAX_PAD halo of real pixels, so banding is bit-exact (every
# sample offset is ≤ MAX_PAD, and at the image's borders the band's edge
# pad equals the whole image's).  The plain twin bands to bound its
# intermediates; K2 tiles the frame itself and reads no band target.
BAND_TARGET_ROWS = 768 * 1024


def _banded_rows(img: torch.Tensor, fn, out_tail_dims: int,
                 target: int = BAND_TARGET_ROWS):
    """Run ``fn`` (a stage ensemble) over row bands of ``img`` with halo."""
    h, w = img.shape[-2:]
    lead = 1
    for d in img.shape[:-2]:
        lead *= d
    band_h = max(1, target // max(lead * w, 1))
    if band_h >= h:
        return fn(img)
    ax = -2 - out_tail_dims
    outs = []
    for r0 in range(0, h, band_h):
        r1 = min(r0 + band_h, h)
        lo, hi = max(r0 - MAX_PAD, 0), min(r1 + MAX_PAD, h)
        part = fn(img[..., lo:hi, :])
        outs.append(part.narrow(ax, r0 - lo, r1 - r0))
    return torch.cat(outs, dim=ax)


def stage_epilogue(pred: torch.Tensor, den: int, bias: int, norm: int):
    """round_half_even(clip(pred + bias·den, 0, norm·den) / den)."""
    return round_half_even_div(
        torch.clamp(pred + bias * den, 0, norm * den), den)


def lut_stage_plain(img: torch.Tensor, tables, modes: Sequence[str], *,
                    split_r: bool, den: int, bias: int, interval: int = 4,
                    norm: int = 255, band_target: int = BAND_TARGET_ROWS):
    """One whole stage — ensemble plus epilogue — in plain PyTorch: the
    twin K2 is held to, bit for bit, on any table layout.  The ensemble
    runs in row bands of at most ``band_target`` output pixels (bit-exact,
    see ``BAND_TARGET_ROWS``).  Returns int32 [..., H, W, oC]."""
    pred = _banded_rows(
        img, lambda part: lut_ensemble(part, tables, modes, interval=interval,
                                       split_r=split_r), 1, band_target)
    return stage_epilogue(pred, den, bias, norm)


def _stage(img, tables, modes, *, split_r, den, bias, interval, norm,
           band_target):
    from .kernels.lut_stage import lut_stage
    return lut_stage(img, tables, modes, split_r=split_r, den=den,
                     bias=bias, interval=interval, norm=norm,
                     band_target=band_target)


def lut_stage1(img: torch.Tensor, tables, modes: Sequence[str], *,
               interval: int = 4, norm: int = 255,
               band_target: int = BAND_TARGET_ROWS):
    """Feature ("pre-filter") stage: int 0..255 image -> int 0..255 feature.

    feat = round_half_even(clip(Σ/(len(modes)·q), 0, 255)) — the reference's
    final-feature-stage averaging with avg_factor=len(modes), bias=0
    (eval_lut_sr.py:565-577).  ``tables``: any layout; ``band_target``
    bands the plain path (the card's K2 tiles the frame and ignores it).
    """
    den = len(modes) * (1 << interval)
    return _stage(img, tables, modes, split_r=False, den=den, bias=0,
                  interval=interval, norm=norm,
                  band_target=band_target)[..., 0]


def lut_stage1_intermediate(img, tables, modes, *, interval=4, norm=255,
                            band_target: int = BAND_TARGET_ROWS):
    """Non-final feature stage (stages > 2): avg len(modes)·4, bias norm//2
    (eval_lut_sr.py:566-572)."""
    den = len(modes) * 4 * (1 << interval)
    return _stage(img, tables, modes, split_r=False, den=den,
                  bias=norm // 2, interval=interval, norm=norm,
                  band_target=band_target)[..., 0]


def lut_stage2(img: torch.Tensor, tables, modes2: Sequence[str], *,
               interval: int = 4, norm: int = 255,
               band_target: int = BAND_TARGET_ROWS):
    """Hyper stage: int 0..255 feature -> int 0..255 hyper codes, [...,H,W,oC].

    hyper_u8 = round_half_even(clip(Σ/(len(modes2)·4·q) + norm//2, 0, norm))
    (eval_lut_sr.py:621-628).
    """
    den = len(modes2) * 4 * (1 << interval)
    return _stage(img, tables, modes2, split_r=True, den=den, bias=norm // 2,
                  interval=interval, norm=norm, band_target=band_target)


def divide_exact(x: torch.Tensor, divisor) -> torch.Tensor:
    """``x / divisor`` (a number, such as ``norm``) as IEEE division on any
    device: the divisor is a 0-d tensor of ``x``'s type on ``x``'s device.
    PyTorch's CUDA division by a Python scalar multiplies by the scalar's
    reciprocal instead, which lands an ulp away from the quotient for some
    values; the CPU, ``lerf_tpu`` and the kernels divide."""
    return x / torch.full((), float(divisor), dtype=x.dtype, device=x.device)


def split_gaussian_hyper(hyper_u8: torch.Tensor, norm: int = 255):
    """[..., C, H, W, 3] int codes -> (rho, sigma_x, sigma_y) float32
    [..., C, H, W] in [0, 1] (eval_lut_sr.py:648-661)."""
    hyper = divide_exact(hyper_u8.to(torch.float32), norm)
    return hyper[..., 0], hyper[..., 1], hyper[..., 2]
