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

The port has one table layout, :class:`FlatTables`: the stage's flat
``[L⁴, oC]`` int8 tables stacked in key order, beside the copies K2 reads
(padded corner words for oC = 3, 16-corner cell rows for oC = 1).  The
public stage functions
(:func:`lut_stage1`, :func:`lut_stage1_intermediate`, :func:`lut_stage2`)
run through the K2 wrapper (:mod:`lerf_torch.ops.kernels.lut_stage`): the
kernel on a CUDA tensor, :func:`lut_stage_plain` on a CPU tensor.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .simplex import round_half_even_div, simplex4d

# neighbor (row, col) offsets per sampling mode, in the rotated frame,
# role order (a, b, c, d) — eval_lut_sr.py:31-81
MODE_OFFSETS = {
    "s": ((0, 0), (0, 1), (1, 0), (1, 1)),
    "d": ((0, 0), (0, 2), (2, 0), (2, 2)),
    "y": ((0, 0), (1, 1), (1, 2), (2, 1)),
    "c": ((0, 0), (0, 1), (0, 2), (0, 3)),
    "t": ((0, 0), (1, 1), (2, 2), (3, 3)),
}

# the largest per-mode bottom/right pad of the reference (eval_lut_sr.py:12-18)
MAX_PAD = 3


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


def lut_ensemble(img: torch.Tensor, tables: FlatTables,
                 modes: Sequence[str], *, interval: int = 4,
                 split_r: bool = False):
    """Σ of q×simplex outputs over modes × 4 rotations.

    ``img``: int32 [..., H, W] with values 0..255.  Returns int32
    [..., H, W, oC] (scale: q × avg-numerator).
    """
    flat_lut, lut_offset, a, b, c, d = stack_ensemble_inputs(
        img, modes, split_r, tables)
    s = simplex4d(flat_lut, a, b, c, d, interval=interval,
                  lut_offset=lut_offset)
    return torch.sum(s, dim=0, dtype=torch.int32)


def stage_epilogue(pred: torch.Tensor, den: int, bias: int, norm: int):
    """round_half_even(clip(pred + bias·den, 0, norm·den) / den)."""
    return round_half_even_div(
        torch.clamp(pred + bias * den, 0, norm * den), den)


def lut_stage_plain(img: torch.Tensor, tables: FlatTables,
                    modes: Sequence[str], *, split_r: bool, den: int,
                    bias: int, interval: int = 4, norm: int = 255):
    """One whole stage — ensemble plus epilogue — in plain PyTorch: the
    twin K2 is held to, bit for bit.  Returns int32 [..., H, W, oC]."""
    pred = lut_ensemble(img, tables, modes, interval=interval,
                        split_r=split_r)
    return stage_epilogue(pred, den, bias, norm)


def _stage(img, tables, modes, *, split_r, den, bias, interval, norm):
    from .kernels.lut_stage import lut_stage
    return lut_stage(img, tables, modes, split_r=split_r, den=den,
                     bias=bias, interval=interval, norm=norm)


def lut_stage1(img: torch.Tensor, tables: FlatTables, modes: Sequence[str],
               *, interval: int = 4, norm: int = 255):
    """Feature ("pre-filter") stage: int 0..255 image -> int 0..255 feature.

    feat = round_half_even(clip(Σ/(len(modes)·q), 0, 255)) — the reference's
    final-feature-stage averaging with avg_factor=len(modes), bias=0
    (eval_lut_sr.py:565-577).
    """
    den = len(modes) * (1 << interval)
    return _stage(img, tables, modes, split_r=False, den=den, bias=0,
                  interval=interval, norm=norm)[..., 0]


def lut_stage1_intermediate(img, tables, modes, *, interval=4, norm=255):
    """Non-final feature stage (stages > 2): avg len(modes)·4, bias norm//2
    (eval_lut_sr.py:566-572)."""
    den = len(modes) * 4 * (1 << interval)
    return _stage(img, tables, modes, split_r=False, den=den,
                  bias=norm // 2, interval=interval, norm=norm)[..., 0]


def lut_stage2(img: torch.Tensor, tables: FlatTables, modes2: Sequence[str],
               *, interval: int = 4, norm: int = 255):
    """Hyper stage: int 0..255 feature -> int 0..255 hyper codes, [...,H,W,oC].

    hyper_u8 = round_half_even(clip(Σ/(len(modes2)·4·q) + norm//2, 0, norm))
    (eval_lut_sr.py:621-628).
    """
    den = len(modes2) * 4 * (1 << interval)
    return _stage(img, tables, modes2, split_r=True, den=den, bias=norm // 2,
                  interval=interval, norm=norm)


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
