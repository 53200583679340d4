"""K2 wrapper: one LUT stage (ensemble + epilogue) in one CUDA launch.

``lut_stage`` runs the plain twin
(:func:`lerf_torch.ops.lut_pipeline.lut_stage_plain`) for a CPU tensor and
launches ``csrc/lut_stage.cu`` for a CUDA tensor: its flat mode for
:class:`~lerf_torch.ops.lut_pipeline.FlatTables`, its row mode for the
packed and cell layouts (:func:`row_members`), which reads lerf_tpu's
rows as they are.  It never falls back from the card to the plain version,
nor from a layout to another.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..lut_pipeline import (BAND_TARGET_ROWS, MODE_OFFSETS, CellTables,
                            FlatTables, PackedTables, ensemble_members,
                            lut_stage_plain, member_descriptors,
                            rotate_offset)
from . import _build

launches = 0


def row_members(tables, modes: Sequence[str], split_r: bool, device):
    """The row mode's member table for ``tables`` (:class:`PackedTables`
    or :class:`CellTables`) on ``device``, cached on the tables: int32
    ``[M, 16]`` — per member its 4 rotated (row, col) offsets in role
    order, ``perm`` (role k's canonical position: its cell weight
    (L-1)^(3-perm_k) and corner bit 3-perm_k), the row's bytes, the
    elements between channels and between corners, 0 — with uint64 ``[M]``
    device pointers to each member's slot of cell 0, the value's bytes and
    oC.  Packed members run mode by mode, group by group (lerf_tpu's
    order); cell members as the flat tables'."""
    key = (tuple(modes), bool(split_r), str(device))
    if key in tables._rows:
        return tables._rows[key]
    rows, ptrs = [], []
    if isinstance(tables, PackedTables):
        for mode in modes:
            for g in tables.groups[mode]:
                t = _checked(g.table, device)
                esize = t.element_size()
                for gi, (delta, perm) in enumerate(zip(g.deltas, g.perms)):
                    offs = [delta[j] + g.canon[perm[k]][j]
                            for k in range(4) for j in range(2)]
                    rows.append(offs + list(perm)
                                + [t.shape[1] * esize, 16, 1, 0])
                    ptrs.append(t.data_ptr() + gi * g.oc * 16 * esize)
        oc = tables.groups[modes[0]][0].oc
    else:
        t = _checked(tables.table, device)
        k, n_cells, _, oc = t.shape
        for mode, r, name in ensemble_members(modes, split_r):
            offs = [v for off in MODE_OFFSETS[mode]
                    for v in rotate_offset(off, r)]
            rows.append(offs + [0, 1, 2, 3] + [16 * oc * 4, 1, oc, 0])
            ptrs.append(t.data_ptr()
                        + tables.keys.index(name) * n_cells * 16 * oc * 4)
        esize = 4
    out = (np.asarray(rows, np.int32), np.asarray(ptrs, np.uint64), esize, oc)
    tables._rows[key] = out
    return out


def _checked(table: torch.Tensor, device) -> torch.Tensor:
    if (table.device != device or table.dtype not in (torch.int8, torch.int32)
            or not table.is_contiguous()):
        raise ValueError("lut_stage: packed / cell tables must be "
                         "contiguous int8 or int32 on the image's device")
    return table


def lut_stage(img: torch.Tensor, tables, modes: Sequence[str], *,
              split_r: bool, den: int, bias: int, interval: int = 4,
              norm: int = 255,
              band_target: int = BAND_TARGET_ROWS) -> torch.Tensor:
    """int32 image [..., H, W] (values 0..255) → int32 [..., H, W, oC]:
    round_half_even(clip(Σ_members q·simplex + bias·den, 0, norm·den) / den).

    ``tables``: :class:`FlatTables`, :class:`PackedTables` or
    :class:`CellTables` on the image's device.  ``band_target`` bands the
    plain path's ensemble (bit-exact); the kernel tiles the frame and does
    not read it.  The values index the LUT lattice, so they must lie in
    0..255: stage outputs do (``norm`` ≤ 255), and
    ``LutPredictor.upscale`` checks its input image on the host; the
    kernel does not check them.
    """
    if img.device.type == "cpu":
        return lut_stage_plain(img, tables, modes, split_r=split_r, den=den,
                               bias=bias, interval=interval, norm=norm,
                               band_target=band_target)
    global launches
    if img.device.type != "cuda":
        raise ValueError(f"lut_stage: unsupported device {img.device}")
    if img.dtype != torch.int32 or img.dim() < 2:
        raise ValueError("lut_stage: img must be int32 [..., H, W]")
    if not 0 < norm <= 255:
        raise ValueError(f"lut_stage: norm {norm} outside 1..255")
    x = img.contiguous()
    h, w = x.shape[-2], x.shape[-1]
    c = x.numel() // max(h * w, 1)
    if isinstance(tables, FlatTables):
        table, members, oc, l4 = _flat_operands(tables, interval, img.device,
                                                modes, split_r)
    elif isinstance(tables, (PackedTables, CellTables)):
        if tables.interval != interval:
            raise ValueError(f"lut_stage: tables built for interval "
                             f"{tables.interval}, not {interval}")
        members, ptrs, esize, oc = row_members(tables, modes, split_r,
                                               img.device)
    else:
        raise ValueError(f"lut_stage: unknown tables {type(tables).__name__}")
    out = torch.empty(x.shape + (oc,), dtype=torch.int32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):       # launch on the tensors' card
        stream = torch.cuda.current_stream().cuda_stream
        if isinstance(tables, FlatTables):
            err = lib.lerf_lut_stage(
                x.data_ptr(), table.data_ptr(), out.data_ptr(),
                members.ctypes.data, len(members), c, h, w, oc, l4,
                interval, den, bias, norm, stream)
        else:
            err = lib.lerf_lut_stage_rows(
                x.data_ptr(), ptrs.ctypes.data, out.data_ptr(),
                members.ctypes.data, len(members), c, h, w, oc, esize,
                interval, den, bias, norm, stream)
    _build.check(err, "lut_stage launch")
    launches += 1
    return out


def _flat_operands(tables: FlatTables, interval: int, device, modes,
                   split_r):
    """The flat mode's table copy, member descriptors, oC and L⁴."""
    k, l4, oc = tables.table.shape
    if l4 != ((1 << (8 - interval)) + 1) ** 4 or oc not in (1, 3):
        raise ValueError(f"lut_stage: table shape "
                         f"{tuple(tables.table.shape)} does not match "
                         f"interval {interval} / oC in (1, 3)")
    # oC 3 reads a corner as one word of the padded copy, oC 1 a member as
    # one 16-byte row of the cell copy
    if oc == 3:
        table, want = tables.padded, (k, l4, 4)
    else:
        table, want = tables.cells, (k, (1 << (4 * (8 - interval))), 16)
    if (table is None or table.device != device
            or table.dtype != torch.int8 or not table.is_contiguous()
            or table.shape != want):
        raise ValueError("lut_stage: tables must be contiguous int8 on "
                         "the image's device (FlatTables.create)")
    return table, member_descriptors(modes, split_r, tables.keys), oc, l4
