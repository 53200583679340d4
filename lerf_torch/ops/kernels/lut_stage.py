"""K2 wrapper: one LUT stage (ensemble + epilogue) in one CUDA launch.

``lut_stage`` runs the plain twin
(:func:`lerf_torch.ops.lut_pipeline.lut_stage_plain`) for a CPU tensor and
launches ``csrc/lut_stage.cu`` for a CUDA tensor; it never falls back from
the card to the plain version.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..lut_pipeline import FlatTables, lut_stage_plain, member_descriptors
from . import _build

launches = 0


def lut_stage(img: torch.Tensor, tables: FlatTables, modes: Sequence[str],
              *, split_r: bool, den: int, bias: int, interval: int = 4,
              norm: int = 255) -> torch.Tensor:
    """int32 image [..., H, W] (values 0..255) → int32 [..., H, W, oC]:
    round_half_even(clip(Σ_members q·simplex + bias·den, 0, norm·den) / den).

    The values index the LUT lattice, so they must lie in 0..255: stage
    outputs do (``norm`` ≤ 255), and ``LutPredictor.upscale`` checks its
    input image on the host; the kernel does not check them.
    """
    if img.device.type == "cpu":
        return lut_stage_plain(img, tables, modes, split_r=split_r, den=den,
                               bias=bias, interval=interval, norm=norm)
    global launches
    if img.device.type != "cuda":
        raise ValueError(f"lut_stage: unsupported device {img.device}")
    if img.dtype != torch.int32 or img.dim() < 2:
        raise ValueError("lut_stage: img must be int32 [..., H, W]")
    if not 0 < norm <= 255:
        raise ValueError(f"lut_stage: norm {norm} outside 1..255")
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
    if (table is None or table.device != img.device
            or table.dtype != torch.int8 or not table.is_contiguous()
            or table.shape != want):
        raise ValueError("lut_stage: tables must be contiguous int8 on "
                         "the image's device (FlatTables.create)")
    members = member_descriptors(modes, split_r, tables.keys)
    x = img.contiguous()
    h, w = x.shape[-2], x.shape[-1]
    c = x.numel() // max(h * w, 1)
    out = torch.empty(x.shape + (oc,), dtype=torch.int32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):       # launch on the tensors' card
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lerf_lut_stage(
            x.data_ptr(), table.data_ptr(), out.data_ptr(),
            members.ctypes.data, len(members), c, h, w, oc, l4, interval,
            den, bias, norm, stream)
    _build.check(err, "lut_stage launch")
    launches += 1
    return out
