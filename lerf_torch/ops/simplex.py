"""Branchless 4D-simplex LUT interpolation (int32, plain PyTorch).

The port of ``lerf_tpu/ops/simplex.py``.  The reference's 24-branch simplex
selection (``resample/eval_lut_sr.py:24-470``) is a descending sort of the
four LSB fractions where ties are won by the later element of (a, b, c, d);
each element's rank comes from 6 strict pairwise comparisons and the blend
walks 5 corners along the sorted chain:

    out = (q - v0)·P(0) + Σ_t (v_t - v_{t+1})·P(cum_t) + v3·P(1111)

All arithmetic is int32, and every division is a floor division of a
non-negative int, so the results are bit-exact vs the reference.  These
functions are the arithmetic of the K2 kernel's plain twin
(:mod:`lerf_torch.ops.lut_pipeline`).
"""
from __future__ import annotations

import numpy as np
import torch

# pixels a segment of the cell-row gather and blend (simplex4d_cells)
CELL_GATHER_CHUNK = 1 << 22


def _ranks(fa, fb, fc, fd):
    """Rank 0 = largest fraction; the later element wins ties."""
    i32 = torch.int32
    fab = (fa > fb).to(i32)
    fac = (fa > fc).to(i32)
    fad = (fa > fd).to(i32)
    fbc = (fb > fc).to(i32)
    fbd = (fb > fd).to(i32)
    fcd = (fc > fd).to(i32)
    sa = fab + fac + fad
    sb = (1 - fab) + fbc + fbd
    sc = (1 - fac) + (1 - fbc) + fcd
    sd = (1 - fad) + (1 - fbd) + (1 - fcd)
    return 3 - sa, 3 - sb, 3 - sc, 3 - sd


def _chain(fracs, ranks, raise_of):
    """(v_t, cumulative corner raise after t+1 largest) for t = 0..3."""
    vs, cums = [], []
    cum = None
    for t in range(4):
        hit = [(r == t).to(torch.int32) for r in ranks]
        vs.append(sum(f * h for f, h in zip(fracs, hit)))
        step = sum(o * h for o, h in zip(raise_of, hit))
        cum = step if cum is None else cum + step
        cums.append(cum)
    return vs, cums


def simplex4d(lut: torch.Tensor, a, b, c, d, interval: int = 4,
              lut_offset=None):
    """4D-simplex interpolation of int LUT values.

    ``lut``: ``[L⁴, oC]`` int8 or int32 table (gathered corners are widened
    to int32), or ``[K·L⁴, oC]`` — K tables stacked — with ``lut_offset``
    (int32, broadcastable against ``a``) holding each element's ``k·L⁴``.
    ``a..d``: int32 tensors (one shape) of raw 8-bit pixel values 0..255 in
    the mode's (a, b, c, d) sampling order.  Returns int32
    ``a.shape + (oC,)`` holding q × the interpolated value — the
    reference's ``out`` before its final ``/q`` (eval_lut_sr.py:469).
    """
    q = 1 << interval
    L = (1 << (8 - interval)) + 1
    ia, fa = a // q, a % q
    ib, fb = b // q, b % q
    ic, fc = c // q, c % q
    id_, fd = d // q, d % q
    base = ((ia * L + ib) * L + ic) * L + id_
    if lut_offset is not None:
        base = base + lut_offset
    ranks = _ranks(fa, fb, fc, fd)
    (v0, v1, v2, v3), (c0, c1, c2, c3) = _chain(
        (fa, fb, fc, fd), ranks, (L * L * L, L * L, L, 1))

    def gather(idx):
        rows = lut.index_select(0, idx.reshape(-1)).to(torch.int32)
        return rows.reshape(idx.shape + (lut.shape[1],))

    w = lambda x: x[..., None]
    return (w(q - v0) * gather(base) + w(v0 - v1) * gather(base + c0)
            + w(v1 - v2) * gather(base + c1) + w(v2 - v3) * gather(base + c2)
            + w(v3) * gather(base + c3))


def simplex_weights16(fa, fb, fc, fd, q: int, bit_of=(8, 4, 2, 1)):
    """Per-corner blend weights of the 4D simplex, as a 16-wide lattice.

    ``fa..fd``: int32 LSB fractions (0..q-1) in role order (a, b, c, d);
    ``bit_of``: the corner-raise bit each role contributes.  Returns int32
    ``fa.shape + (16,)`` with ``w16[..., m]`` the weight of the corner with
    raise-bitmask m; ``sum(w16) == q``.
    """
    ranks = _ranks(fa, fb, fc, fd)
    (v0, v1, v2, v3), (m0, cum1, cum2, _) = _chain((fa, fb, fc, fd), ranks,
                                                   bit_of)
    ws = (q - v0, v0 - v1, v1 - v2, v2 - v3, v3)
    masks = (torch.zeros_like(m0), m0, cum1, cum2, torch.full_like(m0, 15))
    bits = torch.arange(16, dtype=torch.int32, device=fa.device)
    return sum(w[..., None] * (m[..., None] == bits).to(torch.int32)
               for w, m in zip(ws, masks))


def build_cell_table(lut, interval: int = 4) -> np.ndarray:
    """Host-side: flat LUT ``[L⁴, oC]`` → cell-major table ``[(L-1)⁴, 16,
    oC]`` of the same type: ``cells[cell, bits]`` holds the corner with
    raise-bitmask ``bits`` (bit 3 = a, bit 2 = b, bit 1 = c, bit 0 = d) of
    cell ``((ia·B + ib)·B + ic)·B + id``, B = L - 1, so one lookup's 5
    simplex corners lie in one row (lerf_tpu's ``build_cell_table``)."""
    L = (1 << (8 - interval)) + 1
    B = L - 1
    lut = np.asarray(lut).reshape(L, L, L, L, -1)
    cells = np.empty((B, B, B, B, 16, lut.shape[-1]), lut.dtype)
    for bits in range(16):
        ba, bb, bc, bd = (bits >> 3) & 1, (bits >> 2) & 1, \
            (bits >> 1) & 1, bits & 1
        cells[..., bits, :] = lut[ba:B + ba, bb:B + bb, bc:B + bc,
                                  bd:B + bd]
    return cells.reshape(B ** 4, 16, lut.shape[-1])


def simplex4d_cells(cells: torch.Tensor, a, b, c, d, interval: int = 4,
                    cell_offset=None):
    """Cell-major 4D-simplex interpolation, the same values as
    :func:`simplex4d`.

    ``cells``: int ``[K·(L-1)⁴, 16, oC]`` from :func:`build_cell_table`
    (K tables stacked, selected by ``cell_offset`` = k·(L-1)⁴).  One row
    gather fetches a lookup's 16 corners; the 5 simplex corners are
    weighed in with :func:`simplex_weights16`.  The gather and blend run
    in segments of ``CELL_GATHER_CHUNK`` lookups, so one segment's
    ``[n, 16, oC]`` rows are live at a time.  Returns int32 ``a.shape +
    (oC,)``, q × the interpolated value.
    """
    q = 1 << interval
    B = 1 << (8 - interval)
    cell = (((a // q) * B + b // q) * B + c // q) * B + d // q
    if cell_offset is not None:
        cell = cell + cell_offset
    w16 = simplex_weights16(a % q, b % q, c % q, d % q, q)
    cell_f, w_f = cell.reshape(-1), w16.reshape(-1, 16)
    parts = []
    for lo in range(0, cell_f.shape[0], CELL_GATHER_CHUNK):
        rows = cells.index_select(0, cell_f[lo:lo + CELL_GATHER_CHUNK]) \
            .to(torch.int32)
        parts.append(torch.sum(w_f[lo:lo + CELL_GATHER_CHUNK, :, None] * rows,
                               dim=1, dtype=torch.int32))
    out = torch.cat(parts) if parts else w_f.new_zeros(0, cells.shape[-1])
    return out.reshape(cell.shape + (cells.shape[-1],))


def round_half_even_div(num: torch.Tensor, den: int):
    """Exact round-half-to-even of ``num/den`` for non-negative int ``num``.

    Matches ``np.round`` (banker's rounding) applied to the exact rational.
    """
    q_, r_ = num // den, num % den
    twice = 2 * r_
    up = (twice > den) | ((twice == den) & (q_ % 2 == 1))
    return q_ + up.to(num.dtype)
