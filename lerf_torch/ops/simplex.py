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

import torch


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


def round_half_even_div(num: torch.Tensor, den: int):
    """Exact round-half-to-even of ``num/den`` for non-negative int ``num``.

    Matches ``np.round`` (banker's rounding) applied to the exact rational.
    """
    q_, r_ = num // den, num % den
    twice = 2 * r_
    up = (twice > den) | ((twice == den) & (q_ % 2 == 1))
    return q_ + up.to(num.dtype)
