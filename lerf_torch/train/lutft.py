"""LUT fine-tuning: the LUT tables themselves as trainable parameters.

The port of ``lerf_tpu/train/lutft.py`` (reference: ``SWF2LUT``,
resample/model.py:132-431): the transferred ``LUT_*.npy`` tables load as
float params (/127), run a differentiable 4D-simplex interpolation with
straight-through rounding through the steerable resize, and re-quantize
to int8 ``LUTft_*.npy`` (train_model.py:481-499).

Parity note (lerf_tpu's): the reference torch path has a copy-paste bug
for modes c/t (LSB fractions reuse the y geometry, model.py:222-243) while
its numpy deploy path is self-consistent; this follows the deploy
geometry, as lerf_tpu does.

The gathers stay plain torch on every device (lerf_tpu leaves them to
XLA): ``index_select`` forward, whose backward on a card is ``index_add``
with float atomics, so the tables' gradients there are summed in an order
that changes from run to run.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..lut.io import LUTBank
from ..models.srnet import clip, round_ste
from ..ops.lut_pipeline import divide_exact, ensemble_members, ensemble_roles


def params_from_bank(bank: LUTBank, device="cpu") -> Dict:
    """LUT int8 values → float trainables /127 (model.py:144-160)."""
    if bank.inter:
        raise NotImplementedError(
            "LUT fine-tuning is two-stage only, like the reference SWF2LUT "
            "(model.py:140-158 loads s1/s2 tables exclusively); got a bank "
            f"with {bank.stages} stages")

    def up(v):
        return torch.from_numpy(v.astype(np.float32) / 127.0).to(device)

    return {"s1": {k: up(v) for k, v in bank.stage1.items()},
            "s2": {k: up(v) for k, v in bank.stage2.items()}}


def bank_from_params(params: Dict, out_c: int, interval: int = 4) -> LUTBank:
    """Re-quantize fine-tuned tables to int8 (train_model.py:488-497)."""
    def q(v):
        v = torch.as_tensor(v).detach().cpu().numpy()
        return np.round(np.clip(v, -1, 1) * 127).astype(np.int8)

    return LUTBank(
        stage1={k: q(v) for k, v in params["s1"].items()},
        stage2={k: q(v) for k, v in params["s2"].items()},
        out_c=out_c, interval=interval)


def simplex4d_ste(lut: torch.Tensor, a, b, c, d, interval: int = 4,
                  lut_offset=None):
    """Differentiable 4D-simplex interpolation with BPDA quantization.

    ``lut``: [L⁴, oC] float trainable (values ≈ [-1, 1]); a..d: float
    tensors of integer-valued 8-bit pixels (BPDA-rounded upstream).
    Returns float ``a.shape + (oC,)`` ≈ [-127, 127], the reference's
    ``InterpTorchBatch`` output before its final /q (model.py:177-385),
    with the rank-order blend of :func:`lerf_torch.ops.simplex.simplex4d`.
    Gradients flow to ``lut`` linearly and to the inputs through the
    fractional blend weights; the rank order and the cell index are
    constants (``detach``), as lerf_tpu's ``stop_gradient``.
    """
    q = float(1 << interval)
    L = (1 << (8 - interval)) + 1
    w = clip(round_ste(lut * 127.0), -127, 127)

    def split(x):
        i = torch.floor(x / q).detach().to(torch.int64)
        return i, x - i.to(x.dtype) * q

    ia, fa = split(a)
    ib, fb = split(b)
    ic, fc = split(c)
    id_, fd = split(d)
    base = ((ia * L + ib) * L + ic) * L + id_
    if lut_offset is not None:
        base = base + lut_offset

    # strict pairwise wins on the (integer-valued) fractions
    def gt(x, y):
        return (x > y).detach().to(torch.int64)

    fab, fac, fad = gt(fa, fb), gt(fa, fc), gt(fa, fd)
    fbc, fbd, fcd = gt(fb, fc), gt(fb, fd), gt(fc, fd)
    sa = fab + fac + fad
    sb = (1 - fab) + fbc + fbd
    sc = (1 - fac) + (1 - fbc) + fcd
    sd = (1 - fad) + (1 - fbd) + (1 - fcd)
    ranks = (3 - sa, 3 - sb, 3 - sc, 3 - sd)
    offs = (L * L * L, L * L, L, 1)
    fracs = (fa, fb, fc, fd)

    def at_rank(t):
        sel = [(r == t) for r in ranks]
        v = sum(f * s.to(f.dtype) for f, s in zip(fracs, sel))
        o = sum(o_ * s.to(torch.int64) for o_, s in zip(offs, sel))
        return v, o

    v0, o0 = at_rank(0)
    v1, o1 = at_rank(1)
    v2, o2 = at_rank(2)
    v3, o3 = at_rank(3)
    cum1, cum2, cum3 = o0 + o1, o0 + o1 + o2, o0 + o1 + o2 + o3

    def gather(idx):
        return w.index_select(0, idx.reshape(-1)).reshape(
            idx.shape + (w.shape[1],))

    def e(x):
        return x[..., None]

    out = (e(q - v0) * gather(base)
           + e(v0 - v1) * gather(base + o0)
           + e(v1 - v2) * gather(base + cum1)
           + e(v2 - v3) * gather(base + cum2)
           + e(v3) * gather(base + cum3))
    return out / q


def _ensemble(x: torch.Tensor, luts: Dict, modes: Sequence[str],
              interval: int, split_r: bool):
    """Σ over modes × rotations of round_ste(member) (model.py:403-424),
    one simplex interpolation over the stacked members and the members'
    tables concatenated in sorted key order, as lerf_tpu's
    ``stack_ensemble_inputs``."""
    keys = sorted({k for _, _, k in ensemble_members(modes, split_r)})
    lut_offset, a, b, c, d = ensemble_roles(x, modes, split_r, keys,
                                            luts[keys[0]].shape[0])
    members = simplex4d_ste(torch.cat([luts[k] for k in keys]), a, b, c, d,
                            interval, lut_offset=lut_offset)
    return torch.sum(round_ste(members), dim=0)


def predict_stage1(params: Dict, x: torch.Tensor, *,
                   modes: Sequence[str] = ("s", "c", "t"), stages: int = 2,
                   norm: int = 255, interval: int = 4) -> torch.Tensor:
    """x [..., H, W] in [0, 1] → feature in [0, 255] (model.py:415-429)."""
    x = round_ste(x * float(norm))
    half = norm // 2
    for s in range(stages - 1):
        pred = _ensemble(x, params["s1"], modes, interval, split_r=False)
        if s + 1 == stages - 1:
            x = clip(round_ste(divide_exact(pred[..., 0], len(modes))), 0,
                     norm)
        else:
            x = clip(round_ste(divide_exact(pred[..., 0], len(modes) * 4))
                     + half, 0, norm)
    return x


def predict_stage2(params: Dict, x: torch.Tensor, *,
                   modes2: Sequence[str] = ("s", "c", "t"), norm: int = 255,
                   interval: int = 4) -> torch.Tensor:
    """x [..., H, W] in [0, 1] → hyper [..., H, W, oC] in [0, 1]
    (model.py:403-414)."""
    x = round_ste(x * float(norm))
    pred = _ensemble(x, params["s2"], modes2, interval, split_r=True)
    half = norm // 2
    avg = float(len(modes2) * 4)
    return divide_exact(clip(round_ste(divide_exact(pred, avg) + half), 0,
                             norm), norm)
