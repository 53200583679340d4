"""The LUT form's plain reference: LeRF-G's two LUT stages.

Written from the LeRF reference deploy path (``eval_lut_sr.py:24-470``
for the 4D-simplex interpolation, ``:541-628`` for the stages): each
stage rotates the image by each of 0, 90, 180 and 270 degrees, pads it
at the bottom and right by repeating its edge, reads every mode's four
neighbours (a, b, c, d) of each pixel, interpolates the mode's table on
the 4D simplex that holds their low bits, rotates the result back and
sums.  Stage 1 (feature) averages over modes × rotations (``den`` =
modes · q, no bias), stage 2 (hyper) over modes × 4 rotations × q with a
bias of 127 and a table pair a mode (r0 for even rotations, r1 for odd).
All integer, with exact round-half-to-even divisions.

The bank is the benchmark's own, made from the seed (no trained bank is
in the repository): stage 1's tables hold the lattice's ``a`` coordinate
divided by 4 plus seeded noise of ±8, so the feature follows the frame as
a trained one does; stage 2's hold uniform int8 values.
"""
from __future__ import annotations

import torch

from . import resample

MODE_OFFSETS = {
    "s": ((0, 0), (0, 1), (1, 0), (1, 1)),
    "d": ((0, 0), (0, 2), (2, 0), (2, 2)),
    "y": ((0, 0), (1, 1), (1, 2), (2, 1)),
    "c": ((0, 0), (0, 1), (0, 2), (0, 3)),
    "t": ((0, 0), (1, 1), (2, 2), (3, 3)),
}
MODE_PAD = {"s": 1, "d": 2, "y": 2, "c": 3, "t": 3}
NORM = 255


def lattice(interval: int) -> int:
    return (1 << (8 - interval)) + 1


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The seeded bank on ``device``: ``{"stage1": {mode: int8 [L⁴, 1]},
    "stage2": {f"{mode}r{r}": int8 [L⁴, oC]}}``, from two draws of one
    generator on the device."""
    interval = cfg["interval"]
    modes, modes2, oc = cfg["modes"], cfg["modes2"], cfg["out_c"]
    L = lattice(interval)
    l4 = L ** 4
    g = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randint(-8, 9, (len(modes), l4), generator=g,
                          device=device, dtype=torch.int32)
    a = torch.arange(l4, device=device, dtype=torch.int32) // (L ** 3)
    s1 = (a * ((1 << interval) // 4) + noise).to(torch.int8)
    s2 = torch.randint(-127, 128, (len(modes2) * 2, l4, oc), generator=g,
                       device=device, dtype=torch.int32).to(torch.int8)
    keys2 = [f"{m}r{r}" for m in modes2 for r in (0, 1)]
    return {"stage1": {m: s1[i, :, None] for i, m in enumerate(modes)},
            "stage2": {k: s2[i] for i, k in enumerate(keys2)}}


def _ranks(fa, fb, fc, fd):
    """Each fraction's place in the descending order (0: largest), ties
    to the later of (a, b, c, d)."""
    ab, ac, ad = (fa > fb).int(), (fa > fc).int(), (fa > fd).int()
    bc, bd, cd = (fb > fc).int(), (fb > fd).int(), (fc > fd).int()
    return (3 - (ab + ac + ad), 3 - ((1 - ab) + bc + bd),
            3 - ((1 - ac) + (1 - bc) + cd),
            3 - ((1 - ad) + (1 - bd) + (1 - cd)))


def simplex(table: torch.Tensor, a, b, c, d, interval: int):
    """q × the 4D-simplex interpolation of ``table`` (int [L⁴, oC]) at the
    8-bit points (a, b, c, d): int32 ``a.shape + (oC,)``."""
    q = 1 << interval
    L = lattice(interval)
    step = (L ** 3, L ** 2, L, 1)
    idx = [x // q for x in (a, b, c, d)]
    frac = [x % q for x in (a, b, c, d)]
    base = ((idx[0] * L + idx[1]) * L + idx[2]) * L + idx[3]
    ranks = _ranks(*frac)
    v, corner = [], [base]
    for t in range(4):
        hit = [(r == t).int() for r in ranks]
        v.append(sum(f * h for f, h in zip(frac, hit)))
        corner.append(corner[-1] + sum(s * h for s, h in zip(step, hit)))
    weights = [q - v[0], v[0] - v[1], v[1] - v[2], v[2] - v[3], v[3]]

    def at(i):
        return table.index_select(0, i.reshape(-1)).to(torch.int32) \
            .reshape(i.shape + (table.shape[1],))

    return sum(wt[..., None] * at(cn) for wt, cn in zip(weights, corner))


def stage(img: torch.Tensor, tables: dict, modes, *, split_r: bool,
          den: int, bias: int, interval: int) -> torch.Tensor:
    """One LUT stage of an int32 [C, H, W] image → int32 [C, H, W, oC]."""
    total = None
    for mode in modes:
        p = MODE_PAD[mode]
        for r in range(4):
            x = torch.rot90(img, r, (1, 2))
            h, w = x.shape[1:]
            rows = torch.arange(h + p, device=x.device).clamp_(max=h - 1)
            cols = torch.arange(w + p, device=x.device).clamp_(max=w - 1)
            xp = x.index_select(1, rows).index_select(2, cols)
            a, b, c, d = (xp[:, i:i + h, j:j + w]
                          for i, j in MODE_OFFSETS[mode])
            key = f"{mode}r{r % 2}" if split_r else mode
            y = torch.rot90(simplex(tables[key], a, b, c, d, interval),
                            -r, (1, 2))
            total = y if total is None else total + y
    num = torch.clamp(total + bias * den, 0, NORM * den)
    quo, rem = num // den, num % den
    up = (2 * rem > den) | ((2 * rem == den) & (quo % 2 == 1))
    return quo + up.int()


class Stages:
    """The LUT form's two stages: uint8 [C, H, W] → (feature float32,
    maps (ρ, σx, σy) float32 in [0, 1]), as the resampler takes them."""

    def __init__(self, cfg: dict, bank: dict, precision: dict):
        self.cfg = cfg
        self.bank = bank

    def __call__(self, x_u8: torch.Tensor):
        cfg = self.cfg
        q = 1 << cfg["interval"]
        img = x_u8.to(torch.int32)
        feat = stage(img, self.bank["stage1"], cfg["modes"], split_r=False,
                     den=len(cfg["modes"]) * q, bias=0,
                     interval=cfg["interval"])[..., 0]
        hyper = stage(feat, self.bank["stage2"], cfg["modes2"], split_r=True,
                      den=len(cfg["modes2"]) * 4 * q, bias=NORM // 2,
                      interval=cfg["interval"])
        u = resample.divide(hyper.to(torch.float32), NORM)
        return feat.to(torch.float32), (u[..., 0], u[..., 1], u[..., 2])
