"""The IMDN (LeRF-Net) form's plain reference: the two IMDN_RTC towers.

Written from the LeRF reference model (``resample/model.py:475-537``):
a tower is a 3×3 conv to ``nf`` channels, a shortcut around
``num_modules`` IMD modules and a 1×1 conv, and a 3×3 conv out.  A module
is four 3×3 convs that each hand all but a quarter of their channels on
(``leaky_relu`` 0.05 after the first three), the four kept quarters
concatenated and fused by a 1×1 conv, plus its input.  Stage 1 (feature)
is ``clamp(tower1(x), -1, 1) · 127 + 127`` on ``x = frame / 255``; stage 2
(hyper) is ``clamp(tower2(feat / 255), -1, 1) / 2 + 1/2``, whose channel
``o · C + c`` is map ``o`` (ρ, σx, σy) of colour ``c``
(``eval_model.py:124-149``).  Every conv is ``F.conv2d`` in float32 with
TF32 off, as the configuration states; the control turns TF32 on.

The weights are the benchmark's own, made from the seed on the device in
one draw: each conv's weight and bias uniform in ±1/√fan_in, in the
reference checkpoint's names, which both sides load.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import resample


def tower_spec(prefix: str, in_c: int, out_c: int, nf: int, modules: int):
    """[(name, (cout, cin, k, k))] of one tower's convs."""
    dc = int(nf * 0.25)
    rc = nf - dc
    spec = [(f"{prefix}.model.0", (nf, in_c, 3, 3))]
    for i in range(modules):
        sub = f"{prefix}.model.1.sub.{i}"
        spec += [(f"{sub}.c1", (nf, nf, 3, 3)), (f"{sub}.c2", (nf, rc, 3, 3)),
                 (f"{sub}.c3", (nf, rc, 3, 3)), (f"{sub}.c4", (dc, rc, 3, 3)),
                 (f"{sub}.c5", (nf, 4 * dc, 1, 1))]
    spec += [(f"{prefix}.model.1.sub.{modules}", (nf, nf, 1, 1)),
             (f"{prefix}.model.2", (out_c, nf, 3, 3))]
    return spec


def spec(cfg: dict):
    c, nf, mods = cfg["in_c"], cfg["nf"], cfg["num_modules"]
    return (tower_spec("stage1", c, c, nf, mods)
            + tower_spec("stage2", c, c * cfg["out_c"], nf, mods))


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The seeded state dict on ``device``: one uniform draw, cut into
    each conv's weight and bias."""
    shapes = []
    for name, shape in spec(cfg):
        shapes += [(f"{name}.weight", shape, shape[1:]),
                   (f"{name}.bias", shape[:1], shape[1:])]
    total = sum(math.prod(s) for _, s, _ in shapes)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=g, device=device) * 2 - 1
    out, at = {}, 0
    for name, shape, fan in shapes:
        n = math.prod(shape)
        out[name] = flat[at:at + n].reshape(shape) / math.sqrt(math.prod(fan))
        at += n
    return out


def lrelu(x):
    return F.leaky_relu(x, 0.05)


def tower(w: dict, prefix: str, x: torch.Tensor, nf: int, modules: int):
    def conv(name, y):
        k = w[f"{name}.weight"]
        return F.conv2d(y, k, w[f"{name}.bias"], padding=k.shape[-1] // 2)

    dc = int(nf * 0.25)
    fea = conv(f"{prefix}.model.0", x)
    y = fea
    for i in range(modules):
        sub = f"{prefix}.model.1.sub.{i}"
        c1 = lrelu(conv(f"{sub}.c1", y))
        c2 = lrelu(conv(f"{sub}.c2", c1[:, dc:]))
        c3 = lrelu(conv(f"{sub}.c3", c2[:, dc:]))
        c4 = conv(f"{sub}.c4", c3[:, dc:])
        y = conv(f"{sub}.c5", torch.cat([c1[:, :dc], c2[:, :dc],
                                         c3[:, :dc], c4], 1)) + y
    y = fea + conv(f"{prefix}.model.1.sub.{modules}", y)
    return conv(f"{prefix}.model.2", y)


class Stages:
    """The IMDN form's two towers: uint8 [C, H, W] → (feature float32 in
    [0, 254], maps (ρ, σx, σy) float32 in [0, 1])."""

    def __init__(self, cfg: dict, weights: dict, precision: dict):
        self.cfg = cfg
        self.w = weights
        self.tf32 = precision.get("towers") == "tf32"

    def __call__(self, x_u8: torch.Tensor):
        cfg = self.cfg
        nf, mods, c = cfg["nf"], cfg["num_modules"], cfg["in_c"]
        half = 255 // 2
        prev = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = self.tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        try:
            with torch.no_grad():
                x = resample.divide(x_u8.to(torch.float32), 255)[None]
                feat = torch.clamp(tower(self.w, "stage1", x, nf, mods),
                                   -1, 1) * half + half
                h = tower(self.w, "stage2", resample.divide(feat, 255),
                          nf, mods)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = prev
        maps = (torch.clamp(h, -1, 1) / 2 + 0.5)[0]
        maps = maps.reshape(cfg["out_c"], c, *maps.shape[-2:])
        return feat[0], (maps[0], maps[1], maps[2])
