"""IMDN_RTC and LeRF-Net (IMDN2) as PyTorch modules, channel-first.

The port of ``lerf_tpu/models/imdn.py`` (reference:
``resample/model.py:475-537``): the lightweight information
multi-distillation network the LeRF-Net / LeRF-Net++ form uses as its
feature (stage 1) and hyper (stage 2) predictor.  Both towers run at the
input's resolution.  3×3 convolutions with SAME zero padding,
``leaky_relu(0.05)``, the distillation split ``dc = int(nf · 0.25)``.

``dtype`` is lerf_tpu's compute type (``lerf_tpu/models/imdn.py:29,58,87``):
the parameters stay float32, as flax keeps them, and with bf16 each conv
casts its input, kernel and bias to bf16 and adds the bias after the
convolution in bf16, as flax's ``nn.Conv`` does (``promote_dtype``, then
``y += bias``); the leaky ReLU, splits, concats, residual adds and
``predict``'s clip and scale then run in bf16.  On the CPU
``IMDN2(dtype=torch.bfloat16).predict`` is the plain version of the bf16
towers the form serves (:mod:`lerf_torch.models.imdn_s2d`).

Parameter names follow the reference checkpoint's layout
(``stage{1,2}.model.0``, ``.model.1.sub.{i}.c1..c5``,
``.model.1.sub.{n}``, ``.model.2``), so a reference state dict loads
with no mapping (:func:`lerf_torch.models.convert.imdn_from_torch_checkpoint`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resample import in_type


def lrelu(x: torch.Tensor) -> torch.Tensor:
    """``leaky_relu(x, 0.05)`` with the slope in ``x``'s type, as lerf_tpu's
    ``0.05 * x`` takes it (PyTorch would multiply a bf16 ``x`` by the
    float32 slope)."""
    return F.leaky_relu(x, negative_slope=in_type(0.05, x.dtype))


class Conv(nn.Conv2d):
    """A SAME, stride-1 conv computing in ``dtype``: float32 is
    ``nn.Conv2d`` itself; another type casts the input, kernel and bias to
    it and adds the bias after the convolution, as flax's ``nn.Conv``
    does.  The parameters stay float32."""

    def __init__(self, cin: int, cout: int, k: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, k, padding=k // 2)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x)
        y = F.conv2d(x.to(dt), self.weight.to(dt), None, padding=self.padding)
        return y + self.bias.to(dt)[:, None, None]


def _conv(cin: int, cout: int, k: int,
          dtype: torch.dtype = torch.float32) -> nn.Conv2d:
    return Conv(cin, cout, k, dtype)


class IMDModuleSpeed(nn.Module):
    """IMDModule_speed (model.py:480-503): three distillation steps and a
    1×1 fuse with a residual."""

    def __init__(self, channels: int, distillation_rate: float = 0.25,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dc = int(channels * distillation_rate)
        rc = channels - self.dc
        self.c1 = _conv(channels, channels, 3, dtype)
        self.c2 = _conv(rc, channels, 3, dtype)
        self.c3 = _conv(rc, channels, 3, dtype)
        self.c4 = _conv(rc, self.dc, 3, dtype)
        self.c5 = _conv(4 * self.dc, channels, 1, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dc = self.dc
        c1 = lrelu(self.c1(x))
        c2 = lrelu(self.c2(c1[:, dc:]))
        c3 = lrelu(self.c3(c2[:, dc:]))
        c4 = self.c4(c3[:, dc:])
        out = torch.cat([c1[:, :dc], c2[:, :dc], c3[:, :dc], c4], dim=1)
        return self.c5(out) + x


class _Shortcut(nn.Module):
    """x + sub(x): the reference's ShortcutBlock around the modules and the
    1×1 LR conv."""

    def __init__(self, *layers: nn.Module):
        super().__init__()
        self.sub = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.sub(x)


def depth_to_space(x: torch.Tensor, u: int, out_nc: int) -> torch.Tensor:
    """[B, u·u·oC, H, W] → [B, oC, H·u, W·u] in lerf_tpu's channel-minor
    order: channel ``(i·u + j)·oC + c`` lands at (h·u + i, w·u + j) of
    channel c.  ``F.pixel_shuffle`` reads channel ``c·u² + i·u + j``
    there instead."""
    b, _, h, w = x.shape
    x = x.reshape(b, u, u, out_nc, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, out_nc, h * u, w * u)


class IMDN_RTC(nn.Module):
    """IMDN_RTC (model.py:507-523): fea conv → shortcut(modules + 1×1) →
    3×3 up conv, and with ``upscale`` > 1 lerf_tpu's channel-minor depth to
    space.  NCHW."""

    def __init__(self, in_nc: int = 3, nf: int = 12, num_modules: int = 5,
                 out_nc: int = 3, upscale: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nf, self.num_modules = nf, num_modules
        self.out_nc, self.upscale, self.dtype = out_nc, upscale, dtype
        self.model = nn.Sequential(
            _conv(in_nc, nf, 3, dtype),
            _Shortcut(*[IMDModuleSpeed(nf, dtype=dtype)
                        for _ in range(num_modules)],
                      _conv(nf, nf, 1, dtype)),
            _conv(nf, out_nc * upscale ** 2, 3, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = self.model(x)
        if self.upscale > 1:
            up = depth_to_space(up, self.upscale, self.out_nc)
        return up


class IMDN2(nn.Module):
    """LeRF-Net / LeRF-Net++ (model.py:526-537): the stage-1 feature tower
    (output scaled to [0, 2·(norm//2)]) and the stage-2 hyper tower (output
    in [0, 1]), both at upscale 1, computing in ``dtype`` (float32 or
    bf16, lerf_tpu's ``IMDN2.dtype``)."""

    def __init__(self, in_c: int = 3, out_c: int = 3, nf: int = 12,
                 norm: int = 255, num_modules: int = 5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_c, self.out_c, self.nf, self.norm = in_c, out_c, nf, norm
        self.dtype = dtype
        self.stage1 = IMDN_RTC(in_c, nf, num_modules, in_c, upscale=1,
                               dtype=dtype)
        self.stage2 = IMDN_RTC(in_c, nf, num_modules, in_c * out_c,
                               upscale=1, dtype=dtype)

    def predict(self, x: torch.Tensor, stage: int = 1):
        """x: NCHW in [0, 1].  Stage 1 → feature in [0, 2·half] (half =
        norm // 2 = 127 at norm 255, so the feature peaks at 254, as the
        reference's does); stage 2 → hyper in [0, 1]; stage 0 → both
        towers' raw outputs, all in the model's ``dtype``."""
        half = self.norm // 2
        if stage == 0:
            return self.stage1(x), self.stage2(x)
        if stage == 2:
            return torch.clamp(self.stage2(x), -1, 1) / 2 + 0.5
        return torch.clamp(self.stage1(x), -1, 1) * half + half

    def forward(self, x: torch.Tensor, stage: int = 1):
        return self.predict(x, stage)


def init_imdn(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Every conv of ``model`` drawn from ``generator``, in parameter
    order: weight and bias uniform in ±1/√fan_in (PyTorch's default conv
    bounds), so a seed gives the same weights in any process.  lerf_tpu's
    flax init (``PRNGKey``) cannot be reproduced without JAX; tests carry
    its weights across instead (:func:`lerf_torch.convert.imdn_from_arrays`).
    Returns ``model``."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                for p in (m.weight, m.bias):
                    p.copy_((torch.rand(p.shape, generator=generator) * 2
                             - 1) * bound)
    return model
