"""Network → LUT transfer: every head over the input lattice, int8.

The port of ``lerf_tpu/lut/transfer.py`` (reference:
``resample/transfer_to_lut.py``): enumerate the L⁴ quantized input lattice
(17⁴ at interval 4), run every trained SRUnit head over it and quantize
to int8.  The heads are pixel MLPs over the (a, b, c, d) role vector, so
the lattice is one ``[L⁴, 4]`` matrix and each head one dense chain over
it (:func:`lerf_torch.models.srnet.apply_srunit`, ``torch.matmul``, as
lerf_tpu leaves the chain to XLA), in full float32 on the card.

The int8 micro-net backend also calibrates its activation scales over the
lattice (:func:`lerf_torch.ops.kernels.srnet_ensemble_int8.quantize_srunit_head`).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.srnet import apply_srunit
from .io import LUTBank


def lattice_1d(interval: int = 4) -> np.ndarray:
    """base = arange(0, 257, 2^interval) with base[-1] -= 1 → {0,16,…,240,255}
    (transfer_to_lut.py:13-15)."""
    base = np.arange(0, 257, 2 ** interval)
    base[-1] -= 1
    return base


def lattice_inputs(interval: int = 4) -> np.ndarray:
    """All L⁴ (a,b,c,d) tuples / 255 → float32 [L⁴, 4], ordered like the
    reference's first/second/third/fourth nested repeat (transfer_to_lut.py:16-36)."""
    base = lattice_1d(interval).astype(np.float64)
    L = base.shape[0]
    a = np.repeat(base, L ** 3)
    b = np.tile(np.repeat(base, L ** 2), L)
    c = np.tile(np.repeat(base, L), L ** 2)
    d = np.tile(base, L ** 3)
    return (np.stack([a, b, c, d], axis=-1) / 255.0).astype(np.float32)


def quantize_head(out: np.ndarray) -> np.ndarray:
    """round(clamp(out,-1,1)·127) int8 (transfer_to_lut.py:124-129)."""
    return np.round(np.clip(out, -1, 1) * 127).astype(np.int8)


def transfer_to_lut(params: Dict, *, modes: Sequence[str] = ("s", "c", "t"),
                    modes2: Sequence[str] = ("s", "c", "t"),
                    stages: int = 2, out_c: int = 3, interval: int = 4,
                    device=None) -> LUTBank:
    """Enumerate every head of a trained lerf-nets params dict (the port's
    layout, :func:`lerf_torch.models.srnet.init_lerf_nets`; tensors on any
    device) into an int8 :class:`LUTBank`, on ``device`` (``None`` →
    ``cuda``, raising without a card; or ``"cpu"``).

    Hyper heads keep separate r0/r1 tables; feature heads r0 only
    (transfer_to_lut.py:100-170).  With stages > 2 each feature stage gets
    its own table set (heads ``s{n}_{mode}``): the earlier stages land in
    ``LUTBank.inter``, the last in ``LUTBank.stage1``, as the reference's
    per-stage bank files (eval_lut_sr.py:747-775).  The products are full
    float32 (TF32 off for the call, the caller's setting restored)."""
    dev = resolve_device(device)
    x4 = torch.from_numpy(lattice_inputs(interval)).to(dev)

    def run(head):
        out = apply_srunit({k: v.to(dev, torch.float32)
                            for k, v in head.items()}, x4)
        return quantize_head(out.cpu().numpy())

    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            feature = [{m: run(params["s1"][f"s{s + 1}_{m}"]) for m in modes}
                       for s in range(max(stages - 1, 1))]
            stage2 = {f"{m}r{r}": run(params["s2"][f"{m}r{r}"])
                      for m in modes2 for r in (0, 1)}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    return LUTBank(stage1=feature[-1], stage2=stage2, out_c=out_c,
                   interval=interval, inter=feature[:-1])
