"""The LUT form: ``lerf_torch.pipeline.LutPredictor`` on the seeded bank."""
from __future__ import annotations

import torch

from lerf_torch.lut.io import LUTBank
from lerf_torch.pipeline import LutPredictor


def build(cfg: dict, bank: dict, device):
    keys = [("stage1", k) for k in bank["stage1"]] + [
        ("stage2", k) for k in bank["stage2"]]
    flat = torch.cat([bank[s][k].reshape(-1) for s, k in keys]).cpu().numpy()
    host, at = {"stage1": {}, "stage2": {}}, 0
    for s, k in keys:
        t = bank[s][k]
        host[s][k] = flat[at:at + t.numel()].reshape(tuple(t.shape))
        at += t.numel()
    return LutPredictor(
        LUTBank(stage1=host["stage1"], stage2=host["stage2"],
                out_c=cfg["out_c"], interval=cfg["interval"]),
        modes=tuple(cfg["modes"]), modes2=tuple(cfg["modes2"]),
        supp_size=cfg["support"], max_sigma=cfg["max_sigma"],
        stages=cfg["stages"], table_layout=cfg["table_layout"],
        device=device)
