"""The IMDN form: ``lerf_torch.pipeline.NetPredictor.from_imdn`` on the
seeded state dict."""
from __future__ import annotations

from lerf_torch.models.imdn import IMDN2
from lerf_torch.pipeline import NetPredictor


def build(cfg: dict, weights: dict, device):
    model = IMDN2(in_c=cfg["in_c"], out_c=cfg["out_c"], nf=cfg["nf"],
                  num_modules=cfg["num_modules"])
    return NetPredictor.from_imdn(model, variables=weights,
                                  out_c=cfg["out_c"], backend=cfg["backend"],
                                  supp_size=cfg["support"],
                                  max_sigma=cfg["max_sigma"], device=device)
