"""The system under test, built from the benchmark's seeded weights: one
module a form (``<form>.py``, ``build(cfg, weights, device)`` → a
``lerf_torch`` predictor), found by the configuration's ``form``.  The
only part of the benchmark that imports the program."""
from __future__ import annotations

import importlib


def build(cfg: dict, weights, device):
    return importlib.import_module(f"{__name__}.{cfg['form']}").build(
        cfg, weights, device)
