"""Configuration: typed dataclasses behind the reference's CLI flag surface.

The port of the inference part of ``lerf_tpu/config.py`` (``BaseConfig``,
``TestConfig``, the camelCase flag aliases, ``parse_config``).  PyTorch
runs eagerly, so there is no compilation cache; ``--platform`` picks the
device: ``cpu``, or the CUDA card otherwise (which raises without one).
"""
from __future__ import annotations

import argparse
import dataclasses


@dataclasses.dataclass
class BaseConfig:
    # experiment specifics (option.py:13-41)
    name: str = "lerf"
    model: str = "SRNetsSWF2"
    scale: str = "4"
    nsigma: float = -1.0         # Gaussian noise σ; float like option.py:18
    nf: int = 64
    modes: str = "sct"
    modes2: str = "sct"
    interval: int = 4
    norm: int = 255
    supp_size: int = 2
    in_c: int = 1
    out_c: int = 3
    feat_c: int = 1
    max_sigma: int = 10
    stages: int = 2
    two_stage: bool = False
    linear: bool = False
    model_root: str = "./models"
    exp_dir: str = ""
    debug: bool = False
    platform: str = ""           # "" / "cuda" / "gpu": the card; "cpu"

    @property
    def device(self) -> str:
        if self.platform in ("", "cuda", "gpu"):
            return "cuda"
        if self.platform == "cpu":
            return "cpu"
        raise ValueError(f"--platform {self.platform!r}: use cpu or cuda")


@dataclasses.dataclass
class TestConfig(BaseConfig):
    test_dir: str = "./data/rrBenchmark"
    result_root: str = "./results"
    load_iter: int = 50000
    lut_name: str = "LUTft"
    hr_root: str = ""            # warp eval HR root (--hrRoot)
    datasets: str = "Set5"       # comma list of benchmark sets
    scales: str = "2,3,4"        # comma list; 'HxW' pairs allowed
    # micro-net (SRNet) backend: auto / pallas = K3 (kernel on the card,
    # plain twin on the CPU), pallas_int8 = K4, xla = plain batched chain;
    # IMDN2: base / s2d (anything else: auto)
    backend: str = "auto"
    bucket: int = 0              # SR bucket granularity (warp: not ported)
    dynamic_warp: bool = False   # dynamic warp serving (not ported yet)
    dynamic_sr: bool = False     # dynamic SR serving (upscale_dynamic)

    def dataset_list(self):
        return [d for d in self.datasets.split(",") if d]

    def scale_list(self):
        out = []
        for s in self.scales.split(","):
            if not s:
                continue
            if "x" in s:
                h, w = s.split("x")
                out.append((float(h), float(w)))
            else:
                out.append((float(s), float(s)))
        return out


_FLAG_ALIASES = {
    # reference camelCase flag → dataclass field
    "suppSize": "supp_size", "inC": "in_c", "outC": "out_c",
    "featC": "feat_c", "maxSigma": "max_sigma", "twoStage": "two_stage",
    "modelRoot": "model_root", "expDir": "exp_dir", "testDir": "test_dir",
    "resultRoot": "result_root", "loadIter": "load_iter",
    "lutName": "lut_name", "hrRoot": "hr_root", "outSize": "out_size",
    "dynamicWarp": "dynamic_warp", "dynamicSR": "dynamic_sr",
}


def build_parser(cls) -> argparse.ArgumentParser:
    """argparse front-end accepting both snake_case and the reference's
    camelCase flags (so the reference's documented commands port 1:1)."""
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    inverse = {v: k for k, v in _FLAG_ALIASES.items()}
    for f in dataclasses.fields(cls):
        names = [f"--{f.name}"]
        if f.name in inverse:
            names.append(f"--{inverse[f.name]}")
        if f.name == "exp_dir":
            names.append("-e")
        if f.name == "scale":
            names.append("-r")
        if f.type in ("bool", bool):
            p.add_argument(*names, action=argparse.BooleanOptionalAction,
                           default=f.default)
        else:
            typ = {int: int, float: float, str: str}.get(
                f.type if isinstance(f.type, type) else
                {"int": int, "float": float, "str": str}.get(f.type, str))
            p.add_argument(*names, type=typ, default=f.default)
    return p


def parse_config(cls, argv=None):
    args = build_parser(cls).parse_args(argv)
    return cls(**vars(args))
