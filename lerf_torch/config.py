"""Configuration: typed dataclasses behind the reference's CLI flag surface.

The port of ``lerf_tpu/config.py`` (``BaseConfig``, ``TrainConfig``,
``TestConfig``, the camelCase flag aliases, ``parse_config``) and its
experiment-directory system: ``opt.txt`` + ``opt.json``, auto-numbered
``expr_N`` directories, a snapshot of the sources, debug-mode shrinkage
(reference ``common/option.py:113-170``).  PyTorch runs eagerly, so there
is no compilation cache; ``--platform`` picks the device: ``cpu``, or the
CUDA card otherwise (which raises without one).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional


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

    @property
    def scale_value(self):
        """int for "4", float for "0.5" (option.py:127-131)."""
        return float(self.scale) if "." in self.scale else int(self.scale)

    def resolve_exp_dir(self):
        """``{model_root}/{name}/expr_N`` (the next free N) when no
        ``exp_dir`` is given; otherwise create it and name the run after
        it."""
        if self.exp_dir == "":
            model_dir = os.path.join(self.model_root, self.name)
            os.makedirs(model_dir, exist_ok=True)
            count = 1
            while os.path.isdir(os.path.join(model_dir, f"expr_{count}")):
                count += 1
            self.exp_dir = os.path.join(model_dir, f"expr_{count}")
            os.makedirs(self.exp_dir)
        else:
            os.makedirs(self.exp_dir, exist_ok=True)
            self.name = os.path.basename(self.exp_dir.rstrip("/")) \
                + "-" + self.model
        return self.exp_dir

    def snapshot_code(self, out_dir: Optional[str] = None):
        """Copy the package's sources into ``{expDir}/code`` for the
        run's provenance (reference option.py:113-119)."""
        import shutil
        out_dir = out_dir or self.exp_dir
        pkg_root = os.path.dirname(os.path.abspath(__file__))
        dst_root = os.path.join(out_dir, "code")
        for dirpath, _, files in os.walk(pkg_root):
            rel = os.path.relpath(dirpath, pkg_root)
            for f in files:
                if f.endswith((".py", ".cu")):
                    dst = os.path.join(dst_root, rel)
                    os.makedirs(dst, exist_ok=True)
                    shutil.copy2(os.path.join(dirpath, f),
                                 os.path.join(dst, f))

    def save(self, out_dir: Optional[str] = None):
        out_dir = out_dir or self.exp_dir
        os.makedirs(out_dir, exist_ok=True)
        d = dataclasses.asdict(self)
        with open(os.path.join(out_dir, "opt.json"), "w") as f:
            json.dump(d, f, indent=2, sort_keys=True)
        with open(os.path.join(out_dir, "opt.txt"), "w") as f:
            for k in sorted(d):
                f.write(f"{str(k):>25}: {str(d[k]):<30}\n")

    @classmethod
    def load(cls, exp_dir: str):
        with open(os.path.join(exp_dir, "opt.json")) as f:
            d = json.load(f)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


@dataclasses.dataclass
class TrainConfig(BaseConfig):
    # data (option.py:183-189)
    batch_size: int = 16
    crop_size: int = 48
    train_dir: str = "./data/DIV2K"
    val_dir: str = "./data/rrBenchmark"
    val_w_dir: str = "./data/WarpBenchmark"
    lutft: bool = False
    # training (option.py:191-201)
    start_iter: int = 0
    total_iter: int = 50000
    display_step: int = 100
    val_step: int = 2000
    save_step: int = 2000
    lr0: float = 1e-3
    lr1: float = 1e-4
    weight_decay: float = 0.0
    worker_num: int = 8          # accepted, unused: one sampler thread
    # lerf_tpu's additions
    data_axis: int = -1          # -1 or 1: one device (more: item 12)
    seed: int = 0
    keep_checkpoints: int = 5
    profile_steps: int = 0       # >0: torch.profiler trace of that many steps
    auto_reseed: int = 3         # dead-run reinit attempts (0 = off)
    device_data: bool = False    # the dataset on the device, sampled there

    def apply_debug(self):
        """Debug-mode shrinkage (option.py:164-170)."""
        if self.debug:
            self.display_step = 10
            self.save_step = 100
            self.val_step = 50
            self.total_iter = 200
            self.batch_size = 4
            self.nf = 16

    def check_devices(self):
        """The port trains on one device: ``data_axis`` -1 (lerf_tpu's "all
        local devices") or 1.  Data parallelism over several cards is
        ROADMAP Queue A item 12."""
        if self.data_axis not in (-1, 1):
            raise NotImplementedError(
                f"data_axis={self.data_axis}: training on more than one "
                "device is not ported yet (ROADMAP Queue A item 12)")


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
    "modelRoot": "model_root", "expDir": "exp_dir",
    "batchSize": "batch_size", "cropSize": "crop_size",
    "trainDir": "train_dir", "valDir": "val_dir", "valWDir": "val_w_dir",
    "startIter": "start_iter", "totalIter": "total_iter",
    "displayStep": "display_step", "valStep": "val_step",
    "saveStep": "save_step", "weightDecay": "weight_decay",
    "workerNum": "worker_num", "testDir": "test_dir",
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
