"""Network-form evaluation of trained SRNets (LeRF-L/G micro-net form).

Drop-in equivalent of the reference eval script (resample/eval_model.py) and
``lerf_tpu.cli.eval_model`` for the SRNet form, on the CUDA card (or
``--platform cpu``):

    python -m lerf_torch.cli.eval_model --testDir data/rrBenchmark \
        --resultRoot results/sr-net -e models/lerf-g --twoStage --outC 3

Loads ``Model_{loadIter:06d}.pth`` from ``-e`` and prints the same table
format; ``--backend`` picks the ensemble backend (``auto``: K3,
``pallas_int8``: K4, ``xla``: the plain chain).  As in the reference,
"warp" in ``--resultRoot`` evaluates the homographic warp on a
WarpBenchmark tree (``--hrRoot`` for the HR root) and prints the isc / osc
table.  ``--linear`` evaluates a LeRF-L checkpoint (stage-2 heads with one
output); SR serves through ``upscale_dynamic`` with ``--dynamicSR`` and
``upscale_bucketed`` with ``--bucket g``.  The IMDN form (``--model
IMDN2``), orbax ``ckpt/`` checkpoints and the warp's ``--dynamicWarp`` /
``--bucket`` serving forms are not ported yet and exit with a message
saying so.
"""
from __future__ import annotations

import os
import sys

from ..config import TestConfig, parse_config
from ..evaluate import (format_sr_header, format_sr_row, format_warp_header,
                        format_warp_row, run_sr_benchmark,
                        run_warp_benchmark)
from ..pipeline import NetPredictor

DEFAULT_DATASETS = ["Set5"]
DEFAULT_SCALES = [[2, 2], [3, 3], [4, 4]]


def load_params(cfg: TestConfig):
    """The SRNet params of ``cfg.exp_dir``: a reference torch pickle
    ``Model_{load_iter:06d}.pth``.  Raises :class:`NotImplementedError` for
    an orbax ``ckpt/`` directory (which ``lerf_tpu`` would read first) and
    :class:`FileNotFoundError` when there is no checkpoint."""
    from ..models.convert import load_reference_checkpoint

    ckpt_dir = os.path.join(cfg.exp_dir, "ckpt")
    if os.path.isdir(ckpt_dir):
        raise NotImplementedError(
            f"orbax checkpoint {ckpt_dir}: not ported yet (ROADMAP Queue A "
            "item 10)")
    pth = os.path.join(cfg.exp_dir, f"Model_{cfg.load_iter:06d}.pth")
    if not os.path.exists(pth):
        raise FileNotFoundError(f"no checkpoint at {ckpt_dir} or {pth}")
    return load_reference_checkpoint(pth, modes=tuple(cfg.modes),
                                     modes2=tuple(cfg.modes2),
                                     stages=cfg.stages)


def predictor_from_params(cfg: TestConfig, params) -> NetPredictor:
    return NetPredictor.from_srnets(
        params, modes=tuple(cfg.modes), modes2=tuple(cfg.modes2),
        stages=cfg.stages, linear=cfg.linear, two_stage=cfg.two_stage,
        supp_size=cfg.supp_size, max_sigma=cfg.max_sigma, norm=cfg.norm,
        backend=cfg.backend, device=cfg.device)


def build_predictor(cfg: TestConfig) -> NetPredictor:
    if cfg.model == "IMDN2":
        raise SystemExit("eval_model: --model IMDN2 is not ported yet "
                         "(ROADMAP Queue A item 8)")
    try:
        params = load_params(cfg)
    except NotImplementedError as e:
        raise SystemExit(f"eval_model: {e}")
    return predictor_from_params(cfg, params)


def main(argv=None, datasets=None):
    cfg = parse_config(TestConfig, argv)
    warp = "warp" in cfg.result_root
    datasets = datasets or cfg.dataset_list() or DEFAULT_DATASETS
    pred = build_predictor(cfg)
    exp_name = cfg.exp_dir.rstrip("/").split("/")[-1]

    if warp:
        results = {}
        print(format_warp_header(), flush=True)
        for ds in datasets:
            results[ds] = run_warp_benchmark(
                pred, cfg.test_dir, ds, ("isc", "osc"),
                hr_root=cfg.hr_root or None, result_root=cfg.result_root,
                exp_name=exp_name,
                pre_upsample="PreUpsample" in cfg.test_dir,
                dynamic=cfg.dynamic_warp, bucket=cfg.bucket)
            print(format_warp_row(ds, results[ds]), flush=True)
        return results

    post = 2 if "PreUpsample" in cfg.test_dir else 1
    scales = cfg.scale_list() or [tuple(s) for s in DEFAULT_SCALES]
    results = {}
    print(format_sr_header(scales), flush=True)
    for ds in datasets:
        results[ds] = run_sr_benchmark(
            pred, cfg.test_dir, ds, scales, result_root=cfg.result_root,
            exp_name=exp_name, post=post, nsigma=cfg.nsigma,
            bucket=cfg.bucket, dynamic=cfg.dynamic_sr)
        print(format_sr_row(ds, results[ds], scales), flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
