"""Homographic-warp evaluation from LUTs (LeRF-G deploy path).

Drop-in equivalent of the reference script (resample/eval_lut_warp.py) and
of ``lerf_tpu.cli.eval_lut_warp``, on the CUDA card (or ``--platform cpu``):

    python -m lerf_torch.cli.eval_lut_warp --testDir data/WarpBenchmark \
        --resultRoot results/warp --lutName LUTft -e models/lerf-g

Use --hrRoot to point at the HR directory root when the warp benchmark
directory ships only isc/osc.  Prints the same table format.
``--dynamicWarp`` (or ``--bucket g``) serves through ``warp_dynamic``,
bit-equal to the static ``warp``.
"""
from __future__ import annotations

import sys

from ..config import TestConfig, parse_config
from ..evaluate import (format_warp_header, format_warp_row,
                        run_warp_benchmark)
from ..pipeline import LutPredictor

DEFAULT_DATASETS = ["Set5"]
DEFAULT_SCALE_PS = ["isc", "osc"]


def main(argv=None, datasets=None, scale_ps=None):
    cfg = parse_config(TestConfig, argv)
    datasets = datasets or cfg.dataset_list() or DEFAULT_DATASETS
    scale_ps = scale_ps or DEFAULT_SCALE_PS

    pred = LutPredictor.from_config(cfg)

    exp_name = cfg.exp_dir.rstrip("/").split("/")[-1]
    all_results = {}
    print(format_warp_header(tuple(scale_ps)), flush=True)
    for ds in datasets:
        all_results[ds] = run_warp_benchmark(
            pred, cfg.test_dir, ds, tuple(scale_ps),
            hr_root=cfg.hr_root or None, result_root=cfg.result_root,
            exp_name=exp_name,
            pre_upsample="PreUpsample" in cfg.test_dir,
            dynamic=cfg.dynamic_warp, bucket=cfg.bucket)
        print(format_warp_row(ds, all_results[ds], tuple(scale_ps)),
              flush=True)
    return all_results


if __name__ == "__main__":
    main(sys.argv[1:])
