"""Arbitrary-scale SR evaluation from LUTs (LeRF-G deploy path).

Drop-in equivalent of the reference driver (resample/eval_lut_sr.py) and
of ``lerf_tpu.cli.eval_lut_sr``, on the CUDA card (or ``--platform cpu``):

    python -m lerf_torch.cli.eval_lut_sr --testDir data/rrBenchmark \
        --resultRoot results/sr --lutName LUTft -e models/lerf-g

Prints the same table format.  ``--dynamicSR`` serves through
``upscale_dynamic`` (``--bucket g`` its granularity), ``--bucket g`` alone
through ``upscale_bucketed``: the same table, both forms bit-equal to
``upscale``.  ``--linear`` evaluates a LeRF-L bank (stage 2 with one
output), ``--suppSize`` sets the resample's support.
"""
from __future__ import annotations

import sys

from ..config import TestConfig, parse_config
from ..evaluate import format_sr_header, format_sr_row, run_sr_benchmark
from ..pipeline import LutPredictor

DEFAULT_DATASETS = ["Set5"]
DEFAULT_SCALES = [[2, 2], [3, 3], [4, 4]]


def main(argv=None, datasets=None, scales=None):
    cfg = parse_config(TestConfig, argv)
    datasets = datasets or cfg.dataset_list() or DEFAULT_DATASETS
    scales = scales or cfg.scale_list() or DEFAULT_SCALES

    pred = LutPredictor.from_config(cfg)

    # pre-upsampled inputs halve the resample scale (eval_lut_sr.py:630-646)
    post = 2 if ("PreUpsample" in cfg.test_dir or "down2" in cfg.result_root
                 or "lutx2" in cfg.result_root) else 1
    if "rrdb" in cfg.result_root or "down4" in cfg.result_root:
        post = 4

    exp_name = cfg.exp_dir.rstrip("/").split("/")[-1]
    all_results = {}
    print(format_sr_header(scales), flush=True)   # rows flush per dataset
    for ds in datasets:
        all_results[ds] = run_sr_benchmark(
            pred, cfg.test_dir, ds, [tuple(s) for s in scales],
            result_root=cfg.result_root, exp_name=exp_name,
            lut_name=cfg.lut_name, post=post, nsigma=cfg.nsigma,
            bucket=cfg.bucket, dynamic=cfg.dynamic_sr)
        print(format_sr_row(ds, all_results[ds], scales), flush=True)
    return all_results


if __name__ == "__main__":
    main(sys.argv[1:])
