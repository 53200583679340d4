"""Network-form evaluation (LeRF-Net / LeRF-Net++ / trained SRNets).

Drop-in equivalent of the reference eval script (resample/eval_model.py) and
``lerf_tpu.cli.eval_model``, on the CUDA card (or ``--platform cpu``):

    python -m lerf_torch.cli.eval_model --testDir data/rrBenchmark \
        --resultRoot results/sr-net -e models/lerf-g --twoStage --outC 3
    python -m lerf_torch.cli.eval_model --testDir data/rrBenchmark \
        --resultRoot results/sr-net -e models/lerf-net --model IMDN2 \
        --inC 3 --twoStage

Loads ``Model_{loadIter:06d}.pth`` from ``-e`` and prints the same table
format; ``--backend`` picks the SRNet ensemble backend (``auto``: K3,
``pallas_int8``: K4, ``xla``: the plain chain) or the IMDN towers'
(``base``, ``s2d``; anything else: ``auto``).  As in the reference,
"warp" in ``--resultRoot`` evaluates the homographic warp on a
WarpBenchmark tree (``--hrRoot`` for the HR root) and prints the isc / osc
table.  ``--linear`` evaluates a LeRF-L checkpoint (stage-2 heads with one
output); SR serves through ``upscale_dynamic`` with ``--dynamicSR`` and
``upscale_bucketed`` with ``--bucket g``, the warp through
``warp_dynamic`` with ``--dynamicWarp``.

``--model IMDN2`` (LeRF-Net): a reference IMDN2 checkpoint (or a plain
state dict of its layout) loads as it is; with no checkpoint the model is
initialised from a ``torch.Generator`` seeded 0
(:func:`lerf_torch.models.imdn.init_imdn`).  lerf_tpu initialises from
flax's ``PRNGKey(0)``, which cannot be reproduced without JAX, so the two
packages' uncheckpointed models differ.  As lerf_tpu's, both forms first
read the trainer's checkpoint of step ``loadIter``
(``{expDir}/ckpt/{loadIter}``, written by ``lerf_torch.cli.train``) and
fall through to the above when there is none (an empty ``ckpt/``); an
orbax step directory (lerf_tpu's trainer's) exits with a message naming
its writer.
"""
from __future__ import annotations

import os
import sys

from ..config import TestConfig, parse_config
from ..evaluate import (format_sr_header, format_sr_row, format_warp_header,
                        format_warp_row, run_sr_benchmark,
                        run_warp_benchmark)
from ..pipeline import NetPredictor
from .transfer import load_params, trained_params

DEFAULT_DATASETS = ["Set5"]
DEFAULT_SCALES = [[2, 2], [3, 3], [4, 4]]


def load_imdn(cfg: TestConfig):
    """The IMDN2 (LeRF-Net) model of ``cfg.exp_dir`` on the host
    (``lerf_tpu/cli/eval_model.py:27-56``): (the seed-0 model, the state
    dict of the trainer's checkpoint of step ``load_iter``, else of the
    reference checkpoint, else ``None``).  Raises
    :class:`~lerf_torch.train.checkpoint.OrbaxCheckpointError` for
    lerf_tpu's orbax step directory."""
    import torch

    from ..models.convert import imdn_from_torch_checkpoint
    from ..models.imdn import IMDN2, init_imdn

    model = init_imdn(IMDN2(in_c=cfg.in_c, out_c=cfg.out_c, nf=cfg.nf,
                            norm=cfg.norm), torch.Generator().manual_seed(0))
    variables = trained_params(cfg)
    if variables is not None:
        return model, variables
    pth = os.path.join(cfg.exp_dir, f"Model_{cfg.load_iter:06d}.pth")
    return model, (imdn_from_torch_checkpoint(pth) if os.path.exists(pth)
                   else None)


def imdn_predictor(cfg: TestConfig, model, variables) -> NetPredictor:
    """``NetPredictor.from_imdn`` on :func:`load_imdn`'s model with every
    flag the SRNet form takes."""
    backend = cfg.backend if cfg.backend in ("base", "s2d") else "auto"
    return NetPredictor.from_imdn(
        model, variables, out_c=cfg.out_c, linear=cfg.linear,
        two_stage=cfg.two_stage, supp_size=cfg.supp_size,
        max_sigma=cfg.max_sigma, norm=cfg.norm, backend=backend,
        device=cfg.device)


def predictor_from_params(cfg: TestConfig, params) -> NetPredictor:
    return NetPredictor.from_srnets(
        params, modes=tuple(cfg.modes), modes2=tuple(cfg.modes2),
        stages=cfg.stages, linear=cfg.linear, two_stage=cfg.two_stage,
        supp_size=cfg.supp_size, max_sigma=cfg.max_sigma, norm=cfg.norm,
        backend=cfg.backend, device=cfg.device)


def build_predictor(cfg: TestConfig) -> NetPredictor:
    from ..train.checkpoint import OrbaxCheckpointError

    imdn = cfg.model == "IMDN2"
    try:
        loaded = load_imdn(cfg) if imdn else load_params(cfg)
    except OrbaxCheckpointError as e:
        raise SystemExit(f"eval_model: {e}")
    return (imdn_predictor(cfg, *loaded) if imdn
            else predictor_from_params(cfg, loaded))


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
