"""Train LeRF networks or fine-tune LUTs, on the CUDA card (or
``--platform cpu``).

The port of ``lerf_tpu.cli.train`` (reference: resample/train_model.py),
with its flags:

    # train LeRF-G (scripts.sh:2-6)
    python -m lerf_torch.cli.train -e models/lerf-g --twoStage --outC 3

    # fine-tune transferred LUTs (scripts.sh:27-30)
    python -m lerf_torch.cli.train -e models/lerf-g --twoStage --outC 3 \
        --lutft --lr0 1e-4 --totalIter 2000

    # LeRF-Net
    python -m lerf_torch.cli.train -e models/lerf-net --model IMDN2 \
        --inC 3 --outC 3 --nf 12 --twoStage

Checkpoints are written under ``{expDir}/ckpt/{step}`` (torch files);
``--startIter N`` resumes from step N's.
"""
from __future__ import annotations

import sys

from ..config import TrainConfig, parse_config
from ..train.loop import train


def main(argv=None):
    cfg = parse_config(TrainConfig, argv)
    return train(cfg)


if __name__ == "__main__":
    main(sys.argv[1:])
