"""Checkpoints of the training state, as torch files.

The port of ``lerf_tpu/train/checkpoint.py``: one directory a step,
``{exp_dir}/ckpt/{step}/state.pt``, holding the params, the Adam state,
the scheduler, the step and the random generators' states (so a resumed
run draws the batches an uninterrupted one would), the last ``keep``
kept.  lerf_tpu writes orbax step directories in the same place; the port
cannot read orbax without JAX, so it recognises one and refuses it with a
message naming its writer.  The deployable artifact stays the int8
``.npy`` LUT set (``lerf_torch.lut.io``).
"""
from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional

import torch

STATE_FILE = "state.pt"
# what an orbax (lerf_tpu) step directory holds at its top
ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")


class OrbaxCheckpointError(ValueError):
    """A step directory written by lerf_tpu's orbax checkpointer."""


def is_orbax_step(path: str) -> bool:
    return not os.path.exists(os.path.join(path, STATE_FILE)) and any(
        os.path.exists(os.path.join(path, m)) for m in ORBAX_MARKERS)


class CheckpointManager:
    """Save and restore training states under ``{exp_dir}/ckpt``."""

    def __init__(self, exp_dir: str, keep: int = 5):
        self.root = os.path.abspath(os.path.join(exp_dir, "ckpt"))
        self.keep = keep
        os.makedirs(self.root, exist_ok=True)

    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, str(int(step)))

    def all_steps(self) -> List[int]:
        """The steps with a directory, the port's or orbax's, ascending."""
        return sorted(int(d) for d in os.listdir(self.root) if d.isdigit()
                      and os.path.isdir(os.path.join(self.root, d)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Dict[str, Any]):
        """Write ``state`` (a dict of tensors, numbers and nested dicts of
        them) as step ``step``, atomically, then drop all but the last
        ``keep`` steps."""
        final = self.step_dir(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, STATE_FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.keep]:
            shutil.rmtree(self.step_dir(old), ignore_errors=True)

    def restore(self, step: Optional[int] = None,
                map_location="cpu") -> Optional[Dict[str, Any]]:
        """The state saved at ``step`` (the latest when ``None``; ``None``
        when there is none).  Raises :class:`OrbaxCheckpointError` for
        lerf_tpu's orbax directory and ``FileNotFoundError`` for a step
        that was not saved."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        path = self.step_dir(step)
        if is_orbax_step(path):
            raise OrbaxCheckpointError(
                f"{path} is an orbax checkpoint written by lerf_tpu's "
                "trainer (lerf_tpu.train.checkpoint); lerf_torch cannot "
                "read orbax without JAX: train with lerf_torch.cli.train, "
                "or export the params with lerf_tpu")
        file = os.path.join(path, STATE_FILE)
        if not os.path.exists(file):
            raise FileNotFoundError(f"no checkpoint of step {step} in "
                                    f"{self.root}")
        return torch.load(file, map_location=map_location, weights_only=True)

    def close(self):
        """Nothing is pending: :meth:`save` writes synchronously."""


def host_params(params):
    """Params copied to the host, detached: a nested dict of CPU tensors,
    or an ``nn.Module``'s state dict on the CPU."""
    if isinstance(params, torch.nn.Module):
        return {k: v.detach().cpu().clone()
                for k, v in params.state_dict().items()}
    if isinstance(params, dict):
        return {k: host_params(v) for k, v in params.items()}
    return params.detach().cpu().clone()
