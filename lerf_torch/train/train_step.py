"""The LeRF training step: loss, gradients, Adam with a cosine learning rate.

The port of ``lerf_tpu/train/train_step.py`` (reference:
``resample/train_model.py:403-443``): two-stage ensemble prediction with
straight-through rounding, the steerable resize of the stage-1 feature
with the stage-2 hyper maps, ``MSE(clip(pred, 0, norm) / norm, label)``,
Adam with torch-style L2 and a cosine learning rate stepped per
iteration.

The stages are the plain differentiable chains (``srnet.predict_stage1`` /
``predict_stage2``, backend "xla": ``torch.matmul`` dense chains with
``round_ste``), as lerf_tpu leaves them to XLA.  The resize is
:func:`lerf_torch.ops.kernels.resize.steering_resize_train`: on a card K1
forward and K6 backward, on the CPU the plain op and its autograd.  The
whole step, forward and ``loss.backward()``, runs in full float32
(:func:`full_float32`): autograd runs the backward products and
convolutions outside any forward-only scope, where cuDNN's default on
Hopper is TF32.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..models import srnet
from ..models.imdn_s2d import cudnn_fp32
from ..ops.geometry import ResizeGeometry
from ..ops.kernels.resize import steering_resize_train
from ..ops.lut_pipeline import divide_exact


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    """The knobs the loss and step functions need (a subset of
    TrainConfig)."""
    scale: float = 4.0
    crop_size: int = 48
    norm: int = 255
    max_sigma: float = 10.0
    supp_size: int = 2
    linear: bool = False
    two_stage: bool = True
    stages: int = 2
    modes: Tuple[str, ...] = ("s", "c", "t")
    modes2: Tuple[str, ...] = ("s", "c", "t")
    feat_c: int = 1
    lr0: float = 1e-3
    lr1: float = 1e-4
    weight_decay: float = 0.0
    total_iter: int = 50000


def train_geometry(hp: TrainHParams) -> ResizeGeometry:
    """The training resize's geometry: the crop at ``hp.scale``, no
    antialias (the reference's torch path, resize_right2d_torch.py:42-46)."""
    return ResizeGeometry.create(
        (hp.crop_size, hp.crop_size), scale_factors=[hp.scale, hp.scale],
        support=hp.supp_size, antialias=False)


def cosine_lr(hp: TrainHParams) -> Callable[[int], float]:
    """The ``LambdaLR`` factor of step i: ``lr0 · cosine_lr(hp)(i)`` is
    lerf_tpu's ``lr0·(((1+cos(iπ/T))/2)·a + b)``, b = lr1/lr0, a = 1 − b
    (train_model.py:362-369); ``lr1 < 0`` takes the reference's fallback
    a = 0.8, b = 0.2."""
    if hp.lr1 < 0:
        a, b = 0.8, 0.2
    else:
        b = hp.lr1 / hp.lr0
        a = 1.0 - b

    def factor(i: int) -> float:
        return (1.0 + math.cos(i * math.pi / hp.total_iter)) / 2.0 * a + b

    return factor


def param_leaves(params) -> Dict[str, torch.Tensor]:
    """The trainable tensors by name: an ``nn.Module``'s named parameters,
    or a nested dict's leaves under their ``/``-joined keys, in sorted key
    order (the optimizer's parameter order)."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    out = {}

    def walk(prefix, tree):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                walk(f"{prefix}{k}/", tree[k])
            else:
                out[f"{prefix}{k}"] = tree[k]

    walk("", params)
    return out


def make_optimizer(params, hp: TrainHParams) -> torch.optim.Adam:
    """Adam(β 0.9 / 0.999, ε 1e-8) whose ``weight_decay`` adds the L2 term
    to the gradient before the moments, as optax's
    ``add_decayed_weights`` before ``scale_by_adam`` does
    (train_model.py:360)."""
    return torch.optim.Adam(list(param_leaves(params).values()), lr=hp.lr0,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=hp.weight_decay)


@contextlib.contextmanager
def full_float32():
    """Full float32 products and convolutions for the scope (no TF32 in
    cuBLAS or cuDNN; cuDNN deterministic, not autotuned), the caller's
    settings restored after it.  The flags are the process's, so the
    backward pass autograd runs in the scope obeys them too."""
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with cudnn_fp32():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


# ---------------------------------------------------------------------------
# forward = stage1 ensemble → stage2 ensemble → steerable resize
# ---------------------------------------------------------------------------


def lerf_forward(params, im: torch.Tensor, geom: ResizeGeometry,
                 hp: TrainHParams, stage1_fn: Optional[Callable] = None,
                 stage2_fn: Optional[Callable] = None,
                 operands=None) -> torch.Tensor:
    """im [B, C, h, w] in [0, 1] → prediction [B, C, H, W] in [0, 1].

    ``stage1_fn(params, x) -> feat`` / ``stage2_fn(params, x) -> hyper
    [..., oC]`` plug in other model families (LUT fine-tuning, IMDN); the
    default is the SRNet ensemble.  ``operands``: the geometry on the card
    for K1 / K6 (:class:`~lerf_torch.ops.kernels.resize_bwd.
    GradOperands`), made per call when not given."""
    if stage1_fn is None:
        stage1_fn = partial(srnet.predict_stage1, modes=hp.modes,
                            stages=hp.stages, norm=hp.norm)
    if stage2_fn is None:
        stage2_fn = partial(srnet.predict_stage2, modes2=hp.modes2,
                            norm=hp.norm)
    if hp.two_stage:
        feat = stage1_fn(params, im)          # [B, C, h, w] in [0, 255]
        hyper_in = divide_exact(feat, hp.norm)
    else:
        feat = torch.round(im * hp.norm)
        hyper_in = im
    hyper = stage2_fn(params, hyper_in)       # [B, C, h, w, oC] in [0, 1]
    if hp.linear:
        hyper = hyper[..., :1]
    elif hp.feat_c != 1 or hyper.shape[-1] != 3:
        # channel packing parity: pred_hyper[:, :featC] = ρ etc.
        # (train_model.py:434)
        fc = hp.feat_c
        hyper = hyper[..., [0, fc, 2 * fc]]
    b, c, h, w = feat.shape
    pred = steering_resize_train(
        feat.reshape(b * c, h, w), hyper.reshape(b * c, h, w, -1), geom,
        max_sigma=hp.max_sigma, linear=hp.linear, operands=operands)
    pred = pred.reshape((b, c) + pred.shape[-2:])
    return divide_exact(srnet.clip(pred, 0, hp.norm), hp.norm)


def make_loss_fn(geom: ResizeGeometry, hp: TrainHParams, stage1_fn=None,
                 stage2_fn=None, operands=None):
    def loss_fn(params, im, lb):
        pred = lerf_forward(params, im, geom, hp, stage1_fn, stage2_fn,
                            operands)
        return torch.mean((pred - lb) ** 2)
    return loss_fn


# ---------------------------------------------------------------------------
# train state + step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    """Params (a nested dict of tensors or an ``nn.Module``), their Adam
    optimizer, its cosine ``LambdaLR`` and the number of steps taken."""
    params: Any
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0

    @classmethod
    def create(cls, params, hp: TrainHParams):
        for p in param_leaves(params).values():
            p.requires_grad_(True)
        opt = make_optimizer(params, hp)
        return cls(params=params, optimizer=opt,
                   scheduler=torch.optim.lr_scheduler.LambdaLR(
                       opt, cosine_lr(hp)))


def global_norm(tensors) -> torch.Tensor:
    """The L2 norm of all the tensors together (optax.global_norm)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t) for t in tensors]))


def make_train_step(geom: ResizeGeometry, hp: TrainHParams, *,
                    stage1_fn=None, stage2_fn=None, device="cpu"):
    """The step ``(state, im, lb) → (state, {"loss", "grad_norm"})``: the
    loss and its gradients in full float32, Adam, the scheduler; the
    state's params and optimizer are updated in place.  The metrics stay
    0-d tensors on the device (no synchronisation).  On a card the
    geometry's K1 / K6 operands are made here, once."""
    dev = torch.device(device)
    operands = None
    if dev.type == "cuda":
        from ..ops.kernels.resize_bwd import GradOperands
        operands = GradOperands.create(geom, dev, linear=hp.linear)
    loss_fn = make_loss_fn(geom, hp, stage1_fn, stage2_fn, operands)

    def step(state: TrainState, im: torch.Tensor, lb: torch.Tensor):
        leaves = list(param_leaves(state.params).values())
        state.optimizer.zero_grad(set_to_none=True)
        with full_float32():
            loss = loss_fn(state.params, im, lb)
            loss.backward()
        # a parameter the loss does not reach still takes Adam's step
        # (its moments decay, its L2 term applies), as in optax
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        gnorm = global_norm([p.grad for p in leaves])
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step
