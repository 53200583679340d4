"""SRNet micro-networks as pixel MLPs (the LeRF-L/G trainable form).

The port of ``lerf_tpu/models/srnet.py``.  Each member of the
mode×rotation ensemble is a 4-feature MLP applied at every pixel — conv1
(4→nf), four DenseConv blocks, a 5·nf→oC head with tanh — over the 4
pixels its mode samples; rotations rotate the sampling offsets instead of
the image (``lerf_torch.ops.lut_pipeline``).

Params keep the JAX layout: ``{"s1": {"s1_s": head, ...}, "s2": {"sr0":
head, ...}}`` with ``w [in, out]`` and ``b [out]`` float32 tensors per
head; images are ``[..., H, W]`` floats in [0, 1].

Backends of the ensemble sum (:func:`resolve_backend`): ``"pallas"`` (and
``"auto"``) is K3 (:mod:`lerf_torch.ops.kernels.srnet_ensemble`) — the
kernel for a CUDA tensor, its plain twin for a CPU tensor;
``"pallas_int8"`` is K4 on heads from :func:`quantize_lerf_params`;
``"xla"`` is the plain batched PyTorch chain, differentiable through
:func:`round_ste` (it holds every member's activations at once, so keep
its images small).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..ops.kernels import srnet_ensemble as k3
from ..ops.kernels import srnet_ensemble_int8 as k4
from ..ops.kernels.srnet_ensemble import LAYERS, sample_x4, srunit_chain
from ..ops.lut_pipeline import divide_exact

BACKENDS = ("xla", "pallas", "pallas_int8")


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """Straight-through rounding (BPDA): round forward, identity backward.

    Parity: ``round_func`` (resample/model.py:16-22)."""
    return x + (torch.round(x) - x).detach()


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: ``torch.clamp``'s values, and lerf_tpu's gradient,
    which is halved where ``x`` equals a bound (``torch.clamp`` passes it
    whole).  The stages' rounded values land on their bounds often (a
    feature of exactly 0, a code of 255), so the training gradients follow
    it."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


# ---------------------------------------------------------------------------
# pixel-MLP (SRUnit equivalent)
# ---------------------------------------------------------------------------


def init_srunit(generator: torch.Generator, nf: int = 64, out_c: int = 1,
                dtype=torch.float32) -> Dict:
    """Params for one SRUnit: conv1(4→nf), 4 dense blocks, head(5nf→outC),
    MSRA/Kaiming-normal weights and zero biases like the reference
    (network.py:15-24), drawn from ``generator``."""
    def kaiming(fan_in, shape):
        return torch.randn(shape, generator=generator, dtype=dtype) \
            * float(np.sqrt(2.0 / fan_in))

    p = {"w1": kaiming(4, (4, nf)), "b1": torch.zeros(nf, dtype=dtype)}
    for k in range(2, 6):
        p[f"w{k}"] = kaiming((k - 1) * nf, ((k - 1) * nf, nf))
        p[f"b{k}"] = torch.zeros(nf, dtype=dtype)
    p["w6"] = kaiming(5 * nf, (5 * nf, out_c))
    p["b6"] = torch.zeros(out_c, dtype=dtype)
    return p


def apply_srunit(params: Dict, x4: torch.Tensor) -> torch.Tensor:
    """x4 [..., 4] → [..., outC] through the dense-block MLP + tanh
    (SRUnit.forward, network.py:64-73)."""
    return srunit_chain(x4, [params[f"w{k}"] for k in LAYERS],
                        [params[f"b{k}"] for k in LAYERS])


def srunit_on_image(params: Dict, img: torch.Tensor, mode: str, rot: int):
    """The pixel MLP over an image with mode geometry at rotation ``rot``:
    img [..., H, W] float → [..., H, W, outC]."""
    x4 = sample_x4(img, [(mode, rot)])[0]
    return apply_srunit(params, x4).reshape(img.shape + (-1,))


def _stack_heads(heads):
    """List of SRUnit param dicts → one dict of [M, in, out] stacked mats."""
    return {k: torch.stack([h[k] for h in heads]) for k in heads[0]}


def apply_srunit_batched(stacked: Dict, x4: torch.Tensor) -> torch.Tensor:
    """x4 [M, ..., 4] with stacked [M, in, out] weights → [M, ..., outC]."""
    m = x4.shape[0]
    out = srunit_chain(x4.reshape(m, -1, 4),
                       [stacked[f"w{k}"] for k in LAYERS],
                       [stacked[f"b{k}"][:, None] for k in LAYERS])
    return out.reshape(x4.shape[:-1] + out.shape[-1:])


def ensemble_on_image(head_for_member, img: torch.Tensor, members):
    """Batched rotation/mode ensemble: [M, ..., H, W, outC] member outputs.

    ``members``: [(mode, rot)]; ``head_for_member(i)`` → SRUnit params for
    member i."""
    x4 = sample_x4(img, members).reshape(
        (len(members),) + img.shape + (4,))
    stacked = _stack_heads([head_for_member(i) for i in range(len(members))])
    return apply_srunit_batched(stacked, x4)


# ---------------------------------------------------------------------------
# two-stage ensemble (SRNetsSWF2 equivalent)
# ---------------------------------------------------------------------------


def init_lerf_nets(generator: torch.Generator, *,
                   modes: Sequence[str] = ("s", "c", "t"),
                   modes2: Sequence[str] = ("s", "c", "t"), nf: int = 64,
                   out_c: int = 3, stages: int = 2) -> Dict:
    """Parameter dict for the LeRF two-stage micro-net ensemble.

    Layout parity with SRNetsSWF2 (model.py:69-93): stage-1 heads
    ``s1[f"s{s}_{mode}"]`` (r0 only, outC=1), stage-2 hyper heads
    ``s2[f"{mode}r{r}"]`` (r∈{0,1}, outC=out_c)."""
    s1 = {f"s{s + 1}_{m}": init_srunit(generator, nf, 1)
          for s in range(max(stages - 1, 1)) for m in modes}
    s2 = {f"{m}r{r}": init_srunit(generator, nf, out_c)
          for m in modes2 for r in (0, 1)}
    return {"s1": s1, "s2": s2}


def resolve_backend(backend: str) -> str:
    """``"auto"`` → ``"pallas"``: K3, which runs the kernel for a CUDA
    tensor and its plain twin for a CPU tensor.  ``"pallas_int8"`` (opt-in)
    needs heads from :func:`quantize_lerf_params`."""
    if backend == "auto":
        return "pallas"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def quantize_lerf_params(params: Dict, *, interval: int = 4) -> Dict:
    """Post-training int8 quantization of every SRUnit head (host numpy,
    once): the same key structure, each head a
    :func:`~lerf_torch.ops.kernels.srnet_ensemble_int8.quantize_srunit_head`
    dict calibrated on the 17⁴ deploy input lattice."""
    from ..lut.transfer import lattice_inputs

    calib = lattice_inputs(interval)

    def host(head):
        return {k: torch.as_tensor(v).detach().cpu().numpy()
                for k, v in head.items()}

    return {sk: {name: k4.quantize_srunit_head(host(head), calib)
                 for name, head in params[sk].items()}
            for sk in ("s1", "s2")}


def stage_members(modes: Sequence[str]):
    """[(mode, rotation)] of one stage's ensemble, mode-major."""
    return [(m, r) for m in modes for r in range(4)]


def stage1_heads(params: Dict, s: int, modes: Sequence[str]):
    """Member-aligned heads of feature stage ``s`` (0-based)."""
    return [params["s1"][f"s{s + 1}_{m}"] for m, _ in stage_members(modes)]


def stage2_heads(params: Dict, modes2: Sequence[str]):
    """Member-aligned hyper heads: r0 at rotations 0/2, r1 at 1/3."""
    return [params["s2"][f"{m}r{r % 2}"] for m, r in stage_members(modes2)]


def prepare_heads(heads, backend: str, device):
    """Member-aligned heads in the form the backend's sum takes, on
    ``device``, made once so a predictor does not redo it every frame:
    stacked for K3 / K4, float32 dicts for the ``"xla"`` chain."""
    if backend == "pallas":
        return k3.StackedHeads.create(heads, device)
    if backend == "pallas_int8":
        return k4.QuantHeads.create(heads, device)
    return [{k: torch.as_tensor(v).to(device, torch.float32)
             for k, v in h.items()} for h in heads]


def _ensemble_pred(heads, x: torch.Tensor, members, half, *, backend: str):
    """Σ_m round(member_m · half) → [..., H, W, oC]: the plain chain
    (differentiable, round_ste) or the K3 / K4 wrappers (inference)."""
    if backend == "pallas_int8":
        return k4.ensemble_sum_on_image_int8(heads, x, members, half=half)
    if backend == "pallas":
        return k3.ensemble_sum_on_image(heads, x, members, half=half)
    outs = ensemble_on_image(lambda i: heads[i], x, members)
    return torch.sum(round_ste(outs * half), dim=0)


def stage1_from_heads(stage_heads, x: torch.Tensor, *, modes, norm: int,
                      backend: str) -> torch.Tensor:
    """Feature stage(s) over per-stage member heads (see
    :func:`predict_stage1`)."""
    half = norm // 2
    members = stage_members(modes)
    stages = len(stage_heads) + 1
    for s, heads in enumerate(stage_heads):
        pred = _ensemble_pred(heads, x, members, half, backend=backend)[..., 0]
        if s + 1 == stages - 1:
            avg, bias, div = float(len(modes)), 0.0, 1.0
        else:
            avg, bias, div = float(len(modes) * 4), float(half), float(norm)
        x = divide_exact(clip(round_ste(divide_exact(pred, avg)) + bias,
                              0, norm), div)
    return x


def stage2_levels(heads, x: torch.Tensor, *, modes2, norm: int,
                  backend: str) -> torch.Tensor:
    """Hyper stage before the /norm: clip(round(pred/12 + half), 0, norm),
    float levels [..., H, W, outC] (see :func:`predict_stage2`)."""
    half = norm // 2
    pred = _ensemble_pred(heads, x, stage_members(modes2), half,
                          backend=backend)
    avg = float(len(modes2) * 4)
    return clip(round_ste(divide_exact(pred, avg) + half), 0, norm)


def predict_stage1(params: Dict, x: torch.Tensor, *,
                   modes: Sequence[str] = ("s", "c", "t"),
                   stages: int = 2, norm: int = 255,
                   backend: str = "xla") -> torch.Tensor:
    """Feature stage(s): x [..., H, W] in [0,1] → feature in [0,255].

    Parity: SRNetsSWF2.predict stage-1 branch (model.py:113-127):
    ``pred += round(rot_back(net(...)) · norm//2)`` over modes × 4 rots,
    then ``clamp(round(pred/len(modes)), 0, norm)`` for the final feature
    stage; intermediate stages average over modes·4 with a +norm//2 bias
    and divide by norm."""
    heads = [stage1_heads(params, s, modes) for s in range(stages - 1)]
    return stage1_from_heads(heads, x, modes=modes, norm=norm,
                             backend=resolve_backend(backend))


def predict_stage2(params: Dict, x: torch.Tensor, *,
                   modes2: Sequence[str] = ("s", "c", "t"),
                   norm: int = 255, backend: str = "xla") -> torch.Tensor:
    """Hyper stage: x [..., H, W] in [0,1] → hyper [..., H, W, outC] in
    [0,1] (model.py:101-112): clamp(round(pred/12 + 127), 0, 255)/255.
    The levels before the division are the int32 codes the resize kernel
    takes (:func:`predict_stage2_codes`)."""
    return divide_exact(
        stage2_levels(stage2_heads(params, modes2), x, modes2=modes2,
                      norm=norm, backend=resolve_backend(backend)), norm)


def predict_stage2_codes(params: Dict, x: torch.Tensor, *,
                         modes2: Sequence[str] = ("s", "c", "t"),
                         norm: int = 255, backend: str = "xla"):
    """:func:`predict_stage2` as int32 codes 0..norm: ``codes / norm`` in
    float32 is exactly its hyper value."""
    return stage2_levels(stage2_heads(params, modes2), x, modes2=modes2,
                         norm=norm, backend=resolve_backend(backend)) \
        .to(torch.int32)


def predict(params: Dict, x: torch.Tensor, stage: int, *,
            modes=("s", "c", "t"), modes2=("s", "c", "t"), stages: int = 2,
            norm: int = 255, backend: str = "xla"):
    """Uniform duck-type predict(x, stage) like the reference model zoo."""
    if stage == 2:
        return predict_stage2(params, x, modes2=modes2, norm=norm,
                              backend=backend)
    return predict_stage1(params, x, modes=modes, stages=stages, norm=norm,
                          backend=backend)
