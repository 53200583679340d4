"""Carry a LUT bank, micro-net or IMDN weights across from ``lerf_tpu`` to
the port.

Both packages hold a bank as host numpy int8 tables with the same keys,
and micro-net params as the same nested dict of ``w [in, out]`` / ``b
[out]`` float32 (or bfloat16) leaves; lerf_tpu's IMDN2 is a flax variables
tree (HWIO kernels), the port's an ``nn.Module`` state dict (OIHW).
These build the port's objects from plain numpy arrays without importing
either package's classes into the other.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .lut.io import LUTBank
from .ops.kernels.srnet_ensemble import as_tensor


def bank_from_arrays(stage1: Dict[str, np.ndarray],
                     stage2: Dict[str, np.ndarray],
                     inter: Optional[List[Dict[str, np.ndarray]]] = None,
                     out_c: int = 3, interval: int = 4) -> LUTBank:
    """Port bank from plain arrays, e.g. ``bank_from_arrays(b.stage1,
    b.stage2, b.inter, b.out_c, b.interval)`` for a ``lerf_tpu`` bank ``b``.

    Tables are copied as int8 ``[L⁴, oC]``; a value outside int8 raises.
    """
    def table(arr, oc):
        a = np.asarray(arr)
        if a.min() < -128 or a.max() > 127:
            raise ValueError("LUT values must fit int8")
        return a.reshape(-1, oc).astype(np.int8)

    return LUTBank(
        stage1={k: table(v, 1) for k, v in stage1.items()},
        stage2={k: table(v, out_c) for k, v in stage2.items()},
        out_c=out_c, interval=interval,
        inter=[{k: table(v, 1) for k, v in t.items()}
               for t in (inter or [])])


def lerf_nets_from_arrays(params: Dict, device="cpu") -> Dict:
    """Port micro-net params from the JAX pytree as numpy arrays, e.g.
    ``lerf_nets_from_arrays(jax.tree.map(np.asarray, p))``.

    Returns ``{"s1": {...}, "s2": {...}}`` of tensors on ``device``:
    bfloat16 leaves stay bfloat16 (K3 then computes in bf16, as lerf_tpu's
    kernel does for bf16 heads), any other float type becomes float32.
    Raises unless every head has ``w1..w6`` / ``b1..b6`` of
    one SRUnit's shapes: ``w1 [4, nf]``, ``wk [(k-1)·nf, nf]``, ``w6
    [5·nf, oC]``, ``bk [nf]``, ``b6 [oC]``."""
    if set(params) != {"s1", "s2"}:
        raise ValueError(f"params need keys s1, s2; got {sorted(params)}")
    out = {}
    for sk, heads in params.items():
        out[sk] = {}
        for name, head in heads.items():
            if set(head) != {f"{p}{k}" for p in "wb" for k in range(1, 7)}:
                raise ValueError(f"{sk}/{name}: keys {sorted(head)}, want "
                                 "w1..w6 and b1..b6")
            nf, oc = np.shape(head["w1"])[1], np.shape(head["w6"])[-1]
            want = {"w1": (4, nf), "w6": (5 * nf, oc), "b6": (oc,)}
            for k in range(1, 6):
                want.setdefault(f"w{k}", ((k - 1) * nf, nf))
                want[f"b{k}"] = (nf,)
            for k, shape in want.items():
                if np.shape(head[k]) != shape:
                    raise ValueError(f"{sk}/{name}/{k}: shape "
                                     f"{np.shape(head[k])}, want {shape}")
            out[sk][name] = {k: head_tensor(v).to(device)
                             for k, v in head.items()}
    return out


def head_tensor(v) -> torch.Tensor:
    """One micro-net leaf as a CPU tensor in its own compute type: a
    bfloat16 array (what ``np.asarray`` gives for a JAX bf16 array) stays
    bfloat16, taken bit for bit through a ``uint16`` view; anything else
    becomes float32."""
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        return as_tensor(a)
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def imdn_tower_state(prefix: str, tower: Dict) -> Dict[str, torch.Tensor]:
    """One IMDN_RTC tower in lerf_tpu's flax layout (``fea``,
    ``imd{i}.c1..c5``, ``lr``, ``up``, each {kernel [kh, kw, in, out],
    bias}) → the port's state-dict entries under ``prefix``."""
    n = sum(1 for k in tower if k.startswith("imd"))
    names = {"fea": "model.0", "lr": f"model.1.sub.{n}", "up": "model.2"}
    convs = [(names[k], tower[k]) for k in ("fea", "lr", "up")]
    convs += [(f"model.1.sub.{i}.{c}", tower[f"imd{i}"][c])
              for i in range(n) for c in ("c1", "c2", "c3", "c4", "c5")]
    out = {}
    for name, p in convs:
        w = np.asarray(p["kernel"], np.float32).transpose(3, 2, 0, 1)
        out[f"{prefix}.{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(w))
        out[f"{prefix}.{name}.bias"] = torch.from_numpy(
            np.asarray(p["bias"], np.float32).copy())
    return out


def imdn_from_arrays(variables: Dict) -> Dict[str, torch.Tensor]:
    """lerf_tpu's IMDN2 variables ``{"params": {"stage1", "stage2"}}`` as
    numpy arrays (e.g. ``jax.tree.map(np.asarray, variables)``) → the
    port's ``IMDN2`` state dict (float32 CPU tensors, kernels OIHW)."""
    params = variables["params"]
    return {**imdn_tower_state("stage1", params["stage1"]),
            **imdn_tower_state("stage2", params["stage2"])}


def train_state_from_arrays(params, mu, nu, count: int, hp, *, model=None,
                            device="cpu"):
    """lerf_tpu's training state as numpy (``params``; optax Adam's
    first and second moments ``mu`` / ``nu`` in the params' layout and
    its ``count``) → the port's
    :class:`~lerf_torch.train.train_step.TrainState` on ``device``, with
    ``torch.optim.Adam``'s state and the scheduler at step ``count``, so
    that a step taken after k steps can be compared.  Micro-net or LUT
    fine-tuning params are nested dicts of arrays; with ``model`` (the
    port's ``IMDN2``) they are lerf_tpu's flax IMDN2 ``params`` tree,
    carried by :func:`imdn_from_arrays` (the moments too) into ``model``,
    moved to ``device``."""
    from .train.train_step import TrainState, cosine_lr, param_leaves

    def tensors(tree):
        if model is not None:
            return imdn_from_arrays({"params": tree})
        return {k: tensors(v) if isinstance(v, dict) else
                torch.from_numpy(np.asarray(v, np.float32).copy()).to(device)
                for k, v in tree.items()}

    if model is not None:
        model.load_state_dict(tensors(params))
        target = model.to(device)
    else:
        target = tensors(params)
    state = TrainState.create(target, hp)
    leaves = param_leaves(target)
    mus, nus = param_leaves(tensors(mu)), param_leaves(tensors(nu))
    for name, p in leaves.items():
        state.optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": mus[name].to(device).clone(),
            "exp_avg_sq": nus[name].to(device).clone()}
    # a scheduler that has stepped ``count`` times: lr0 · cosine_lr(count)
    state.scheduler = torch.optim.lr_scheduler.LambdaLR(
        state.optimizer, cosine_lr(hp), last_epoch=count - 1)
    state.step = count
    return state
