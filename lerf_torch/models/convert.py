"""Reference-checkpoint conversion: torch state_dicts → the port's params.

The port of ``lerf_tpu/models/convert.py:16-115``.  The reference
ships whole pickled ``SRNetsSWF2`` modules (``models/lerf-{l,g}/
Model_050000.pth``, saved with ``torch.save(module)`` — train_model.py:
56-65); only their state_dict tensors are read.  Unpickling a whole module
imports the reference's own modules (``model``, ``common.network``), so put
the reference's ``resample/`` directory on ``PYTHONPATH`` for those files;
a plain state dict needs nothing.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _to_f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().cpu().to(torch.float32)


def srunit_from_torch(prefix: str, sd: Dict) -> Dict:
    """One SRUnit's conv weights → the dense pixel-MLP layout.

    conv1 kernels ``[nf,1,2,2]`` flatten row-major to ``[4, nf]`` in
    (a,b,c,d) order for every mode geometry; 1×1 convs ``[out,in,1,1]``
    become ``[in, out]`` dense matrices."""
    def conv(name):
        return (_to_f32(sd[f"{prefix}.{name}.conv.weight"]),
                _to_f32(sd[f"{prefix}.{name}.conv.bias"]))

    w1, b1 = conv("conv1")
    nf = w1.shape[0]
    p = {"w1": w1.reshape(nf, -1).T.contiguous(), "b1": b1}
    for i, name in [(2, "conv2.conv1"), (3, "conv3.conv1"),
                    (4, "conv4.conv1"), (5, "conv5.conv1")]:
        w, b = conv(name)
        p[f"w{i}"] = w.reshape(w.shape[0], -1).T.contiguous()
        p[f"b{i}"] = b
    w6, b6 = conv("conv6")
    p["w6"] = w6.reshape(w6.shape[0], -1).T.contiguous()
    p["b6"] = b6
    return p


def lerf_nets_from_torch_state_dict(sd: Dict, *, modes=("s", "c", "t"),
                                    modes2=("s", "c", "t"),
                                    stages: int = 2) -> Dict:
    """SRNetsSWF2 state_dict → ``{"s1": {...}, "s2": {...}}`` params.

    Reference module names: ``s{stage}_{mode}r{r}.model.convN.conv.weight``
    (model.py:79-92 registers SRNet(mode) whose ``.model`` is the SRUnit)."""
    s1 = {f"s{s + 1}_{m}": srunit_from_torch(f"s{s + 1}_{m}r0.model", sd)
          for s in range(max(stages - 1, 1)) for m in modes}
    s2 = {f"{m}r{r}": srunit_from_torch(f"s{stages}_{m}r{r}.model", sd)
          for m in modes2 for r in (0, 1)}
    return {"s1": s1, "s2": s2}


def _load_torch_pickle(path: str):
    """Unpickle a reference checkpoint on the CPU: a whole module (its
    state_dict is taken) or a state dict.  Unpickling runs code from the
    file, so load only checkpoints you trust."""
    module = torch.load(path, map_location="cpu", weights_only=False)
    return module.state_dict() if hasattr(module, "state_dict") else module


def imdn_rtc_from_torch(prefix: str, sd: Dict, num_modules: int = 5) -> Dict:
    """One IMDN_RTC tower of a reference state dict (model.py:507-523) →
    lerf_tpu's flax layout, the inverse of
    :func:`lerf_torch.convert.imdn_tower_state`: ``{prefix}.model.0`` →
    ``fea``, ``.model.1.sub.{i}.c1..c5`` → ``imd{i}``, ``.model.1.sub.{n}``
    → ``lr``, ``.model.2`` → ``up``, each ``{"kernel": [kh, kw, in, out],
    "bias"}`` as float32 numpy arrays (lerf_tpu's
    ``imdn_rtc_from_torch``)."""
    def conv(name):
        w = _to_f32(sd[f"{prefix}.{name}.weight"]).numpy()
        return {"kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
                "bias": _to_f32(sd[f"{prefix}.{name}.bias"]).numpy()}

    out = {"fea": conv("model.0"), "lr": conv(f"model.1.sub.{num_modules}"),
           "up": conv("model.2")}
    for i in range(num_modules):
        out[f"imd{i}"] = {c: conv(f"model.1.sub.{i}.{c}")
                          for c in ("c1", "c2", "c3", "c4", "c5")}
    return out


def imdn_from_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference IMDN2 checkpoint (a pickled module or a plain state
    dict) → the port's ``IMDN2`` state dict: the port keeps the
    reference's parameter names (``stage{1,2}.model.0``,
    ``.model.1.sub.{i}.c1..c5``, ``.model.1.sub.{n}``, ``.model.2``), so
    only the two towers' tensors are taken, as float32."""
    return {k: _to_f32(v) for k, v in _load_torch_pickle(path).items()
            if k.split(".")[0] in ("stage1", "stage2")}


def load_reference_checkpoint(path: str, **kw) -> Dict:
    """Load a pickled reference checkpoint and convert it."""
    return lerf_nets_from_torch_state_dict(_load_torch_pickle(path), **kw)
