"""The IMDN (LeRF-Net) towers' two backends and the form's stage functions.

The port of ``lerf_tpu/models/imdn_s2d.py``.  "base" runs the towers as
they are: one ``F.conv2d`` a conv at nf channels (the block-1 case of the
same functional forward, whose re-embedding is the identity, as lerf_tpu
runs its masked base towers).  "s2d" re-blocks them
exactly by space-to-depth: each b×b pixel block becomes b² channel phases
and every conv kernel is re-embedded on the host into the equivalent conv
over C·b² channels (:func:`embed_kernel`; channel ``c·b² + (u·b + v)``,
original-channel major, so the modules' channel splits stay contiguous
slices).  Every output is the same sum of the same products; only the
order of the sums differs.  The re-embedding multiplies the
multiply-adds by about b² (zeros in the inflated kernels), so it pays only
where a narrow channel axis wastes the hardware more than that.

Sizes that are not a multiple of b are zero-padded up to one, and the pad
region is zeroed again after every conv (the phase mask), so that no conv
reads anything but the zeros SAME padding would give.

Not ported: lerf_tpu's bucket masking (``valid_hw``, the port has no
shape buckets) and its 3-tuple row mask: the port's row-sharded towers
(:func:`lerf_torch.parallel.spatial.imdn_stages_sharded`) run on bands
that end at the image edges, where the convs' own zero padding is the
whole image's, so they need only the halo, :func:`tower_halo_rows`.

On the card the float32 base towers run on their own kernel
(:func:`apply_tower_kernel`, ``csrc/imdn_conv.cu``: float32 FFMA, the
elementwise steps in its epilogues, about 22 launches a tower).  The
s2d and bf16 towers run on cuDNN, in full float32 under a scoped
``torch.backends.cudnn.flags(..., allow_tf32=False)`` (:func:`cudnn_fp32`),
restored on exit: cuDNN's default on Hopper is TF32.

``dtype`` bf16 is lerf_tpu's bf16 compute type (its ``_conv``,
``imdn_s2d.py:148-164``): each conv casts its input and the kernel and
bias to bf16 (the towers' weights are cast once, when they are built),
convolves with no bias and adds the bias after, in bf16; the phase mask
is bf16, and every elementwise step runs in bf16.  On the card the bf16
convs are cuDNN's on bf16 operands, in the same deterministic scope.
lerf_tpu's towers are XLA convolutions, not Pallas kernels, so a library
convolution is their counterpart, as for float32.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .imdn import IMDN2, IMDN_RTC, lrelu

# "auto" on the card: the backend the H100 measured faster at 360×640
# (chip_smoke's IMDN phase times both; PERF.md)
AUTO_BACKEND = "base"


def resolve_backend(backend: str) -> str:
    """"base" | "s2d", or "auto": :data:`AUTO_BACKEND`, the faster on the
    H100 (the CPU runs either the same way)."""
    if backend == "auto":
        return AUTO_BACKEND
    if backend not in ("base", "s2d"):
        raise ValueError(f"unknown IMDN backend {backend!r}")
    return backend


def cudnn_fp32():
    """The scope every IMDN conv runs in: cuDNN on, deterministic, no
    autotuning, no TF32 (full float32), the flags restored on exit."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


# -- host-side weight re-embedding (numpy; lerf_tpu's flax layout) ----------

def embed_kernel(w: np.ndarray, b: int) -> np.ndarray:
    """Embed an odd-sized [kh, kw, cin, cout] SAME / stride-1 conv kernel
    (HWIO) into the equivalent s2d-space kernel [KH, KW, cin·b², cout·b²]
    (see the module doc)."""
    kh, kw, cin, cout = w.shape
    if kh % 2 != 1 or kw % 2 != 1:
        raise ValueError("embed_kernel needs odd kernel sizes")
    rh, rw = kh // 2, kw // 2
    Rh, Rw = (b - 1 + rh) // b, (b - 1 + rw) // b
    w2 = np.zeros((2 * Rh + 1, 2 * Rw + 1, cin * b * b, cout * b * b),
                  dtype=w.dtype)
    bb = b * b
    for p in range(b):
        for q in range(b):
            for di in range(-rh, rh + 1):
                for dj in range(-rw, rw + 1):
                    t, s = p + di, q + dj
                    Di, u = t // b, t % b       # floor division: t < 0 too
                    Dj, v = s // b, s % b
                    w2[Di + Rh, Dj + Rw, u * b + v::bb,
                       p * b + q::bb] = w[di + rh, dj + rw]
    return w2


def embed_bias(bias: np.ndarray, b: int) -> np.ndarray:
    """[cout] → [cout·b²], each channel repeated over its b² phases."""
    return np.repeat(np.asarray(bias), b * b)


def convert_tower(tower_params: Dict, b: int) -> Dict:
    """Re-embed an IMDN_RTC tower's params in lerf_tpu's flax layout
    (``fea``, ``imd{i}.c1..c5``, ``lr``, ``up``, each {kernel HWIO, bias})
    for s2d-b execution: the same layout, numpy."""
    def emb(p):
        return {"kernel": embed_kernel(np.asarray(p["kernel"]), b),
                "bias": embed_bias(np.asarray(p["bias"]), b)}

    return {name: ({k: emb(v) for k, v in p.items()}
                   if name.startswith("imd") else emb(p))
            for name, p in tower_params.items()}


def convert_imdn2(variables: Dict, b: int) -> Dict:
    """Re-embed both towers of a flax-layout IMDN2 variables tree."""
    params = variables["params"]
    return {"params": {s: convert_tower(params[s], b)
                       for s in ("stage1", "stage2")}}


def tower_arrays(tower: IMDN_RTC) -> Dict:
    """A port tower's weights in lerf_tpu's flax layout (numpy, HWIO), the
    input of :func:`convert_tower`."""
    def conv(m):
        return {"kernel": m.weight.detach().cpu().numpy()
                .transpose(2, 3, 1, 0),
                "bias": m.bias.detach().cpu().numpy()}

    fea, shortcut, up = tower.model
    n = tower.num_modules
    out = {"fea": conv(fea), "lr": conv(shortcut.sub[n]), "up": conv(up)}
    for i in range(n):
        out[f"imd{i}"] = {c: conv(getattr(shortcut.sub[i], c))
                          for c in ("c1", "c2", "c3", "c4", "c5")}
    return out


def _torch_tower(p: Dict, device, dtype=torch.float32) -> Dict:
    """Flax-layout numpy params → {name: (weight OIHW, bias)} tensors,
    float32 values cast to ``dtype``."""
    def conv(q):
        return (torch.from_numpy(np.ascontiguousarray(
                    np.asarray(q["kernel"], np.float32).transpose(3, 2, 0, 1)))
                .to(device).to(dtype),
                torch.from_numpy(np.asarray(q["bias"], np.float32))
                .to(device).to(dtype))

    return {name: ({k: conv(v) for k, v in q.items()}
                   if name.startswith("imd") else conv(q))
            for name, q in p.items()}


# -- s2d data movement (NCHW) ---------------------------------------------

def space_to_depth(x: torch.Tensor, b: int) -> torch.Tensor:
    """[B, C, H, W] → [B, C·b², H/b, W/b], channel ``c·b² + (u·b + v)``."""
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // b, b, W // b, b).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(B, C * b * b, H // b, W // b)


def depth_to_space(x: torch.Tensor, b: int) -> torch.Tensor:
    """The inverse of :func:`space_to_depth`."""
    B, Cbb, H2, W2 = x.shape
    C = Cbb // (b * b)
    x = x.reshape(B, C, b, b, H2, W2).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, C, H2 * b, W2 * b)


# -- the s2d-space forward ----------------------------------------------------

def _conv(x, p, mask, dtype, b):
    """SAME conv + bias in ``dtype``; ``mask`` (if any) the [b², H2, W2]
    phase-validity mask, applied after the conv so the zero-padded rows
    and columns of a size that is not a multiple of b stay zero.  float32
    adds the bias in the convolution; another type after it, in that
    type, as lerf_tpu's ``y + bias.astype(dtype)``."""
    w, bias = p
    if dtype == torch.float32:
        y = F.conv2d(x, w, bias, padding=w.shape[-1] // 2)
    else:
        y = F.conv2d(x.to(dtype), w.to(dtype), None,
                     padding=w.shape[-1] // 2) + bias.to(dtype)[:, None, None]
    if mask is not None:
        B, Cbb, H2, W2 = y.shape
        bb = b * b
        y = (y.reshape(B, Cbb // bb, bb, H2, W2) * mask).reshape(y.shape)
    return y


def _imd_module(x, p, dc2, mask, dtype, b):
    """IMDModuleSpeed (model.py:480-503) in s2d space; dc2 = dc·b²."""
    c1 = lrelu(_conv(x, p["c1"], mask, dtype, b))
    c2 = lrelu(_conv(c1[:, dc2:], p["c2"], mask, dtype, b))
    c3 = lrelu(_conv(c2[:, dc2:], p["c3"], mask, dtype, b))
    c4 = _conv(c3[:, dc2:], p["c4"], mask, dtype, b)
    out = torch.cat([c1[:, :dc2], c2[:, :dc2], c3[:, :dc2], c4], dim=1)
    return _conv(out, p["c5"], mask, dtype, b) + x


def apply_tower_s2d(p2: Dict, x: torch.Tensor, *, block: int, nf: int = 12,
                    num_modules: int = 5, distillation_rate: float = 0.25,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """IMDN_RTC forward (upscale 1) on s2d-``block`` params ``p2``
    (:func:`_torch_tower` of :func:`convert_tower`) in ``dtype``: ``x``
    NCHW, any H, W (zero pad and a per-conv phase mask where not a
    multiple of the block) → [B, out_nc, H, W] of ``dtype``."""
    b = block
    B, C, H, W = x.shape
    Hp, Wp = -(-H // b) * b, -(-W // b) * b
    mask = None
    if (Hp, Wp) != (H, W):
        x = F.pad(x, (0, Wp - W, 0, Hp - H))
        m = torch.zeros((1, 1, Hp, Wp), dtype=dtype, device=x.device)
        m[..., :H, :W] = 1.0
        mask = space_to_depth(m, b)[0]              # [b², H2, W2]
    x2 = space_to_depth(x, b)
    dc2 = int(nf * distillation_rate) * b * b
    h = _conv(x2, p2["fea"], mask, dtype, b)
    r = h
    for i in range(num_modules):
        r = _imd_module(r, p2[f"imd{i}"], dc2, mask, dtype, b)
    h = h + _conv(r, p2["lr"], mask, dtype, b)
    up = _conv(h, p2["up"], None, dtype, b)   # cropped below: no mask needed
    return depth_to_space(up, b)[:, :, :H, :W]


def predict_imdn2_s2d(p2: Dict, x: torch.Tensor, stage: int, *, block: int,
                      nf: int = 12, norm: int = 255,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """IMDN2.predict (model.py:526-537) on s2d-converted params ``p2``
    (:func:`convert_imdn2`, lerf_tpu's flax layout) in ``dtype``: ``x``
    NHWC in [0, 1] on any device → stage 1's feature in [0, 2·(norm//2)]
    or stage 2's hyper maps in [0, 1], NHWC, under :func:`cudnn_fp32`
    (``lerf_tpu.models.imdn_s2d.predict_imdn2_s2d``)."""
    tower = _torch_tower(p2["params"][f"stage{stage}"], x.device, dtype)
    with torch.no_grad(), cudnn_fp32():
        y = apply_tower_s2d(tower, x.permute(0, 3, 1, 2), block=block,
                            nf=nf, dtype=dtype).permute(0, 2, 3, 1)
    half = norm // 2
    if stage == 2:
        return torch.clamp(y, -1, 1) / 2 + 0.5
    return torch.clamp(y, -1, 1) * half + half


#: Chained spatial (3x3) convs per IMDN_RTC tower (upscale=1): ``fea`` +
#: 5 modules x (c1..c4) + ``up`` (c5 and lr are 1x1) — the tower's
#: receptive-field radius in rows / cols, and so the depth to which
#: band-edge garbage spreads when a tower runs on a row slab
#: (``lerf_tpu/models/imdn_s2d.py:266``).
TOWER_SPATIAL_CONVS = 22


def tower_halo_rows() -> int:
    """Image rows of band-edge halo ONE tower run needs for its interior
    output rows to be exact — for either backend and any s2d block: the
    s2d re-embedding keeps the image-space 3×3 receptive field (the
    inflated kernel's extra taps are zero), so a corrupted input row
    spreads ±22 image rows (``lerf_tpu/models/imdn_s2d.py:269-276``)."""
    return TOWER_SPATIAL_CONVS


def kernel_tower(tower: Dict, num_modules: int) -> Dict:
    """A float32 base tower (:func:`_torch_tower` at block 1) as the
    kernel path's weights (:mod:`lerf_torch.ops.kernels.imdn_conv`):
    ``fea``, ``lr``, ``up`` and each module's ``c1``..``c5`` as
    ``ConvWeights``, and each module's ``tail``, its end fused (c4 + c5,
    on the last module also lr) where the fused end takes the widths (nf
    at most 12), else ``None`` (c4, c5 and lr run as convs of their
    own)."""
    from ..ops.kernels import imdn_conv as kc

    def cw(p):
        return kc.ConvWeights.create(*p)

    out = {name: cw(tower[name]) for name in ("fea", "lr", "up")}
    mods = [{c: cw(tower[f"imd{i}"][c]) for c in ("c1", "c2", "c3", "c4",
                                                  "c5")}
            for i in range(num_modules)]
    fused = bool(mods) and all(kc.TailWeights.fits(m["c4"], m["c5"],
                                                   out["lr"]) for m in mods)
    for i, m in enumerate(mods):
        lr = out["lr"] if i == num_modules - 1 else None
        m["tail"] = (kc.TailWeights.create(m["c4"], m["c5"], lr) if fused
                     else None)
        out[f"imd{i}"] = m
    return out


def apply_tower_kernel(kt: Dict, x: torch.Tensor, *, stage: int, nf: int,
                       num_modules: int, half: int = 127, oc: int = 1,
                       distillation_rate: float = 0.25) -> torch.Tensor:
    """IMDN_RTC forward (upscale 1) and the stage's clamp and scale on
    :func:`kernel_tower` weights, one :mod:`~lerf_torch.ops.kernels.
    imdn_conv` call a step: ``fea``; a module's c1, c2, c3 (leaky ReLU,
    the distilled channels stored straight into the module's concat
    buffer) and its end (c4 + c5 + the module's input, fused; the last
    module's also lr + ``fea``'s output); the up conv with the clamp and
    scale (stage 1: ``· half + half``, [N, cout, H, W]; stage 2: ``/ 2 +
    0.5``, [N, cout / oc, H, W, oc]).  ``x``: float32 [N, C, H, W],
    contiguous.  The same steps as :func:`apply_tower_s2d` at block 1 and
    :func:`make_chw_stage_fns`' clamps (on CPU tensors each call is its
    plain twin, bit-equal to them)."""
    from ..ops.kernels import imdn_conv as kc

    n, _, h, w = x.shape
    dc = int(nf * distillation_rate)
    rc = nf - dc

    def new(c):
        return x.new_empty((n, c, h, w))

    fea = new(nf)
    kc.conv(x, kt["fea"], fea)
    ta, tb = new(rc), new(rc)
    fused = num_modules > 0 and kt["imd0"]["tail"] is not None
    dist = new(3 * dc if fused else 4 * dc)
    r = fea
    for i in range(num_modules):
        m = kt[f"imd{i}"]
        kc.conv(r, m["c1"], ta, act=True, dist=dist[:, :dc])
        kc.conv(ta, m["c2"], tb, act=True, dist=dist[:, dc:2 * dc])
        kc.conv(tb, m["c3"], ta, act=True, dist=dist[:, 2 * dc:3 * dc])
        out = new(nf) if r is fea else r        # a pixel's own in place
        if fused:
            kc.tail(ta, m["tail"], dist, r, out,
                    h=fea if i == num_modules - 1 else None)
        else:
            kc.conv(ta, m["c4"], None, dist=dist[:, 3 * dc:])
            kc.conv(dist, m["c5"], out, residual=r)
        r = out
    if not fused:
        # not in place: above 12 outputs another block may still read r
        out = new(nf)
        kc.conv(r, kt["lr"], out, residual=fea)
        r = out
    cout = kt["up"].cout
    y = (x.new_empty((n, cout, h, w)) if stage == 1
         else x.new_empty((n, cout // oc, h, w, oc)))
    kc.tower_end(r, kt["up"], y, stage=stage, half=half, oc=oc)
    return y


def make_chw_stage_fns(model: IMDN2, *, backend: str = "auto",
                       block: int = 2, norm: int = 255, out_c: int = 3,
                       device=None, dtype=None):
    """The channel-first IMDN2 stage functions of
    ``NetPredictor.from_imdn``: ``(s1, s2)`` with

    - ``s1(x)``: ``x`` [..., C, H, W] in [0, 1] → feature [..., C, H, W]
      in [0, 2·(norm//2)] (reference eval_model.py:124-129);
    - ``s2(x)``: → hyper [..., C, H, W, out_c] in [0, 1]: the tower's
      ``[ρ·C, σx·C, σy·C]`` channels (eval_model.py:149, channel ``o·C +
      c``) moved to the trailing axis.

    ``model``'s weights are read once here (on ``device``), re-embedded
    for ``block`` by "s2d" (block 1, the identity, for "base") and cast to
    the compute type ``dtype`` (``None``: the model's, ``model.dtype``),
    which the outputs keep.

    Float32 base towers whose weights lie on a card run on the towers'
    own kernel (:func:`apply_tower_kernel`: one launch a conv, the
    elementwise steps, concats, clamps and stage 2's order in its
    epilogues, a batch in one launch: its sums run in an order that does
    not depend on the batch).  Every other tower (the CPU, s2d, bf16) runs
    :func:`apply_tower_s2d` under :func:`cudnn_fp32`, a batch frame by
    frame."""
    b = block if resolve_backend(backend) == "s2d" else 1
    dtype = model.dtype if dtype is None else dtype
    half = norm // 2
    n_mod = model.stage1.num_modules
    towers = {s: _torch_tower(convert_tower(tower_arrays(getattr(model, s)),
                                            b), device, dtype)
              for s in ("stage1", "stage2")}
    on_card = (b == 1 and dtype == torch.float32
               and towers["stage1"]["fea"][0].device.type == "cuda")
    kernel = ({s: kernel_tower(t, n_mod) for s, t in towers.items()}
              if on_card else None)

    def tower(stage, x):
        return apply_tower_s2d(towers[stage], x, block=b, nf=model.nf,
                               num_modules=n_mod, dtype=dtype)

    def run(stage, x):
        # frame by frame: cuDNN may pick another algorithm (another order
        # of sums) for another batch size, and a batch must give each
        # frame's own result
        frames = x.reshape((-1,) + x.shape[-3:])
        with torch.no_grad(), cudnn_fp32():
            ys = [tower(stage, frames[i:i + 1])
                  for i in range(frames.shape[0])]
        y = ys[0] if len(ys) == 1 else torch.cat(ys)
        return y.reshape(x.shape[:-3] + y.shape[-3:])

    def run_kernel(stage, x, oc):
        frames = x.reshape((-1,) + x.shape[-3:]).contiguous()
        with torch.no_grad():
            y = apply_tower_kernel(kernel[stage], frames,
                                   stage=int(stage[-1]), nf=model.nf,
                                   num_modules=n_mod, half=half, oc=oc)
        return y.reshape(x.shape[:-3] + y.shape[1:])

    def s1(x):
        if kernel is not None:
            return run_kernel("stage1", x, 1)
        return torch.clamp(run("stage1", x), -1, 1) * half + half

    def s2(x):
        if kernel is not None:
            return run_kernel("stage2", x, out_c)
        y = torch.clamp(run("stage2", x), -1, 1) / 2 + 0.5   # [..., oC·C, H, W]
        c = x.shape[-3]
        y = y.reshape(y.shape[:-3] + (out_c, c) + y.shape[-2:])
        return torch.movedim(y, -4, -1)                      # [..., C, H, W, oC]

    return s1, s2
