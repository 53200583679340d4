"""K4 wrapper: the int8 SRUnit ensemble in one CUDA launch.

Port of ``lerf_tpu/ops/pallas/srnet_kernel_int8.py``: the same chain as K3
with int8 weights and activations, int32 dot products, the float32
requantization ``clip(round(float(acc)·c + b), 0, 127)`` (the clip at 0 is
the ReLU) and a float32 ``tanh(float(acc)·c6 + b6)`` head.

The host prep, :func:`quantize_srunit_head` and :func:`stack_qheads`, is
the JAX package's numpy code, copied as it is, so the port's int8 operands
equal lerf_tpu's for the same float32 params.  The stage input is exact
8-bit codes: the kernel reads the int32 code image and forms ``code − 128``
itself.  The products run on the int8 tensor cores: :class:`QuantHeads`
carries the weights in the kernel's fragment order (:func:`int8_frags`),
and nf is at most ``MAX_NF``.

``ensemble_sum_int8`` runs the plain twin (:func:`ensemble_sum_int8_plain`)
for a CPU tensor and launches ``csrc/srnet_ensemble_int8.cu`` for a CUDA
tensor; it never falls back from the card to the plain version.
``launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..lut_pipeline import MAX_PAD, _pad_all_sides, _sample4, member_offsets
from . import _build
from .resize import BLOCK_SMEM_MAX
from .srnet_ensemble import LAYERS, MAX_MEMBERS, MAX_NF, padded_layer

_SEGS = (1, 1, 2, 3, 4, 5)   # input segments per layer (of 64 features each;
                             # layer 1's "segment" is the 4-pixel input)

launches = 0


# ---------------------------------------------------------------------------
# host-side quantization prep (lerf_tpu/ops/pallas/srnet_kernel_int8.py:63-138)
# ---------------------------------------------------------------------------


def quantize_srunit_head(head: Dict, calib_x4: np.ndarray,
                         margin: float = 1.05) -> Dict:
    """Float SRUnit params → int8 kernel operands (host, one-time).

    ``calib_x4`` [N, 4] in [0,1] — activation-scale calibration inputs
    (the 17⁴ lattice covers the deploy input space's corners).  Returns
    ``{"wK": int8 [out,in], "cK": f32 [out,1], "bK": f32 [out,1]}`` for
    K=1..6 with every scale pre-folded: weights per-output-channel
    symmetric int8, activations per-channel scales from the calibration
    maxima folded into the next layer's weight rows and this layer's
    scale and bias, the input layer exact on ``round(x·255) − 128``.
    """
    w = {k: np.asarray(head[f"w{k}"], np.float32) for k in LAYERS}
    b = {k: np.asarray(head[f"b{k}"], np.float32) for k in LAYERS}
    nf = w["1"].shape[1]                         # segment width (64 default)

    # calibration forward (f32, same math as apply_srunit) capturing the
    # PER-CHANNEL post-ReLU maxima — channel scales fold into weight rows
    # (inputs) and the colscale/bias (outputs), so they cost the kernel
    # nothing and isolate outlier channels from the whole layer's step size
    x = np.asarray(calib_x4, np.float32)
    segs = []                                    # h1..h5 [N, nf]
    h = np.maximum(x @ w["1"] + b["1"], 0.0)
    segs.append(h)
    cat = h
    for k in LAYERS[1:5]:
        hn = np.maximum(cat @ w[k] + b[k], 0.0)
        segs.append(hn)
        cat = np.concatenate([cat, hn], axis=-1)
    s_act = [np.maximum(s.max(axis=0) * margin, 1e-6) for s in segs]  # [nf]

    out = {}

    def quant_cols(weff: np.ndarray):
        sw = np.maximum(np.abs(weff).max(axis=0) / 127.0, 1e-12)
        wq = np.round(weff / sw).astype(np.int8)          # [in, out]
        return wq, sw.astype(np.float32)

    # layer 1: exact int8 input xq = round(x·255) − 128
    w1eff = w["1"] / 255.0
    b1eff = b["1"] + (128.0 / 255.0) * w["1"].sum(axis=0)
    wq, sw = quant_cols(w1eff)
    qf = 127.0 / s_act[0]
    out["w1"] = wq.T                                       # [out, in]
    out["c1"] = (sw * qf)[:, None]
    out["b1"] = (b1eff * qf)[:, None]

    # hidden layers 2..5: rows scaled by their channel's s/127; outputs
    # requantized by 127/s_k[channel] (folded into colscale/bias)
    for li, k in enumerate(LAYERS[1:5], start=1):
        weff = w[k].copy()
        for j in range(_SEGS[li]):
            weff[nf * j:nf * (j + 1)] *= (s_act[j] / 127.0)[:, None]
        wq, sw = quant_cols(weff)
        qf = 127.0 / s_act[li]
        out[f"w{k}"] = wq.T
        out[f"c{k}"] = (sw * qf)[:, None]
        out[f"b{k}"] = (b[k] * qf)[:, None]

    # head layer 6: tanh output stays f32 (no requant)
    weff = w["6"].copy()
    for j in range(5):
        weff[nf * j:nf * (j + 1)] *= (s_act[j] / 127.0)[:, None]
    wq, sw = quant_cols(weff)
    out["w6"] = wq.T
    out["c6"] = sw[:, None]
    out["b6"] = b["6"][:, None].astype(np.float32)
    return out


def stack_qheads(qheads: Sequence[Dict]):
    """Per-member quantized dicts → the kernel's 18 stacked operands
    [w1,c1,b1, …, w6,c6,b6] with a leading member axis."""
    ops = []
    for k in LAYERS:
        ops.append(np.stack([np.asarray(q[f"w{k}"]) for q in qheads], 0))
        ops.append(np.stack([np.asarray(q[f"c{k}"]) for q in qheads], 0))
        ops.append(np.stack([np.asarray(q[f"b{k}"]) for q in qheads], 0))
    return ops


# ---------------------------------------------------------------------------
# device operands, plain twin, wrapper
# ---------------------------------------------------------------------------


class QuantHeads(NamedTuple):
    """One stage's quantized member heads on one device, aligned with its
    members: ``w[k]`` int8 ``[M, out, in]`` (the :func:`stack_qheads`
    layout), ``frags[k]`` the same weights in the B-fragment order of the
    kernel's ``mma.sync.m16n8k32`` (:func:`int8_frags`), ``c[k]`` and
    ``b[k]`` float32 ``[M, out]``."""
    w: Tuple[torch.Tensor, ...]
    frags: Tuple[torch.Tensor, ...]
    c: Tuple[torch.Tensor, ...]
    b: Tuple[torch.Tensor, ...]

    @classmethod
    def create(cls, qheads: Sequence[Dict], device=None):
        """From per-member :func:`quantize_srunit_head` dicts."""
        ops = stack_qheads(qheads)

        def up(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

        w = tuple(up(ops[3 * i], np.int8) for i in range(6))
        nf = w[0].shape[1]
        return cls(w=w,
                   frags=tuple(int8_frags(x, layer, nf)
                               for layer, x in enumerate(w)),
                   c=tuple(up(ops[3 * i + 1][..., 0], np.float32)
                           for i in range(6)),
                   b=tuple(up(ops[3 * i + 2][..., 0], np.float32)
                           for i in range(6)))

    @property
    def nf(self) -> int:
        return self.w[0].shape[1]

    @property
    def oc(self) -> int:
        return self.w[5].shape[1]


def padded_nf(nf: int) -> int:
    """K4's feature width: nf rounded up to 16 (two warps share a pixel
    group's n-tiles of 8)."""
    return -(-nf // 16) * 16


def int8_frags(w: torch.Tensor, layer: int, nf: int) -> torch.Tensor:
    """Stacked int8 ``[M, out, in]`` weights of ``layer`` → the B fragments
    K4's ``mma.sync.m16n8k32`` reads, int8 ``[M, k-steps, n-tiles, 32, 8]``:
    lane ``4g + q`` of (k-step s, n-tile t) holds inputs ``32s + 4q ..
    +3`` and ``32s + 16 + 4q .. +3`` of output ``8t + g``; zero padding as
    :func:`padded_layer`, to :func:`padded_nf` features and fan-ins of a
    multiple of 32."""
    dense = padded_layer(w.transpose(1, 2), layer, nf, padded_nf(nf), 32)
    m, kp, np_ = dense.shape
    return dense.reshape(m, kp // 32, 2, 4, 4, np_ // 8, 8) \
        .permute(0, 1, 5, 6, 3, 2, 4).reshape(m, kp // 32, np_ // 8, 32, 8) \
        .contiguous()


def sample_x4q(codes: torch.Tensor, members) -> torch.Tensor:
    """int codes ``[..., H, W]`` → the exact int8 operand ``[M, 4, N]``:
    each member's 4 edge-clamped neighbours minus 128 (``_sample_x4q``)."""
    h, w = codes.shape[-2], codes.shape[-1]
    xq = (torch.clamp(codes, 0, 255) - 128).to(torch.int8)
    xpad = _pad_all_sides(xq, MAX_PAD)
    return torch.stack([torch.stack(_sample4(xpad, h, w, mode, r))
                        .reshape(4, -1) for mode, r in members])


def _dot(w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Exact int8 × int8 → int32 product ``[out, in] × [in, N]``.  Taken in
    float64: |acc| ≤ 127·128·320 < 2⁵³, so every partial sum is exact, on
    the CPU and on the card (CUDA has no integer matmul)."""
    return (w.to(torch.float64) @ h.to(torch.float64)).to(torch.int32)


def _requant(acc, c, b):
    """int32 → int8 ``clip(round(float(acc)·c + b), 0, 127)``: a multiply
    and an add, each rounded on its own (no FMA), as the kernel does."""
    v = acc.to(torch.float32) * c[:, None]
    v = v + b[:, None]
    return torch.clamp(torch.round(v), 0, 127).to(torch.int8)


def ensemble_sum_int8_plain(codes: torch.Tensor, heads: QuantHeads, members,
                            *, half: float) -> torch.Tensor:
    """The twin K4 is held to: int codes ``[..., H, W]`` → float32
    ``[..., H, W, oC]``, with the arithmetic of ``lerf_tpu``'s
    ``_ensemble_sum_flat_int8_ref``, one member at a time."""
    x4 = sample_x4q(codes, members)
    acc = torch.zeros(heads.oc, x4.shape[-1], dtype=torch.float32,
                      device=codes.device)
    for m in range(len(members)):
        h = _requant(_dot(heads.w[0][m], x4[m]), heads.c[0][m], heads.b[0][m])
        for k in range(1, 5):
            hn = _requant(_dot(heads.w[k][m], h), heads.c[k][m],
                          heads.b[k][m])
            h = torch.cat([h, hn], 0)
        o = _dot(heads.w[5][m], h).to(torch.float32) * heads.c[5][m][:, None]
        o = torch.tanh(o + heads.b[5][m][:, None])
        acc += torch.round(o * half)
    return acc.T.reshape(codes.shape + (heads.oc,))


def smem_bytes(nf: int) -> int:
    """Dynamic shared memory of one K4 block at ``nf``, as the kernel lays
    it out: 4 weight buffers of 16 KB, the int8 activation tile of 128
    pixels (rows of ``act_words`` words) and the samples."""
    words = -(-5 * padded_nf(nf) // 32) * 8
    words += (4 - words) % 8
    return (4 * 4096 + 128 * words + 128) * 4


def _check_heads(heads: QuantHeads, n_members: int, device):
    nf, oc = heads.nf, heads.oc
    if not 0 < nf <= MAX_NF or oc not in (1, 3):
        raise ValueError(f"srnet_ensemble_int8: nf {nf} must be "
                         f"1..{MAX_NF} (K4 is built for nf up to {MAX_NF}, "
                         f"as K3, whose tile at nf {MAX_NF} fills the "
                         f"{BLOCK_SMEM_MAX} bytes of shared memory a block "
                         f"may use) and oC {oc} 1 or 3")
    if smem_bytes(nf) > BLOCK_SMEM_MAX:
        raise ValueError(f"srnet_ensemble_int8: nf {nf} needs "
                         f"{smem_bytes(nf)} bytes of shared memory a block, "
                         f"over the {BLOCK_SMEM_MAX} allowed")
    nt = padded_nf(nf) // 8
    ksteps = [1] + [-(-k * nt // 4) for k in range(1, 6)]
    outs = [nf] * 5 + [oc]
    for k in range(6):
        shapes = ((heads.frags[k],
                   (n_members, ksteps[k], nt if k < 5 else 1, 32, 8),
                   torch.int8),
                  (heads.c[k], (n_members, outs[k]), torch.float32),
                  (heads.b[k], (n_members, outs[k]), torch.float32))
        for t, shape, dtype in shapes:
            if (t.shape != shape or t.dtype != dtype or t.device != device
                    or not t.is_contiguous()):
                raise ValueError(
                    "srnet_ensemble_int8: heads must be QuantHeads for "
                    f"M={n_members}, nf={nf}, oC={oc} on the codes' device")


def ensemble_sum_int8(codes: torch.Tensor, heads: QuantHeads, members, *,
                      half: float) -> torch.Tensor:
    """int32 codes ``[..., H, W]`` (0..255; the kernel clamps) → float32
    ``[..., H, W, oC]``: Σ_m round(chain_m · half) with the quantized
    chain, over ``members`` [(mode, rot)] aligned with ``heads``."""
    if codes.device.type == "cpu":
        return ensemble_sum_int8_plain(codes, heads, members, half=half)
    global launches
    if codes.device.type != "cuda":
        raise ValueError(
            f"srnet_ensemble_int8: unsupported device {codes.device}")
    if codes.dtype != torch.int32 or codes.dim() < 2:
        raise ValueError("srnet_ensemble_int8: codes must be int32 [..., H, W]")
    if not 0 < len(members) <= MAX_MEMBERS:
        raise ValueError(f"srnet_ensemble_int8: {len(members)} members, "
                         f"want 1..{MAX_MEMBERS}")
    _check_heads(heads, len(members), codes.device)
    x = codes.contiguous()
    h, w = x.shape[-2], x.shape[-1]
    c = x.numel() // max(h * w, 1)
    out = torch.empty(x.shape + (heads.oc,), dtype=torch.float32,
                      device=x.device)
    offsets = member_offsets(members)
    lib = _build.library()
    with torch.cuda.device(x.device):       # launch on the tensors' card
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lerf_srnet_ensemble_int8(
            x.data_ptr(), out.data_ptr(),
            *(t.data_ptr() for t in heads.frags),
            *(t.data_ptr() for t in heads.c), *(t.data_ptr() for t in heads.b),
            offsets.ctypes.data, len(members), c, h, w, heads.nf, heads.oc,
            float(half), stream)
    _build.check(err, "srnet_ensemble_int8 launch")
    launches += 1
    return out


def ensemble_sum_on_image_int8(qheads, img: torch.Tensor, members, *,
                               half: float) -> torch.Tensor:
    """``lerf_tpu``'s ``ensemble_sum_on_image_int8`` signature: ``img``
    float ``[..., H, W]`` holding exact codes k/255, ``qheads`` the
    member-aligned :func:`quantize_srunit_head` dicts (or already a
    :class:`QuantHeads` on the image's device)."""
    if not isinstance(qheads, QuantHeads):
        qheads = QuantHeads.create(qheads, img.device)
    codes = torch.clamp(torch.round(img * 255.0), 0, 255).to(torch.int32)
    return ensemble_sum_int8(codes, qheads, members, half=half)
