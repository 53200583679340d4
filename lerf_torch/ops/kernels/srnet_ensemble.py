"""K3 wrapper: the float SRUnit (micro-net) ensemble in one CUDA launch.

Port of ``lerf_tpu/ops/pallas/srnet_kernel.py`` (``ensemble_sum_on_image``
→ ``_ensemble_sum_flat``).  For every pixel of a ``[..., H, W]`` float
image it sums, over the mode×rotation members, ``round(tanh(chain_m(x4))
· half)``: ``x4`` the member's 4 edge-clamped neighbours, ``chain_m`` the
member's DenseConv chain ``hk = relu(Wk·[h1..hk-1] + bk)``, k = 1..5,
then ``W6·[h1..h5] + b6``.

The kernel keeps float32 on the tensor cores as three TF32 products a
multiply-add (3xTF32): :class:`StackedHeads` carries the weights split
into TF32 ``hi`` and ``lo`` in the kernel's fragment order
(:func:`tf32_frags`), and nf is at most ``MAX_NF``.

``ensemble_sum`` runs the plain twin (:func:`ensemble_sum_plain`) for a CPU
tensor and launches ``csrc/srnet_ensemble.cu`` for a CUDA tensor; it never
falls back from the card to the plain version.  ``launches`` counts kernel
launches.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from ..lut_pipeline import MAX_PAD, _pad_all_sides, _sample4, member_offsets
from . import _build

LAYERS = ("1", "2", "3", "4", "5", "6")
MAX_MEMBERS = 20                    # 5 modes × 4 rotations (csrc kMaxMembers)
MAX_NF = 64                         # the kernels' activation tiles (kMaxNf)

launches = 0


def srunit_chain(x4: torch.Tensor, ws: Sequence[torch.Tensor],
                 bs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The DenseConv chain + tanh on ``x4 [..., 4]`` → ``[..., oC]``, weights
    ``[in, out]`` (or ``[M, in, out]`` against ``x4 [M, n, 4]`` with biases
    ``[M, 1, out]``)."""
    h = torch.relu(x4 @ ws[0] + bs[0])
    for w, b in zip(ws[1:5], bs[1:5]):
        h = torch.cat([h, torch.relu(h @ w + b)], -1)
    return torch.tanh(h @ ws[5] + bs[5])


class StackedHeads(NamedTuple):
    """One stage's member heads on one device, aligned with its members:
    ``w[k]`` float32 ``[M, in, out]`` (the params' own ``[in, out]``
    layout, stacked), ``b[k]`` float32 ``[M, out]``, k = layer 1..6, and
    ``frags[k]``, the same weights split for 3xTF32 in the kernel's
    B-fragment order (:func:`tf32_frags`)."""
    w: Tuple[torch.Tensor, ...]
    b: Tuple[torch.Tensor, ...]
    frags: Tuple[torch.Tensor, ...]

    @classmethod
    def create(cls, heads: Sequence[Dict], device=None):
        """From per-member SRUnit param dicts (``w1..w6``, ``b1..b6``)."""
        def stack(name):
            return torch.stack([torch.as_tensor(h[name]) for h in heads]) \
                .to(device=device, dtype=torch.float32).contiguous()

        w = tuple(stack(f"w{k}") for k in LAYERS)
        return cls(w=w, b=tuple(stack(f"b{k}") for k in LAYERS),
                   frags=tuple(tf32_frags(x, layer, w[0].shape[2])
                               for layer, x in enumerate(w)))

    @property
    def nf(self) -> int:
        return self.w[0].shape[2]

    @property
    def oc(self) -> int:
        return self.w[5].shape[2]


def padded_nf(nf: int) -> int:
    """K3's feature width: nf rounded up to 16 (two warps share a pixel
    group's n-tiles of 8)."""
    return -(-nf // 16) * 16


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``x`` → ``(hi, lo)``: ``hi`` is ``x`` rounded to TF32 (10
    mantissa bits, to nearest, ties away from zero: PTX ``cvt.rna.tf32``),
    ``lo`` the same rounding of ``x − hi`` (exact in float32), so ``hi +
    lo`` is ``x`` within ~2⁻²² of it."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def padded_layer(w: torch.Tensor, layer: int, nf: int, nfp: int,
                 k_mult: int) -> torch.Tensor:
    """Stacked ``[M, in, out]`` weights of ``layer`` (0-based) → ``[M, Kp,
    Np]`` with zeros around them, as the kernels' tiles lay inputs out:
    layer 1's 4 inputs first, otherwise feature segment s of width nf at
    rows ``s·nfp ..`` (nfp ≥ nf, the kernel's padded width); Kp a multiple
    of ``k_mult``, Np = nfp for hidden layers or 8 (one n-tile) for the
    head."""
    m, fan_in, out = w.shape
    if layer == 0:
        rows = torch.arange(fan_in)
    else:
        rows = torch.arange(fan_in).reshape(layer, nf) \
            + torch.arange(layer)[:, None] * (nfp - nf)
        rows = rows.reshape(-1)
    kp = -(-(4 if layer == 0 else layer * nfp) // k_mult) * k_mult
    np_ = nfp if layer < 5 else 8
    dense = w.new_zeros(m, kp, np_)
    dense[:, rows.to(w.device), :out] = w
    return dense


def tf32_frags(w: torch.Tensor, layer: int, nf: int) -> torch.Tensor:
    """Stacked ``[M, in, out]`` float32 weights of ``layer`` → the B
    fragments K3's ``mma.sync.m16n8k8`` reads, ``[M, k-steps, n-tiles, 32,
    4]``: lane ``4g + q`` of (k-step s, n-tile t) holds ``hi`` of inputs
    ``8s + 2q`` and ``8s + 2q + 1`` of output ``8t + g`` (the fragment's k
    = q and q + 4: the kernel pairs its activations the same way), then
    their ``lo`` (:func:`tf32_split`); zero padding as
    :func:`padded_layer`, to :func:`padded_nf` features."""
    dense = padded_layer(w, layer, nf, padded_nf(nf), 8)
    m, kp, np_ = dense.shape
    pairs = dense.reshape(m, kp // 8, 4, 2, np_ // 8, 8) \
        .permute(0, 1, 4, 5, 2, 3).reshape(m, kp // 8, np_ // 8, 32, 2)
    hi, lo = tf32_split(pairs)
    return torch.cat([hi, lo], -1).contiguous()


def sample_x4(img: torch.Tensor, members) -> torch.Tensor:
    """``[..., H, W]`` → ``[M, N, 4]``: each member's 4 neighbours of every
    pixel from the all-sides edge-padded image (N = pixels of ``img``)."""
    h, w = img.shape[-2], img.shape[-1]
    xpad = _pad_all_sides(img, MAX_PAD)
    return torch.stack([torch.stack(_sample4(xpad, h, w, mode, r), -1)
                        .reshape(-1, 4) for mode, r in members])


def ensemble_sum_plain(img: torch.Tensor, heads: StackedHeads, members, *,
                       half: float) -> torch.Tensor:
    """The twin K3 is held to: float32 ``[..., H, W]`` → ``[..., H, W, oC]``.

    Members run one at a time and their rounded outputs are summed, so the
    twin holds one member's ``[N, 5·nf]`` activations, not all of them.  On
    a CUDA tensor the products must be full float32: TF32 is switched off
    for the call and the caller's setting restored after it."""
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x4 = sample_x4(img, members)
        acc = torch.zeros(x4.shape[1], heads.oc, dtype=torch.float32,
                          device=img.device)
        for m in range(len(members)):
            o = srunit_chain(x4[m], [w[m] for w in heads.w],
                             [b[m] for b in heads.b])
            acc += torch.round(o * half)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    return acc.reshape(img.shape + (heads.oc,))


def _check_heads(heads: StackedHeads, n_members: int, device):
    nf, oc = heads.nf, heads.oc
    if not 0 < nf <= MAX_NF or oc not in (1, 3):
        raise ValueError(f"srnet_ensemble: nf {nf} must be 1..{MAX_NF} "
                         f"and oC {oc} 1 or 3")
    nt = padded_nf(nf) // 8
    want_f = [(1, nt)] + [(k * nt, nt) for k in range(1, 5)] + [(5 * nt, 1)]
    for f, b, (ks, nts), out in zip(heads.frags, heads.b, want_f,
                                   [nf] * 5 + [oc]):
        if (f.shape != (n_members, ks, nts, 32, 4)
                or b.shape != (n_members, out)
                or f.dtype != torch.float32 or b.dtype != torch.float32
                or f.device != device or b.device != device
                or not (f.is_contiguous() and b.is_contiguous())):
            raise ValueError(
                "srnet_ensemble: heads must be StackedHeads for "
                f"M={n_members}, nf={nf}, oC={oc} on the image's device")


def ensemble_sum(img: torch.Tensor, heads: StackedHeads, members, *,
                 half: float) -> torch.Tensor:
    """float32 ``[..., H, W]`` → float32 ``[..., H, W, oC]``:
    Σ_m round(chain_m(x4_m) · half) over ``members`` [(mode, rot)], aligned
    with the stacked ``heads``."""
    if img.device.type == "cpu":
        return ensemble_sum_plain(img, heads, members, half=half)
    global launches
    if img.device.type != "cuda":
        raise ValueError(f"srnet_ensemble: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.dim() < 2:
        raise ValueError("srnet_ensemble: img must be float32 [..., H, W]")
    if not 0 < len(members) <= MAX_MEMBERS:
        raise ValueError(f"srnet_ensemble: {len(members)} members, "
                         f"want 1..{MAX_MEMBERS}")
    _check_heads(heads, len(members), img.device)
    x = img.contiguous()
    h, w = x.shape[-2], x.shape[-1]
    c = x.numel() // max(h * w, 1)
    out = torch.empty(x.shape + (heads.oc,), dtype=torch.float32,
                      device=x.device)
    offsets = member_offsets(members)
    lib = _build.library()
    with torch.cuda.device(x.device):       # launch on the tensors' card
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lerf_srnet_ensemble(
            x.data_ptr(), out.data_ptr(),
            *(t.data_ptr() for t in heads.frags),
            *(t.data_ptr() for t in heads.b),
            offsets.ctypes.data, len(members), c, h, w, heads.nf, heads.oc,
            float(half), stream)
    _build.check(err, "srnet_ensemble launch")
    launches += 1
    return out


def ensemble_sum_on_image(heads, img: torch.Tensor, members, *,
                          half: float) -> torch.Tensor:
    """``lerf_tpu``'s ``ensemble_sum_on_image`` signature: ``heads`` the
    member-aligned SRUnit param dicts (or already a :class:`StackedHeads`
    on the image's device)."""
    if not isinstance(heads, StackedHeads):
        heads = StackedHeads.create(heads, img.device)
    return ensemble_sum(img, heads, members, half=half)
