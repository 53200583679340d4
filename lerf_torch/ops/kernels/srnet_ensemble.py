"""K3 wrapper: the float SRUnit (micro-net) ensemble in one CUDA launch.

Port of ``lerf_tpu/ops/pallas/srnet_kernel.py`` (``ensemble_sum_on_image``
→ ``_ensemble_sum_flat``).  For every pixel of a ``[..., H, W]`` float
image it sums, over the mode×rotation members, ``round(tanh(chain_m(x4))
· half)``: ``x4`` the member's 4 edge-clamped neighbours, ``chain_m`` the
member's DenseConv chain ``hk = relu(Wk·[h1..hk-1] + bk)``, k = 1..5,
then ``W6·[h1..h5] + b6``.

The compute type is the heads' own, as in lerf_tpu (``dt =
heads[0]["w1"].dtype``): float32 heads keep float32 on the tensor cores
as three TF32 products a multiply-add (3xTF32, ``csrc/srnet_ensemble.cu``),
bfloat16 heads run one bf16 product with float32 sums, the inputs and every
activation rounded to bf16 where lerf_tpu's kernel casts them, biases, tanh
and the head in float32 (``csrc/srnet_ensemble_bf16.cu``: ``wgmma`` on
shared-memory tiles, the weights brought in by bulk copies).
:class:`StackedHeads` carries the weights as each kernel reads them (:func:`tf32_frags`: B fragments split into TF32 ``hi``
and ``lo``; :func:`bf16_images`: the swizzled shared-memory images); nf is
at most ``MAX_NF``.

``ensemble_sum`` runs the plain twin (:func:`ensemble_sum_plain`) for a CPU
tensor and launches the kernel of the heads' type for a CUDA tensor; it
never falls back from the card to the plain version, nor from a bf16 head
to the float32 kernel.  ``launches`` counts kernel launches of either type,
``bf16_launches`` those of the bf16 kernel.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..lut_pipeline import MAX_PAD, _pad_all_sides, _sample4, member_offsets
from . import _build
from .resize import BLOCK_SMEM_MAX

LAYERS = ("1", "2", "3", "4", "5", "6")
MAX_MEMBERS = 20                    # 5 modes × 4 rotations (csrc kMaxMembers)
MAX_NF = 128                        # the kernels' activation tiles (kMaxNf)
COMPUTE_TYPES = (torch.float32, torch.bfloat16)

launches = 0
bf16_launches = 0


def srunit_chain(x4: torch.Tensor, ws: Sequence[torch.Tensor],
                 bs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The DenseConv chain + tanh on ``x4 [..., 4]`` → ``[..., oC]``, weights
    ``[in, out]`` (or ``[M, in, out]`` against ``x4 [M, n, 4]`` with biases
    ``[M, 1, out]``)."""
    h = torch.relu(x4 @ ws[0] + bs[0])
    for w, b in zip(ws[1:5], bs[1:5]):
        h = torch.cat([h, torch.relu(h @ w + b)], -1)
    return torch.tanh(h @ ws[5] + bs[5])


def as_tensor(v) -> torch.Tensor:
    """A param leaf as a tensor of its own type: a tensor as it is, a
    bfloat16 numpy array (what ``np.asarray`` of a JAX bf16 array gives)
    as bfloat16 bit for bit through a ``uint16`` view, any other array
    through ``torch.as_tensor``."""
    if isinstance(v, torch.Tensor):
        return v
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16)
    return torch.as_tensor(a)


class StackedHeads(NamedTuple):
    """One stage's member heads on one device, aligned with its members:
    ``w[k]`` ``[M, in, out]`` in the compute type (the params' own ``[in,
    out]`` layout, stacked), ``b[k]`` float32 ``[M, out]`` (of the bf16
    values for bf16 heads, as lerf_tpu's ``stack_heads_transposed``),
    k = layer 1..6, and ``frags[k]``, the same weights as the kernel of
    their type reads them: B fragments split for 3xTF32 (:func:`tf32_frags`)
    for float32, shared-memory images (:func:`bf16_images`) for
    bfloat16."""
    w: Tuple[torch.Tensor, ...]
    b: Tuple[torch.Tensor, ...]
    frags: Tuple[torch.Tensor, ...]

    @classmethod
    def create(cls, heads: Sequence[Dict], device=None):
        """From per-member SRUnit param dicts (``w1..w6``, ``b1..b6``).
        The compute type is the first head's ``w1``'s: bfloat16 stays
        bfloat16, any other type computes in float32."""
        dt = as_tensor(heads[0]["w1"]).dtype
        dt = dt if dt in COMPUTE_TYPES else torch.float32

        def stack(name, dtype):
            return torch.stack([as_tensor(h[name]).to(dtype)
                                for h in heads]) \
                .to(device=device).contiguous()

        w = tuple(stack(f"w{k}", dt) for k in LAYERS)
        frags = bf16_images if dt == torch.bfloat16 else tf32_frags
        return cls(w=w, b=tuple(stack(f"b{k}", torch.float32)
                                for k in LAYERS),
                   frags=tuple(frags(x, layer, w[0].shape[2])
                               for layer, x in enumerate(w)))

    @property
    def nf(self) -> int:
        return self.w[0].shape[2]

    @property
    def oc(self) -> int:
        return self.w[5].shape[2]

    @property
    def dtype(self) -> torch.dtype:
        """The compute type: ``torch.float32`` or ``torch.bfloat16``."""
        return self.w[0].dtype


def padded_nf(nf: int) -> int:
    """K3's feature width: nf rounded up to 16 (two warps share a pixel
    group's n-tiles of 8)."""
    return -(-nf // 16) * 16


def _row_stride(n: int, mod: int) -> int:
    """The least row stride ≥ ``n`` elements that is 8 mod ``mod``: the
    kernels' conflict-free activation rows."""
    return n + (8 - n) % mod


def smem_bytes(nf: int, dtype=torch.float32) -> int:
    """Dynamic shared memory of one K3 block at ``nf``, as the kernel of
    that type lays it out: float32, 3 weight buffers of 16 KB, the
    activation tile (rows padded to 8 mod 32 floats), the samples and 6
    barriers; bf16, 1 KB to align the swizzle atoms, the activation tile
    (``tile_pixels`` rows of 5 segments of nf padded to 16, bf16), the
    samples (32 bytes a row), and ``ring_slots`` slots of 16 KB with two
    barriers each."""
    nfp, tile = padded_nf(nf), tile_pixels(nf, dtype)
    if dtype == torch.bfloat16:
        slots = ring_slots(nf)
        return (1024 + tile * 5 * nfp * 2 + tile * 32
                + slots * (16384 + 16))
    return (3 * 4096 + tile * (_row_stride(5 * nfp, 32) + 8)) * 4 + 48


def tile_pixels(nf: int, dtype=torch.float32) -> int:
    """Pixels of one K3 block.  float32: 128, or 64 above nf 64 (128
    pixels at nf 128 would need 332 KB); bf16: 256 up to nf 64, 128 above
    (256 rows of 5 segments of nf 128 would need 320 KB)."""
    if dtype == torch.bfloat16:
        return 256 if padded_nf(nf) <= 64 else 128
    return 64 if padded_nf(nf) > 64 else 128


def ring_slots(nf: int) -> int:
    """The bf16 kernel's weight ring: as many 16 KB slots (at most 8) as
    the opt-in leaves beside the tile, the samples, 1 KB to align and 8
    slots' barriers."""
    nfp, tile = padded_nf(nf), tile_pixels(nf, torch.bfloat16)
    free = BLOCK_SMEM_MAX - 1024 - tile * 5 * nfp * 2 - tile * 32 - 16 * 8
    return min(8, free // 16384)


def block_width(nf: int, layer: int = 1) -> int:
    """The bf16 kernel's k-block width in features (16 bf16 = one k-step):
    16 for layer 1's padded samples, otherwise 64 where padded nf is a
    multiple of 64 (128-byte swizzle), 32 where it is one of 32 (64-byte),
    else 16 (32-byte): each layer's segment is whole blocks."""
    nfp = padded_nf(nf)
    if layer == 0:
        return 16
    return 64 if nfp % 64 == 0 else 32 if nfp % 32 == 0 else 16


def swizzle(blocks: torch.Tensor) -> torch.Tensor:
    """``[..., rows, wb]`` K-major blocks (rows a multiple of 8, wb bf16
    features a row) → the same bytes as the ``wgmma`` swizzle of that width
    stores them (the 128-, 64- or 32-byte mode for wb 64, 32, 16): in row
    r, the 16-byte chunk c lands at chunk c ^ ((r · 2 wb) >> 7 & (wb / 8 −
    1)), the XOR of address bits 4.. with bits 7.. of a block laid out at
    an atom-aligned address.  The map is its own inverse."""
    rows, wb = blocks.shape[-2:]
    r = torch.arange(rows)
    sw = ((r * 2 * wb) >> 7) & (wb // 8 - 1)
    idx = torch.arange(wb // 8)[None, :] ^ sw[:, None]          # [rows, c]
    chunks = blocks.reshape(blocks.shape[:-1] + (wb // 8, 8))
    idx = idx.to(blocks.device)[..., None].expand(chunks.shape)
    return torch.gather(chunks, -2, idx).reshape(blocks.shape)


def bf16_images(w: torch.Tensor, layer: int, nf: int) -> torch.Tensor:
    """Stacked ``[M, in, out]`` bfloat16 weights of ``layer`` → the shared
    memory images the bf16 kernel's ``wgmma`` reads as B, bfloat16 ``[M,
    k-blocks, rows, wb]``: B K-major (a row an output: :func:`padded_nf`
    rows for hidden layers, 8 for the head; a column an input, zero
    padding as :func:`padded_layer`), cut into k-blocks of
    :func:`block_width` inputs, each block :func:`swizzle`-d.  A ring slot
    takes whole blocks, copied as they are."""
    wb = block_width(nf, layer)
    dense = padded_layer(w, layer, nf, padded_nf(nf), 16)
    m, kp, np_ = dense.shape
    blocks = dense.transpose(1, 2).reshape(m, np_, kp // wb, wb) \
        .permute(0, 2, 1, 3)
    return swizzle(blocks).contiguous()


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


def _to_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 → the float32 value of its bf16 rounding (to nearest
    even), where lerf_tpu's kernel casts to its compute type."""
    return x.to(torch.bfloat16).to(torch.float32)


def srunit_chain_bf16(x4: torch.Tensor, ws: Sequence[torch.Tensor],
                      bs: Sequence[torch.Tensor]) -> torch.Tensor:
    """:func:`srunit_chain` in lerf_tpu's bf16 compute type: the inputs
    and each hidden activation rounded to bf16 after its bias and ReLU,
    products of bf16 values summed in float32 (``ws`` float32 tensors
    holding bf16 values), biases, tanh and the head in float32."""
    h = _to_bf16(torch.relu(_to_bf16(x4) @ ws[0] + bs[0]))
    for w, b in zip(ws[1:5], bs[1:5]):
        h = torch.cat([h, _to_bf16(torch.relu(h @ w + b))], -1)
    return torch.tanh(h @ ws[5] + bs[5])


def ensemble_sum_plain(img: torch.Tensor, heads: StackedHeads, members, *,
                       half: float) -> torch.Tensor:
    """The twin K3 is held to: float32 ``[..., H, W]`` → ``[..., H, W, oC]``.

    Members run one at a time and their rounded outputs are summed, so the
    twin holds one member's ``[N, 5·nf]`` activations, not all of them.
    bf16 heads run :func:`srunit_chain_bf16` on the float32 values of the
    bf16 weights (products of bf16 values are exact in float32).  On a
    CUDA tensor the products must be float32 products: TF32 is switched off
    for the call and the caller's setting restored after it."""
    chain = srunit_chain_bf16 if heads.dtype == torch.bfloat16 \
        else srunit_chain
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x4 = sample_x4(img, members)
        acc = torch.zeros(x4.shape[1], heads.oc, dtype=torch.float32,
                          device=img.device)
        for m in range(len(members)):
            o = chain(x4[m], [w[m].to(torch.float32) for w in heads.w],
                      [b[m] for b in heads.b])
            acc += torch.round(o * half)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    return acc.reshape(img.shape + (heads.oc,))


def _check_heads(heads: StackedHeads, n_members: int, device):
    nf, oc, dt = heads.nf, heads.oc, heads.dtype
    if not 0 < nf <= MAX_NF or oc not in (1, 3):
        raise ValueError(
            f"srnet_ensemble: nf {nf} must be 1..{MAX_NF} (at nf {MAX_NF} "
            f"a block's activation tile and weight ring take "
            f"{smem_bytes(MAX_NF)} (float32, {tile_pixels(MAX_NF)} "
            f"pixels) or {smem_bytes(MAX_NF, torch.bfloat16)} (bf16, "
            f"{tile_pixels(MAX_NF, torch.bfloat16)} pixels) of the "
            f"{BLOCK_SMEM_MAX} bytes of shared memory a block may use) "
            f"and oC {oc} 1 or 3")
    if smem_bytes(nf, dt) > BLOCK_SMEM_MAX:
        raise ValueError(f"srnet_ensemble: nf {nf} needs "
                         f"{smem_bytes(nf, dt)} bytes of shared memory a "
                         f"block, over the {BLOCK_SMEM_MAX} allowed")
    nfp = padded_nf(nf)
    if dt == torch.bfloat16:                 # [M, k-blocks, rows, wb]
        wbs = [block_width(nf, j) for j in range(6)]
        want_f = [(n_members, 1 if j == 0 else j * nfp // wbs[j],
                   nfp if j < 5 else 8, wbs[j]) for j in range(6)]
    else:                                    # [M, k-steps, n-tiles, 32, 4]
        want_f = [(n_members, 1 if j == 0 else j * nfp // 8,
                   nfp // 8 if j < 5 else 1, 32, 4) for j in range(6)]
    for f, b, shape, out in zip(heads.frags, heads.b, want_f,
                                [nf] * 5 + [oc]):
        if (f.shape != shape
                or b.shape != (n_members, out)
                or dt not in COMPUTE_TYPES
                or f.dtype != dt or b.dtype != torch.float32
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
    global launches, bf16_launches
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
    bf16 = heads.dtype == torch.bfloat16
    entry = lib.lerf_srnet_ensemble_bf16 if bf16 else lib.lerf_srnet_ensemble
    with torch.cuda.device(x.device):       # launch on the tensors' card
        stream = torch.cuda.current_stream().cuda_stream
        err = entry(x.data_ptr(), out.data_ptr(),
                    *(t.data_ptr() for t in heads.frags),
                    *(t.data_ptr() for t in heads.b),
                    offsets.ctypes.data, len(members), c, h, w, heads.nf,
                    heads.oc, float(half), stream)
    _build.check(err, "srnet_ensemble_bf16 launch" if bf16
                 else "srnet_ensemble launch")
    launches += 1
    bf16_launches += bf16
    return out


def ensemble_sum_on_image(heads, img: torch.Tensor, members, *,
                          half: float) -> torch.Tensor:
    """``lerf_tpu``'s ``ensemble_sum_on_image`` signature: ``heads`` the
    member-aligned SRUnit param dicts (or already a :class:`StackedHeads`
    on the image's device)."""
    if not isinstance(heads, StackedHeads):
        heads = StackedHeads.create(heads, img.device)
    return ensemble_sum(img, heads, members, half=half)
