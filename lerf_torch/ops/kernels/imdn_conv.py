"""The IMDN towers' convolutions with their epilogues:
``csrc/imdn_conv.cu``.

Replaces no TPU kernel: lerf_tpu runs the towers as XLA convolutions
(``lerf_tpu/models/imdn_s2d.py:148-162``); on the card the port ran them
on cuDNN with a separate pass for each bias, leaky ReLU, residual add and
concat.  Three calls cover a tower (:func:`lerf_torch.models.imdn_s2d.
apply_tower_kernel`):

- :func:`conv`: a SAME, stride-1 3×3 or 1×1 conv + bias, then
  optionally ``leaky_relu(0.05)`` and + ``residual``; output channels
  below ``dist.shape[1]`` go to ``dist`` (a slice of a module's concat
  buffer), the rest to ``out``;
- :func:`tail`: a module's end, c4 (3×3) joined with the distilled
  channels and c5 (1×1) + bias + the module's input, and with ``lr`` the
  tower's 1×1 lr conv + bias + ``h`` after it;
- :func:`tower_end`: the tower's up conv + bias, clamped to [-1, 1] and
  scaled (stage 1: ``· half + half``; stage 2: ``/ 2 + 0.5``), stage 2
  written in ``[N, C, H, W, oC]`` order (channel ``o·C + c``).

Each runs its plain PyTorch twin (``F.conv2d`` and the same epilogue in
torch, :func:`conv_plain`, :func:`tail_plain`, :func:`tower_end_plain`)
for CPU tensors and launches the kernel for CUDA tensors; it never falls
back from the card to the twin.  Both check device, type, layout, kernel
size and channel ranges first.  ``launches`` counts kernel launches;
:func:`twin_check` holds each call on a card to its twin (the card tests
and ``chip_smoke.py`` run it).

Activations are float32 ``[N, C, H, W]`` whose frames are dense (strides
``(any, H·W, W, 1)``): a channel slice of a larger buffer qualifies.  The
kernel sums each output's products in a fixed order (input channel,
kernel row, kernel column, then the bias), so a frame gives the same bits
alone or in a batch; cuDNN and the CPU sum in other orders (float32
reorder differences only).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build

launches = 0

GROUPS = (3, 9, 12)     # output channels a block computes (csrc instances)
MAX_CIN = 128           # input channels (csrc kMaxCin)
MAX_FRAMES = 65535      # frames a launch (its tiles counted in 32 bits)
TAIL_NF = 12            # :func:`tail`'s widest c5 / lr (csrc kTailNf)
TAIL_DIST = 9           # distilled channels it reads (csrc kTailDist)
TAIL_C4 = 3             # c4's outputs it keeps (csrc kTailG)


def _group(cout: int, k: int) -> int:
    """The instance's output group: the least of :data:`GROUPS` that holds
    ``cout`` (12 above it, in groups; always 12 for 1×1)."""
    if k == 1:
        return 12
    return next((g for g in GROUPS if g >= cout), GROUPS[-1])


def _padded(g: int) -> int:
    return -(-g // 4) * 4


class ConvWeights(NamedTuple):
    """One conv's weights: ``w`` [cout, cin, k, k] and ``b`` [cout] float32
    (the twin's), and ``packed`` / ``bias`` as the kernel stages them:
    ``[groups, cin, k·k, gp]`` and ``[groups, gp]``, each group's ``group``
    outputs padded with zeros to ``gp``, a multiple of 4."""
    w: torch.Tensor
    b: torch.Tensor
    packed: torch.Tensor
    bias: torch.Tensor
    group: int

    @classmethod
    def create(cls, w: torch.Tensor, b: torch.Tensor) -> "ConvWeights":
        cout, cin, k, k2 = w.shape
        if k != k2 or k not in (1, 3):
            raise ValueError(f"imdn_conv: kernel {k}x{k2}, want 3x3 or 1x1")
        if w.dtype != torch.float32 or b.dtype != torch.float32:
            raise ValueError(f"imdn_conv: weights {w.dtype} / {b.dtype}, "
                             "want float32")
        if not 1 <= cin <= MAX_CIN or b.shape != (cout,):
            raise ValueError(f"imdn_conv: weights {tuple(w.shape)}, bias "
                             f"{tuple(b.shape)} (cin 1..{MAX_CIN})")
        g = _group(cout, k)
        groups, gp = -(-cout // g), _padded(g)
        packed = w.new_zeros((groups, gp, cin, k * k))
        bias = b.new_zeros((groups, gp))
        for i in range(groups):
            n = min(g, cout - i * g)
            packed[i, :n] = w[i * g:i * g + n].reshape(n, cin, k * k)
            bias[i, :n] = b[i * g:i * g + n]
        return cls(w.contiguous(), b.contiguous(),
                   packed.permute(0, 2, 3, 1).contiguous(), bias, g)

    @property
    def cin(self) -> int:
        return self.w.shape[1]

    @property
    def cout(self) -> int:
        return self.w.shape[0]

    @property
    def k(self) -> int:
        return self.w.shape[-1]


class TailWeights(NamedTuple):
    """A module's end: c4 (3×3, at most :data:`TAIL_C4` outputs), c5 (1×1
    over the ``n_dist`` distilled channels and c4's) and optionally the
    tower's lr (1×1), each as :class:`ConvWeights`, and ``fuse``: c5's
    weights [12, 12] and bias [12], then lr's (zeros without lr), as the
    kernel stages them: c5's columns for the distilled channels at 0..8,
    c4's at 9..11, each padded with zeros."""
    c4: ConvWeights
    c5: ConvWeights
    lr: Optional[ConvWeights]
    fuse: torch.Tensor
    n_dist: int

    @staticmethod
    def fits(c4: ConvWeights, c5: ConvWeights,
             lr: Optional[ConvWeights] = None) -> bool:
        """Whether the fused end takes these widths (IMDN2 up to nf 12)."""
        nf, dc = c5.cout, c4.cout
        return (c4.k == 3 and c5.k == 1 and dc <= TAIL_C4
                and 0 <= c5.cin - dc <= TAIL_DIST and nf <= TAIL_NF
                and (lr is None or (lr.k == 1 and lr.cin == nf
                                    and lr.cout == nf)))

    @classmethod
    def create(cls, c4: ConvWeights, c5: ConvWeights,
               lr: Optional[ConvWeights] = None) -> "TailWeights":
        nf, dc = c5.cout, c4.cout
        n_dist = c5.cin - dc
        if not cls.fits(c4, c5, lr):
            raise ValueError(
                f"imdn_conv.tail: c4 {tuple(c4.w.shape)}, c5 "
                f"{tuple(c5.w.shape)}, lr "
                f"{None if lr is None else tuple(lr.w.shape)}: the fused "
                f"end takes c4 3x3 to <= {TAIL_C4}, c5 1x1 over <= "
                f"{TAIL_DIST} + c4's channels to <= {TAIL_NF}, lr 1x1 "
                "nf -> nf")
        n = TAIL_NF
        w5 = c5.w.new_zeros((n, n))
        w5[:nf, :n_dist] = c5.w[:, :n_dist, 0, 0]
        w5[:nf, TAIL_DIST:TAIL_DIST + dc] = c5.w[:, n_dist:, 0, 0]
        b5 = c5.b.new_zeros(n)
        b5[:nf] = c5.b
        wl, bl = c5.w.new_zeros((n, n)), c5.b.new_zeros(n)
        if lr is not None:
            wl[:nf, :nf] = lr.w[:, :, 0, 0]
            bl[:nf] = lr.b
        fuse = torch.cat([w5.reshape(-1), b5, wl.reshape(-1), bl])
        return cls(c4, c5, lr, fuse.contiguous(), n_dist)


# -- the plain twins ----------------------------------------------------------

def conv_plain(x, wt: ConvWeights, out, *, act=False, residual=None,
               dist=None):
    """:func:`conv` in torch: ``F.conv2d`` + bias, ``lrelu``, ``+
    residual``, the channels split between ``dist`` and ``out``."""
    from ...models.imdn import lrelu
    y = F.conv2d(x, wt.w, wt.b, padding=wt.k // 2)
    if act:
        y = lrelu(y)
    if residual is not None:
        y = y + residual
    split = 0 if dist is None else dist.shape[1]
    if split:
        dist.copy_(y[:, :split])
    if split < wt.cout:
        out.copy_(y[:, split:])


def tail_plain(x, tw: TailWeights, dist, residual, out, h=None):
    """:func:`tail` in torch: ``F.conv2d`` for c4, ``torch.cat`` with the
    distilled channels, ``F.conv2d`` for c5 + the module's input, then
    lr's + ``h``."""
    c4 = F.conv2d(x, tw.c4.w, tw.c4.b, padding=1)
    y = F.conv2d(torch.cat([dist, c4], dim=1), tw.c5.w, tw.c5.b) + residual
    if tw.lr is not None:
        y = h + F.conv2d(y, tw.lr.w, tw.lr.b)
    out.copy_(y)


def tower_end_plain(x, wt: ConvWeights, out, *, stage, half=127, oc=1):
    """:func:`tower_end` in torch: ``F.conv2d`` + bias, ``torch.clamp``,
    the stage's scale, and stage 2's ``movedim`` to ``[N, C, H, W, oC]``."""
    y = torch.clamp(F.conv2d(x, wt.w, wt.b, padding=wt.k // 2), -1, 1)
    if stage == 1:
        out.copy_(y * half + half)
        return
    y = y / 2 + 0.5
    y = y.reshape((y.shape[0], oc, wt.cout // oc) + y.shape[-2:])
    out.copy_(torch.movedim(y, 1, -1))


# -- checks -------------------------------------------------------------------

def _frames(t, name, shape, device):
    """``t`` float32 [N, C, H, W] of ``shape`` on ``device``, each frame
    dense (strides (any, H·W, W, 1)); returns its frame stride."""
    if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
        raise ValueError(f"imdn_conv: {name} must be a float32 tensor, got "
                         f"{getattr(t, 'dtype', type(t))}")
    if t.device != device:
        raise ValueError(f"imdn_conv: {name} on {t.device}, the weights on "
                         f"{device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"imdn_conv: {name} {tuple(t.shape)}, want "
                         f"{tuple(shape)}")
    _, c, h, w = shape
    if c * h * w and t.stride()[1:] != (h * w, w, 1):
        raise ValueError(f"imdn_conv: {name} strides {t.stride()}: each "
                         "frame must be dense (contiguous C, H, W)")
    return t.stride(0)


def _input(x, wt: ConvWeights):
    if not isinstance(x, torch.Tensor) or x.dim() != 4:
        raise ValueError("imdn_conv: x must be a [N, C, H, W] tensor")
    if x.shape[1] != wt.cin:
        raise ValueError(f"imdn_conv: x has {x.shape[1]} channels, the "
                         f"conv takes {wt.cin}")
    if x.shape[0] > MAX_FRAMES:
        raise ValueError(f"imdn_conv: {x.shape[0]} frames, at most "
                         f"{MAX_FRAMES} a call")
    _frames(x, "x", x.shape, wt.w.device)
    return x.shape[0], x.shape[2], x.shape[3]


def _vec(w, tensors, strides):
    """The kernel's 16-byte path: rows of 4k floats, every pointer and
    frame stride on 16 bytes."""
    return int(w % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
               and all(s % 4 == 0 for s in strides))


def _launch(what, fn, device, *args):
    global launches
    with torch.cuda.device(device):         # launch on the tensors' card
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(err, what)
    launches += 1


# -- the calls ----------------------------------------------------------------

def conv(x, wt: ConvWeights, out, *, act: bool = False, residual=None,
         dist=None):
    """``y = conv(x) + bias``, ``leaky_relu(0.05)`` if ``act``, ``+
    residual``; channels ``< dist.shape[1]`` into ``dist``, the rest into
    ``out`` (``[N, cout - split, H, W]``)."""
    n, h, w = _input(x, wt)
    split = 0 if dist is None else dist.shape[1]
    if not 0 <= split <= wt.cout:
        raise ValueError(f"imdn_conv: dist takes {split} of {wt.cout} "
                         "channels")
    dev = wt.w.device
    outs = [(out, "out", wt.cout - split)] if split < wt.cout else []
    if split:
        outs.append((dist, "dist", split))
    strides = {name: _frames(t, name, (n, c, h, w), dev)
               for t, name, c in outs}
    if residual is not None:
        strides["residual"] = _frames(residual, "residual",
                                      (n, wt.cout, h, w), dev)
    if dev.type != "cuda":
        conv_plain(x, wt, out, act=act, residual=residual, dist=dist)
        return
    ts = [x] + [t for t, _, _ in outs] + (
        [] if residual is None else [residual])
    vec = _vec(w, ts, [x.stride(0)] + list(strides.values()))
    null = (None, 0)
    o = (out.data_ptr(), strides["out"]) if "out" in strides else null
    d = (dist.data_ptr(), strides["dist"]) if split else null
    r = ((residual.data_ptr(), strides["residual"])
         if residual is not None else null)
    _launch("imdn_conv launch", _build.library().lerf_imdn_conv, dev,
            x.data_ptr(), x.stride(0), wt.packed.data_ptr(),
            wt.bias.data_ptr(), *o, *d, split, *r, n, wt.cin, wt.cout, h, w,
            wt.k, wt.group, int(act), 0, 0, 0.0, 1, vec)


def tail(x, tw: TailWeights, dist, residual, out, h=None):
    """A module's end: ``c5(cat(dist, c4(x))) + residual``, and with
    ``tw.lr`` then ``h + lr(·)``, into ``out`` [N, nf, H, W] (which may be
    ``residual`` itself: each pixel is read before it is written)."""
    n, hh, w = _input(x, tw.c4)
    dev = tw.c4.w.device
    nf = tw.c5.cout
    if (tw.lr is None) != (h is None):
        raise ValueError("imdn_conv.tail: h is lr's residual: give both "
                         "or neither")
    strides = {"dist": _frames(dist, "dist", (n, tw.n_dist, hh, w), dev),
               "residual": _frames(residual, "residual", (n, nf, hh, w),
                                   dev),
               "out": _frames(out, "out", (n, nf, hh, w), dev)}
    if h is not None:
        strides["h"] = _frames(h, "h", (n, nf, hh, w), dev)
    if dev.type != "cuda":
        tail_plain(x, tw, dist, residual, out, h)
        return
    ts = [x, dist, residual, out] + ([] if h is None else [h])
    vec = _vec(w, ts, [x.stride(0)] + list(strides.values()))
    hp = (h.data_ptr(), strides["h"]) if h is not None else (None, 0)
    _launch("imdn_conv tail launch", _build.library().lerf_imdn_tail, dev,
            x.data_ptr(), x.stride(0), tw.c4.packed.data_ptr(),
            tw.c4.bias.data_ptr(), tw.fuse.data_ptr(), dist.data_ptr(),
            strides["dist"], tw.n_dist, residual.data_ptr(),
            strides["residual"], *hp, out.data_ptr(), strides["out"], n,
            tw.c4.cin, nf, hh, w, vec)


def tower_end(x, wt: ConvWeights, out, *, stage: int, half: int = 127,
              oc: int = 1):
    """The tower's up conv + bias, clamped to [-1, 1]; stage 1 ``· half +
    half`` into ``out`` [N, cout, H, W]; stage 2 ``/ 2 + 0.5`` into
    ``out`` [N, cout / oc, H, W, oc] (channel ``o·C + c`` at ``[c, ..,
    o]``), contiguous."""
    n, h, w = _input(x, wt)
    if stage not in (1, 2) or (stage == 1 and oc != 1) or wt.cout % oc:
        raise ValueError(f"imdn_conv.tower_end: stage {stage}, oc {oc}, "
                         f"cout {wt.cout}")
    if wt.k != 3:
        raise ValueError("imdn_conv.tower_end: the up conv is 3x3")
    shape = ((n, wt.cout, h, w) if stage == 1
             else (n, wt.cout // oc, h, w, oc))
    if (not isinstance(out, torch.Tensor) or out.dtype != torch.float32
            or out.device != wt.w.device or tuple(out.shape) != shape
            or not out.is_contiguous()):
        raise ValueError(f"imdn_conv.tower_end: out must be a contiguous "
                         f"float32 {shape} on {wt.w.device}")
    if wt.w.device.type != "cuda":
        tower_end_plain(x, wt, out, stage=stage, half=half, oc=oc)
        return
    _launch("imdn_conv tower end launch", _build.library().lerf_imdn_conv,
            wt.w.device, x.data_ptr(), x.stride(0), wt.packed.data_ptr(),
            wt.bias.data_ptr(), out.data_ptr(), out.stride(0), None, 0, 0,
            None, 0, n, wt.cin, wt.cout, h, w, wt.k, wt.group, 0, 1, stage,
            float(half), oc, _vec(w, [x], [x.stride(0)]))


# -- the check against the twins ----------------------------------------------

# (cin, cout, k, act, residual, split): the towers' convs at nf 12, wider
# groups (16, 30 outputs), two staged chunks (cin 24) and a 1x1 above 12
TWIN_CONVS = [(3, 12, 3, False, False, 0), (12, 12, 3, True, False, 3),
              (9, 12, 3, True, False, 3), (9, 3, 3, False, False, 0),
              (12, 12, 1, False, True, 0), (16, 16, 3, True, True, 4),
              (24, 30, 3, True, False, 6), (12, 16, 1, False, True, 0)]


def twin_check(device, n: int, h: int, w: int, atol: float,
               generator: torch.Generator) -> float:
    """Each call on ``device`` against its plain twin (under
    ``cudnn_fp32``) at ``n`` frames of ``h`` × ``w``, on random weights
    and inputs from ``generator``: every case of :data:`TWIN_CONVS` (the
    split store into a slice of a wider buffer, whose other channels must
    stay as they were), the module end with and without lr (also in
    place, which must equal its copy) and both tower ends (stage 1's
    difference divided by its scale, 127).  Raises ``AssertionError``
    where a difference passes ``atol``; returns the largest."""
    from ...models.imdn_s2d import cudnn_fp32

    def rnd(*shape, scale=1.0):
        return ((torch.rand(shape, generator=generator) * 2 - 1)
                * scale).to(device)

    def wts(cin, cout, k):
        return ConvWeights.create(
            rnd(cout, cin, k, k, scale=1 / (cin * k * k) ** 0.5),
            rnd(cout, scale=0.1))

    worst = 0.0

    def note(what, a, b):
        nonlocal worst
        d = float((a - b).abs().max()) if a.numel() else 0.0
        worst = max(worst, d)
        if not d <= atol:
            raise AssertionError(f"imdn_conv {what}: {d} from its twin")

    at = f"at {n}x{h}x{w}"
    with torch.no_grad(), cudnn_fp32():
        for cin, cout, k, act, res, split in TWIN_CONVS:
            wt = wts(cin, cout, k)
            x = rnd(n, cin, h, w)
            r = rnd(n, cout, h, w) if res else None
            got = []
            for fn in (conv, conv_plain):
                big = torch.full((n, split + 2, h, w), 7.0, device=device)
                out = torch.empty(n, cout - split, h, w, device=device)
                fn(x, wt, out, act=act, residual=r,
                   dist=big[:, 1:1 + split] if split else None)
                got.append((out, big))
            what = f"conv {cin}->{cout} k{k} {at}"
            note(what, got[0][0], got[1][0])
            note(what + " (dist)", got[0][1], got[1][1])
            if not bool((got[0][1][:, 0] == 7).all()
                        and (got[0][1][:, -1] == 7).all()):
                raise AssertionError(f"imdn_conv {what}: wrote outside its "
                                     "channels")
        for with_lr in (False, True):
            tw = TailWeights.create(wts(9, 3, 3), wts(12, 12, 1),
                                    wts(12, 12, 1) if with_lr else None)
            x, dist = rnd(n, 9, h, w), rnd(n, 9, h, w)
            res, hh = rnd(n, 12, h, w), rnd(n, 12, h, w)
            hh = hh if with_lr else None
            got = torch.empty(n, 12, h, w, device=device)
            want = torch.empty_like(got)
            tail(x, tw, dist, res, got, hh)
            tail_plain(x, tw, dist, res, want, hh)
            tail(x, tw, dist, res, res, hh)          # in place
            note(f"tail lr={with_lr} {at}", got, want)
            if not torch.equal(res, got):
                raise AssertionError(f"imdn_conv tail lr={with_lr} {at}: "
                                     "in place differs")
        for cout, stage, oc in ((3, 1, 1), (9, 2, 3)):
            wt = wts(12, cout, 3)
            x = rnd(n, 12, h, w, scale=4)
            shape = ((n, cout, h, w) if stage == 1
                     else (n, cout // oc, h, w, oc))
            got = torch.empty(shape, device=device)
            want = torch.empty(shape, device=device)
            tower_end(x, wt, got, stage=stage, oc=oc)
            tower_end_plain(x, wt, want, stage=stage, oc=oc)
            scale = 127.0 if stage == 1 else 1.0
            note(f"tower end {stage} {at}", got / scale, want / scale)
    return worst
