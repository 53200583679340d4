"""LeRF deploy pipelines: stages → hyper codes → steerable resize or warp.

The port of ``lerf_tpu.pipeline``'s two predictors, SR and static warp:

* :class:`LutPredictor` (``pipeline.py:41-66,855-1017,1219-1278``), the
  LUT form: on a CUDA device a frame runs as two K2 launches (stage 1,
  stage 2) and one K1 launch (``upscale``) or one K5 launch (``warp``),
  which writes the uint8 frame itself.
* :class:`NetPredictor` (``pipeline.py:194-398,563-601``), the micro-net
  (SRNet) form: two K3 launches (or K4 with ``backend="pallas_int8"``),
  the stage epilogues and one K1 or K5 launch.

On the CPU the same calls run the kernels' plain twins.  PyTorch runs
eagerly, so there is no per-shape program cache: a predictor keeps one
device copy of each shape's resize geometry, and for a few homographies
the warp's parameters (on a card) or host geometry (on the CPU) and its
validity mask.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np
import torch

from .device import resolve_device
from .lut.io import LUTBank
from .models import srnet
from .ops.geometry import ResizeGeometry, WarpGeometry
from .ops.kernels.resize import ResizeOperands, steering_resize
from .ops.kernels.warp import WarpParams, steering_warp
from .ops.lut_pipeline import (FlatTables, divide_exact, lut_stage1,
                               lut_stage1_intermediate, lut_stage2)
from .ops.resample import nearest_warp_mask_host
# the uint8 cast K1 fuses, kept under its old name for callers
from .ops.resample import quantize_device as _quantize_device  # noqa: F401

# Warps a predictor keeps.  At 1440×2560 outputs an entry holds the 3.7 MB
# host mask, and on the CPU ~240 MB of float64 / int32 host geometry for
# the plain twin (on a card K5 takes the matrix and derives the rest), so
# only the most recently used few stay.
WARP_CACHE_SIZE = 4


def _out_dtype(norm: int):
    """K1 writes uint8 itself when the range allows it; otherwise float32,
    which ``_quantize_host`` finishes."""
    return torch.uint8 if norm <= 255 else torch.float32


def _quantize_host(arr, norm):
    """Finish quantization for outputs the device couldn't cast (norm>255)."""
    a = np.asarray(arr)
    if a.dtype == np.uint8:
        return a
    return np.clip(np.round(a), 0, norm).astype(np.uint8)


def _rgb_chw(img_hwc) -> np.ndarray:
    """An [H,W,C] image (or a gray [H,W] one, as three channels) →
    contiguous [C,H,W]."""
    img = np.asarray(img_hwc)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return np.ascontiguousarray(img.transpose(2, 0, 1))


def _lut_input(img_hwc) -> np.ndarray:
    """The LUT form's int32 [C,H,W] input; the stages index the LUT
    lattice with the raw 8-bit values, so they must lie in 0..255."""
    chw = _rgb_chw(img_hwc).astype(np.int32)
    if chw.size and (chw.min() < 0 or chw.max() > 255):
        raise ValueError("image values must lie in 0..255")
    return chw


def _warp_entry(cache: OrderedDict, in_sz, matrix, out_sz, support: int,
                device):
    """(the warp K5 takes, host validity mask) for one (in_sz, homography,
    out_sz), kept in ``cache`` (least recently used first, at most
    :data:`WARP_CACHE_SIZE` entries) under the key JAX gives its warp
    programs (``pipeline.py:1221,1272``).  The warp is :class:`WarpParams`
    on a card (the matrix: K5 derives the geometry itself) and the host
    :class:`WarpGeometry` its plain twin reads on the CPU.  The mask is
    geometry only, computed on the host as ``nearest_warp_mask_host``."""
    if support != 2:
        raise NotImplementedError(
            f"warp with supp_size={support}: K5 and its twin take support 2 "
            "(the deploy configuration); other supports are not ported")
    matrix = np.asarray(matrix, dtype=np.float64)
    key = (tuple(in_sz), matrix.tobytes(), tuple(out_sz))
    if key in cache:
        cache.move_to_end(key)
        return cache[key]
    warp = (WarpParams.create(in_sz, matrix, out_sz) if device.type == "cuda"
            else WarpGeometry.create(in_sz, matrix, out_sz, support=support))
    mask = nearest_warp_mask_host(tuple(in_sz), matrix, tuple(out_sz),
                                  border=4)
    cache[key] = (warp, mask)
    while len(cache) > WARP_CACHE_SIZE:
        cache.popitem(last=False)
    return cache[key]


def _warp_out(feat, hyper, entry, max_sigma, norm):
    """K5 on the stage outputs: uint8 [C,oH,oW] (norm ≤ 255), else float32
    with NaN → 0 for the host to quantize."""
    warp, _ = entry
    out = steering_warp(feat, hyper, warp, max_sigma=max_sigma, norm=norm,
                        out_dtype=_out_dtype(norm))
    return out if out.dtype == torch.uint8 else torch.nan_to_num(out, nan=0.0)


class LutPredictor:
    """Two-stage LUT inference: feature LUTs → hyper LUTs → steerable
    resample, with bit-exact stage arithmetic (eval_lut_sr.py semantics).

    ``device``: ``None`` → ``cuda`` (raises without a card), or ``"cpu"``.
    The bank's int8 tables live on that device as :class:`FlatTables`.
    """

    @classmethod
    def from_config(cls, cfg, **kwargs):
        """Load the LUT bank named by a TestConfig and build the predictor
        on ``cfg.device`` (reference: eval_lut_sr.py:750-775)."""
        from .lut.io import load_lut_bank

        out_c = 1 if cfg.linear else 3
        bank = load_lut_bank(cfg.exp_dir, lut_name=cfg.lut_name,
                             modes=tuple(cfg.modes), modes2=tuple(cfg.modes2),
                             out_c=out_c, interval=cfg.interval,
                             stages=cfg.stages)
        kwargs.setdefault("device", cfg.device)
        return cls(bank, linear=cfg.linear, modes=tuple(cfg.modes),
                   modes2=tuple(cfg.modes2),
                   supp_size=cfg.supp_size, max_sigma=cfg.max_sigma,
                   stages=cfg.stages, norm=cfg.norm, **kwargs)

    def __init__(self, bank: LUTBank, *, linear: bool = False,
                 modes=("s", "c", "t"), modes2=("s", "c", "t"),
                 supp_size: int = 2, max_sigma: float = 10.0,
                 stages: int = 2, norm: int = 255,
                 table_layout: str = "flat", mesh=None, device=None):
        if linear:
            raise NotImplementedError(
                "LeRF-L (linear=True, amplified_linear_resize) is not ported "
                "yet (ROADMAP Queue A item 3)")
        if mesh is not None:
            raise NotImplementedError(
                "multi-device serving (mesh=) is not ported yet "
                "(ROADMAP Queue A item 12)")
        if table_layout != "flat":
            raise NotImplementedError(
                f"table_layout={table_layout!r}: the port has the flat "
                "layout only; packed/cells are ROADMAP Queue A item 2")
        if stages != bank.stages:
            raise ValueError(
                f"stages={stages} but the LUT bank holds {bank.stages} "
                f"stages ({len(bank.inter)} intermediate feature table sets "
                "+ final feature + hyper) — load_lut_bank(stages=...) must "
                "match (eval_lut_sr.py:747-775 loads one table set per "
                "stage)")
        if bank.out_c != 3:
            raise ValueError("the Gaussian (LeRF-G) form needs out_c == 3")
        self.device = resolve_device(device)
        self.bank = bank
        self.modes = tuple(modes)
        self.modes2 = tuple(modes2)
        self.supp_size = supp_size
        self.max_sigma = max_sigma
        self.stages = stages
        self.norm = norm
        self._s1 = FlatTables.create(bank.stage1, self.device)
        self._s2 = FlatTables.create(bank.stage2, self.device)
        self._inter = [FlatTables.create(t, self.device) for t in bank.inter]
        self._resize_cache: Dict = {}
        self._warp_cache: OrderedDict = OrderedDict()

    # -- stages -------------------------------------------------------------

    def _stages_fn(self, img_i32: torch.Tensor):
        """img [C,H,W] int32 → (feat int32 [C,H,W], hyper int32 [C,H,W,oC]).

        Stage loop parity: eval_lut_sr.py:541-577 — each feature stage uses
        its OWN table set; intermediate stages average over modes·4 with a
        +norm//2 bias, the final feature stage over modes with no bias.
        """
        interval = self.bank.interval
        feat = img_i32
        for tables in self._inter:
            feat = lut_stage1_intermediate(feat, tables, self.modes,
                                           interval=interval, norm=self.norm)
        feat = lut_stage1(feat, self._s1, self.modes, interval=interval,
                          norm=self.norm)
        hyper = lut_stage2(feat, self._s2, self.modes2, interval=interval,
                           norm=self.norm)
        return feat, hyper

    # -- SR -----------------------------------------------------------------

    def _resize_fn(self, in_sz: Tuple[int, int], scale: Tuple[float, float]):
        """(geometry, its device operands) for one (in_sz, scale), cached."""
        key = (in_sz, scale)
        if key not in self._resize_cache:
            geom = ResizeGeometry.create(in_sz, scale_factors=list(scale),
                                         support=self.supp_size)
            self._resize_cache[key] = (
                geom, ResizeOperands.create(geom, self.device))
        return self._resize_cache[key]

    def run_device(self, chw: torch.Tensor, scale: Tuple[float, float]):
        """The device part of a frame: int32 [C,H,W] on ``self.device`` →
        (uint8 [C,oH,oW], feat, hyper), all on the device."""
        geom, operands = self._resize_fn(tuple(chw.shape[1:]), scale)
        feat, hyper = self._stages_fn(chw)
        out = steering_resize(feat, hyper, geom, max_sigma=self.max_sigma,
                              norm=self.norm, operands=operands,
                              out_dtype=_out_dtype(self.norm))
        return out, feat, hyper

    def upscale(self, img_hwc: np.ndarray, scale_h: float, scale_w: float,
                return_aux: bool = False):
        """uint8/float [H,W,C] → uint8 [outH,outW,C] (plus feat/hyper)."""
        x = torch.from_numpy(_lut_input(img_hwc)).to(self.device)
        out, feat, hyper = self.run_device(
            x, (float(scale_h), float(scale_w)))
        out_u8 = _quantize_host(out.cpu().numpy(), self.norm).transpose(1, 2, 0)
        if return_aux:
            return out_u8, feat.cpu().numpy(), hyper.cpu().numpy()
        return out_u8

    # -- warp ---------------------------------------------------------------

    def run_warp_device(self, chw: torch.Tensor, matrix: np.ndarray,
                        out_sz: Tuple[int, int]):
        """The device part of a warped frame: int32 [C,H,W] on
        ``self.device`` → (uint8 [C,oH,oW], feat, hyper), all on the
        device: the stages, then K5 in uint8 mode (NaN windows → 0)."""
        entry = _warp_entry(self._warp_cache, tuple(chw.shape[1:]), matrix,
                            tuple(out_sz), self.supp_size, self.device)
        feat, hyper = self._stages_fn(chw)
        return (_warp_out(feat, hyper, entry, self.max_sigma, self.norm),
                feat, hyper)

    def warp(self, img_hwc: np.ndarray, matrix: np.ndarray,
             out_hw: Tuple[int, int], return_aux: bool = False):
        """Homographic warp: uint8/float [H,W,C] → (uint8 [oH,oW,C], bool
        mask [oH,oW]), plus feat and hyper (int32) with ``return_aux``.

        Fully out-of-view support windows (NaN) are zeroed before
        quantization, matching the torch eval path (eval_model.py:261);
        the mask excludes them from mPSNR.  The warp's parameters (or on
        the CPU its host geometry) and the mask are cached per (image
        size, matrix, out size), for the last :data:`WARP_CACHE_SIZE`
        keys."""
        chw = _lut_input(img_hwc)
        out_sz = tuple(int(v) for v in out_hw)
        out, feat, hyper = self.run_warp_device(
            torch.from_numpy(chw).to(self.device), matrix, out_sz)
        mask = _warp_entry(self._warp_cache, chw.shape[1:], matrix, out_sz,
                           self.supp_size, self.device)[1].copy()
        out_u8 = _quantize_host(out.cpu().numpy(), self.norm).transpose(1, 2, 0)
        if return_aux:
            return out_u8, mask, feat.cpu().numpy(), hyper.cpu().numpy()
        return out_u8, mask


def _unported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to lerf_torch yet "
                               f"(ROADMAP Queue A item {item})")


class NetPredictor:
    """Two-stage *network* inference: feature net → hyper net → resample.

    Mirrors ``lerf_tpu.pipeline.NetPredictor``'s static SR path with the
    same public API as :class:`LutPredictor`.  ``stage1_fn(x)`` maps
    [C,H,W] float32 in [0,1] → feature in [0,255] (float);
    ``stage2_fn(x)`` maps [C,H,W] in [0,1] → int32 hyper codes
    [C,H,W,oC] in 0..norm (``lerf_tpu``'s hyper is ``codes / norm``).

    ``device``: ``None`` → ``cuda`` (raises without a card), or ``"cpu"``.
    """

    def __init__(self, stage1_fn, stage2_fn, *, linear: bool = False,
                 two_stage: bool = True, supp_size: int = 2,
                 max_sigma: float = 10.0, norm: int = 255, mesh=None,
                 device=None):
        if linear:
            raise _unported("LeRF-L (linear=True, amplified_linear_resize)",
                            "3")
        if mesh is not None:
            raise _unported("multi-device serving (mesh=)", "12")
        self.device = resolve_device(device)
        self.stage1_fn = stage1_fn
        self.stage2_fn = stage2_fn
        self.two_stage = two_stage
        self.supp_size = supp_size
        self.max_sigma = max_sigma
        self.norm = norm
        self._resize_cache: Dict = {}
        self._warp_cache: OrderedDict = OrderedDict()

    @classmethod
    def from_srnets(cls, params, *, modes=("s", "c", "t"),
                    modes2=("s", "c", "t"), stages: int = 2,
                    linear: bool = False, two_stage: bool = True,
                    supp_size: int = 2, max_sigma: float = 10.0,
                    norm: int = 255, backend: str = "auto", mesh=None,
                    device=None):
        """LeRF-L/G trainable form (SRNetsSWF2 pixel-MLP ensemble).

        ``params``: :func:`lerf_torch.models.srnet.init_lerf_nets` layout
        (float32 tensors on any device).  ``backend``: "auto" / "pallas"
        run K3 (the kernel on a card, its plain twin on the CPU); "xla"
        the plain batched chain; "pallas_int8" (opt-in) K4 on heads
        post-training-quantized here, once, against the 17⁴ deploy
        lattice.  The member heads are stacked on the device once, here.
        Inference only."""
        backend = srnet.resolve_backend(backend)
        dev = resolve_device(device)
        if backend == "pallas_int8":
            params = srnet.quantize_lerf_params(params)
        heads1 = [srnet.prepare_heads(srnet.stage1_heads(params, s, modes),
                                      backend, dev)
                  for s in range(stages - 1)]
        heads2 = srnet.prepare_heads(srnet.stage2_heads(params, modes2),
                                     backend, dev)

        def s1(x):
            return srnet.stage1_from_heads(heads1, x, modes=modes, norm=norm,
                                           backend=backend)

        def s2(x):
            return srnet.stage2_levels(heads2, x, modes2=modes2, norm=norm,
                                       backend=backend).to(torch.int32)

        return cls(s1, s2, linear=linear, two_stage=two_stage,
                   supp_size=supp_size, max_sigma=max_sigma, norm=norm,
                   mesh=mesh, device=dev)

    @classmethod
    def from_imdn(cls, *args, **kwargs):
        raise _unported("the IMDN (LeRF-Net) form, NetPredictor.from_imdn",
                        "8")

    # -- stages -------------------------------------------------------------

    def _stages(self, img_f: torch.Tensor):
        """img [C,H,W] float32 in [0,1] → (feat int32 [C,H,W], hyper codes
        int32 [C,H,W,oC]).  ``two_stage=False`` skips the feature net like
        the reference (eval_model.py:124-129): feat = round(img·norm), the
        hyper net sees the image."""
        if self.two_stage:
            feat = self.stage1_fn(img_f)
            hyper_in = divide_exact(feat, self.norm)
        else:
            feat = torch.round(img_f * self.norm)
            hyper_in = img_f
        return feat.to(torch.int32), self.stage2_fn(hyper_in)

    # -- SR -----------------------------------------------------------------

    def _resize_fn(self, in_sz: Tuple[int, int], scale: Tuple[float, float]):
        """(geometry, its device operands) for one (in_sz, scale), cached."""
        key = (in_sz, scale)
        if key not in self._resize_cache:
            geom = ResizeGeometry.create(in_sz, scale_factors=list(scale),
                                         support=self.supp_size)
            self._resize_cache[key] = (
                geom, ResizeOperands.create(geom, self.device))
        return self._resize_cache[key]

    def run_device(self, img_f: torch.Tensor, scale: Tuple[float, float]):
        """The device part of a frame: float32 [C,H,W] in [0,1] on
        ``self.device`` → (uint8 [C,oH,oW], feat int32 [C,H,W], hyper
        codes int32 [C,H,W,oC]), all on the device."""
        geom, operands = self._resize_fn(tuple(img_f.shape[1:]), scale)
        feat, hyper = self._stages(img_f)
        out = steering_resize(feat, hyper, geom, max_sigma=self.max_sigma,
                              norm=self.norm, operands=operands,
                              out_dtype=_out_dtype(self.norm))
        return out, feat, hyper

    def upscale(self, img_hwc: np.ndarray, scale_h: float, scale_w: float,
                return_aux: bool = False):
        """uint8/float [H,W,C] → uint8 [outH,outW,C]; with ``return_aux``
        also feat (float32 [C,H,W], 0..255) and hyper (float32 [C,H,W,oC]
        in [0,1]), the types ``lerf_tpu`` returns.  Scale 1 on both axes
        skips the nets (eval_model.py:153-154) and returns the image."""
        chw = _rgb_chw(img_hwc).astype(np.float32) / self.norm
        if float(scale_h) == 1.0 and float(scale_w) == 1.0:
            out = np.round(chw * self.norm)
            return np.clip(out, 0, self.norm).astype(np.uint8) \
                .transpose(1, 2, 0)
        out, feat, hyper = self.run_device(
            torch.from_numpy(chw).to(self.device),
            (float(scale_h), float(scale_w)))
        out_u8 = _quantize_host(out.cpu().numpy(), self.norm).transpose(1, 2, 0)
        if return_aux:
            return (out_u8, feat.cpu().numpy().astype(np.float32),
                    divide_exact(hyper.to(torch.float32), self.norm)
                    .cpu().numpy())
        return out_u8

    # -- warp ---------------------------------------------------------------

    def run_warp_device(self, img_f: torch.Tensor, matrix: np.ndarray,
                        out_sz: Tuple[int, int]):
        """The device part of a warped frame: float32 [C,H,W] in [0,1] on
        ``self.device`` → (uint8 [C,oH,oW], feat int32, hyper codes int32),
        all on the device.  The stage codes are integers, so K5 takes them
        as the JAX path's u8 rows do (``hyper_u8 = norm == 255``)."""
        entry = _warp_entry(self._warp_cache, tuple(img_f.shape[1:]), matrix,
                            tuple(out_sz), self.supp_size, self.device)
        feat, hyper = self._stages(img_f)
        return (_warp_out(feat, hyper, entry, self.max_sigma, self.norm),
                feat, hyper)

    def warp(self, img_hwc: np.ndarray, matrix: np.ndarray,
             out_hw: Tuple[int, int], return_aux: bool = False):
        """Homographic warp: uint8/float [H,W,C] → (uint8 [oH,oW,C], bool
        mask [oH,oW]); with ``return_aux`` also feat (float32, 0..255) and
        hyper (float32 in [0,1]), as :meth:`upscale`.  NaN windows → 0;
        geometry cached as :meth:`LutPredictor.warp` caches it."""
        chw = _rgb_chw(img_hwc).astype(np.float32) / self.norm
        out_sz = tuple(int(v) for v in out_hw)
        out, feat, hyper = self.run_warp_device(
            torch.from_numpy(chw).to(self.device), matrix, out_sz)
        mask = _warp_entry(self._warp_cache, chw.shape[1:], matrix, out_sz,
                           self.supp_size, self.device)[1].copy()
        out_u8 = _quantize_host(out.cpu().numpy(), self.norm).transpose(1, 2, 0)
        if return_aux:
            return (out_u8, mask, feat.cpu().numpy().astype(np.float32),
                    divide_exact(hyper.to(torch.float32), self.norm)
                    .cpu().numpy())
        return out_u8, mask

    # -- serving forms not ported yet ----------------------------------------

    def upscale_bucketed(self, *args, **kwargs):
        raise _unported("bucketed net serving (upscale_bucketed)", "6")

    def upscale_dynamic(self, *args, **kwargs):
        raise _unported("dynamic net serving (upscale_dynamic)", "6")

    def upscale_batch(self, *args, **kwargs):
        raise _unported("batched net serving (upscale_batch)", "6")

    def upscale_dynamic_async(self, *args, **kwargs):
        raise _unported("async net serving (upscale_dynamic_async)", "11")

    def warp_dynamic(self, *args, **kwargs):
        raise _unported("dynamic net warp serving (warp_dynamic)", "6")

    def warp_batch(self, *args, **kwargs):
        raise _unported("batched net warp serving (warp_batch)", "6")
