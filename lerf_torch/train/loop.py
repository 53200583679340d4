"""The LeRF training loop (network form and LUT fine-tuning).

The port of ``lerf_tpu/train/loop.py`` (reference:
``resample/train_model.py:318-500``): the step of
:mod:`lerf_torch.train.train_step`, on one device or, with ``data_axis``
beyond one device, data-parallel over a mesh of them (the batch split
across the shards, the state on the first device, where checkpoints read
it); on the host the data sampler thread
(or the dataset on the device), logging (``train.log`` and
``scalars.jsonl``), checkpoints, Set5 SR / warp validation through the
port's predictors, the final LUT export of ``--lutft`` runs, the
clamp-saturation auto-reseed and a ``torch.profiler`` window.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from functools import partial
from typing import Any, Callable, Dict, Optional

import torch

from ..config import TrainConfig
from ..data.div2k import DIV2K, Provider, set_rng_state
from ..device import resolve_device
from ..evaluate import run_sr_benchmark, run_warp_benchmark
from ..lut.io import load_lut_bank, save_lut_bank
from ..models import srnet
from . import lutft
from .checkpoint import CheckpointManager, host_params
from .train_step import (TrainHParams, TrainState, make_train_step,
                         param_leaves, train_geometry)


def setup_logger(exp_dir: str, name: str = "train") -> logging.Logger:
    """File + stream logger (reference common/utils.py:8-28)."""
    logger = logging.getLogger(f"lerf_torch.{name}.{exp_dir}")
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        fmt = logging.Formatter("%(asctime)s - %(message)s")
        fh = logging.FileHandler(os.path.join(exp_dir, f"{name}.log"))
        fh.setFormatter(fmt)
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(fh)
        logger.addHandler(sh)
    return logger


class ScalarWriter:
    """Scalar log, one JSON line a point (``scalars.jsonl``), and TensorBoard
    event files when ``torch.utils.tensorboard`` imports (the
    ``tensorboard`` package), both with the reference's SummaryWriter tags
    (loss_Pixel, PSNR_X{s}/{ds}, SSIM_X{s}/{ds}, mPSNR_{isc,osc}/{ds};
    train_model.py:173-176,310-312,453-454), as lerf_tpu's writer does."""

    def __init__(self, exp_dir: str):
        self._f = open(os.path.join(exp_dir, "scalars.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(exp_dir)

    def add_scalar(self, tag: str, value: float, step: int):
        self._f.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def hparams_from_config(cfg: TrainConfig) -> TrainHParams:
    return TrainHParams(
        scale=float(cfg.scale_value), crop_size=cfg.crop_size,
        norm=cfg.norm, max_sigma=float(cfg.max_sigma),
        supp_size=cfg.supp_size, linear=cfg.linear,
        two_stage=cfg.two_stage, stages=cfg.stages,
        modes=tuple(cfg.modes), modes2=tuple(cfg.modes2),
        feat_c=cfg.feat_c, lr0=cfg.lr0, lr1=cfg.lr1,
        weight_decay=cfg.weight_decay, total_iter=cfg.total_iter)


@dataclasses.dataclass
class ModelAdapter:
    """Plugs a trainable model family into the generic loop."""
    init_params: Callable[[torch.Generator], Any]   # on the device
    stage1_fn: Optional[Callable]       # (params, x) -> feat in [0, 255]
    stage2_fn: Optional[Callable]       # (params, x) -> hyper [..., oC]
    make_predictor: Callable[[Any], Any]
    finalize: Callable[[Any, TrainConfig], None]


def srnets_adapter(cfg: TrainConfig, hp: TrainHParams,
                   device) -> ModelAdapter:
    """The SRNetsSWF2 pixel-MLP ensemble (the default)."""
    from ..pipeline import NetPredictor

    def init(generator):
        params = srnet.init_lerf_nets(
            generator, modes=hp.modes, modes2=hp.modes2, nf=cfg.nf,
            out_c=cfg.out_c, stages=cfg.stages)
        return {sk: {name: {k: v.to(device) for k, v in head.items()}
                     for name, head in heads.items()}
                for sk, heads in params.items()}

    def predictor(params):
        params = {sk: {name: {k: v.detach() for k, v in head.items()}
                       for name, head in heads.items()}
                  for sk, heads in params.items()}
        return NetPredictor.from_srnets(
            params, modes=hp.modes, modes2=hp.modes2, stages=hp.stages,
            linear=hp.linear, two_stage=hp.two_stage,
            supp_size=hp.supp_size, max_sigma=hp.max_sigma, norm=hp.norm,
            device=device)

    return ModelAdapter(init_params=init, stage1_fn=None, stage2_fn=None,
                        make_predictor=predictor,
                        finalize=lambda params, cfg: None)


def imdn_stage_fns(out_c: int, in_c: int):
    """The IMDN2 stages on NCHW batches: ``s1(model, x)`` [B, C, h, w] →
    feature [B, C, h, w]; ``s2(model, x)`` → hyper [B, C, h, w, oC] (the
    tower's channel o·C + c to the trailing axis)."""
    def s1(model, x):
        return model(x, 1)

    def s2(model, x):
        y = model(x, 2)                          # [B, oC·C, h, w]
        b, _, h, w = y.shape
        return y.reshape(b, out_c, in_c, h, w).permute(0, 2, 3, 4, 1)

    return s1, s2


def imdn_adapter(cfg: TrainConfig, hp: TrainHParams, device) -> ModelAdapter:
    """LeRF-Net / LeRF-Net++ (IMDN2, inC 3) as an ``nn.Module``, trained
    through the same steerable-resize objective (train_model.py:336-338
    with --model IMDN2)."""
    from ..models.imdn import IMDN2, init_imdn
    from ..pipeline import NetPredictor

    def init(generator):
        return init_imdn(IMDN2(in_c=cfg.in_c, out_c=cfg.out_c, nf=cfg.nf,
                               norm=cfg.norm), generator).to(device)

    def predictor(model):
        return NetPredictor.from_imdn(
            model, out_c=cfg.out_c, linear=hp.linear,
            two_stage=hp.two_stage, supp_size=hp.supp_size,
            max_sigma=hp.max_sigma, norm=hp.norm, device=device)

    s1, s2 = imdn_stage_fns(cfg.out_c, cfg.in_c)
    return ModelAdapter(init_params=init, stage1_fn=s1, stage2_fn=s2,
                        make_predictor=predictor,
                        finalize=lambda params, cfg: None)


def lutft_adapter(cfg: TrainConfig, hp: TrainHParams,
                  device) -> ModelAdapter:
    """LUT fine-tuning: the tables of ``{exp_dir}/LUT_*.npy`` become the
    trainable params; validation serves their int8 requantization through
    ``LutPredictor`` (K2 + K1 on a card), and ``finalize`` writes it as
    ``LUTft_*.npy``."""
    from ..pipeline import LutPredictor

    bank = load_lut_bank(cfg.exp_dir, lut_name="LUT",
                         modes=tuple(cfg.modes), modes2=tuple(cfg.modes2),
                         out_c=cfg.out_c, interval=cfg.interval)
    s1 = partial(lutft.predict_stage1, modes=hp.modes, stages=hp.stages,
                 norm=hp.norm, interval=cfg.interval)
    s2 = partial(lutft.predict_stage2, modes2=hp.modes2, norm=hp.norm,
                 interval=cfg.interval)

    def predictor(params):
        return LutPredictor(
            lutft.bank_from_params(params, cfg.out_c, cfg.interval),
            linear=hp.linear, modes=hp.modes, modes2=hp.modes2,
            supp_size=hp.supp_size, max_sigma=hp.max_sigma, norm=hp.norm,
            device=device)

    def finalize(params, cfg):
        save_lut_bank(lutft.bank_from_params(params, cfg.out_c,
                                             cfg.interval),
                      cfg.exp_dir, lut_name="LUTft",
                      keep_trailing_dims=False)

    return ModelAdapter(
        init_params=lambda generator: lutft.params_from_bank(bank, device),
        stage1_fn=s1, stage2_fn=s2, make_predictor=predictor,
        finalize=finalize)


def validate(predictor, cfg: TrainConfig, logger, writer: ScalarWriter,
             step: int, datasets=("Set5",)):
    """Set5 SR (×2/3/4) + warp (isc / osc) validation, logged like the
    reference's valid_steps / valid_steps_warp scalars
    (train_model.py:173-176,310-312); images go under
    ``{expDir}/val/{step}``.  Returns {tag: value}."""
    scales = [(2, 2), (3, 3), (4, 4)]
    val_root = os.path.join(cfg.exp_dir, "val", f"{step:06d}")
    out = {}
    for ds in datasets:
        if os.path.isdir(os.path.join(cfg.val_dir, ds, "HR")):
            res = run_sr_benchmark(predictor, cfg.val_dir, ds, scales,
                                   result_root=val_root, exp_name="sr")
            for (sh, _), (p, s) in res.items():
                logger.info(f"Iter {step} | {ds} X{sh} PSNR: {p:.2f} "
                            f"SSIM: {s:.4f}")
                out[f"PSNR_X{sh}/{ds}"], out[f"SSIM_X{sh}/{ds}"] = p, s
        if os.path.isdir(os.path.join(cfg.val_w_dir, ds, "HR")):
            resw = run_warp_benchmark(predictor, cfg.val_w_dir, ds,
                                      result_root=val_root, exp_name="warp")
            for sp, p in resw.items():
                logger.info(f"Iter {step} | {ds} {sp} mPSNR: {p:.2f}")
                out[f"mPSNR_{sp}/{ds}"] = p
    for tag, value in out.items():
        writer.add_scalar(tag, value, step)
    return out


def checkpoint_state(state: TrainState, data: Dict) -> Dict:
    """What a checkpoint holds: params on the host, Adam's and the
    scheduler's state dicts, the step and the data generators' states."""
    return {"params": host_params(state.params),
            "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict(),
            "step": state.step, "data": data}


def load_checkpoint_state(state: TrainState, saved: Dict):
    """Restore :func:`checkpoint_state` into ``state`` in place (the
    optimizer keeps its parameters)."""
    if isinstance(state.params, torch.nn.Module):
        state.params.load_state_dict(saved["params"])
    else:
        flat = param_leaves(saved["params"])
        with torch.no_grad():
            for name, p in param_leaves(state.params).items():
                p.copy_(flat[name])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.scheduler.load_state_dict(saved["scheduler"])
    state.step = int(saved["step"])


def to_device(x, device) -> torch.Tensor:
    """A host batch (numpy, or a pinned tensor from the provider) on
    ``device``; a pinned one copies asynchronously."""
    t = torch.as_tensor(x)
    return t.to(device, non_blocking=t.is_pinned())


def train(cfg: TrainConfig, adapter: Optional[ModelAdapter] = None) -> Any:
    """Run the training job on ``cfg.device``; returns the final params
    on the host (a nested dict of tensors, or IMDN2's state dict)."""
    cfg.apply_debug()
    devices = cfg.train_devices()
    mesh = None
    if len(devices) > 1:
        from ..parallel import make_mesh
        mesh = make_mesh(devices=devices)
        if cfg.batch_size % mesh.size:
            raise ValueError(f"batch {cfg.batch_size} % devices "
                             f"{mesh.size} != 0")
    cfg.resolve_exp_dir()
    cfg.save()
    cfg.snapshot_code()
    dev = resolve_device(devices[0])
    logger = setup_logger(cfg.exp_dir, "lutft" if cfg.lutft else "train")
    writer = ScalarWriter(cfg.exp_dir)
    hp = hparams_from_config(cfg)
    if adapter is None:
        if cfg.lutft:
            adapter = lutft_adapter(cfg, hp, dev)
        elif cfg.model == "IMDN2":
            adapter = imdn_adapter(cfg, hp, dev)
        else:
            adapter = srnets_adapter(cfg, hp, dev)
    logger.info(f"device: {dev}"
                + (f" ({torch.cuda.get_device_name(dev)})"
                   if dev.type == "cuda" else "")
                + (f", mesh: {mesh.size} × {dev.type}" if mesh else ""))

    state = TrainState.create(
        adapter.init_params(torch.Generator().manual_seed(cfg.seed)), hp)
    ckpt = CheckpointManager(cfg.exp_dir, keep=cfg.keep_checkpoints)
    dataset = DIV2K(cfg.train_dir, cfg.scale_value, cfg.crop_size,
                    nsigma=cfg.nsigma, in_c=cfg.in_c, seed=cfg.seed)
    data_gen = None
    if cfg.device_data:
        data_gen = torch.Generator(device=dev).manual_seed(cfg.seed + 17)
    if cfg.start_iter > 0:
        saved = ckpt.restore(cfg.start_iter)
        load_checkpoint_state(state, saved)
        if data_gen is not None:
            data_gen.set_state(saved["data"]["device"])
        else:
            set_rng_state(dataset.rng, saved["data"]["host"])
        logger.info(f"restored step {cfg.start_iter}")

    step_fn = make_train_step(train_geometry(hp), hp,
                              stage1_fn=adapter.stage1_fn,
                              stage2_fn=adapter.stage2_fn, device=dev,
                              mesh=mesh)
    device_ds = provider = None
    if cfg.device_data:
        from ..data.device_data import DeviceDataset
        device_ds = DeviceDataset.from_div2k(dataset, device=dev)
        logger.info(f"dataset on the device: {device_ds.hbm_bytes / 1e6:.0f}"
                    " MB of uint8 LR + HR")
    else:
        provider = Provider(dataset, cfg.batch_size,
                            pin_memory=dev.type == "cuda")

    def data_state():
        if data_gen is not None:
            return {"device": data_gen.get_state()}
        return {"host": provider.rng_state}

    # the profiling window (the reference has only wall-clock dT / rT)
    prof_start = cfg.start_iter + 10 if cfg.profile_steps > 0 else -1
    prof_stop = prof_start + cfg.profile_steps
    prof = None

    # dead-run guard: the LeRF objective has a clamp-saturation trap (all
    # predictions pinned at 0/255 → zero gradients, stuck for good),
    # detected as a high loss with a ~zero gradient norm early on; the run
    # restarts from the next seed (--auto_reseed 0 turns it off)
    reseed_left = cfg.auto_reseed if cfg.start_iter == 0 else 0
    reseed_check = cfg.start_iter + max(2 * cfg.display_step, 50)
    next_seed = cfg.seed + 1

    dT, rT = 0.0, 0.0
    i = cfg.start_iter
    try:
        while i < cfg.total_iter:
            i += 1
            if i == prof_start:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    *([torch.profiler.ProfilerActivity.CUDA]
                      if dev.type == "cuda" else [])])
                prof.start()
            st = time.time()
            if device_ds is not None:
                im, lb = device_ds.sample_batch(data_gen, cfg.batch_size)
            else:
                im, lb = (to_device(a, dev) for a in provider.next())
            dT += time.time() - st

            st = time.time()
            state, metrics = step_fn(state, im, lb)
            if i % cfg.display_step == 0:
                metrics["loss"].item()
            rT += time.time() - st

            if i == prof_stop:
                prof.stop()
                os.makedirs(os.path.join(cfg.exp_dir, "profile"),
                            exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(cfg.exp_dir, "profile", "trace.json"))
                prof = None
                logger.info(f"profile trace written to {cfg.exp_dir}/profile")

            if i == reseed_check and reseed_left > 0:
                lval = float(metrics["loss"])
                gn = float(metrics["grad_norm"])
                if lval > 0.15 and gn < 1e-3:
                    logger.warning(
                        f"dead run at iter {i} (loss {lval:.3f}, grad_norm "
                        f"{gn:.2e}): clamp-saturation trap — reinitializing "
                        f"with seed {next_seed}")
                    state = TrainState.create(adapter.init_params(
                        torch.Generator().manual_seed(next_seed)), hp)
                    next_seed += 1
                    reseed_left -= 1
                    i = cfg.start_iter
                    continue

            if i % cfg.display_step == 0:
                lval = float(metrics["loss"])
                gn = float(metrics["grad_norm"])
                writer.add_scalar("loss_Pixel", lval, i)
                writer.add_scalar("grad_norm", gn, i)
                logger.info(
                    f"{cfg.exp_dir} | Iter:{i:6d}, GPixel:{lval:.2e}, "
                    f"gNorm:{gn:.2e}, dT:{dT / cfg.display_step:.4f}, "
                    f"rT:{rT / cfg.display_step:.4f}")
                dT, rT = 0.0, 0.0

            if i % cfg.save_step == 0 and not cfg.lutft:
                ckpt.save(i, checkpoint_state(state, data_state()))
                logger.info(f"Checkpoint saved {i}")

            if i % cfg.val_step == 0 or (cfg.debug and i == 1):
                validate(adapter.make_predictor(state.params), cfg, logger,
                         writer, i)
        final = host_params(state.params)
        adapter.finalize(final, cfg)
        logger.info("Complete")
    finally:
        if prof is not None:
            prof.stop()
        if provider is not None:
            provider.close()
        writer.close()
        ckpt.close()
        for handler in logger.handlers[:]:
            handler.close()
            logger.removeHandler(handler)
    return final
