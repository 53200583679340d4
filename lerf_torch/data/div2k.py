"""DIV2K training data: the host sampler.

The port of ``lerf_tpu/data/div2k.py`` (reference: ``resample/data.py:
15-168``), the same numpy code and the same ``RandomState`` stream, so a
seed gives lerf_tpu's batches bit for bit: whole-dataset npy dict caches
(``cache_hr.npy`` / ``cache_lr_x{scale}.npy``, the reference's format),
random image and aligned random crop, optional single channel (inC 1),
flips and rot90, /255, optional Gaussian noise.  A sampler thread keeps a
few batches ready (:class:`Provider`); with ``pin_memory`` it hands them
out as pinned tensors, so the copy to the card is asynchronous.  Batches
are [B, C, h, w] float32 in [0, 1].
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch


def _load_image_dict(folder: str, file_list,
                     suffix: str) -> Dict[str, np.ndarray]:
    from PIL import Image
    out = {}
    for f in file_list:
        out[f] = np.array(Image.open(os.path.join(folder, f + suffix)))
    return out


def rng_state_tensors(rng: np.random.RandomState) -> Dict:
    """A ``RandomState``'s state as tensors and numbers (a checkpoint
    loads them without unpickling numpy)."""
    _, keys, pos, has_gauss, cached = rng.get_state()
    return {"keys": torch.from_numpy(keys.astype(np.int64)), "pos": int(pos),
            "has_gauss": int(has_gauss), "cached_gaussian": float(cached)}


def set_rng_state(rng: np.random.RandomState, state: Dict):
    """The inverse of :func:`rng_state_tensors`."""
    rng.set_state(("MT19937", state["keys"].numpy().astype(np.uint32),
                   state["pos"], state["has_gauss"], state["cached_gaussian"]))


class DIV2K:
    """Random-crop sampler over the DIV2K 800-image train split."""

    def __init__(self, path: str, scale, crop_size: int = 48,
                 nsigma: float = -1, in_c: int = 1, rigid_aug: bool = True,
                 seed: int = 0, file_list: Optional[Sequence[str]] = None):
        self.scale = scale
        self.sz = crop_size
        self.nsigma = nsigma
        self.in_c = in_c
        self.rigid_aug = rigid_aug
        self.rng = np.random.RandomState(seed)
        if file_list is not None:
            self.file_list = list(file_list)
        else:
            # standard DIV2K train split (data.py:63-64); autodiscover for
            # non-standard layouts
            self.file_list = [str(i).zfill(4) for i in range(1, 801)]
            probe = os.path.join(path, "HR", self.file_list[-1] + ".png")
            if not os.path.exists(probe):
                hr_dir = os.path.join(path, "HR")
                self.file_list = sorted(
                    f[:-4] for f in os.listdir(hr_dir) if f.endswith(".png"))

        hr_cache = os.path.join(path, "cache_hr.npy")
        if not os.path.exists(hr_cache):
            np.save(hr_cache, _load_image_dict(
                os.path.join(path, "HR"), self.file_list, ".png"),
                allow_pickle=True)
        self.hr_ims = np.load(hr_cache, allow_pickle=True).item()

        lr_cache = os.path.join(path, f"cache_lr_x{scale}.npy")
        if not os.path.exists(lr_cache):
            np.save(lr_cache, _load_image_dict(
                os.path.join(path, "LR", f"X{scale}"), self.file_list,
                f"x{scale}.png"), allow_pickle=True)
        self.lr_ims = np.load(lr_cache, allow_pickle=True).item()

    def sample(self) -> Tuple[np.ndarray, np.ndarray]:
        """One (im, lb) pair: [C, sz, sz] / [C, sz·scale, sz·scale] in
        [0, 1]."""
        r = self.rng
        key = self.file_list[r.randint(len(self.file_list))]
        lb = self.hr_ims[key]
        im = self.lr_ims[key]

        sh = im.shape
        i = r.randint(0, sh[0] - self.sz + 1)
        j = r.randint(0, sh[1] - self.sz + 1)
        s = self.scale
        lb = lb[int(i * s):int(i * s) + int(self.sz * s),
                int(j * s):int(j * s) + int(self.sz * s), :]
        im = im[i:i + self.sz, j:j + self.sz, :]

        if self.in_c == 1:
            c = r.randint(3)
            im, lb = im[:, :, c], lb[:, :, c]

        if self.rigid_aug:
            if r.uniform() < 0.5:
                lb, im = np.fliplr(lb), np.fliplr(im)
            if r.uniform() < 0.5:
                lb, im = np.flipud(lb), np.flipud(im)
            k = r.randint(4)
            lb, im = np.rot90(lb, k), np.rot90(im, k)

        lb = lb.astype(np.float32) / 255.0
        im = im.astype(np.float32) / 255.0
        if self.in_c == 1:
            lb, im = lb[None], im[None]
        else:
            lb, im = lb.transpose(2, 0, 1), im.transpose(2, 0, 1)

        if self.nsigma == 0:       # blind noise up to 25/255 like MuLUT
            level = r.uniform(0, 25)
            im = im + r.normal(0, level / 255.0, im.shape).astype(np.float32)
        elif self.nsigma > 0:
            im = im + r.normal(0, self.nsigma / 255.0,
                               im.shape).astype(np.float32)
        return im, lb

    def batch(self, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
        ims, lbs = zip(*(self.sample() for _ in range(batch_size)))
        return np.ascontiguousarray(np.stack(ims)), \
            np.ascontiguousarray(np.stack(lbs))


class Provider:
    """Infinite prefetching batch iterator (reference data.py:15-51).

    A daemon thread keeps ``prefetch`` batches ready.  ``next()`` returns
    numpy arrays, or with ``pin_memory`` pinned CPU tensors (pinned in the
    thread) for an asynchronous copy to the card.  ``rng_state`` is the
    sampler's state after the last batch handed out: a checkpoint keeps
    it, and a resumed run that sets it draws the batches an uninterrupted
    run would have.
    """

    def __init__(self, dataset: DIV2K, batch_size: int, prefetch: int = 4,
                 pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.pin_memory = pin_memory
        self.rng_state = rng_state_tensors(dataset.rng)
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            while not self._stop.is_set():
                im, lb = self.dataset.batch(self.batch_size)
                state = rng_state_tensors(self.dataset.rng)
                if self.pin_memory:
                    im = torch.from_numpy(im).pin_memory()
                    lb = torch.from_numpy(lb).pin_memory()
                self._put((im, lb, state))
        except Exception as e:          # the consumer raises it
            self._put(e)

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def next(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise RuntimeError("the batch sampler thread failed") from item
        im, lb, self.rng_state = item
        return im, lb

    def close(self):
        self._stop.set()
        self._thread.join()

    def __iter__(self) -> Iterator:
        while True:
            yield self.next()
