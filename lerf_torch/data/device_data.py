"""Training data kept on the device, sampled and augmented there.

The port of ``lerf_tpu/data/device_data.py``: the training set lives on
the device as uint8 stacks, and each batch is drawn there from a
``torch.Generator`` on that device — image choice, aligned random crop,
channel pick (inC 1), flips and rot90 — so the host does nothing per
step.  The distribution is lerf_tpu's (and the host sampler's, reference
data.py:107-165); the random stream is torch's, not JAX's, so the two
packages draw different batches from one seed.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.lut_pipeline import divide_exact


def tile_images(lr_images, hr_images, scale: int, tile: int):
    """Pre-tile images of different sizes into fixed-size crop pairs.

    Covers each LR image with a grid of ``tile``×``tile`` crops (the last
    row and column edge-aligned, so edges are covered with a slight
    overlap) and the aligned ×scale HR crops, so the stacks are dense.  An
    image contributes ~area/tile² tiles: image choice becomes
    area-weighted (the reference's is image-uniform, data.py:117); crop
    positions stay uniform over content.
    """
    lrs, hrs = [], []
    for lr, hr in zip(lr_images, hr_images):
        h, w = lr.shape[:2]
        if h < tile or w < tile:
            raise ValueError(f"image {h}x{w} smaller than tile {tile}")
        if hr.shape[:2] != (h * scale, w * scale):
            # a short HR would make the edge-aligned tiles' labels come up
            # short and stack as silent zero padding
            raise ValueError(
                f"HR shape {hr.shape[:2]} != LR {h}x{w} × scale {scale}")
        starts_i = list(range(0, h - tile, tile)) + [h - tile]
        starts_j = list(range(0, w - tile, tile)) + [w - tile]
        for i in starts_i:
            for j in starts_j:
                lrs.append(lr[i:i + tile, j:j + tile])
                hrs.append(hr[i * scale:(i + tile) * scale,
                              j * scale:(j + tile) * scale])
    return lrs, hrs


class DeviceDataset:
    """uint8 LR / HR stacks padded to a common shape, on ``device``.

    Images of different sizes are padded to the largest (each image's
    valid crop range is kept); for DIV2K-scale sets pass ``tile=``
    (:func:`tile_images`) so the stacks are dense.  ``hbm_bytes`` is the
    stacks' size on the device.  ``device``: ``None`` → ``cuda`` (raises
    without a card), or ``"cpu"``.
    """

    def __init__(self, lr_images, hr_images, scale: int, crop_size: int,
                 in_c: int = 1, tile: int = 0, device=None):
        if tile:
            if tile < crop_size:
                raise ValueError(f"tile {tile} < crop_size {crop_size}")
            lr_images, hr_images = tile_images(lr_images, hr_images,
                                               int(scale), tile)
        if len(lr_images) != len(hr_images):
            raise ValueError("as many HR images as LR images")
        device = resolve_device(device)
        self.scale = int(scale)
        self.crop = crop_size
        self.in_c = in_c
        n = len(lr_images)
        lh = max(im.shape[0] for im in lr_images)
        lw = max(im.shape[1] for im in lr_images)
        lr_stack = np.zeros((n, lh, lw, 3), np.uint8)
        hr_stack = np.zeros((n, lh * self.scale, lw * self.scale, 3),
                            np.uint8)
        max_hw = np.zeros((n, 2), np.int64)
        for i, (lr, hr) in enumerate(zip(lr_images, hr_images)):
            h, w = lr.shape[:2]
            lr_stack[i, :h, :w] = lr
            hr_stack[i, :h * self.scale, :w * self.scale] = \
                hr[:h * self.scale, :w * self.scale]
            max_hw[i] = (h - crop_size, w - crop_size)
        self.lr = torch.from_numpy(lr_stack).to(device)
        self.hr = torch.from_numpy(hr_stack).to(device)
        self.max_hw = torch.from_numpy(max_hw).to(device)

    @property
    def device(self) -> torch.device:
        return self.lr.device

    @property
    def hbm_bytes(self) -> int:
        """The image stacks' bytes on the device."""
        return int(self.lr.nbytes + self.hr.nbytes)

    @classmethod
    def from_div2k(cls, dataset, **kw):
        """From a host :class:`~lerf_torch.data.div2k.DIV2K` (its npy
        caches)."""
        lrs = [dataset.lr_ims[k] for k in dataset.file_list]
        hrs = [dataset.hr_ims[k] for k in dataset.file_list]
        return cls(lrs, hrs, int(dataset.scale), dataset.sz,
                   in_c=dataset.in_c, **kw)

    def sample_batch(self, generator: torch.Generator, batch_size: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(im, lb) float32 [B, C, sz, sz] / [B, C, sz·s, sz·s] in [0, 1],
        drawn on the device from ``generator`` (a generator of that
        device)."""
        dev, n, sz, s = self.device, self.lr.shape[0], self.crop, self.scale

        def randint(high, size=(batch_size,)):
            return torch.randint(0, high, size, generator=generator,
                                 device=dev)

        idx = randint(n)
        i = randint(1 << 30) % (self.max_hw[idx, 0] + 1)
        j = randint(1 << 30) % (self.max_hw[idx, 1] + 1)
        b = idx[:, None, None]

        def crop(stack, top, left, size):
            ar = torch.arange(size, device=dev)
            return stack[b, (top[:, None] + ar)[:, :, None],
                         (left[:, None] + ar)[:, None, :]]

        im = crop(self.lr, i, j, sz)                   # [B, sz, sz, 3]
        lb = crop(self.hr, i * s, j * s, sz * s)
        if self.in_c == 1:
            c = randint(3)[:, None, None, None]
            im = im.gather(-1, c.expand(-1, sz, sz, 1))
            lb = lb.gather(-1, c.expand(-1, sz * s, sz * s, 1))

        def where(flag, a, b_):
            return torch.where(flag[:, None, None, None], a, b_)

        f1 = torch.rand(batch_size, generator=generator, device=dev) < 0.5
        f2 = torch.rand(batch_size, generator=generator, device=dev) < 0.5
        rot = randint(4)
        out = []
        for x in (im, lb):
            x = where(f1, x.flip(2), x)                # left-right
            x = where(f2, x.flip(1), x)                # up-down
            turns = torch.stack([torch.rot90(x, k, dims=(1, 2))
                                 for k in range(4)])
            x = turns[rot, torch.arange(batch_size, device=dev)]
            out.append(divide_exact(x.permute(0, 3, 1, 2).to(torch.float32),
                                    255))
        return out[0].contiguous(), out[1].contiguous()
