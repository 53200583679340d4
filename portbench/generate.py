"""The one traffic generator: a traffic file's parameters and a seed →
a pool of frames and the requests of a stream.

Frames are made on the device from the seed, in a few large calls, with
the structure of a video frame: a smooth field (a coarse random grid
upsampled bicubically), a dozen straight edges (steps across random
lines) and fine grain.  Requests cycle through the pool in a seeded
order; a warp's homography is drawn afresh for each request: the
traffic's zoom composed with a rotation about the frame's centre, a
translation and a perspective term, each uniform within its ``jitter``.
Every seed gives the same sizes, counts and distributions, in another
order and with other values.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

EDGES = 12          # straight edges a frame
GRID = (9, 16)      # the smooth field's coarse grid (rows, columns)
GRAIN = 4.0         # the fine grain's standard deviation, in levels


def seed64(seed: int) -> int:
    """Any whole number as a generator seed."""
    return int(seed) % (1 << 63)


def child_rng(rng: np.random.Generator) -> np.random.Generator:
    """A generator seeded by one draw of ``rng``."""
    return np.random.default_rng(int(rng.integers(1 << 63)))


def frame_pool(traffic: dict, seed: int, device) -> np.ndarray:
    """uint8 [pool, H, W, 3] on the host, made on ``device``."""
    n, (h, w) = traffic["pool"], traffic["frame_hw"]
    g = torch.Generator(device=device).manual_seed(seed64(seed))
    coarse = torch.rand((n, 3) + GRID, generator=g, device=device) * 200 + 28
    img = F.interpolate(coarse, size=(h, w), mode="bicubic",
                        align_corners=False)
    lines = torch.rand((EDGES, n, 6), generator=g, device=device)
    ys = torch.linspace(-1, 1, h, device=device)[:, None]
    xs = torch.linspace(-1, 1, w, device=device)[None, :]
    for k in range(EDGES):
        theta = lines[k, :, 0] * (2 * math.pi)
        side = (torch.cos(theta)[:, None, None] * xs
                + torch.sin(theta)[:, None, None] * ys
                > (lines[k, :, 1] * 2 - 1)[:, None, None])
        amp = (lines[k, :, 2:5] - 0.5) * 120
        img += side[:, None].float() * amp[:, :, None, None]
    img += torch.randn(img.shape, generator=g, device=device) * GRAIN
    img = img.round_().clamp_(0, 255).to(torch.uint8)
    return img.permute(0, 2, 3, 1).contiguous().cpu().numpy()


def homography(rng: np.random.Generator, traffic: dict) -> np.ndarray:
    """float64 [3, 3]: input (column, row) → output pixel coordinates."""
    h, w = traffic["frame_hw"]
    j = traffic["jitter"]
    u = rng.uniform(-1.0, 1.0, 5)
    a = math.radians(j["rotate_deg"]) * u[0]
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    rot = np.array([[math.cos(a), -math.sin(a), 0.0],
                    [math.sin(a), math.cos(a), 0.0], [0.0, 0.0, 1.0]])
    move = np.array([[1.0, 0.0, cx + j["translate_px"] * u[1]],
                     [0.0, 1.0, cy + j["translate_px"] * u[2]],
                     [j["perspective"] * u[3], j["perspective"] * u[4], 1.0]])
    back = np.array([[1.0, 0.0, -cx], [0.0, 1.0, -cy], [0.0, 0.0, 1.0]])
    zoom = np.diag([traffic["zoom"], traffic["zoom"], 1.0])
    return zoom @ move @ rot @ back


class Stream:
    """One stream's requests: ``(pool index, args of the call)``, in the
    order a seeded permutation of the pool gives, cycled."""

    def __init__(self, traffic: dict, pool: np.ndarray, rng):
        self.traffic = traffic
        self.pool = pool
        self.rng = rng
        self.order = rng.permutation(len(pool))
        self.sent = 0

    def next(self):
        """The next request: (pool index, matrix or ``None``)."""
        i = int(self.order[self.sent % len(self.order)])
        self.sent += 1
        if self.traffic["kind"] == "warp":
            return i, homography(self.rng, self.traffic)
        return i, None
