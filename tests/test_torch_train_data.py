"""The training data pipeline: the host sampler (lerf_torch.data.div2k)
against lerf_tpu's, and the dataset on the device
(lerf_torch.data.device_data), as tests/test_device_data.py holds
lerf_tpu's.

The host sampler is the same numpy code on the same ``RandomState``
stream: its batches are bit-equal to lerf_tpu's for one seed.  The device
dataset draws from a ``torch.Generator``, whose stream is not JAX's, so
it is held to the same distribution and alignment rules as lerf_tpu's,
not to its values.  Torch runs on one thread (``one_torch_thread``).
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from lerf_tpu.data.div2k import DIV2K as JaxDIV2K

from lerf_torch.data.device_data import DeviceDataset, tile_images
from lerf_torch.data.div2k import (DIV2K, Provider, rng_state_tensors,
                                   set_rng_state)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """See tests/test_torch_train.py: torch on one thread for the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_div2k(root, n=3, seed=0, scale=4):
    """A DIV2K layout of random images: HR/{f}.png, LR/X{s}/{f}x{s}.png
    (LR = the HR decimated)."""
    rng = np.random.RandomState(seed)
    os.makedirs(root / "HR")
    os.makedirs(root / "LR" / f"X{scale}")
    for i in range(n):
        f = f"{i + 1:04d}"
        hr = rng.randint(0, 256, (48 + 8 * i, 64, 3), dtype=np.uint8)
        Image.fromarray(hr).save(root / "HR" / f"{f}.png")
        Image.fromarray(hr[::scale, ::scale]).save(
            root / "LR" / f"X{scale}" / f"{f}x{scale}.png")
    return root


@pytest.fixture(scope="module")
def div2k(tmp_path_factory):
    return write_div2k(tmp_path_factory.mktemp("div2k"))


@pytest.mark.parametrize("in_c,nsigma,aug", [(1, -1, True), (3, -1, True),
                                             (1, 0, True), (3, 5.0, False)])
def test_div2k_batches_bit_equal_to_lerf_tpu(div2k, in_c, nsigma, aug):
    kw = dict(crop_size=6, nsigma=nsigma, in_c=in_c, rigid_aug=aug, seed=3)
    got = DIV2K(str(div2k), 4, **kw)
    want = JaxDIV2K(str(div2k), 4, **kw)
    assert got.file_list == want.file_list == ["0001", "0002", "0003"]
    for _ in range(3):
        (gi, gl), (wi, wl) = got.batch(5), want.batch(5)
        assert gi.dtype == np.float32 and gi.shape == (5, in_c, 6, 6)
        assert gl.shape == (5, in_c, 24, 24)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_provider_hands_out_the_sampler_stream_and_its_state(div2k):
    """The provider's batches are the sampler's in order; its
    ``rng_state`` after batch k, set on a new sampler, gives batch k+1."""
    ref = DIV2K(str(div2k), 4, crop_size=6, seed=5)
    want = [ref.batch(4) for _ in range(4)]
    ds = DIV2K(str(div2k), 4, crop_size=6, seed=5)
    prov = Provider(ds, 4, prefetch=2)
    try:
        for k in range(2):
            im, lb = prov.next()
            np.testing.assert_array_equal(im, want[k][0])
            np.testing.assert_array_equal(lb, want[k][1])
        state = prov.rng_state
    finally:
        prov.close()
    resumed = DIV2K(str(div2k), 4, crop_size=6, seed=99)
    set_rng_state(resumed.rng, state)
    for k in (2, 3):
        im, lb = resumed.batch(4)
        np.testing.assert_array_equal(im, want[k][0])
    assert rng_state_tensors(resumed.rng)["pos"] == \
        rng_state_tensors(ref.rng)["pos"]


def make_images(n=3, seed=0):
    rng = np.random.RandomState(seed)
    lrs, hrs = [], []
    for i in range(n):
        h, w = 16 + 4 * i, 20 + 4 * i
        lrs.append(rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
        hrs.append(rng.randint(0, 256, (h * 4, w * 4, 3), dtype=np.uint8))
    return lrs, hrs


def nearest_pairs(n=3, seed=0):
    """LR images and their ×4 nearest-neighbour HR: an aligned HR crop
    decimated by 4 is the LR crop, under any flip or rotation too."""
    lrs, _ = make_images(n, seed)
    return lrs, [lr.repeat(4, 0).repeat(4, 1) for lr in lrs]


def test_sample_shapes_and_alignment():
    lrs, hrs = nearest_pairs()
    ds = DeviceDataset(lrs, hrs, scale=4, crop_size=8, in_c=1,
                       device="cpu")
    im, lb = ds.sample_batch(torch.Generator().manual_seed(0), 32)
    assert im.shape == (32, 1, 8, 8) and lb.shape == (32, 1, 32, 32)
    assert im.dtype == torch.float32
    assert float(im.min()) >= 0 and float(im.max()) <= 1
    # crop, channel and augmentation aligned between LR and HR
    assert torch.equal(lb[..., ::4, ::4], im)

    # crops come from valid (unpadded) regions of one image: with a
    # constant image per index, a crop's pixels name its image
    lrs2 = [np.full((12, 12, 3), v, np.uint8) for v in (10, 100, 200)]
    hrs2 = [np.full((48, 48, 3), v, np.uint8) for v in (10, 100, 200)]
    ds2 = DeviceDataset(lrs2, hrs2, scale=4, crop_size=8, in_c=1,
                        device="cpu")
    im2, lb2 = ds2.sample_batch(torch.Generator().manual_seed(1), 16)
    vals = np.unique(np.round(im2.numpy() * 255))
    assert set(vals.tolist()) <= {10.0, 100.0, 200.0}
    for x in (im2, lb2):
        assert bool((x == x[:, :1, :1, :1]).all())
    assert torch.equal(im2[:, 0, 0, 0], lb2[:, 0, 0, 0])


def test_rgb_mode_and_generator_determinism():
    lrs, hrs = nearest_pairs(seed=2)
    ds = DeviceDataset(lrs, hrs, scale=4, crop_size=8, in_c=3,
                       device="cpu")
    a = ds.sample_batch(torch.Generator().manual_seed(2), 4)
    b = ds.sample_batch(torch.Generator().manual_seed(2), 4)
    assert a[0].shape == (4, 3, 8, 8) and a[1].shape == (4, 3, 32, 32)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[1][..., ::4, ::4], a[0])


def test_augmentation_covers_the_eight_symmetries_and_channels():
    """A crop the size of the image: every sample is one of the image's 8
    flips / rotations, each drawn; with inC 1 every channel is drawn."""
    img = np.arange(8 * 8 * 3, dtype=np.uint8).reshape(8, 8, 3)
    ds = DeviceDataset([img], [img.repeat(4, 0).repeat(4, 1)], scale=4,
                       crop_size=8, in_c=3, device="cpu")
    im, _ = ds.sample_batch(torch.Generator().manual_seed(3), 256)
    base = torch.from_numpy(img).permute(2, 0, 1).float() / 255
    views = [torch.rot90(v, k, dims=(1, 2)) for v in (base, base.flip(2))
             for k in range(4)]
    seen = [sum(bool(torch.equal(x, v)) for x in im) for v in views]
    assert sum(seen) == 256 and min(seen) >= 16, seen
    chans = [np.full((8, 8, 3), 0, np.uint8)]
    chans[0][..., 1], chans[0][..., 2] = 1, 2
    ds1 = DeviceDataset(chans, [chans[0].repeat(4, 0).repeat(4, 1)],
                        scale=4, crop_size=8, in_c=1, device="cpu")
    im1, _ = ds1.sample_batch(torch.Generator().manual_seed(4), 64)
    assert set(np.round(im1[:, 0, 0, 0].numpy() * 255).tolist()) == \
        {0.0, 1.0, 2.0}


def test_tiled_dataset_dense_and_valid():
    """tile= pre-tiling: dense stacks of images of different sizes, crops
    still from real content (tests/test_device_data.py:76-107)."""
    sizes = [(24, 40), (32, 28), (48, 48)]
    lrs = [np.full((h, w, 3), 10 * i + 10, np.uint8)
           for i, (h, w) in enumerate(sizes)]
    hrs = [np.full((2 * h, 2 * w, 3), 10 * i + 10, np.uint8)
           for i, (h, w) in enumerate(sizes)]
    tl, th = tile_images(lrs, hrs, 2, 16)
    assert all(t.shape == (16, 16, 3) for t in tl)
    assert all(t.shape == (32, 32, 3) for t in th)
    assert len(tl) == 2 * 3 + 2 * 2 + 3 * 3
    ds = DeviceDataset(lrs, hrs, scale=2, crop_size=8, in_c=3, tile=16,
                       device="cpu")
    n = len(tl)
    assert ds.hbm_bytes == n * 16 * 16 * 3 + n * 32 * 32 * 3
    padded = DeviceDataset(lrs, hrs, scale=2, crop_size=8, in_c=3,
                           device="cpu")
    assert padded.hbm_bytes == 3 * (48 * 48 * 3) * 5
    im, lb = ds.sample_batch(torch.Generator().manual_seed(0), 16)
    assert im.shape == (16, 3, 8, 8) and lb.shape == (16, 3, 16, 16)
    vals = np.unique(np.round(im.numpy() * 255).astype(int))
    assert set(vals.tolist()) <= {10, 20, 30}
    np.testing.assert_allclose(im.mean((1, 2, 3)).numpy(),
                               lb.mean((1, 2, 3)).numpy(), atol=1e-6)


def test_tile_images_match_lerf_tpu():
    from lerf_tpu.data.device_data import tile_images as jax_tile

    lrs, hrs = make_images(seed=5)
    got, want = tile_images(lrs, hrs, 4, 12), jax_tile(lrs, hrs, 4, 12)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_tile_hr_shape_mismatch_rejected():
    rng = np.random.RandomState(0)
    lr = rng.randint(0, 256, (40, 40, 3), dtype=np.uint8)
    hr_short = rng.randint(0, 256, (79, 80, 3), dtype=np.uint8)
    with pytest.raises(ValueError, match="HR shape"):
        tile_images([lr], [hr_short], 2, 16)


def test_tile_smaller_than_crop_rejected():
    lrs = [np.zeros((32, 32, 3), np.uint8)]
    hrs = [np.zeros((64, 64, 3), np.uint8)]
    with pytest.raises(ValueError, match="tile"):
        DeviceDataset(lrs, hrs, scale=2, crop_size=24, in_c=3, tile=16,
                      device="cpu")


def test_from_div2k_keeps_the_sampler_images(div2k):
    ds = DIV2K(str(div2k), 4, crop_size=6, in_c=1)
    dev = DeviceDataset.from_div2k(ds, device="cpu")
    assert dev.lr.shape[0] == 3 and dev.crop == 6 and dev.in_c == 1
    assert torch.equal(dev.lr[0, :12, :16],
                       torch.from_numpy(ds.lr_ims["0001"]))
