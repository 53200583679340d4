"""The frozen work counts against values worked by hand at tiny shapes."""
import json
import os

import pytest

from portbench import harness
from portbench.reference.imdn import spec as imdn_spec
from portbench.work import counts, frame


def test_bound_is_the_largest_time():
    assert counts.bound_s(nbytes=3.35e12) == pytest.approx(1.0)
    assert counts.bound_s(f32_ops=67e12, nbytes=1.0) == pytest.approx(1.0)
    assert counts.bound_s(f64_ops=68e12) == pytest.approx(2.0)


def test_k1_at_a_tiny_shape():
    # 1 channel 2×3 → 4×6, support 2: source 6 px × 16 bytes, 24 bytes
    # out, (4 + 6) × 2 neighbours × 8 bytes of geometry; 6 decodes of 8
    # operations, 24 outputs × (4 × 14 + 4)
    assert counts.k1((2, 3), (4, 6), c=1) == (280, 1488)
    assert counts.k1((2, 3), (4, 6), c=1, floats=True) == (280, 1470)


def test_k2_at_a_tiny_shape():
    # 6 px int32 in, 6 tables × 10 rows × 3 int8, 6 px × 3 int32 out;
    # 6 px × 12 members × 3 channels × 10 operations
    assert counts.k2((2, 3), 1, 3, 6, 12, 10) == (276, 2160)


def test_k5_at_a_tiny_shape():
    # as K1 but the 3×3 float64 inverse (72 bytes) for the geometry and
    # the mask's 24 bytes; 24 outputs × (4 × 14 + 5) + 6 × 8; float64:
    # 24 × (5 + 2 × (6 + 2 × 2)) + 4 rows × 3 + 6 columns × 6 + 24 × 8
    assert counts.k5((2, 3), (4, 6), c=1) == (216, 1512, 840)


def test_imdn_towers_at_reference_width():
    cfg = json.load(open(os.path.join(harness.HERE, "configs",
                                      "lerf-net-imdn.json")))
    shapes = [s for _, s in imdn_spec(cfg)]
    assert len(shapes) == 2 * (1 + 5 * 5 + 2)
    # nf 12: a module 1296 + 972 + 972 + 243 + 144; stage 1's ends 324,
    # 144, 324; stage 2's last conv has 9 outputs (972)
    nbytes, macs = counts.imdn_towers(shapes, (1, 1))
    assert macs == 18927 + 19575
    assert nbytes == (3 + 3 + 9) * 4
    # 8.87 G multiply-adds at 360×640, as the bring-up script counted
    assert counts.imdn_towers(shapes, (360, 640))[1] == 38502 * 230400


def test_frame_least_times():
    load = lambda kind, name: json.load(open(os.path.join(  # noqa: E731
        harness.HERE, kind, name + ".json")))
    imdn, lut = load("configs", "lerf-net-imdn"), load("configs", "lerf-g")
    sr, warp = load("traffic", "video-1080p-x2"), load("traffic",
                                                       "warp-1080p-4k")
    px = 1080 * 1920
    k1_ops = counts.k1((1080, 1920), (2160, 3840), floats=True)[1]
    assert frame.frame_least_s(imdn, sr) == pytest.approx(
        (2 * 38502 * px + k1_ops) / 67e12)
    assert set(frame.kernel_least_s(imdn, sr)) == {"towers", "k1"}
    assert set(frame.kernel_least_s(lut, sr)) == {"k2", "k1"}
    assert set(frame.kernel_least_s(lut, warp)) == {"k2", "k5"}
    # the LUT frame is bound by its bytes or operations, both counted
    assert 0 < frame.frame_least_s(lut, warp) < 1e-3
