"""K6's host tile plan (``lerf_torch.ops.kernels.resize_bwd.plan_tiles``) on
the CPU, against a brute-force scan of the field of view: each band's output
range is exactly the outputs whose windows touch its source rows (a pad
position touches the border row that it copies), each such output's window
lies in the band's staged window, the bands cover every source row once,
and every block's shared memory is within the plan's and the card's.  The
kernel itself runs only on a card (``tests/test_torch_kernels.py``)."""
import numpy as np
import pytest

from lerf_torch.ops.geometry import ResizeGeometry
from lerf_torch.ops.kernels import resize_bwd as k6
from lerf_torch.ops.kernels.resize import BLOCK_SMEM_MAX, ResizeOperands

H100_SMS = 132

# name → (LR size, scale, support, antialias): ×1.5 to ×8 at supports 2 to
# 4, the antialiased downscales, sizes no tile divides
PLAN_CASES = {
    **{f"x{s}-s{n}": ((13, 37), s, n, False)
       for s in (1.5, 2.5, 3.0, 4.0, 8.0) for n in (2, 3, 4)},
    "x2-s2": ((48, 48), 2.0, 2, False),
    "x4-s2-train": ((48, 48), 4.0, 2, False),
    "x0.5-aa": ((32, 36), 0.5, 2, True),
    "x0.25-aa": ((29, 41), 0.25, 2, True),
    "x0.5": ((31, 18), 0.5, 2, False),
    "x4-1px": ((1, 1), 4.0, 2, False),
}


def plans_of(case, linear, **kw):
    size, scale, support, aa = PLAN_CASES[case]
    geom = ResizeGeometry.create(size, scale_factors=[scale] * 2,
                                 support=support, antialias=aa)
    ops = ResizeOperands.create(geom, "cpu", linear=linear)
    return geom, ops, k6.plan_tiles(ops, **kw)


def touching(fov, n_src, lo, hi):
    """Brute force: the outputs with a window position, clamped to the
    source (the pads copy the border), in source rows [lo, hi)."""
    clamped = np.clip(fov, 0, n_src - 1)
    return np.nonzero(((clamped >= lo) & (clamped < hi)).any(1))[0]


@pytest.mark.parametrize("linear", [False, True], ids=["gauss", "linear"])
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_tile_plan_matches_brute_force(case, linear):
    geom, ops, plans = plans_of(case, linear)
    rows, cols = ops.rows.numpy(), ops.cols.numpy()
    dis = (ops.lin_x, ops.lin_y) if linear else (ops.dis_x, ops.dis_y)
    masks = (ops.mask_x, ops.mask_y) if linear else (None, None)
    assert plans, case
    S = geom.support
    for plan in plans:
        th, tw = plan.tile
        bands = {"rows": (plan.bands[:plan.n_ty], rows, geom.in_sz[0], th,
                          dis[0].numpy(), masks[0]),
                 "cols": (plan.bands[plan.n_ty:], cols, geom.in_sz[1], tw,
                          dis[1].numpy(), masks[1])}
        for axis, (b, fov, n_src, tile, d, mask) in bands.items():
            # the bands cover every source row once, in order
            assert b[0, 0] == 0 and b[-1, 1] == n_src, (plan.tile, axis)
            assert np.array_equal(b[1:, 0], b[:-1, 1]), (plan.tile, axis)
            assert (b[:, 1] - b[:, 0] <= tile).all()
            for lo, hi, o_lo, o_hi, w_lo, w_n, v_lo, n_v, f_at, i_at, i_n, \
                    _ in b:
                want = touching(fov, n_src, lo, hi)
                assert np.array_equal(np.arange(o_lo, o_hi), want), \
                    (case, plan.tile, axis, lo)
                if o_hi == o_lo:
                    assert w_n == n_v == 0
                    continue
                win = fov[o_lo:o_hi]
                assert win.min() == w_lo and win.max() == w_lo + w_n - 1
                # the virtual rows: the band's own and, on the border, the
                # pads; each one's outputs are those that read it
                virt = np.arange(v_lo, v_lo + n_v)
                assert (np.clip(virt, 0, n_src - 1) >= lo).all()
                assert (np.clip(virt, 0, n_src - 1) < hi).all()
                mine = win[(np.clip(win, 0, n_src - 1) >= lo)
                           & (np.clip(win, 0, n_src - 1) < hi)]
                assert set(mine.tolist()) <= set(virt.tolist())
                # the packed geometry: distances, offsets, virtual rows'
                # outputs, masks
                n = o_hi - o_lo
                assert np.array_equal(plan.geo_f[f_at:f_at + n * S],
                                      d[o_lo:o_hi].reshape(-1))
                words = plan.geo_i[i_at:i_at + i_n]
                assert np.array_equal(words[:n], win[:, 0] - w_lo)
                for k, r in enumerate(virt):
                    reads = np.nonzero((win == r).any(1))[0] + o_lo
                    got = words[n + 2 * k:n + 2 * k + 2]
                    assert np.array_equal(np.arange(*got), reads), (axis, r)
                tail = words[n + 2 * n_v:]
                if mask is None:
                    assert len(tail) == 0
                else:
                    assert np.array_equal(tail,
                                          mask[o_lo:o_hi].numpy().ravel())
        ni = plan.bands[:plan.n_ty, 3] - plan.bands[:plan.n_ty, 2]
        nj = plan.bands[plan.n_ty:, 3] - plan.bands[plan.n_ty:, 2]
        rows_, cols_ = plan.bands[:plan.n_ty], plan.bands[plan.n_ty:]
        blocks = [k6.smem_bytes(a[3] - a[2], b[3] - b[2], a[5], b[5], S,
                                linear, a[10] + b[10])
                  for a in rows_ for b in cols_]
        assert max(blocks) <= plan.smem <= BLOCK_SMEM_MAX, (case, plan.tile)
        assert plan.phase_a == ni.sum() * nj.sum()
        # G lanes a pixel: a power of two covering the output rows that read
        # one source row; whole groups in a block of whole warps
        most = max(len(touching(rows, geom.in_sz[0], r, r + 1))
                   for r in range(1, geom.in_sz[0] - 1)) \
            if geom.in_sz[0] > 2 else 1
        assert plan.group & (plan.group - 1) == 0 and plan.group <= 32
        assert plan.group >= min(most, 32)
        assert plan.threads % 32 == 0 and plan.threads <= k6.MAX_THREADS


@pytest.mark.parametrize("planes", [1, 3, 5, 16, 48])
@pytest.mark.parametrize("case", ["x4-s2-train", "x8.0-s2", "x0.5-aa"])
def test_pick_fills_the_card(case, planes):
    """The pick keeps WARPS_PER_SM warps on every SM where a tile can, with
    the least phase-A work of those; where none can, the most warps."""
    _, _, plans = plans_of(case, False)
    got = k6.pick_plan(plans, planes, H100_SMS)
    warps = {p.tile: k6.resident_warps(p, planes, H100_SMS) for p in plans}
    if max(warps.values()) >= k6.WARPS_PER_SM:
        assert warps[got.tile] >= k6.WARPS_PER_SM
        assert got.phase_a == min(p.phase_a for p in plans
                                  if warps[p.tile] >= k6.WARPS_PER_SM)
    else:
        assert warps[got.tile] == max(warps.values())


def test_training_shape_plan():
    """The LeRF training geometry (16 planes of 48² → ×4, support 2): eight
    lanes a pixel, 8 × 8 tiles, 576 blocks of 256 threads, 22 % more
    phase-A work than outputs."""
    geom, _, plans = plans_of("x4-s2-train", False)
    got = k6.pick_plan(plans, 16, H100_SMS)
    assert (got.tile, got.group, got.threads) == ((8, 8), 8, 256)
    assert 16 * got.n_ty * got.n_tx == 576
    assert got.phase_a / np.prod(geom.out_sz) == pytest.approx(1.219, 0.01)


def test_plan_that_cannot_fit_raises():
    """A support whose one-output window alone overflows shared memory: no
    tile fits, and the plan says so instead of launching."""
    geom = ResizeGeometry.create((100, 100), scale_factors=[0.01] * 2,
                                 support=2, antialias=True)
    ops = ResizeOperands.create(geom, "cpu")
    with pytest.raises(ValueError, match="does not fit"):
        k6.plan_tiles(ops)


def test_threads_must_be_whole_warps():
    with pytest.raises(ValueError, match="multiple of 32"):
        plans_of("x2-s2", False, threads=48)
