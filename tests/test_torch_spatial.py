"""lerf_torch.parallel.spatial's resize, warp and LUT functions against
lerf_tpu.parallel.spatial's, on the CPU.

lerf_tpu runs each function jitted on ``make_mesh(8)`` and ``make_mesh(4)``
over the virtual CPU devices of ``tests/conftest.py``; the port on meshes
of ``["cpu"] * 8``, ``* 4`` and ``* 3`` (three shards give unequal bands),
on the same numpy-seeded inputs at ``tests/test_spatial.py``'s small
shapes, lerf_tpu's LUT references in the flat table layout.  Tolerances
are ``tests/test_spatial.py``'s own: the LUT stages int32 bit-equal; the
resizes and the static warps within ``rtol=1e-6, atol=1e-4`` (the port's
plain twins and XLA evaluate float32 ``exp`` in other ways), the warps
with equal NaN masks; the dynamic warps within ``rtol=2e-5, atol=1e-4``
(lerf_tpu's own bound for its jitted rings warp).  The pins: ONE
``all_gather_rows`` of one stacked tensor a pipeline call.  Torch runs on
one thread (``one_torch_thread``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lerf_tpu.ops import ResizeGeometry as JaxResizeGeometry
from lerf_tpu.ops import WarpGeometry as JaxWarpGeometry
from lerf_tpu.ops import resample as jrs
from lerf_tpu.ops.geometry import ResizeOperands as JaxResizeOperands
from lerf_tpu.ops.geometry import WarpOperands as JaxWarpOperands
from lerf_tpu.parallel import make_mesh as jax_mesh
from lerf_tpu.parallel import spatial as jsp

import lerf_torch.parallel as tp
from lerf_torch.ops import geometry as geo
from lerf_torch.ops import resample as trs
from lerf_torch.ops.kernels.warp import WarpParams
from lerf_torch.ops.lut_pipeline import FlatTables
from lerf_torch.parallel import mesh as pm

JAX_SHARDS = (8, 4)
TORCH_SHARDS = (8, 4, 3)
L4 = 17 ** 4
MODES = ("s", "c", "t")
RESIZE_TOL = dict(rtol=1e-6, atol=1e-4)
RINGS_WARP_TOL = dict(rtol=2e-5, atol=1e-4)
DEVGEO_ATOL = 1e-3       # lerf_tpu's float32 device geometry, see below
PERSPECTIVE = np.array([[1.1, 0.02, 3.0], [0.01, 0.95, -2.0],
                        [1e-4, 2e-5, 1.0]])
ZOOM = np.linalg.inv(np.diag([0.55, 0.6, 1.0]))

_JAX = {}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """See tests/test_torch_train.py: torch on one thread for the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_once(key, make):
    """lerf_tpu's value under ``key``, computed once for the module."""
    if key not in _JAX:
        _JAX[key] = jax.tree.map(np.asarray, make())
    return _JAX[key]


def torch_meshes():
    return [tp.make_mesh(devices=["cpu"] * n) for n in TORCH_SHARDS]


def tables(seed=7, modes2=MODES):
    """(lerf_tpu's flat int32 tables, the port's FlatTables) of a random
    two-stage bank, stage 2 on ``modes2``."""
    rng = np.random.RandomState(seed)
    s1 = {m: rng.randint(-127, 128, (L4, 1)).astype(np.int8) for m in MODES}
    s2 = {f"{m}r{r}": rng.randint(-127, 128, (L4, 3)).astype(np.int8)
          for m in modes2 for r in (0, 1)}
    jax_t = tuple({k: jnp.asarray(v.astype(np.int32)) for k, v in t.items()}
                  for t in (s1, s2))
    return jax_t, (FlatTables.create(s1), FlatTables.create(s2))


def float_inputs(seed, c, h, w):
    """Feature (0..255 float) and three hyper maps in [0, 1]."""
    rng = np.random.RandomState(seed)
    img = (rng.rand(c, h, w) * 255).astype(np.float32)
    return img, [rng.rand(c, h, w).astype(np.float32) for _ in range(3)]


def u8_inputs(seed, c, h, w):
    """u8-exact float inputs: integer feature, hyper maps ``code / 255``."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (c, h, w)).astype(np.float32)
    return img, [(rng.randint(0, 256, (c, h, w)).astype(np.float32)
                  / np.float32(255)) for _ in range(3)]


def lut_image(seed, c, h, w):
    return np.random.RandomState(seed).randint(0, 256, (c, h, w)) \
        .astype(np.int32)


def assert_warp_close(got, want, tol):
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    np.testing.assert_array_equal(nan_g, nan_w)
    np.testing.assert_allclose(got[~nan_g], want[~nan_w], **tol)


def pinned_gather(call, n):
    """``call()`` with the mesh's counters at 0: one all-gather of one
    stacked tensor (n·(n-1) moves), no other collective."""
    pm.transfers = 0
    pm.collectives.clear()
    out = call()
    assert dict(pm.collectives) == {"all_gather_rows": 1}
    assert pm.transfers == 1 + n * (n - 1)
    return out


# -- the resize and the warp ---------------------------------------------


@pytest.mark.parametrize("n", JAX_SHARDS)
@pytest.mark.parametrize("scale", [[2, 2], [2.5, 1.5], [2.35, 2.0]])
def test_resize_sharded_matches_lerf_tpu(scale, n):
    """Non-divisible outH (16·2.35 = 37 rows): lerf_tpu pads duplicated
    geometry rows, the port's shards take unequal windows."""
    img, hyper = float_inputs(0, 3, 16, 20)
    geom = JaxResizeGeometry.create((16, 20), scale_factors=scale, support=2)
    want = jax_once(("resize", tuple(scale), n), lambda: jax.jit(
        lambda *a: jsp.steering_gaussian_resize_sharded(
            *a, geom, jax_mesh(n)))(img, *hyper))
    tgeom = geo.ResizeGeometry.create((16, 20), scale_factors=scale)
    for mesh in torch_meshes():
        got = tp.steering_gaussian_resize_sharded(
            torch.from_numpy(img), *map(torch.from_numpy, hyper), tgeom, mesh)
        assert isinstance(got, tp.RowShards) and len(got.slabs) == mesh.size
        np.testing.assert_allclose(got.to_host(), want, **RESIZE_TOL)


@pytest.mark.parametrize("n", JAX_SHARDS)
def test_warp_sharded_matches_lerf_tpu(n):
    img, hyper = float_inputs(1, 3, 14, 18)
    out = (27, 30)                       # outH not divisible by 8
    geom = JaxWarpGeometry.create((14, 18), ZOOM, out, support=2)
    want = jax_once(("warp", n), lambda: jax.jit(
        lambda *a: jsp.steering_gaussian_warp_sharded(
            *a, geom, jax_mesh(n)))(img, *hyper))
    warp = WarpParams.create((14, 18), ZOOM, out)
    for mesh in torch_meshes():
        got = tp.steering_gaussian_warp_sharded(
            torch.from_numpy(img), *map(torch.from_numpy, hyper), warp, mesh)
        assert_warp_close(got.to_host(), want, RESIZE_TOL)


@pytest.mark.parametrize("n", JAX_SHARDS)
@pytest.mark.parametrize("scale", [(2.0, 2.0), (1.93, 2.0)])
def test_resize_rings_sharded_matches_lerf_tpu(scale, n):
    """The dynamic-scale resize: lerf_tpu's rings against the port's
    serving geometry (K1's windows of ``from_serving``)."""
    img, hyper = float_inputs(5, 3, 14, 18)
    rings = jax.tree.map(jnp.asarray, jrs.resize_rings(
        JaxResizeOperands.create((14, 18), scale_factors=list(scale))))
    want = jax_once(("resize_rings", scale, n), lambda: jax.jit(
        lambda *a: jsp.steering_gaussian_resize_rings_sharded(
            *a, jax_mesh(n)))(img, *hyper, rings))
    ops = geo.ResizeOperands.create((14, 18), scale_factors=list(scale))
    for mesh in torch_meshes():
        got = tp.steering_gaussian_resize_rings_sharded(
            torch.from_numpy(img), *map(torch.from_numpy, hyper), ops, mesh)
        np.testing.assert_allclose(got.to_host(), want, **RESIZE_TOL)


@pytest.mark.parametrize("n", JAX_SHARDS)
@pytest.mark.parametrize("u8", [True, False], ids=["u8", "float"])
def test_warp_rings_sharded_matches_lerf_tpu(u8, n):
    """The dynamic-homography warp, lerf_tpu's flat [C, N]: its rings
    against the port's ``WarpParams`` (the matrix)."""
    img, hyper = u8_inputs(10, 3, 22, 19)
    out = (31, 27)                       # N = 837, not divisible by 8
    rings = jax.tree.map(jnp.asarray, jrs.warp_rings(
        JaxWarpOperands.create((22, 19), PERSPECTIVE, out)))
    want = jax_once(("warp_rings", u8, n), lambda: jax.jit(
        lambda *a: jsp.steering_gaussian_warp_rings_sharded(
            *a, jax_mesh(n), u8_inputs=u8))(img, *hyper, rings))
    warp = WarpParams.create((22, 19), PERSPECTIVE, out)
    for mesh in torch_meshes():
        got = tp.steering_gaussian_warp_rings_sharded(
            torch.from_numpy(img), *map(torch.from_numpy, hyper), warp, mesh,
            u8_inputs=u8)
        assert got.shape == want.shape == (3, out[0] * out[1])
        np.testing.assert_allclose(np.nan_to_num(got.to_host()),
                                   np.nan_to_num(want), **RINGS_WARP_TOL)


# -- the float ops on every pair of float types -----------------------------

# (feature, maps) types of the float pairs: lerf_tpu's sharded ops keep
# them (bf16 maps decoded in bf16, the distances in the feature's type)
FLOAT_PAIRS = {"bf16": (torch.bfloat16, torch.bfloat16),
               "f32_feat_bf16_maps": (torch.float32, torch.bfloat16),
               "bf16_feat_f32_maps": (torch.bfloat16, torch.float32)}
# bf16 outputs against lerf_tpu's sharded op, in bf16 ulps: its sharded
# warp sums the four neighbours with jnp.sum where its single-device warp
# adds them in turn, each add rounded to bf16 (3 ulps on 28.2 % of these
# outputs, lerf_tpu against itself); its other sharded ops are its
# single-device ones
SHARDED_BF16_ULPS = {"resize": 1, "warp": 3, "resize_rings": 1,
                     "warp_rings": 1}


def jnp_of(t):
    return jnp.asarray(t.float().numpy(),
                       jnp.bfloat16 if t.dtype == torch.bfloat16
                       else jnp.float32)


def float_op_case(op, ft, mt):
    """(lerf_tpu's sharded call, its single-device call, the port's
    sharded call, its single-device call) of one float op, each taking
    (img, rho, sigma_x, sigma_y) (lerf_tpu's sharded one on ``jax_mesh(4)``,
    the port's a mesh); the rings warp's rings bf16 where the maps are."""
    hw = (14, 18)
    if op == "resize":
        jg = JaxResizeGeometry.create(hw, scale_factors=[2.35, 2.0],
                                      support=2)
        tg = geo.ResizeGeometry.create(hw, scale_factors=[2.35, 2.0])
        return (lambda *a: jsp.steering_gaussian_resize_sharded(
                    *a, jg, jax_mesh(4)),
                lambda *a: jrs.steering_gaussian_resize(*a, jg),
                lambda *a, mesh: tp.steering_gaussian_resize_sharded(
                    *a, tg, mesh),
                lambda *a: trs.steering_gaussian_resize(*a, tg))
    if op == "warp":
        out = (27, 30)
        jg = JaxWarpGeometry.create(hw, ZOOM, out, support=2)
        warp = WarpParams.create(hw, ZOOM, out)
        return (lambda *a: jsp.steering_gaussian_warp_sharded(
                    *a, jg, jax_mesh(4)),
                lambda *a: jrs.steering_gaussian_warp(*a, jg),
                lambda *a, mesh: tp.steering_gaussian_warp_sharded(
                    *a, warp, mesh),
                lambda *a: trs.steering_gaussian_warp(*a, warp.geometry()))
    if op == "resize_rings":
        jr = jax.tree.map(jnp.asarray, jrs.resize_rings(
            JaxResizeOperands.create(hw, scale_factors=[1.93, 2.0])))
        ops = geo.ResizeOperands.create(hw, scale_factors=[1.93, 2.0])
        return (lambda *a: jsp.steering_gaussian_resize_rings_sharded(
                    *a, jr, jax_mesh(4)),
                lambda *a: jrs.steering_gaussian_resize_rings(*a, jr),
                lambda *a, mesh: tp.steering_gaussian_resize_rings_sharded(
                    *a, ops, mesh),
                lambda *a: trs.steering_gaussian_resize_rings(
                    *a, trs.resize_rings(ops)))
    out = (31, 27)
    bf16 = mt == torch.bfloat16
    jr = jax.tree.map(jnp.asarray, jrs.warp_rings(
        JaxWarpOperands.create(hw, PERSPECTIVE, out),
        dtype=jnp.bfloat16 if bf16 else np.float32))
    rings = trs.warp_rings(geo.WarpOperands.create(hw, PERSPECTIVE, out),
                           dtype=torch.bfloat16 if bf16 else np.float32)
    return (lambda *a: jsp.steering_gaussian_warp_rings_sharded(
                *a, jr, jax_mesh(4), u8_inputs=False),
            lambda *a: jrs.steering_gaussian_warp_rings(*a, jr),
            lambda *a, mesh: tp.steering_gaussian_warp_rings_sharded(
                *a, rings, mesh, u8_inputs=False),
            lambda *a: trs.steering_gaussian_warp_rings(*a, rings))


@pytest.mark.parametrize("pair", sorted(FLOAT_PAIRS))
@pytest.mark.parametrize("op", ["resize", "warp", "resize_rings",
                                "warp_rings"])
def test_sharded_float_ops_keep_the_types(op, pair):
    """The four sharded float ops on a bf16 feature and bf16 maps, and on
    one float32 and the other bf16: the sources keep their types (no
    float32 copy), the output takes lerf_tpu's type (bf16 where the
    feature and the maps are, and for the rings warp its rings too; else
    float32), bit-equal to the port's single-device op on meshes of 3 and
    8 CPU shards.  Against lerf_tpu's sharded op (jitted on 4 devices): a
    float32 output within this file's tolerances (on 20-35 % of these
    outputs the float32 ``exp`` differs), a bf16 one with its NaN pattern,
    bit-equal to lerf_tpu's single-device op and within
    ``SHARDED_BF16_ULPS`` of its sharded op (the warp: 3 ulps on 28.2 %,
    its sharded warp's own distance from its single-device warp; the
    others 0 ulps here)."""
    ft, mt = FLOAT_PAIRS[pair]
    img, hyper = float_inputs(3, 3, 14, 18)
    ti = torch.from_numpy(img).to(ft)
    tm = [torch.from_numpy(h).to(mt) for h in hyper]
    j_sharded, j_single, t_sharded, t_single = float_op_case(op, ft, mt)
    jargs = [jnp_of(t) for t in [ti] + tm]
    want = jax_once(("float_types", op, pair), lambda: jax.jit(j_sharded)(
        *jargs).astype(jnp.float32))
    single = t_single(ti, *tm)
    out_t = torch.bfloat16 if ft == mt == torch.bfloat16 else torch.float32
    assert single.dtype == out_t
    for n in (3, 8):
        got = t_sharded(ti, *tm, mesh=tp.make_mesh(devices=["cpu"] * n))
        assert got.dtype == out_t
        assert torch.equal(torch.nan_to_num(got.cat(), nan=-1.0),
                           torch.nan_to_num(single.reshape(got.shape),
                                            nan=-1.0))
    got = got.cat().float().numpy()
    if out_t == torch.float32:
        if op in ("warp", "warp_rings"):
            tol = RINGS_WARP_TOL if op == "warp_rings" else RESIZE_TOL
            assert_warp_close(got, want, tol)
        else:
            np.testing.assert_allclose(got, want, **RESIZE_TOL)
        return
    alone = np.asarray(j_single(*jargs).astype(jnp.float32))
    assert_warp_close(got, alone.reshape(got.shape), dict(rtol=0, atol=0))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)

    def bits(a):
        return torch.from_numpy(np.ascontiguousarray(a)).bfloat16() \
            .view(torch.int16).to(torch.int32)
    ulps = (bits(got[ok]) - bits(want[ok])).abs()
    assert int(ulps.max()) <= SHARDED_BF16_ULPS[op], int(ulps.max())


# -- the LUT stages and pipelines -------------------------------------------


@pytest.mark.parametrize("n", JAX_SHARDS)
@pytest.mark.parametrize("case", ["h32", "h29", "modes2"])
def test_lut_stages_sharded_bit_equal_to_lerf_tpu(case, n):
    """int32 bit-equal, divisible and non-divisible heights, and a stage-2
    bank on another mode set (``modes2``)."""
    modes2 = ("s", "d") if case == "modes2" else MODES
    (j1, j2), (t1, t2) = tables(23 if case == "modes2" else 7, modes2)
    h, w = {"h32": (32, 24), "h29": (29, 24), "modes2": (26, 20)}[case]
    img = lut_image(3, 3, h, w)
    want = jax_once(("stages", case, n), lambda: jax.jit(
        lambda im, a, b: jsp.lut_stages_sharded(
            im, a, b, MODES, jax_mesh(n), modes2=modes2))(img, j1, j2))
    for mesh in torch_meshes():
        feat, hyper = tp.lut_stages_sharded(torch.from_numpy(img), t1, t2,
                                            MODES, mesh, modes2=modes2)
        assert feat.dtype == hyper.dtype == torch.int32
        np.testing.assert_array_equal(feat.to_host(), want[0])
        np.testing.assert_array_equal(hyper.to_host(), want[1])


@pytest.mark.parametrize("n", JAX_SHARDS)
def test_lut_sr_pipeline_matches_lerf_tpu(n):
    """Stages → one all-gather → K1's windows (the plain twin here)."""
    (j1, j2), (t1, t2) = tables()
    img = lut_image(4, 3, 29, 24)
    geom = JaxResizeGeometry.create((29, 24), scale_factors=[2, 2], support=2)
    want = jax_once(("lut_sr", n), lambda: jax.jit(
        lambda im, a, b: jsp.sharded_lut_sr_pipeline(
            im, a, b, MODES, geom, jax_mesh(n)))(img, j1, j2))
    tgeom = geo.ResizeGeometry.create((29, 24), scale_factors=[2, 2])
    for mesh in torch_meshes():
        got = pinned_gather(lambda: tp.sharded_lut_sr_pipeline(
            torch.from_numpy(img), t1, t2, MODES, tgeom, mesh), mesh.size)
        np.testing.assert_allclose(got.to_host(), want, **RESIZE_TOL)


@pytest.mark.parametrize("n", JAX_SHARDS)
def test_lut_warp_pipeline_matches_lerf_tpu(n):
    (j1, j2), (t1, t2) = tables(9)
    h, w = 29, 24
    img = lut_image(9, 3, h, w)
    mat = np.linalg.inv(np.diag([0.5, 0.5, 1.0]))
    geom = JaxWarpGeometry.create((h, w), mat, (2 * h, 2 * w), support=2)
    want = jax_once(("lut_warp", n), lambda: jax.jit(
        lambda im, a, b: jsp.sharded_lut_warp_pipeline(
            im, a, b, MODES, geom, jax_mesh(n)))(img, j1, j2))
    warp = WarpParams.create((h, w), mat, (2 * h, 2 * w))
    for mesh in torch_meshes():
        got = pinned_gather(lambda: tp.sharded_lut_warp_pipeline(
            torch.from_numpy(img), t1, t2, MODES, warp, mesh), mesh.size)
        assert_warp_close(got.to_host(), want, RESIZE_TOL)


@pytest.mark.parametrize("n", JAX_SHARDS)
@pytest.mark.parametrize("scale", [(2.0, 2.0), (1.93, 2.0)])
def test_dynamic_sr_pipeline_matches_lerf_tpu(scale, n):
    (j1, j2), (t1, t2) = tables(5)
    img = lut_image(5, 3, 14, 18)
    rings = jax.tree.map(jnp.asarray, jrs.resize_rings(
        JaxResizeOperands.create((14, 18), scale_factors=list(scale))))
    want = jax_once(("dyn_sr", scale, n), lambda: jax.jit(
        lambda im, a, b, r: jsp.sharded_dynamic_sr_pipeline(
            im, a, b, MODES, r, jax_mesh(n)))(img, j1, j2, rings))
    ops = geo.ResizeOperands.create((14, 18), scale_factors=list(scale))
    for mesh in torch_meshes():
        got = pinned_gather(lambda: tp.sharded_dynamic_sr_pipeline(
            torch.from_numpy(img), t1, t2, MODES, ops, mesh), mesh.size)
        np.testing.assert_allclose(got.to_host(), want, **RESIZE_TOL)


@pytest.mark.parametrize("n", JAX_SHARDS)
@pytest.mark.parametrize("matrix", ["zoom", "perspective"])
def test_dynamic_warp_pipeline_matches_lerf_tpu(matrix, n):
    (j1, j2), (t1, t2) = tables(10)
    h, w, out = 22, 19, (31, 27)
    img = lut_image(10, 3, h, w)
    mat = {"zoom": ZOOM, "perspective": PERSPECTIVE}[matrix]
    rings = jax.tree.map(jnp.asarray, jrs.warp_rings(
        JaxWarpOperands.create((h, w), mat, out)))
    want = jax_once(("dyn_warp", matrix, n), lambda: jax.jit(
        lambda im, a, b, r: jsp.sharded_dynamic_warp_pipeline(
            im, a, b, MODES, r, jax_mesh(n)))(img, j1, j2, rings))
    warp = WarpParams.create((h, w), mat, out)
    for mesh in torch_meshes():
        got = pinned_gather(lambda: tp.sharded_dynamic_warp_pipeline(
            torch.from_numpy(img), t1, t2, MODES, warp, mesh), mesh.size)
        assert got.axis == -1 and got.shape == want.shape
        np.testing.assert_allclose(np.nan_to_num(got.to_host()),
                                   np.nan_to_num(want), **RINGS_WARP_TOL)


@pytest.mark.parametrize("n", JAX_SHARDS)
def test_devgeo_warp_pipeline_matches_lerf_tpu(n):
    """The device-geometry warp from the inverse alone.  The port derives
    the geometry in float64 (K5, its twin here), lerf_tpu in float32 in
    its program: against lerf_tpu's devgeo warp the NaN mask equal and
    the values within ``DEVGEO_ATOL`` (a float32 geometry's distances move
    a weight by a few ulps: 5e-4 at most here); against lerf_tpu's
    float64 host-geometry (rings) warp of the same matrix, its own rings
    tolerance."""
    (j1, j2), (t1, t2) = tables(17)
    h, w, out = 22, 19, (32, 24)
    img = lut_image(17, 3, h, w)
    inv = np.linalg.inv(PERSPECTIVE)
    want32 = jax_once(("devgeo", n), lambda: jax.jit(
        lambda im, a, b, iv: jsp.sharded_devgeo_warp_pipeline(
            im, a, b, MODES, iv, out, jax_mesh(n)))(
        img, j1, j2, jnp.asarray(inv.astype(np.float32))))
    rings = jax.tree.map(jnp.asarray, jrs.warp_rings(
        JaxWarpOperands.create((h, w), np.linalg.inv(inv), out)))
    want64 = jax_once(("devgeo64", n), lambda: jax.jit(
        lambda im, a, b, r: jsp.sharded_dynamic_warp_pipeline(
            im, a, b, MODES, r, jax_mesh(n)))(img, j1, j2, rings))
    for mesh in torch_meshes():
        got = pinned_gather(lambda: tp.sharded_devgeo_warp_pipeline(
            torch.from_numpy(img), t1, t2, MODES, inv, out, mesh), mesh.size)
        got = got.to_host()
        assert_warp_close(got, want32, dict(rtol=0, atol=DEVGEO_ATOL))
        np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want64),
                                   **RINGS_WARP_TOL)


# -- the mesh's structure ------------------------------------------------------


def test_sharded_pipelines_equal_their_unsharded_twins():
    """On every port mesh the sharded LUT SR and warp equal one shard's
    (the unsharded call) bit for bit, the outputs staying on their shards
    until asked: ``cat()`` and ``to_host()`` agree."""
    _, (t1, t2) = tables(11)
    img = torch.from_numpy(lut_image(11, 3, 29, 24))
    geom = geo.ResizeGeometry.create((29, 24), scale_factors=[2.5, 2.0])
    warp = WarpParams.create((29, 24), PERSPECTIVE, (50, 41))
    one = tp.make_mesh(devices=["cpu"])
    want_sr = tp.sharded_lut_sr_pipeline(img, t1, t2, MODES, geom, one)
    want_w, want_m = tp.sharded_lut_warp_pipeline(
        img, t1, t2, MODES, warp, one, out_dtype=torch.uint8, mask=True)
    for mesh in torch_meshes():
        got = tp.sharded_lut_sr_pipeline(img, t1, t2, MODES, geom, mesh)
        assert [tuple(s.shape) for s in got.slabs] == [
            (3, r1 - r0, geom.out_sz[1]) for r0, r1 in got.ranges]
        assert torch.equal(got.cat(), want_sr.cat())
        np.testing.assert_array_equal(got.to_host(), got.cat().numpy())
        frame, mask = tp.sharded_lut_warp_pipeline(
            img, t1, t2, MODES, warp, mesh, out_dtype=torch.uint8, mask=True)
        assert torch.equal(frame.cat(), want_w.cat())
        np.testing.assert_array_equal(mask.to_host(), want_m.to_host())
