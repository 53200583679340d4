"""lerf_torch.parallel.spatial's SRNet and IMDN functions against
lerf_tpu.parallel.spatial's, on the CPU (the resize, warp and LUT ones:
``tests/test_torch_spatial.py``, whose conventions these follow).

lerf_tpu runs each function jitted on ``make_mesh(8)`` and ``make_mesh(4)``
of the virtual CPU devices; the port on ``["cpu"] * 8``, ``* 4`` and
``* 3``.  Tolerances, those of each form against lerf_tpu:

- the SRNet form (nf 16, lerf_tpu's ``PRNGKey(3)`` params carried across):
  feature and hyper codes within one level on < 0.5 % of pixels (the
  dense products summed in another order, a ``round`` at a .5 edge); the
  resized frame within ``tests/test_spatial.py``'s ``rtol=1e-6,
  atol=1e-4`` where the codes are lerf_tpu's;
- the IMDN form (nf 12, lerf_tpu's ``PRNGKey(7)`` variables carried
  across): feature within 1e-3, hyper maps within 1e-5 (``PERF.md`` §2's
  gates; conv sums in another order), frames within ``rtol=1e-5,
  atol=1e-3`` (``tests/test_spatial.py``'s IMDN bound) with equal NaN
  masks.

Pins: the exchange form moves one copy a direction across each interior
boundary in ONE ``exchange_halos`` and gathers nothing; a slab shorter
than the 44-row halo raises.  Torch runs on one thread.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from lerf_tpu.models import imdn as jimdn
from lerf_tpu.models import srnet as jsrnet
from lerf_tpu.ops import ResizeGeometry as JaxResizeGeometry
from lerf_tpu.ops import WarpGeometry as JaxWarpGeometry
from lerf_tpu.parallel import make_mesh as jax_mesh
from lerf_tpu.parallel import spatial as jsp
from lerf_tpu.parallel.mesh import DATA_AXIS

import lerf_torch.parallel as tp
from lerf_torch.convert import imdn_from_arrays, lerf_nets_from_arrays
from lerf_torch.models.imdn import IMDN2
from lerf_torch.models.imdn_s2d import TOWER_SPATIAL_CONVS, tower_halo_rows
from lerf_torch.ops import geometry as geo
from lerf_torch.ops.kernels.warp import WarpParams
from lerf_torch.parallel import mesh as pm

JAX_SHARDS = (8, 4)
TORCH_SHARDS = (8, 4, 3)
NET_CODES = (1, 0.005)         # (max level difference, share that differ)
FEAT_ATOL, HYPER_ATOL = 1e-3, 1e-5
IMDN_FRAME_TOL = dict(rtol=1e-5, atol=1e-3)
RESIZE_TOL = dict(rtol=1e-6, atol=1e-4)
HALO = 2 * TOWER_SPATIAL_CONVS

_JAX = {}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """See tests/test_torch_train.py: torch on one thread for the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_once(key, make):
    if key not in _JAX:
        _JAX[key] = jax.tree.map(np.asarray, make())
    return _JAX[key]


def torch_meshes():
    return [tp.make_mesh(devices=["cpu"] * n) for n in TORCH_SHARDS]


def codes_close(got, want, what):
    d = np.abs(np.round(np.asarray(got, np.float64))
               - np.round(np.asarray(want, np.float64)))
    assert d.max() <= NET_CODES[0] and (d > 0).mean() < NET_CODES[1], \
        (what, d.max(), (d > 0).mean())


# -- the SRNet form -------------------------------------------------------------


def srnet_params():
    """lerf_tpu's seed-3 nf 16 params (numpy) and the port's copy."""
    def make():
        return jsrnet.init_lerf_nets(jax.random.PRNGKey(3), nf=16, out_c=3)
    arrays = jax_once("srnet_params", make)
    return arrays, lerf_nets_from_arrays(arrays)


@pytest.mark.parametrize("n", JAX_SHARDS)
def test_srnet_stages_sharded_match_lerf_tpu(n):
    arrays, params = srnet_params()
    img = np.random.RandomState(5).randint(0, 256, (2, 21, 17)) \
        .astype(np.int32)                # not divisible by 8
    feat_w, hyper_w = jax_once(("srnet_stages", n), lambda: jax.jit(
        lambda im, p: jsp.srnet_stages_sharded(im, p, jax_mesh(n)))(
        img, arrays))
    for mesh in torch_meshes():
        feat, hyper = tp.srnet_stages_sharded(torch.from_numpy(img), params,
                                              mesh)
        codes_close(feat.to_host(), feat_w, "feat")
        codes_close(hyper.to_host() * 255, hyper_w * 255, "hyper")


@pytest.mark.parametrize("n", JAX_SHARDS)
def test_net_sr_pipeline_matches_lerf_tpu(n):
    """The frame within the resize's bound wherever the port's codes are
    lerf_tpu's (every pixel, where no code differs)."""
    arrays, params = srnet_params()
    h, w = 21, 17
    img = np.random.RandomState(5).randint(0, 256, (2, h, w)).astype(np.int32)
    geom = JaxResizeGeometry.create((h, w), scale_factors=[2, 2], support=2)
    want = jax_once(("net_sr", n), lambda: jax.jit(
        lambda im, p: jsp.sharded_net_sr_pipeline(im, p, geom, jax_mesh(n)))(
        img, arrays))
    feat_w, hyper_w = jax_once(("srnet_stages", n), lambda: jax.jit(
        lambda im, p: jsp.srnet_stages_sharded(im, p, jax_mesh(n)))(
        img, arrays))
    tgeom = geo.ResizeGeometry.create((h, w), scale_factors=[2, 2])
    for mesh in torch_meshes():
        feat, hyper = tp.srnet_stages_sharded(torch.from_numpy(img), params,
                                              mesh)
        same = (np.array_equal(feat.to_host(), feat_w)
                and np.array_equal(hyper.to_host(), hyper_w))
        pm.transfers = 0
        pm.collectives.clear()
        got = tp.sharded_net_sr_pipeline(torch.from_numpy(img), params,
                                         tgeom, mesh)
        assert dict(pm.collectives) == {"all_gather_rows": 1}
        if same:
            np.testing.assert_allclose(got.to_host(), want, **RESIZE_TOL)
        else:
            codes_close(got.to_host(), want, "frame")


# -- the IMDN form ---------------------------------------------------------------


def imdn_variables():
    """lerf_tpu's IMDN2 (nf 12, ``PRNGKey(7)``) variables and the port's
    model carrying them."""
    def make():
        model = jimdn.IMDN2(in_c=3, out_c=3, nf=12)
        return model.init(jax.random.PRNGKey(7), jnp.zeros((1, 8, 8, 3)), 0)
    variables = jax_once("imdn_variables", make)
    model = IMDN2(nf=12)
    model.load_state_dict(imdn_from_arrays(variables))
    return variables, model


def close_maps(feat, hyper, want):
    np.testing.assert_allclose(feat.to_host(), want[0], rtol=0,
                               atol=FEAT_ATOL)
    np.testing.assert_allclose(hyper.to_host(), want[1], rtol=0,
                               atol=HYPER_ATOL)


@pytest.mark.parametrize("n", JAX_SHARDS)
@pytest.mark.parametrize("case", ["two_stage", "one_stage", "s2d"])
def test_imdn_stages_sharded_match_lerf_tpu(case, n):
    """Bands with 44-row (two-stage) or 22-row halos; H 60 on 8 shards
    keeps interior band edges and their crops in play."""
    variables, model = imdn_variables()
    h, w = 60, 13
    img = np.random.RandomState(11).randint(0, 256, (3, h, w)) \
        .astype(np.int32)
    kw = {"two_stage": case != "one_stage",
          "backend": "s2d" if case == "s2d" else "base"}
    want = jax_once(("imdn_stages", case, n), lambda: jax.jit(
        lambda im: jsp.imdn_stages_sharded(im, variables, jax_mesh(n),
                                           **kw))(img))
    for mesh in torch_meshes():
        feat, hyper = tp.imdn_stages_sharded(torch.from_numpy(img), model,
                                             mesh, **kw)
        close_maps(feat, hyper, want)


@pytest.mark.parametrize("n", JAX_SHARDS)
def test_imdn_exchange_matches_lerf_tpu(n):
    """The row-sharded input (lerf_tpu: 8 · 44 = 352 rows over its mesh,
    the slabs as tall as the halo) through one halo exchange: the port's
    slabs, even or not, held to lerf_tpu's result; the structure pinned:
    one ``exchange_halos``, two neighbour copies across each interior
    boundary, no all-gather."""
    variables, model = imdn_variables()
    h, w = 8 * HALO, 9
    img = np.random.RandomState(13).randint(0, 256, (3, h, w)) \
        .astype(np.float32)

    def run():
        mesh = jax_mesh(n)
        sharded = jax.device_put(jnp.asarray(img),
                                 NamedSharding(mesh, P(None, DATA_AXIS, None)))
        return jax.jit(lambda im: jsp.imdn_stages_sharded_exchange(
            im, variables, mesh, backend="base"))(sharded)

    want = jax_once(("imdn_exchange", n), run)
    x = torch.from_numpy(img)
    for mesh in torch_meshes():
        ranges = tp.row_ranges(h, mesh.size)
        slabs = tp.RowShards([x[:, r0:r1] for r0, r1 in ranges], ranges, h)
        pm.transfers = 0
        pm.collectives.clear()
        feat, hyper = tp.imdn_stages_sharded_exchange(slabs, model, mesh,
                                                      backend="base")
        assert dict(pm.collectives) == {"exchange_halos": 1}
        assert pm.transfers == 1 + 2 * (mesh.size - 1)
        assert feat.ranges == ranges
        close_maps(feat, hyper, want)


def test_imdn_exchange_slab_shorter_than_halo_raises():
    """lerf_tpu's rule: one hop must cover the receptive field."""
    _, model = imdn_variables()
    mesh = tp.make_mesh(devices=["cpu"] * 4)
    slabs = [torch.zeros(3, r, 5) for r in (50, 50, HALO - 1, 50)]
    assert tower_halo_rows() == 22 and HALO == 44
    with pytest.raises(ValueError, match="halo"):
        tp.imdn_stages_sharded_exchange(slabs, model, mesh)


@pytest.mark.parametrize("n", JAX_SHARDS)
def test_imdn_sr_pipeline_matches_lerf_tpu(n):
    variables, model = imdn_variables()
    h, w = 40, 13
    img = np.random.RandomState(11).randint(0, 256, (3, h, w)) \
        .astype(np.int32)
    geom = JaxResizeGeometry.create((h, w), scale_factors=[2, 2], support=2)
    want = jax_once(("imdn_sr", n), lambda: jax.jit(
        lambda im: jsp.sharded_imdn_sr_pipeline(
            im, variables, geom, jax_mesh(n), backend="base"))(img))
    tgeom = geo.ResizeGeometry.create((h, w), scale_factors=[2, 2])
    for mesh in torch_meshes():
        pm.collectives.clear()
        got = tp.sharded_imdn_sr_pipeline(torch.from_numpy(img), model,
                                          tgeom, mesh, backend="base")
        assert dict(pm.collectives) == {"all_gather_rows": 1}
        np.testing.assert_allclose(got.to_host(), want, **IMDN_FRAME_TOL)


@pytest.mark.parametrize("n", JAX_SHARDS)
def test_imdn_warp_pipeline_matches_lerf_tpu(n):
    """The warp form, single stage (the hyper tower sees the image)."""
    variables, model = imdn_variables()
    h, w, out = 21, 15, (31, 27)
    img = np.random.RandomState(12).randint(0, 256, (3, h, w)) \
        .astype(np.int32)
    matrix = np.linalg.inv(np.diag([0.55, 0.6, 1.0]))
    geom = JaxWarpGeometry.create((h, w), matrix, out, support=2)
    want = jax_once(("imdn_warp", n), lambda: jax.jit(
        lambda im: jsp.sharded_imdn_warp_pipeline(
            im, variables, geom, jax_mesh(n), backend="base",
            two_stage=False))(img))
    warp = WarpParams.create((h, w), matrix, out)
    for mesh in torch_meshes():
        got = tp.sharded_imdn_warp_pipeline(
            torch.from_numpy(img), model, warp, mesh, backend="base",
            two_stage=False).to_host()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                                   **IMDN_FRAME_TOL)
