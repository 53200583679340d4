"""The IMDN towers' conv kernel's plain twins (``lerf_torch.ops.kernels.
imdn_conv``) against the composition they replace, on the CPU.

Each twin is ``F.conv2d`` and the same elementwise steps in torch, so it
is held bit-equal to the plain composition of ``models/imdn_s2d.py``
(``F.conv2d``, ``lrelu``, ``+ x``, ``torch.cat``, ``torch.clamp``,
``torch.movedim``) on ragged shapes and a batch of 3; the kernel path's
whole tower (``apply_tower_kernel``) on CPU tensors is bit-equal to
``apply_tower_s2d`` at block 1 with the stage's clamp.  The wrappers
refuse what the kernel does not take.  The kernel itself is held to these
twins on the card (``test_torch_kernels.py``, ``-k imdn_conv``).  No JAX
here.
"""
import pytest
import torch
import torch.nn.functional as F

from lerf_torch.models import imdn_s2d as m
from lerf_torch.models.imdn import IMDN2, init_imdn, lrelu
from lerf_torch.ops.kernels import imdn_conv as kc

SHAPES = [(1, 1, 1), (1, 7, 5), (3, 37, 53)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small convs: one intra-op thread, as the other IMDN files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rnd(g, *shape, scale=1.0):
    return (torch.rand(shape, generator=g) * 2 - 1) * scale


def weights(g, cin, cout, k):
    return kc.ConvWeights.create(
        rnd(g, cout, cin, k, k, scale=1 / (cin * k * k) ** 0.5),
        rnd(g, cout, scale=0.1))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", ["bias", "lrelu", "residual", "split",
                                     "split_lrelu_1x1"])
def test_conv_twin_equals_the_composition(shape, variant):
    n, h, w = shape
    g = torch.Generator().manual_seed(1)
    k = 1 if variant == "split_lrelu_1x1" else 3
    cin, cout = (9, 12) if variant.startswith("split") else (12, 12)
    wt = weights(g, cin, cout, k)
    x = rnd(g, n, cin, h, w)
    act = "lrelu" in variant
    res = rnd(g, n, cout, h, w) if variant == "residual" else None
    split = 3 if variant.startswith("split") else 0

    y = F.conv2d(x, wt.w, wt.b, padding=k // 2)
    if act:
        y = lrelu(y)
    if res is not None:
        y = y + res
    # the split store writes into a slice of a wider concat buffer
    big = torch.full((n, 2 + split, h, w), 7.0)
    dist = big[:, 1:1 + split] if split else None
    out = torch.empty(n, cout - split, h, w)
    kc.conv(x, wt, out, act=act, residual=res, dist=dist)
    assert torch.equal(out, y[:, split:])
    if split:
        assert torch.equal(dist, y[:, :split])
        assert bool((big[:, 0] == 7).all() and (big[:, -1] == 7).all())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_lr", [False, True])
def test_tail_twin_equals_the_composition(shape, with_lr):
    """c4 + concat + c5 + the module's input (+ lr + h), also written over
    the module's input in place."""
    n, h, w = shape
    g = torch.Generator().manual_seed(2)
    c4, c5, lr = weights(g, 9, 3, 3), weights(g, 12, 12, 1), \
        weights(g, 12, 12, 1)
    tw = kc.TailWeights.create(c4, c5, lr if with_lr else None)
    x, dist = rnd(g, n, 9, h, w), rnd(g, n, 9, h, w)
    res = rnd(g, n, 12, h, w)
    hh = rnd(g, n, 12, h, w) if with_lr else None

    cat = torch.cat([dist[:, :3], dist[:, 3:6], dist[:, 6:],
                     F.conv2d(x, c4.w, c4.b, padding=1)], dim=1)
    want = F.conv2d(cat, c5.w, c5.b) + res
    if with_lr:
        want = hh + F.conv2d(want, lr.w, lr.b)
    out = torch.empty(n, 12, h, w)
    kc.tail(x, tw, dist, res, out, hh)
    assert torch.equal(out, want)
    kc.tail(x, tw, dist, res, res, hh)
    assert torch.equal(res, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("stage,cout", [(1, 3), (2, 9)])
def test_tower_end_twin_equals_the_composition(shape, stage, cout):
    """The up conv + clamp + the stage's scale; stage 2 in [N, C, H, W,
    oC] order (``make_chw_stage_fns``' ``movedim``)."""
    n, h, w = shape
    g = torch.Generator().manual_seed(3)
    wt = weights(g, 12, cout, 3)
    x = rnd(g, n, 12, h, w, scale=4)
    y = torch.clamp(F.conv2d(x, wt.w, wt.b, padding=1), -1, 1)
    if stage == 1:
        want = y * 127 + 127
        out = torch.empty(n, cout, h, w)
        kc.tower_end(x, wt, out, stage=1, half=127)
    else:
        y = (y / 2 + 0.5).reshape(n, 3, cout // 3, h, w)
        want = torch.movedim(y, -4, -1)
        out = torch.empty(n, cout // 3, h, w, 3)
        kc.tower_end(x, wt, out, stage=2, oc=3)
    assert torch.equal(out, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_twin_check_runs_the_twins_on_the_cpu(shape):
    """``twin_check`` (the card's check, shared by the card tests and
    chip_smoke) runs every case on CPU tensors, where each call is its
    twin: no difference at all."""
    assert kc.twin_check(torch.device("cpu"), *shape, 0.0,
                         torch.Generator().manual_seed(0)) == 0.0


@pytest.mark.parametrize("nf", [12, 8, 16])
@pytest.mark.parametrize("stage", [1, 2])
def test_kernel_tower_on_the_cpu_equals_apply_tower_s2d(nf, stage):
    """The kernel path's whole tower (fused module ends at nf ≤ 12, convs
    of their own above) against the cuDNN path's composition."""
    model = init_imdn(IMDN2(nf=nf), torch.Generator().manual_seed(nf))
    tower = m._torch_tower(m.convert_tower(m.tower_arrays(
        getattr(model, f"stage{stage}")), 1), "cpu")
    kt = m.kernel_tower(tower, 5)
    assert (kt["imd0"]["tail"] is not None) == (nf <= 12)
    x = torch.rand((3, 3, 7, 5), generator=torch.Generator().manual_seed(4))
    y = torch.clamp(m.apply_tower_s2d(tower, x, block=1, nf=nf), -1, 1)
    if stage == 1:
        want = y * 127 + 127
    else:
        want = torch.movedim((y / 2 + 0.5).reshape(3, 3, 3, 7, 5), 1, -1)
    got = m.apply_tower_kernel(kt, x, stage=stage, nf=nf, num_modules=5,
                               oc=1 if stage == 1 else 3)
    assert torch.equal(got, want)


def test_stage_fns_on_the_cpu_keep_the_cudnn_path():
    """On CPU tensors ``make_chw_stage_fns`` runs ``apply_tower_s2d`` as
    before (the port's parity with lerf_tpu runs through it), not the
    kernel path's twins."""
    model = init_imdn(IMDN2(nf=12), torch.Generator().manual_seed(0))
    s1, s2 = m.make_chw_stage_fns(model, backend="base", device="cpu")
    x = torch.rand((2, 3, 9, 11), generator=torch.Generator().manual_seed(5))
    before = kc.launches
    tower = m._torch_tower(m.convert_tower(m.tower_arrays(model.stage1), 1),
                           "cpu")
    y = torch.cat([m.apply_tower_s2d(tower, x[i:i + 1], block=1, nf=12)
                   for i in range(2)])      # frame by frame, as before
    assert torch.equal(s1(x), torch.clamp(y, -1, 1) * 127 + 127)
    assert s2(x).shape == (2, 3, 9, 11, 3)
    assert kc.launches == before


def test_wrappers_refuse_what_the_kernel_does_not_take():
    g = torch.Generator().manual_seed(6)
    wt = weights(g, 12, 12, 3)
    x = rnd(g, 1, 12, 8, 8)
    out = torch.empty(1, 12, 8, 8)
    with pytest.raises(ValueError, match="float32"):
        kc.conv(x.double(), wt, out)
    with pytest.raises(ValueError, match="on meta"):
        kc.conv(x.to("meta"), wt, out)
    with pytest.raises(ValueError, match="dense"):
        kc.conv(rnd(g, 1, 12, 8, 8).transpose(2, 3), wt, out)
    with pytest.raises(ValueError, match="dense"):
        kc.conv(x, wt, torch.empty(1, 8, 8, 12).permute(0, 3, 1, 2))
    with pytest.raises(ValueError, match="3x3 or 1x1"):
        kc.ConvWeights.create(rnd(g, 12, 12, 5, 5), rnd(g, 12))
    with pytest.raises(ValueError, match="float32"):
        kc.ConvWeights.create(rnd(g, 12, 12, 3, 3).half(), rnd(g, 12).half())
    with pytest.raises(ValueError, match="channels"):
        kc.conv(rnd(g, 1, 9, 8, 8), wt, out)
    with pytest.raises(ValueError, match="dist takes"):
        kc.conv(x, wt, out, dist=torch.empty(1, 13, 8, 8))
    with pytest.raises(ValueError, match="fused end"):
        kc.TailWeights.create(weights(g, 9, 4, 3), weights(g, 13, 13, 1))
    with pytest.raises(ValueError, match="tower_end"):
        kc.tower_end(x, weights(g, 12, 9, 3), torch.empty(1, 9, 8, 8),
                     stage=2, oc=3)
