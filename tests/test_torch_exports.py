"""The port's package surfaces against lerf_tpu's, and the sharded IMDN
towers' compute type: ``lerf_torch.ops`` / ``lerf_torch.lut`` export every
name of ``lerf_tpu.ops`` / ``lerf_tpu.lut`` but those the port leaves out
on purpose (``lerf_torch.ops.LEFT_OUT``), each the port's own object; the
sharded IMDN functions refuse a compute type they would widen to float32.
"""
import numpy as np
import pytest
import torch

import lerf_torch.lut as tlut
import lerf_torch.ops as tops
import lerf_torch.parallel as tp
import lerf_tpu.lut as jlut
import lerf_tpu.ops as jops
from lerf_torch.models.imdn import IMDN2, init_imdn


@pytest.mark.parametrize("port, ref", [(tops, jops), (tlut, jlut)],
                         ids=["ops", "lut"])
def test_exports_match_lerf_tpu(port, ref):
    left_out = ({name for name, _ in tops.LEFT_OUT} if port is tops
                else set())
    assert left_out <= set(ref.__all__)
    assert sorted(port.__all__) == sorted(set(ref.__all__) - left_out)
    ns = {}
    exec(f"from {port.__name__} import {', '.join(port.__all__)}", ns)
    for name in port.__all__:
        obj = ns[name]
        assert obj is getattr(port, name)
        if isinstance(obj, (dict, tuple)):      # MODE_OFFSETS, MODE_PAD
            assert obj is not getattr(ref, name)
        else:
            assert obj.__module__.startswith("lerf_torch."), name


def test_left_out_names_have_reasons():
    for name, reason in tops.LEFT_OUT:
        assert not hasattr(tops, name) and reason


@pytest.fixture(scope="module")
def imdn_case():
    model = init_imdn(IMDN2(nf=12), torch.Generator().manual_seed(0))
    img = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, (3, 44, 5)).astype(np.float32))
    return model, img, tp.make_mesh(devices=["cpu"] * 2)


@pytest.mark.parametrize("fn", ["imdn_stages_sharded",
                                "imdn_stages_sharded_exchange"])
def test_sharded_imdn_refuses_bf16(imdn_case, fn):
    model, img, mesh = imdn_case
    # one-stage towers: each exchange slab holds the 22-row halo
    arg = img if fn == "imdn_stages_sharded" else [img[:, :22], img[:, 22:]]
    call = getattr(tp, fn)
    with pytest.raises(NotImplementedError, match="A1"):
        call(arg, model, mesh, dtype=torch.bfloat16, two_stage=False)
    outs = [call(arg, model, mesh, dtype=dt, two_stage=False)
            for dt in (None, torch.float32)]
    for (feat, hyper) in outs:
        assert feat.to_host().dtype == np.float32
        assert hyper.to_host().shape == (3, 44, 5, 3)
    np.testing.assert_array_equal(outs[0][1].to_host(), outs[1][1].to_host())
