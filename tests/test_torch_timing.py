"""``lerf_torch.utils.timing.chain_time`` on the CPU: a shape-stable chain
times, one whose shape or type changes raises with lerf_tpu's message."""
import pytest
import torch

from lerf_torch.utils.timing import chain_time


def test_stable_chain_times_each_iteration():
    calls = []

    def step(x):
        calls.append(x.shape)
        return x * 0.5 + 1.0

    t = chain_time(step, torch.ones(8, 8), warmup=2, iters=5)
    assert isinstance(t, float) and t >= 0
    assert len(calls) == 7


def test_nested_stable_chain_times():
    t = chain_time(lambda xs: (xs[1], xs[0] + 1), (torch.zeros(3),
                                                  torch.ones(3)), iters=3)
    assert t >= 0


@pytest.mark.parametrize("step", [lambda x: x[::2],
                                  lambda x: x.to(torch.float64)],
                         ids=["shrinking", "retyped"])
def test_unstable_chain_raises(step):
    with pytest.raises(AssertionError, match="chain not shape-stable"):
        chain_time(step, torch.ones(16))
