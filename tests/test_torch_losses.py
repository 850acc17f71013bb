"""Port parity: photon_tpu_torch.core.losses against photon_tpu.core.losses.

The same float32 margins and labels, made with a seeded numpy, go through
both packages.  Tolerance rtol 2e-6, atol 1e-6: the formulas are the same
float32 expressions, so the two only differ where exp/log1p/sigmoid round
differently in the last bit (XLA's CPU kernels against PyTorch's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.core import losses as jl
from photon_tpu_torch.core import losses as tl

NAMES = ["logistic", "squared", "poisson", "smoothed_hinge"]
RTOL, ATOL = 2e-6, 1e-6


def _inputs(name: str):
    rng = np.random.default_rng(0)
    edge = [0.0, -0.0, 1.0, -1.0, 0.5, 29.5, 30.0, 30.5, 45.0, 80.0, -20.0, -90.0]
    z = np.concatenate([rng.standard_normal(256) * 3.0, edge]).astype(np.float32)
    if name == "poisson":
        y = rng.poisson(1.5, z.size).astype(np.float32)
    elif name == "squared":
        y = rng.standard_normal(z.size).astype(np.float32)
    else:
        y = (rng.random(z.size) < 0.5).astype(np.float32)
    return z, y


@pytest.mark.parametrize("part", ["value", "d1", "d2"])
@pytest.mark.parametrize("name", NAMES)
def test_loss_parts_match_jax(name, part):
    z, y = _inputs(name)
    want = np.asarray(getattr(jl.get_loss(name), part)(jnp.asarray(z), jnp.asarray(y)))
    got = getattr(tl.get_loss(name), part)(torch.as_tensor(z), torch.as_tensor(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_loss_mean_matches_jax(name):
    z, _ = _inputs(name)
    want = np.asarray(jl.get_loss(name).mean(jnp.asarray(z)))
    got = tl.get_loss(name).mean(torch.as_tensor(z))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_logistic_d1_is_exact_at_zero():
    """Every margin is 0 at w0 = 0; the derivative there is sigmoid(0) - y."""
    y = torch.tensor([0.0, 1.0])
    d1 = tl.LOGISTIC.d1(torch.zeros(2), y)
    assert d1.tolist() == [0.5, -0.5]


def test_poisson_past_cap_is_linear_with_flat_curvature():
    z = torch.tensor([31.0, 40.0])
    y = torch.zeros(2)
    value = tl.POISSON.value(z, y)
    slope = (value[1] - value[0]) / 9.0
    np.testing.assert_allclose(float(slope), float(np.exp(np.float32(30.0))), rtol=1e-5)
    assert tl.POISSON.d2(z, y).tolist() == [0.0, 0.0]
    assert torch.isfinite(tl.POISSON.value(torch.tensor([1e4]), torch.zeros(1))).all()


def test_registry_matches_jax():
    assert sorted(tl.LOSSES) == sorted(jl.LOSSES)
    assert {k: v.name for k, v in tl.TASK_TO_LOSS.items()} == {
        k: v.name for k, v in jl.TASK_TO_LOSS.items()
    }
    assert tl.BINARY_TASKS == jl.BINARY_TASKS
    assert tl.get_loss("LOGISTIC_REGRESSION") is tl.LOGISTIC
    with pytest.raises(KeyError):
        tl.get_loss("hinge")
