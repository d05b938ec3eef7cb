"""The utilities the port now exports, on the CPU, against the JAX package.

``_safe_xlogy``, ``to_categorical``, ``reduce``, ``class_reduce``, ``_auc_compute``
and ``interp`` take the same seeded inputs in both packages and agree within
``RTOL`` (float32 elementwise arithmetic and one short sum); the argmax
indices are equal. ``check_forward_full_state_property`` recommends what the
JAX package recommends for the same metric.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.regression as JR
import torchmetrics_tpu.utilities as JU
import torchmetrics_tpu_torch.regression as PR
import torchmetrics_tpu_torch.utilities as PU

RTOL = 1e-6


def test_safe_xlogy_is_zero_where_x_is_zero():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 3, 40).astype(np.float32)
    y = rng.uniform(0, 3, 40).astype(np.float32)
    x[::5], y[::7] = 0.0, 0.0  # x == 0 (with y == 0 at index 0 and 35) gives 0, never NaN
    got = PU._safe_xlogy(torch.from_numpy(x), torch.from_numpy(y))
    want = np.asarray(JU._safe_xlogy(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    assert (got.numpy()[::5] == 0).all()


@pytest.mark.parametrize("dim", [0, 1, -1])
def test_to_categorical(dim):
    x = np.random.default_rng(1).random((7, 5, 3)).astype(np.float32)
    got = PU.to_categorical(torch.from_numpy(x), argmax_dim=dim)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JU.to_categorical(jnp.asarray(x), argmax_dim=dim)))


@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none", None])
def test_reduce(reduction):
    x = np.random.default_rng(2).normal(size=(4, 6)).astype(np.float32)
    got = PU.reduce(torch.from_numpy(x), reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(JU.reduce(jnp.asarray(x), reduction)), rtol=RTOL)


@pytest.mark.parametrize("class_reduction", ["micro", "macro", "weighted", "none", None])
def test_class_reduce(class_reduction):
    rng = np.random.default_rng(3)
    num = rng.integers(0, 10, 6)
    denom = num + rng.integers(0, 5, 6)
    denom[2] = num[2] = 0  # 0 / 0: NaN becomes 0 in both
    weights = rng.integers(1, 20, 6)
    got = PU.class_reduce(torch.from_numpy(num), torch.from_numpy(denom), torch.from_numpy(weights), class_reduction)
    want = JU.class_reduce(jnp.asarray(num), jnp.asarray(denom), jnp.asarray(weights), class_reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_reduce_rejects_unknown_reductions():
    with pytest.raises(ValueError, match="unknown"):
        PU.reduce(torch.zeros(2), "max")
    with pytest.raises(ValueError, match="unknown"):
        PU.class_reduce(torch.ones(2), torch.ones(2), torch.ones(2), "max")


@pytest.mark.parametrize("reorder", [False, True])
def test_auc_compute_and_interp(reorder):
    rng = np.random.default_rng(4)
    x = np.sort(rng.random(12)).astype(np.float32)
    y = rng.random(12).astype(np.float32)
    if reorder:
        x = x[rng.permutation(12)]
    got = PU._auc_compute(torch.from_numpy(x), torch.from_numpy(y), reorder=reorder)
    want = JU._auc_compute(jnp.asarray(x), jnp.asarray(y), reorder=reorder)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    q = rng.uniform(-0.2, 1.2, 9).astype(np.float32)
    xs = np.sort(x)
    got = PU.interp(torch.from_numpy(q), torch.from_numpy(xs), torch.from_numpy(y))
    want = JU.interp(jnp.asarray(q), jnp.asarray(xs), jnp.asarray(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_check_forward_full_state_property_recommends_as_jax(capsys):
    rng = np.random.default_rng(5)
    p, t = rng.normal(size=16).astype(np.float32), rng.normal(size=16).astype(np.float32)
    PU.check_forward_full_state_property(PR.MeanSquaredError, init_args={"device": "cpu"},
                                         input_args={"preds": torch.from_numpy(p), "target": torch.from_numpy(t)},
                                         num_update_to_compare=(3, 4), reps=1)
    got = capsys.readouterr().out.strip().splitlines()
    JU.check_forward_full_state_property(JR.MeanSquaredError, init_args={"auto_compile": False},
                                         input_args={"preds": jnp.asarray(p), "target": jnp.asarray(t)},
                                         num_update_to_compare=(3, 4), reps=1)
    want = capsys.readouterr().out.strip().splitlines()
    assert got[-1] == want[-1] == "Recommended setting `full_state_update=False`"
    assert len(got) == len(want) == 5
