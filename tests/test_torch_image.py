"""The port's InceptionV3 trunk and FID on the CPU, against the JAX package.

Weights are the port's seeded random ones with random BatchNorm statistics
(so that folding is exercised), exported to the JAX package's flat ``.npz``
layout; both packages load that one file. The JAX side runs its Pallas
kernels in interpret mode and is checked for silent degradation. Features
are compared by relative norm ``||got - want|| / ||want||``, since random
weights shrink activations layer by layer: ``1e-4`` in float32 (the JAX
package's own fused-vs-unfused tolerance) and ``2e-2`` in bfloat16, where the
two frameworks round at other places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from torchmetrics_tpu import _kernels as K
from torchmetrics_tpu._kernels.dispatch import reset_degradations
from torchmetrics_tpu.image import FrechetInceptionDistance as JaxFID
from torchmetrics_tpu.image._inception import InceptionFeatureExtractor as JaxExtractor
from torchmetrics_tpu.image._inception import InceptionV3 as JaxInceptionV3
from torchmetrics_tpu.image._inception import _resize_bilinear_tf1 as jax_resize
from torchmetrics_tpu.image._inception import fold_batchnorm as jax_fold_batchnorm
from torchmetrics_tpu_torch.image import FrechetInceptionDistance
from torchmetrics_tpu_torch.image._inception import (
    FEATURES,
    InceptionFeatureExtractor,
    InceptionV3,
    _resize_bilinear_tf1,
    fold_batchnorm,
    init_weights_,
)
from torchmetrics_tpu_torch.utilities import state_from_jax
from torchmetrics_tpu_torch.utilities.convert import (
    build_on_cpu,
    inception_state_dict_from_variables,
    state_dict_from_variables,
    variables_from_state_dict,
)

FID_STATES = {
    "real_features_sum", "real_features_cov_sum", "real_features_num_samples",
    "fake_features_sum", "fake_features_cov_sum", "fake_features_num_samples",
}


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    """The JAX side runs its Pallas kernels (interpret mode on the CPU) and must not degrade to XLA."""
    reset_degradations()
    monkeypatch.setenv(K.KERNELS_ENV, "pallas")
    yield
    assert not K.degraded_kernels()
    reset_degradations()


@pytest.fixture(scope="module")
def inception(tmp_path_factory):
    net = init_weights_(build_on_cpu(InceptionV3, fuse_bn=False), seed=0)
    state = net.state_dict()
    rng = np.random.default_rng(1)
    for key, value in state.items():
        draw = {
            "running_mean": lambda n: rng.normal(0.0, 0.1, n),
            "running_var": lambda n: rng.uniform(0.5, 1.5, n),
            "BatchNorm_0.weight": lambda n: rng.uniform(0.5, 1.5, n),
            "BatchNorm_0.bias": lambda n: rng.normal(0.0, 0.1, n),
        }
        for suffix, fn in draw.items():
            if key.endswith(suffix):
                value.copy_(torch.from_numpy(fn(value.shape[0]).astype(np.float32)))
    flat = variables_from_state_dict(state)
    path = tmp_path_factory.mktemp("weights") / "inception.npz"
    np.savez(path, **flat)
    return {"state": state, "flat": flat, "npz": str(path)}


def _jax_tree(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _nchw(x_nhwc):
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def test_weights_convert_both_ways_in_the_jax_layout(inception):
    shapes = jax.eval_shape(JaxInceptionV3(fuse_bn=False).init, jax.random.PRNGKey(0), jnp.zeros((1, 80, 80, 3)))
    want = {"/".join(k): tuple(v.shape) for k, v in flatten_dict(shapes).items()}
    assert {k: v.shape for k, v in inception["flat"].items()} == want
    back = inception_state_dict_from_variables(inception["flat"])
    assert back.keys() == inception["state"].keys()
    assert all(torch.equal(back[k], inception["state"][k]) for k in back)
    again = variables_from_state_dict(back)
    assert all(np.array_equal(again[k], inception["flat"][k]) for k in want)


def test_a_bare_key_is_a_parameter():
    flat = {"fc/kernel": np.ones((3, 2), np.float32), "params/x/Conv_0/bias": np.zeros(2, np.float32)}
    state = state_dict_from_variables(flat)
    assert state["fc.weight"].shape == (2, 3) and "x.Conv_0.bias" in state


def test_fold_batchnorm_matches_jax(inception):
    want = state_dict_from_variables(_flat(jax_fold_batchnorm(_jax_tree(inception["flat"]))))
    got = fold_batchnorm(inception["state"])
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-6, atol=1e-7, err_msg=key)
    build_on_cpu(InceptionV3, fuse_bn=True).load_state_dict(got)  # strict: the folded layout fits the fused trunk


def test_tf1_resize_matches_jax():
    x = (np.random.default_rng(0).random((2, 17, 31, 3)) * 255).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), 299, 299))
    got = _resize_bilinear_tf1(torch.from_numpy(x).permute(0, 3, 1, 2), 299, 299).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    assert _resize_bilinear_tf1(torch.ones(1, 3, 299, 299), 299, 299).shape == (1, 3, 299, 299)


@pytest.mark.parametrize("fuse_bn", [False, True], ids=["unfused", "fused"])
def test_inception_v3_matches_jax_at_80x80(inception, fuse_bn):
    x = np.random.default_rng(2).normal(size=(2, 80, 80, 3)).astype(np.float32)
    variables = _jax_tree(inception["flat"])
    if fuse_bn:
        want = jax.jit(lambda v, xx: JaxInceptionV3(fuse_bn=True).apply(v, xx))(jax_fold_batchnorm(variables), x)
    else:
        want = JaxInceptionV3(fuse_bn=False).apply(variables, x)
    net = build_on_cpu(InceptionV3, fuse_bn=fuse_bn)
    net.load_state_dict(fold_batchnorm(inception["state"]) if fuse_bn else inception["state"])
    with torch.no_grad():
        got = net.to(memory_format=torch.channels_last)(_nchw(x))
    assert set(got) == set(FEATURES)
    for tap in FEATURES:
        assert got[tap].dtype == torch.float32
        assert _rel(got[tap], want[tap]) < 1e-4, tap
    with torch.no_grad():
        assert torch.equal(net(_nchw(x), "768"), got["768"])  # stops at the tap, same value


@pytest.mark.parametrize("kind, feature", [("uint8", "2048"), ("float", "64"), ("uint8", "logits_unbiased")])
def test_feature_extractor_matches_jax_at_299(inception, kind, feature):
    """The whole trunk at 299x299 once; the float inputs' preprocessing (floor of x * 255) at the first tap."""
    rng = np.random.default_rng(3)
    if kind == "uint8":
        imgs = rng.integers(0, 256, (2, 3, 37, 29), dtype=np.uint8)
    else:
        imgs = rng.random((2, 3, 37, 29)).astype(np.float32)
    want = JaxExtractor(feature=feature, weights_path=inception["npz"], compute_dtype=jnp.float32)(jnp.asarray(imgs))
    ours = InceptionFeatureExtractor(feature=feature, weights_path=inception["npz"], compute_dtype=torch.float32, device="cpu")
    got = ours(torch.from_numpy(imgs))
    width = 1008 if feature == "logits_unbiased" else int(feature)  # the TF checkpoint's 1008 classes
    assert got.shape == (2, width) and got.dtype == torch.float32
    assert _rel(got, want) < 1e-4


def test_feature_extractor_bf16_default_matches_jax(inception):
    imgs = np.random.default_rng(4).integers(0, 256, (2, 3, 32, 32), dtype=np.uint8)
    want = JaxExtractor(feature="192", weights_path=inception["npz"])(jnp.asarray(imgs))
    got = InceptionFeatureExtractor(feature=192, weights_path=inception["npz"], device="cpu")(torch.from_numpy(imgs))
    assert got.dtype == torch.float32
    assert _rel(got, want) < 2e-2


def _fid_states_close(port, jax_metric, rtol=1e-4):
    want = jax_metric.state_dict(all_states=True)
    got = port.state_dict(all_states=True)
    assert set(got) == set(want) == FID_STATES
    for key in FID_STATES:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=rtol, atol=1e-12, err_msg=key)


def test_fid_matches_jax_over_a_stream(inception):
    """Three updates, resumed mid-stream from the JAX state, then ``reset`` keeping the real statistics.

    States agree to ``rtol=1e-4``. The FID values agree to ``rel=2e-2`` only:
    a handful of 64-d features make both covariances singular, and the two
    libraries' float32 eigensolvers differ on the clipped near-zero
    eigenvalues (the FID math itself is held to ``1e-4`` with well-conditioned
    features below).
    """
    rng = np.random.default_rng(5)
    batches = [(rng.integers(0, 256, (3, 3, 32, 32), dtype=np.uint8), real) for real in (True, False, True, False)]
    kw = {"feature": 64, "reset_real_features": False, "weights_path": inception["npz"]}
    jm = JaxFID(compute_dtype=jnp.float32, **kw)
    pm = FrechetInceptionDistance(compute_dtype=torch.float32, device="cpu", **kw)
    assert pm.state_dict() == {} and set(pm.state_dict(all_states=True)) == FID_STATES  # no trunk weights
    for imgs, real in batches[:2]:
        jm.update(jnp.asarray(imgs), real=real)
        pm.update(torch.from_numpy(imgs), real=real)
    resumed = FrechetInceptionDistance(compute_dtype=torch.float32, device="cpu", **kw)
    resumed.load_state_dict(state_from_jax(jm.state_dict(all_states=True), device="cpu"))
    imgs, real = batches[2]
    jm.update(jnp.asarray(imgs), real=real)
    pm.update(torch.from_numpy(imgs), real=real)
    resumed.update(torch.from_numpy(imgs), real=real)
    _fid_states_close(pm, jm)
    _fid_states_close(resumed, jm)
    want = float(jm.compute())
    assert float(pm.compute()) == pytest.approx(want, rel=2e-2)
    assert float(resumed.compute()) == pytest.approx(want, rel=2e-2)

    jm.reset()
    pm.reset()
    assert float(pm.real_features_num_samples) == 6 and float(pm.fake_features_num_samples) == 0
    imgs, _ = batches[3]
    jm.update(jnp.asarray(imgs), real=False)
    pm.update(torch.from_numpy(imgs), real=False)
    _fid_states_close(pm, jm)
    assert float(pm.compute()) == pytest.approx(float(jm.compute()), rel=2e-2)


class _PooledFeatures:
    """A callable feature extractor: 2x2 average pooling of the first channel, 16-d."""

    num_features = 16

    def __init__(self, xp):
        self.xp = xp

    def __call__(self, imgs):
        n = imgs.shape[0]
        if self.xp == "jax":
            return jnp.asarray(imgs, jnp.float32)[:, 0].reshape(n, 4, 8, 4, 8).mean(axis=(2, 4)).reshape(n, 16)
        return imgs.float()[:, 0].reshape(n, 4, 8, 4, 8).mean(dim=(2, 4)).reshape(n, 16)


def test_fid_with_a_callable_feature_matches_jax():
    rng = np.random.default_rng(6)
    jm = JaxFID(feature=_PooledFeatures("jax"))
    pm = FrechetInceptionDistance(feature=_PooledFeatures("torch"), device="cpu")
    for i in range(4):
        imgs = rng.integers(0, 256, (40, 3, 32, 32), dtype=np.uint8)
        if i % 2:
            imgs = np.clip(imgs.astype(np.int64) + 40, 0, 255).astype(np.uint8)
        jm.update(jnp.asarray(imgs), real=i % 2 == 0)
        pm.update(torch.from_numpy(imgs), real=i % 2 == 0)
    _fid_states_close(pm, jm, rtol=1e-6)
    assert float(pm.compute()) == pytest.approx(float(jm.compute()), rel=1e-4)


def test_fid_refuses_a_bad_feature():
    with pytest.raises(ValueError):
        FrechetInceptionDistance(feature=65, device="cpu")
    with pytest.raises(TypeError):
        FrechetInceptionDistance(feature="2048", device="cpu")
