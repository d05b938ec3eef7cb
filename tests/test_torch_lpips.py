"""The port's LPIPS networks, metric and functional on the CPU, against the JAX package.

Weights are the port's seeded random ones (heads made non-negative, as real
LPIPS heads are), exported to the JAX package's flat ``.npz`` layout; both
packages load that one file through ``weights_path``. The JAX side runs its
Pallas head kernel in interpret mode and is checked for silent degradation.
Distances agree to ``rtol=1e-4`` in float32 (the JAX package's own
fused-vs-unfused tolerance) and ``2e-2`` with bfloat16 trunks, where the two
frameworks round at other places. Images are 65x65, so the SqueezeNet
trunk's ceil-mode pools see partial windows.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from torchmetrics_tpu import _kernels as K
from torchmetrics_tpu._kernels.dispatch import reset_degradations
from torchmetrics_tpu.functional.image import learned_perceptual_image_patch_similarity as jax_lpips_fn
from torchmetrics_tpu.image import LearnedPerceptualImagePatchSimilarity as JaxLPIPS
from torchmetrics_tpu.image._lpips import LPIPSExtractor as JaxExtractor
from torchmetrics_tpu.image._lpips import LPIPSNet as JaxLPIPSNet
from torchmetrics_tpu_torch.functional.image import learned_perceptual_image_patch_similarity
from torchmetrics_tpu_torch.image import LearnedPerceptualImagePatchSimilarity
from torchmetrics_tpu_torch.image._inception import init_weights_
from torchmetrics_tpu_torch.image._lpips import LPIPSExtractor, LPIPSNet
from torchmetrics_tpu_torch.utilities.convert import build_on_cpu, lpips_state_dict_from_variables, variables_from_state_dict

lh = importlib.import_module("torchmetrics_tpu_torch._kernels.lpips_head")
NET_TYPES = ("vgg", "alex", "squeeze")


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    """The JAX side runs its Pallas kernel (interpret mode on the CPU) and must not degrade to XLA."""
    reset_degradations()
    monkeypatch.setenv(K.KERNELS_ENV, "pallas")
    yield
    assert not K.degraded_kernels()
    reset_degradations()


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    out = {}
    folder = tmp_path_factory.mktemp("lpips")
    for seed, net_type in enumerate(NET_TYPES):
        net = init_weights_(build_on_cpu(LPIPSNet, net_type=net_type), seed=seed)
        with torch.no_grad():
            for name, param in net.named_parameters():
                if name.startswith("lin"):
                    param.abs_()
        flat = variables_from_state_dict(net.state_dict())
        np.savez(folder / f"{net_type}.npz", **flat)
        out[net_type] = {"state": net.state_dict(), "flat": flat, "npz": str(folder / f"{net_type}.npz")}
    return out


def _images(seed, shape=(2, 3, 65, 65)):
    rng = np.random.default_rng(seed)
    img0 = (rng.random(shape) * 2 - 1).astype(np.float32)
    img1 = np.clip(img0 + rng.normal(0.0, 0.3, shape), -1, 1).astype(np.float32)
    return img0, img1


@pytest.mark.parametrize("net_type", NET_TYPES)
def test_weights_convert_both_ways_in_the_jax_layout(weights, net_type):
    dummy = jnp.zeros((1, 3, 64, 64))
    shapes = jax.eval_shape(JaxLPIPSNet(net_type=net_type).init, jax.random.PRNGKey(0), dummy, dummy)
    want = {"/".join(k): tuple(v.shape) for k, v in flatten_dict(shapes).items()}
    assert {k: v.shape for k, v in weights[net_type]["flat"].items()} == want
    back = lpips_state_dict_from_variables(weights[net_type]["flat"])
    assert back.keys() == weights[net_type]["state"].keys()
    assert all(torch.equal(back[k], weights[net_type]["state"][k]) for k in back)


@pytest.mark.parametrize("unfused", [False, True], ids=["fused", "unfused"])
@pytest.mark.parametrize("net_type", NET_TYPES)
def test_lpips_network_matches_jax(weights, net_type, unfused):
    img0, img1 = _images(seed=len(net_type))
    npz = weights[net_type]["npz"]
    want = JaxExtractor(net_type=net_type, weights_path=npz, compute_dtype=jnp.float32, unfused=unfused)(
        jnp.asarray(img0), jnp.asarray(img1)
    )
    ours = LPIPSExtractor(net_type=net_type, weights_path=npz, compute_dtype=torch.float32, unfused=unfused, device="cpu")
    got = ours(torch.from_numpy(img0), torch.from_numpy(img1))
    assert got.shape == (2,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-7)
    assert lh.lpips_head.launches == 0  # CPU tensors take the oracle chain


def test_lpips_bf16_trunk_matches_jax(weights):
    img0, img1 = _images(seed=7)
    npz = weights["alex"]["npz"]
    want = JaxExtractor(net_type="alex", weights_path=npz)(jnp.asarray(img0), jnp.asarray(img1))
    got = LPIPSExtractor(net_type="alex", weights_path=npz, device="cpu")(torch.from_numpy(img0), torch.from_numpy(img1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_metric_and_functional_match_jax(weights, reduction):
    npz = weights["alex"]["npz"]
    kw = {"net_type": "alex", "weights_path": npz, "reduction": reduction, "normalize": True}
    jm = JaxLPIPS(compute_dtype=jnp.float32, **kw)
    pm = LearnedPerceptualImagePatchSimilarity(compute_dtype=torch.float32, device="cpu", **kw)
    assert set(pm.state_dict(all_states=True)) == set(jm.state_dict(all_states=True)) == {"sum_scores", "total"}
    for seed in (11, 12):
        img0, img1 = ((x + 1) / 2 for x in _images(seed))  # [0, 1] under normalize=True
        jm.update(jnp.asarray(img0), jnp.asarray(img1))
        pm.update(torch.from_numpy(img0), torch.from_numpy(img1))
    assert float(pm.total) == 4
    np.testing.assert_allclose(float(pm.compute()), float(jm.compute()), rtol=1e-4)

    img0, img1 = _images(seed=13)
    want = jax_lpips_fn(jnp.asarray(img0), jnp.asarray(img1), reduction=reduction, net=jm.net)
    got = learned_perceptual_image_patch_similarity(
        torch.from_numpy(img0), torch.from_numpy(img1), reduction=reduction, net=pm.net
    )
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def test_functional_builds_its_network_where_the_images_lie():
    img0, img1 = _images(seed=14, shape=(2, 3, 64, 64))
    d = learned_perceptual_image_patch_similarity(torch.from_numpy(img0), torch.from_numpy(img1), net_type="squeeze")
    assert d.ndim == 0 and d.device.type == "cpu" and bool(torch.isfinite(d))


def test_bad_arguments_are_refused():
    with pytest.raises(ValueError):
        LearnedPerceptualImagePatchSimilarity(net_type="resnet", device="cpu")
    with pytest.raises(ValueError):
        LearnedPerceptualImagePatchSimilarity(net=lambda a, b: a.sum(), reduction="max", device="cpu")
    with pytest.raises(ValueError):
        learned_perceptual_image_patch_similarity(torch.zeros(1, 3, 8, 8), torch.zeros(1, 3, 8, 8), net_type="resnet")
