"""The port's IS, KID, MiFID and PPL on the CPU, against the JAX package.

Features come from a seeded callable given to both packages (a fixed
projection of the pixels), and once from the built-in InceptionV3 on the
weights of ``test_torch_image.py`` (``logits_unbiased``, float32). Both
packages draw their permutations from numpy's global generator, so
``np.random.seed`` before each ``compute`` gives both the same subsets.
Tolerances, relative:

- IS: the mean 1e-6 (softmax, log-softmax and float32 means); the std 1e-6
  of the mean, absolute, since a float32 rounding of each split's score
  (~1e-7 of the mean) moves a std of a few hundredths by that much;
- KID 1e-4, or 1e-6 absolute where that is larger: the unbiased MMD
  subtracts sums of cubed kernel values of ~1e0 to leave ~1e-2;
- MiFID's cosine term 1e-6; its FID part 1e-4, as FID's own parity test
  (two float32 eigensolvers);
- PPL distances 1e-5 with ``epsilon=1e-2``, as the JAX suite runs it: the
  images differ by ~1e-2, so a float32 rounding of an image (~3e-8) is
  ~3e-6 of the difference and ~6e-6 of its square. With ``resize`` the
  antialiased resizes differ by up to 2.4e-7 (``test_torch_image_quality.py``),
  which the same division turns into up to ~5e-5 (seen 1.2e-5): 1e-4 there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu.image as JI
import torchmetrics_tpu_torch.image as PI
from tests.test_torch_image import inception  # noqa: F401  (the module's seeded trunk weights)
from torchmetrics_tpu.collections import MetricCollection as JaxCollection
from torchmetrics_tpu.image.perceptual_path_length import perceptual_path_length as jax_ppl
from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.image.perceptual_path_length import perceptual_path_length

KID_RTOL, KID_ATOL = 1e-4, 1e-6


class _Projection:
    """A seeded 'feature extractor': flattened pixels times a fixed matrix, in either framework."""

    def __init__(self, framework, d=16, in_dim=3 * 8 * 8, scale=1.0):
        self.framework = framework
        self.num_features = d
        self.w = (scale * np.random.default_rng(0).normal(0, 1 / np.sqrt(in_dim), (in_dim, d))).astype(np.float32)

    def __call__(self, imgs):
        if self.framework == "jax":
            x = jnp.asarray(imgs, jnp.float32).reshape(imgs.shape[0], -1) / 255.0
            return x @ jnp.asarray(self.w)
        x = torch.as_tensor(imgs).to(torch.float32).reshape(imgs.shape[0], -1) / 255.0
        return x @ torch.from_numpy(self.w)


def _images(seed, n, shift=0):
    imgs = np.random.default_rng(seed).integers(0, 256, (n, 3, 8, 8))
    return np.clip(imgs + shift, 0, 255).astype(np.uint8)


def _scalar_close(got, want, rtol, atol=0.0):
    assert float(got) == pytest.approx(float(want), rel=rtol, abs=atol)


@pytest.mark.parametrize("splits", [1, 4, 10])
def test_inception_score_with_a_callable_matches_jax(splits):
    port = PI.InceptionScore(feature=_Projection("torch", d=10, scale=20.0), splits=splits, device="cpu")
    jax_metric = JI.InceptionScore(feature=_Projection("jax", d=10, scale=20.0), splits=splits, auto_compile=False)
    for i in range(3):
        imgs = _images(i, 40)
        port.update(torch.from_numpy(imgs))
        jax_metric.update(jnp.asarray(imgs))
    np.random.seed(7)
    got = port.compute()
    np.random.seed(7)
    want = jax_metric.compute()
    assert float(got[0]) > 1.1  # the logits are spread enough for the score to move off 1
    _scalar_close(got[0], want[0], 1e-6)
    _scalar_close(got[1], want[1], 0.0, 1e-6 * float(want[0]))


def test_inception_score_on_the_built_in_trunk_matches_jax(inception):  # noqa: F811
    imgs = np.random.default_rng(3).integers(0, 256, (6, 3, 24, 24), dtype=np.uint8)
    port = PI.InceptionScore(weights_path=inception["npz"], compute_dtype=torch.float32, splits=2, device="cpu")
    jax_metric = JI.InceptionScore(weights_path=inception["npz"], compute_dtype=jnp.float32, splits=2,
                                   auto_compile=False)
    port.update(torch.from_numpy(imgs))
    jax_metric.update(jnp.asarray(imgs))
    got_features, want_features = port.features[0].numpy(), np.asarray(jax_metric.features[0])
    assert got_features.shape == (6, 1008)
    assert np.linalg.norm(got_features - want_features) / np.linalg.norm(want_features) < 1e-4
    np.random.seed(1)
    got = port.compute()
    np.random.seed(1)
    want = jax_metric.compute()
    _scalar_close(got[0], want[0], 1e-6)
    _scalar_close(got[1], want[1], 0.0, 1e-6 * float(want[0]))


def _stream(port, jax_metric, n=3, batch=30):
    for i in range(n):
        real, fake = _images(10 + i, batch), _images(20 + i, batch, shift=30)
        port.update(torch.from_numpy(real), real=True)
        port.update(torch.from_numpy(fake), real=False)
        jax_metric.update(jnp.asarray(real), real=True)
        jax_metric.update(jnp.asarray(fake), real=False)


@pytest.mark.parametrize(
    "kwargs", [{"subsets": 5, "subset_size": 40}, {"subsets": 1, "subset_size": 90, "degree": 2, "coef": 0.5},
               {"subsets": 8, "subset_size": 25, "gamma": 0.25}],
    ids=["default_kernel", "one_subset_degree2", "gamma"],
)
def test_kid_with_a_callable_matches_jax(kwargs):
    port = PI.KernelInceptionDistance(feature=_Projection("torch"), device="cpu", **kwargs)
    jax_metric = JI.KernelInceptionDistance(feature=_Projection("jax"), auto_compile=False, **kwargs)
    _stream(port, jax_metric)
    np.random.seed(3)
    got = port.compute()
    np.random.seed(3)
    want = jax_metric.compute()
    for g, w in zip(got, want):
        _scalar_close(g, w, KID_RTOL, KID_ATOL)


def test_kid_against_float64_numpy_on_the_same_subsets():
    port = PI.KernelInceptionDistance(feature=_Projection("torch"), subsets=6, subset_size=30, device="cpu")
    for i in range(3):
        port.update(torch.from_numpy(_images(30 + i, 30)), real=True)
        port.update(torch.from_numpy(_images(40 + i, 30, shift=20)), real=False)
    real = torch.cat(port.real_features).double().numpy()
    fake = torch.cat(port.fake_features).double().numpy()
    np.random.seed(5)
    got = port.compute()
    np.random.seed(5)
    scores = []
    for _ in range(6):
        x = real[np.random.permutation(len(real))[:30]]
        y = fake[np.random.permutation(len(fake))[:30]]
        k = lambda a, b: (a @ b.T / a.shape[1] + 1.0) ** 3  # noqa: E731
        kxx, kyy, kxy = k(x, x), k(y, y), k(x, y)
        m = 30
        scores.append((kxx.sum() - np.trace(kxx) + kyy.sum() - np.trace(kyy)) / (m * (m - 1)) - 2 * kxy.sum() / m**2)
    _scalar_close(got[0], np.mean(scores), KID_RTOL, KID_ATOL)
    _scalar_close(got[1], np.std(scores, ddof=1), KID_RTOL, KID_ATOL)


@pytest.mark.parametrize("eps", [0.1, 1.0], ids=["eps_0.1", "eps_1"])
def test_mifid_with_a_callable_matches_jax(eps):
    port = PI.MemorizationInformedFrechetInceptionDistance(feature=_Projection("torch"), cosine_distance_eps=eps,
                                                           device="cpu")
    jax_metric = JI.MemorizationInformedFrechetInceptionDistance(feature=_Projection("jax"), cosine_distance_eps=eps,
                                                                 auto_compile=False)
    _stream(port, jax_metric)
    _scalar_close(port.compute(), jax_metric.compute(), 1e-4)
    from torchmetrics_tpu.image.mifid import _compute_cosine_distance as jax_cosine
    from torchmetrics_tpu_torch.image.mifid import _compute_cosine_distance

    fake, real = torch.cat(port.fake_features), torch.cat(port.real_features)
    _scalar_close(_compute_cosine_distance(fake, real, eps),
                  jax_cosine(jnp.asarray(fake.numpy()), jnp.asarray(real.numpy()), eps), 1e-6)


def test_kid_and_mifid_share_one_compute_group():
    """The same trunk and the same ``update(imgs, real)`` give equal states: one group, one feature pass an update."""
    calls = []

    class Counting(_Projection):
        def __call__(self, imgs):
            calls.append(len(imgs))
            return super().__call__(imgs)

    feature = Counting("torch")
    port = MetricCollection({"kid": PI.KernelInceptionDistance(feature=feature, subsets=4, subset_size=30, device="cpu"),
                             "mifid": PI.MemorizationInformedFrechetInceptionDistance(feature=feature, device="cpu")})
    jax_col = JaxCollection({
        "kid": JI.KernelInceptionDistance(feature=_Projection("jax"), subsets=4, subset_size=30, auto_compile=False),
        "mifid": JI.MemorizationInformedFrechetInceptionDistance(feature=_Projection("jax"), auto_compile=False),
    })
    _stream(port, jax_col)
    assert [sorted(g) for g in port.compute_groups.values()] == [["kid", "mifid"]]
    assert len(calls) == 2 + 5  # both members on the first update, then the head alone
    np.random.seed(9)
    got = port.compute()
    np.random.seed(9)
    want = jax_col.compute()
    for g, w in zip(got["kid"], want["kid"]):
        _scalar_close(g, w, KID_RTOL, KID_ATOL)
    _scalar_close(got["mifid"], want["mifid"], 1e-4)


@pytest.mark.parametrize("cls", ["KernelInceptionDistance", "MemorizationInformedFrechetInceptionDistance"])
def test_reset_real_features_false_keeps_the_real_features(cls):
    """``reset`` keeps the real features. A ``forward`` after it merges the batch's state, which holds the kept
    real features, into the state that holds them too: both packages (and torchmetrics) then list them twice."""
    kwargs = {"subsets": 2, "subset_size": 20} if cls.startswith("Kernel") else {}
    port = getattr(PI, cls)(feature=_Projection("torch"), reset_real_features=False, device="cpu", **kwargs)
    jax_metric = getattr(JI, cls)(feature=_Projection("jax"), reset_real_features=False, auto_compile=False, **kwargs)
    for metric, as_array in ((port, torch.from_numpy), (jax_metric, jnp.asarray)):
        metric.update(as_array(_images(50, 30)), real=True)
        metric.update(as_array(_images(51, 30, shift=10)), real=False)
        metric.reset()
        assert len(metric.real_features) == 1 and len(metric.fake_features) == 0
        metric(as_array(_images(52, 30, shift=10)), real=False)
    assert (len(port.real_features), len(port.fake_features)) == (len(jax_metric.real_features),
                                                                  len(jax_metric.fake_features)) == (2, 1)
    again = getattr(PI, cls)(feature=_Projection("torch"), device="cpu", **kwargs)
    again.update(torch.from_numpy(_images(50, 30)), real=True)
    again.reset()
    assert len(again.real_features) == 0


class _ToyGenerator:
    """A seeded generator in either framework: ``tanh(z @ W [+ label embedding])`` reshaped to 3x16x16."""

    num_classes = 4

    def __init__(self, framework):
        self.framework = framework
        rng = np.random.default_rng(11)
        self.w = rng.normal(0, 1, (8, 3 * 16 * 16)).astype(np.float32)
        self.embed = rng.normal(0, 0.5, (4, 3 * 16 * 16)).astype(np.float32)
        self.rng = np.random.default_rng(3)

    def sample(self, n):
        z = self.rng.normal(0, 1, (n, 8)).astype(np.float32)
        return jnp.asarray(z) if self.framework == "jax" else torch.from_numpy(z)

    def __call__(self, z, labels=None):
        xp = jnp if self.framework == "jax" else torch
        w = jnp.asarray(self.w) if self.framework == "jax" else torch.from_numpy(self.w)
        h = z @ w
        if labels is not None:
            h = h + (jnp.asarray(self.embed) if self.framework == "jax" else torch.from_numpy(self.embed))[labels]
        return xp.tanh(h).reshape(-1, 3, 16, 16)


class _L2Sim:
    def __call__(self, a, b):
        return ((a - b) ** 2).mean(axis=(1, 2, 3)) if isinstance(a, jnp.ndarray) else ((a - b) ** 2).mean(dim=(1, 2, 3))


PPL_CASES = {
    "lerp": ({"interpolation_method": "lerp"}, 1e-5),
    "slerp_any": ({"interpolation_method": "slerp_any"}, 1e-5),
    "slerp_unit": ({"interpolation_method": "slerp_unit"}, 1e-5),
    "conditional": ({"conditional": True}, 1e-5),
    "no_discards": ({"lower_discard": None, "upper_discard": None}, 1e-5),
    "resize_8": ({"resize": 8}, 1e-4),
}


@pytest.mark.parametrize(("kwargs", "rtol"), list(PPL_CASES.values()), ids=list(PPL_CASES))
def test_perceptual_path_length_matches_jax(kwargs, rtol):
    common = {"num_samples": 40, "batch_size": 16, "epsilon": 1e-2, "resize": None, "sim_net": _L2Sim()}
    common.update(kwargs)
    want = jax_ppl(_ToyGenerator("jax"), **common)
    got = perceptual_path_length(_ToyGenerator("torch"), device=torch.device("cpu"), **common)
    assert got[2].shape == (40,)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=rtol)
    for g, w in zip(got[:2], want[:2]):
        _scalar_close(g, w, rtol)


def test_perceptual_path_length_class_matches_the_functional():
    kwargs = {"num_samples": 32, "batch_size": 16, "epsilon": 1e-2, "resize": None, "sim_net": _L2Sim()}
    port = PI.PerceptualPathLength(device="cpu", **kwargs)
    port.update(_ToyGenerator("torch"))
    jax_metric = JI.PerceptualPathLength(auto_compile=False, **kwargs)
    jax_metric.update(_ToyGenerator("jax"))
    got, want = port.compute(), jax_metric.compute()
    for g, w in zip(got[:2], want[:2]):
        _scalar_close(g, w, 1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5)


def test_perceptual_path_length_builds_lpips_vgg_on_its_device():
    mean, std, dists = perceptual_path_length(_ToyGenerator("torch"), num_samples=4, batch_size=2, resize=32,
                                              device=torch.device("cpu"))
    assert dists.shape == (4,) and dists.device.type == "cpu" and torch.isfinite(dists).all()
    assert torch.isfinite(mean) and torch.isfinite(std)


def test_perceptual_path_length_refuses_what_the_jax_package_refuses():
    with pytest.raises(ValueError, match="torch.device"):
        perceptual_path_length(_ToyGenerator("torch"), device="cpu", sim_net=_L2Sim())
    with pytest.raises(NotImplementedError, match="sample"):
        perceptual_path_length(object(), device=torch.device("cpu"))
    with pytest.raises(ValueError, match="interpolation_method"):
        perceptual_path_length(_ToyGenerator("torch"), interpolation_method="nearest", device=torch.device("cpu"))
    with pytest.raises(AttributeError, match="num_classes"):

        class NoClasses(_ToyGenerator):
            num_classes = property(lambda self: (_ for _ in ()).throw(AttributeError("num_classes")))

        perceptual_path_length(NoClasses("torch"), conditional=True, device=torch.device("cpu"))


def test_generative_classes_default_to_cuda():
    """Built without ``device=``, a metric keeps its states (and its trunk) on ``cuda``: with no GPU it raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    for make in (lambda: PI.InceptionScore(feature=_Projection("torch")),
                 lambda: PI.KernelInceptionDistance(feature=_Projection("torch")),
                 lambda: PI.PerceptualPathLength(sim_net=_L2Sim())):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
