"""The stream pool's kernel route on a CUDA card (skipped where there is none).

Kernel B1's lane-batched launch (``confusion_matrix_lanes``) against its
plain version at a pool's micro-batch shapes, once a call; and a pooled
1,000-class confusion matrix on the card: captured into one CUDA graph per
signature and capacity, B1 launched once a micro-batch whatever the number
of lanes, every tenant's matrix equal to the plain version's counts. The
trunk kernels' vmap rules (B2a/B2b, B3, B4, B5, S1): one launch for every
lane, against a launch a lane; a pooled FID whose trunk runs inline in the
pool's graph; a trunk's ``CapturedForward`` on a vmapped lane. This file
imports no JAX: run it on the card with
``python -m pytest --noconftest tests/test_torch_streams_card.py``.
"""

import importlib

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tm
from torchmetrics_tpu_torch import _compile
from torchmetrics_tpu_torch.functional.classification import _confmat_kernel as K
from torchmetrics_tpu_torch.utilities.checks import _no_vmap_fallback

ce, lh, ka, kb = (
    importlib.import_module(f"torchmetrics_tpu_torch._kernels.{name}")
    for name in ("conv_epilogue", "lpips_head", "attention", "biquad")
)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("the lane-batched kernel launches only on a CUDA card")


@pytest.mark.cuda
def test_the_lane_batched_b1_kernel_matches_its_plain_version_on_the_card():
    _card()
    rng = np.random.default_rng(9)
    for lanes, n, c in ((64, 1024, 1000), (3, 1001, 300), (5, 7, 256)):
        preds = torch.from_numpy(rng.integers(-1, c + 1, (lanes, n))).cuda()
        target = torch.from_numpy(rng.integers(-1, c + 1, (lanes, n))).cuda()
        mask = torch.from_numpy(rng.random((lanes, n)) < 0.8).cuda()
        for weights in (None, mask):
            before = int(K.confusion_matrix_lanes.launches)
            got = K.confusion_matrix_lanes(preds, target, c, weights)
            assert int(K.confusion_matrix_lanes.launches) == before + 1
            want = K.confusion_matrix_lanes_plain(preds.cpu(), target.cpu(), c, None if weights is None else weights.cpu())
            assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_a_pooled_confusion_matrix_replays_one_graph_and_launches_b1_once_a_micro_batch():
    _card()
    rng = np.random.default_rng(10)
    c, lanes, rows, steps = 300, 6, 257, 5
    pool = tm.MulticlassConfusionMatrix(num_classes=c, device="cuda").to_stream_pool(capacity=lanes)
    ids = [pool.attach() for _ in range(lanes)]
    preds = torch.from_numpy(rng.integers(0, c, (steps, lanes, rows))).cuda()
    target = torch.from_numpy(rng.integers(0, c, (steps, lanes, rows))).cuda()
    K.confusion_matrix_lanes.launches.reset()
    for s in range(steps):
        pool.update(ids, preds[s], target[s])
    assert int(K.confusion_matrix_lanes.launches) == steps
    assert len(pool._step_fns) == 1 and isinstance(next(iter(pool._step_fns.values())), _compile.CapturedStep)
    got = pool.compute_all()
    for i, sid in enumerate(ids):
        want = K.confusion_matrix_plain(preds[:, i].reshape(-1).cpu(), target[:, i].reshape(-1).cpu(), c)
        assert torch.equal(got[sid].cpu(), want)


def _vmap(fn, *lanes):
    with torch.no_grad(), _no_vmap_fallback():
        return torch.func.vmap(fn)(*lanes)


@pytest.mark.cuda
def test_each_trunk_kernel_launches_once_for_every_lane_on_the_card():
    """A vmapped wrapper launches its kernel once for the lanes, and agrees with a launch a lane."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(11)
    lanes = 4
    x = torch.randn((lanes, 3, 9, 9, 64), generator=g, device="cuda").relu_().bfloat16().permute(0, 1, 4, 2, 3)
    w = (torch.randn((32, 64, 1, 1), generator=g, device="cuda") / 8).bfloat16()
    b = torch.randn(32, generator=g, device="cuda").bfloat16()
    f0, f1 = (torch.randn((lanes, 2, 7, 7, 64), generator=g, device="cuda").bfloat16() for _ in range(2))
    wt = torch.rand(64, generator=g, device="cuda")
    q, k, v = (torch.randn((lanes, 2, 17, 64), generator=g, device="cuda") for _ in range(3))
    mask = torch.ones((2, 17), device="cuda")
    coefs = (torch.rand(4, 5, 3) * 0.1, torch.cat([torch.ones(5, 1), torch.rand(5, 2) * 0.2], 1), torch.rand(5) + 1)
    audio = torch.randn((lanes, 2, 300), generator=g, device="cuda")
    cases = [
        (ce.matmul_bias_relu, lambda t: ce.conv_bias_act(t, w, b), (x,), 0.0),
        (lh.lpips_head, lambda a, c: lh.lpips_head(a, c, wt), (f0, f1), 1e-5),
        (ka.attention, lambda a, c, d: ka.attention(a, c, d, mask, num_heads=4), (q, k, v), 0.0),
        (ka.layernorm_residual, lambda a, c: ka.layernorm_residual(a, c, wt, wt, eps=1e-5), (q, k), 0.0),
        (kb.biquad_bank, lambda t: kb.biquad_bank(t, *coefs), (audio,), 0.0),
    ]
    for wrapper, fn, args, rtol in cases:
        before = int(wrapper.launches)
        got = _vmap(fn, *args)
        assert int(wrapper.launches) == before + 1, wrapper.__name__
        want = torch.stack([fn(*lane) for lane in zip(*args)])
        if rtol:
            torch.testing.assert_close(got, want, rtol=rtol, atol=1e-7)
        else:
            assert torch.equal(got, want), wrapper.__name__


@pytest.mark.cuda
def test_a_pooled_fid_runs_its_trunk_inline_and_each_conv_once_a_micro_batch():
    _card()
    rng = np.random.default_rng(12)
    lanes, steps = 3, 4
    pool = tm.FrechetInceptionDistance(feature=64, device="cuda").to_stream_pool(capacity=lanes)
    ids = [pool.attach() for _ in range(lanes)]
    imgs = torch.from_numpy(rng.integers(0, 256, (steps, lanes, 2, 3, 32, 32), dtype=np.uint8)).cuda()
    pool.update(ids, imgs[0], real=True)  # the key's warm-up and capture
    pool.update(ids, imgs[1], real=False)
    ce.bias_relu_.launches.reset()
    for s in range(2, steps):
        pool.update(ids, imgs[s], real=s % 2 == 0)
    assert int(ce.bias_relu_.launches) == 3 * (steps - 2)  # the stem's three spatial convs, once a step
    assert len(pool._step_fns) == 2 and all(isinstance(e, _compile.CapturedStep) for e in pool._step_fns.values())
    assert pool.capture_failures == {}
    assert pool._units[0].metric.inception.captured.graphs == {}  # the trunk lives in the pool's graphs


@pytest.mark.cuda
def test_a_trunk_runs_inline_on_a_vmapped_lane_on_the_card():
    _card()
    cap = _compile.CapturedForward()
    proj = torch.randn(12, 4, device="cuda")
    fn = lambda t: t.reshape(len(t), -1) @ proj  # noqa: E731
    x = torch.randn(3, 2, 3, 2, 2, device="cuda")
    for _ in range(3):  # a signature seen three times would be captured and replayed, were it not a lane
        got = _vmap(lambda lane: cap(fn, lane, statics=("lane",)), x)
    assert torch.equal(got, torch.stack([fn(lane) for lane in x]))
    assert cap.seen == set() and cap.graphs == {} and cap.pool is None
