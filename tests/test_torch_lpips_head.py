"""The port's LPIPS head kernel (B3) on the CPU, against the JAX package's ``lpips_head``.

On CPU tensors :func:`lpips_head` runs the oracle chain; the JAX side runs
its Pallas kernel in interpret mode (``pallas``) and its XLA graph (``xla``),
with no silent degradation, at the shapes and tolerances of
``tests/unittests/kernels/test_equivalence.py``: ``rtol=1e-5, atol=1e-7`` for
float32 features, ``rtol=1e-3, atol=1e-5`` for bfloat16 ones. The CUDA kernel
runs only on a card (``chip_smoke.py``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu import _kernels as K
from torchmetrics_tpu._kernels.dispatch import reset_degradations

lh = importlib.import_module("torchmetrics_tpu_torch._kernels.lpips_head")


@pytest.fixture(autouse=True)
def _clean_kernel_state(monkeypatch):
    reset_degradations()
    monkeypatch.delenv(K.KERNELS_ENV, raising=False)
    yield
    reset_degradations()


def _maps(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape).astype(np.float32), rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("shape", [(3, 13, 17, 64), (2, 7, 5, 35), (1, 33, 31, 256)])
def test_lpips_head_matches_jax(monkeypatch, mode, shape):
    monkeypatch.setenv(K.KERNELS_ENV, mode)
    f0, f1 = _maps(shape, seed=shape[-1])
    w = (np.random.default_rng(1).normal(size=(1, 1, shape[-1], 1)) * 0.3).astype(np.float32)
    want = K.lpips_head(jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(w))
    assert not K.degraded_kernels()
    got = lh.lpips_head(torch.from_numpy(f0), torch.from_numpy(f1), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
def test_lpips_head_bf16_features(monkeypatch, mode):
    monkeypatch.setenv(K.KERNELS_ENV, mode)
    f0, f1 = _maps((2, 6, 9, 64), seed=2)
    f0, f1 = (np.array(jnp.asarray(f, jnp.bfloat16), np.float32) for f in (f0, f1))
    w = (np.random.default_rng(3).normal(size=(64,)) * 0.3).astype(np.float32)
    want = K.lpips_head(jnp.asarray(f0, jnp.bfloat16), jnp.asarray(f1, jnp.bfloat16), jnp.asarray(w))
    got = lh.lpips_head(torch.from_numpy(f0).bfloat16(), torch.from_numpy(f1).bfloat16(), torch.from_numpy(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-5)


def test_identical_maps_are_at_distance_zero():
    f0, _ = _maps((2, 5, 4, 48), seed=4)
    got = lh.lpips_head(torch.from_numpy(f0), torch.from_numpy(f0), torch.rand(48))
    assert torch.equal(got, torch.zeros(2))


@pytest.mark.parametrize("shape", [(3, 13, 17, 64), (50, 63, 63, 64)])
def test_cost_matches_jax(shape):
    want = K.lpips_head_cost(jnp.zeros(shape), jnp.zeros(shape), jnp.zeros((shape[-1],)))
    meta = torch.empty(shape, device="meta")
    got = lh.lpips_head_cost(meta, meta, torch.empty(shape[-1], device="meta"))
    assert (got.flops, got.bytes_accessed) == (want.flops, want.bytes_accessed)


def test_cpu_tensors_never_launch():
    f0, f1 = _maps((2, 3, 3, 8), seed=5)
    lh.lpips_head(torch.from_numpy(f0), torch.from_numpy(f1), torch.ones(8))
    assert int(lh.lpips_head.launches) == 0


@pytest.mark.parametrize(
    ("args", "error"),
    [
        ((torch.zeros(2, 3, 3, 8), torch.zeros(2, 3, 3, 7), torch.ones(8)), ValueError),
        ((torch.zeros(2, 3, 3, 8), torch.zeros(2, 3, 3, 8), torch.ones(7)), ValueError),
        ((torch.zeros(2, 3, 8), torch.zeros(2, 3, 8), torch.ones(8)), ValueError),
        ((torch.zeros(2, 3, 3, 8, device="meta"), torch.zeros(2, 3, 3, 8, device="meta"), torch.ones(8, device="meta")), ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(args, error):
    with pytest.raises(error):
        lh.lpips_head(*args)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("shape", [(2, 6, 9, 64), (3, 5, 4, 192), (1, 7, 7, 40)])
def test_lpips_head_bf16_maps_equal_jax_of_their_float32_cast(monkeypatch, mode, shape):
    """bf16 -> float32 is exact, so bf16 maps read as they are agree with the float32 cast at float32's tolerance."""
    monkeypatch.setenv(K.KERNELS_ENV, mode)
    f0, f1 = _maps(shape, seed=shape[-1] + 1)
    t0, t1 = torch.from_numpy(f0).bfloat16(), torch.from_numpy(f1).bfloat16()
    w = (np.random.default_rng(6).normal(size=(shape[-1],)) * 0.3).astype(np.float32)
    want = K.lpips_head(jnp.asarray(t0.float().numpy()), jnp.asarray(t1.float().numpy()), jnp.asarray(w))
    assert not K.degraded_kernels()
    got = lh.lpips_head(t0, t1, torch.from_numpy(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


# (B, H, W, C) of every LPIPS tap at 50 pairs of 256x256 (chip_smoke.py's main path), then odd shapes
TAPS = {
    "alex": [(50, 63, 63, 64), (50, 31, 31, 192), (50, 15, 15, 384), (50, 15, 15, 256)],
    "vgg": [(50, 256, 256, 64), (50, 128, 128, 128), (50, 64, 64, 256), (50, 32, 32, 512), (50, 16, 16, 512)],
    "squeeze": [(50, 127, 127, 64), (50, 63, 63, 128), (50, 31, 31, 256), (50, 15, 15, 384), (50, 15, 15, 512)],
    "odd": [(1, 1, 1, 8), (3, 5, 7, 35), (2, 9, 9, 5), (7, 3, 3, 1000), (1, 300, 301, 24), (4096, 2, 2, 64), (2, 1, 1, 1)],
}
H100_SMS = 132


def _covered_pixels(plan, hw, threads):
    """How often the kernel's loops (csrc/lpips_head.cu) visit each pixel of one row, over every block of its cluster."""
    counts = np.zeros(hw, np.int64)
    groups_per_warp = 32 // plan.lanes
    warp_step = groups_per_warp * plan.pix
    stride = (threads // 32) * warp_step
    for rank in range(plan.cluster):
        p_begin = rank * plan.pixels_per_block
        p_end = min(p_begin + plan.pixels_per_block, hw)
        for warp in range(threads // 32):
            bases = np.arange(p_begin + warp * warp_step, max(p_end, p_begin), stride)
            for q in range(plan.pix):
                for group in range(groups_per_warp):
                    p = bases + q * groups_per_warp + group
                    np.add.at(counts, p[p < p_end], 1)
    return counts


@pytest.mark.parametrize("elem_bytes", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("shape", [s for taps in TAPS.values() for s in taps], ids=str)
def test_head_plan_covers_every_pixel_and_channel_once(shape, aligned, elem_bytes):
    b, h, w, c = shape
    if c > (1024 if aligned and c % (16 // elem_bytes) == 0 else 512):  # at most 32 channels a lane
        with pytest.raises(ValueError):
            lh.head_plan(b, h * w, c, elem_bytes, aligned, H100_SMS)
        return
    plan = lh.head_plan(b, h * w, c, elem_bytes, aligned, H100_SMS)
    assert np.array_equal(_covered_pixels(plan, h * w, lh.THREADS), np.ones(h * w, np.int64))
    # channels: vector k * lanes + sub of lane `sub`, masked past the last one
    vectors = c // plan.vec
    assert c % plan.vec == 0 and plan.vec in (1, 16 // elem_bytes)
    seen = [k * plan.lanes + sub for k in range(plan.k) for sub in range(plan.lanes) if k * plan.lanes + sub < vectors]
    assert sorted(seen) == list(range(vectors))
    # within the card's and the kernel's limits
    assert 32 % plan.lanes == 0 and plan.k in lh.K_STEPS and plan.k * plan.vec <= lh.MAX_LANE_CHANNELS
    assert lh.THREADS <= 1024
    assert 1 <= plan.cluster <= lh.MAX_CLUSTER and b * plan.cluster <= 2**31 - 1
    assert c * 4 <= lh.MAX_WEIGHT_BYTES


@pytest.mark.parametrize("elem_bytes", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [s for net in ("alex", "vgg", "squeeze") for s in TAPS[net]], ids=str)
def test_head_plan_covers_the_card_twice_at_every_tap(shape, elem_bytes):
    """At 50 pairs every tap's grid is at least two waves of blocks over the H100's 132 SMs, with 16-byte loads."""
    b, h, w, c = shape
    plan = lh.head_plan(b, h * w, c, elem_bytes, True, H100_SMS)
    assert b * plan.cluster >= 2 * H100_SMS and plan.vec == 16 // elem_bytes


def test_head_plan_refuses_channels_past_the_registers():
    with pytest.raises(ValueError):
        lh.head_plan(2, 4, 4096, 4, True, H100_SMS)


def test_cost_halves_the_feature_bytes_at_bf16():
    shape = (50, 63, 63, 64)
    f32 = lh.lpips_head_cost(torch.empty(shape, device="meta"), None, torch.empty(64, device="meta"))
    bf16 = lh.lpips_head_cost(torch.empty(shape, device="meta", dtype=torch.bfloat16), None, torch.empty(64, device="meta"))
    want = K.lpips_head_cost(jnp.zeros(shape), jnp.zeros(shape), jnp.zeros((64,)))
    assert (f32.flops, f32.bytes_accessed) == (want.flops, want.bytes_accessed)
    feature_bytes = 2.0 * 50 * 63 * 63 * 64 * 4
    assert bf16.flops == f32.flops and f32.bytes_accessed - bf16.bytes_accessed == feature_bytes / 2
