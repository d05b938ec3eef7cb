"""The port's attention (B4) and layernorm+residual (B5) kernels on the CPU, against the JAX package.

On CPU tensors the wrappers run their plain versions; the JAX side runs its
Pallas kernels in interpret mode (``TM_TPU_KERNELS=pallas``) with no silent
degradation, at the tolerances of ``tests/unittests/kernels/test_equivalence.py``:
``rtol=atol=2e-5`` in float32 and ``2e-2`` in bfloat16 for attention,
``rtol=atol=1e-5`` for the LayerNorm. The CUDA kernels run only on a card
(``chip_smoke.py``).

Inputs are bf16-representable, so both packages start from the same values
in either dtype. The Pallas comparisons keep one real key in every row, as
the JAX suite does; a row whose keys are all masked is held against the XLA
oracle (``_xla_attention``), whose answer the port follows.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu import _kernels as K
from torchmetrics_tpu._kernels.attention import _xla_attention
from torchmetrics_tpu._kernels.dispatch import reset_degradations

ka = importlib.import_module("torchmetrics_tpu_torch._kernels.attention")

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    """The JAX side runs its Pallas kernels (interpret mode on the CPU) and must not degrade to XLA."""
    reset_degradations()
    monkeypatch.setenv(K.KERNELS_ENV, "pallas")
    yield
    assert not K.degraded_kernels()
    reset_degradations()


def _bf16_exact(rng, shape, scale=1.0):
    """float32 values that bfloat16 holds exactly."""
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _qkv_mask(seed, bsz, length, hidden):
    rng = np.random.default_rng(seed)
    q, k, v = (_bf16_exact(rng, (bsz, length, hidden)) for _ in range(3))
    mask = rng.integers(0, 2, (bsz, length)).astype(np.float32)
    mask[:, 0] = 1  # one real key per row
    return q, k, v, mask


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hidden,heads", [(96, 4), (128, 2)], ids=["96x4", "128x2"])
@pytest.mark.parametrize("length", [37, 128])
def test_attention_plain_matches_jax(dtype, hidden, heads, length):
    tdt, jdt = DTYPES[dtype]
    q, k, v, mask = _qkv_mask(length + hidden, 2, length, hidden)
    want = K.attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(mask), num_heads=heads)
    got = ka.attention_plain(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), torch.from_numpy(mask), num_heads=heads)
    assert got.dtype == tdt and got.shape == (2, length, hidden)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL[dtype])


def test_fully_masked_row_follows_the_xla_oracle():
    """All keys masked: every score rounds to -1e9, so the oracle's softmax is uniform: the mean of V over L."""
    q, k, v, mask = _qkv_mask(3, 2, 37, 96)
    mask[1] = 0
    want = _xla_attention(*(jnp.asarray(a) for a in (q, k, v, mask)), num_heads=4)
    got = ka.attention(*(torch.from_numpy(a) for a in (q, k, v, mask)), num_heads=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[1].numpy(), np.broadcast_to(v[1].mean(axis=0), (37, 96)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtypes", [("float32", "float32"), ("bfloat16", "bfloat16"), ("float32", "bfloat16")],
                         ids=["f32", "bf16", "f32+bf16"])
@pytest.mark.parametrize("feat", [256, 70])  # the JAX package's Pallas path, and its XLA-only path
def test_layernorm_residual_plain_matches_jax(dtypes, feat):
    rng = np.random.default_rng(feat)
    x, h = _bf16_exact(rng, (3, 5, feat)), _bf16_exact(rng, (3, 5, feat))
    scale, bias = rng.normal(size=(feat,)).astype(np.float32), rng.normal(size=(feat,)).astype(np.float32)
    (tx, jx), (th, jh) = DTYPES[dtypes[0]], DTYPES[dtypes[1]]
    want = K.layernorm_residual(jnp.asarray(x, jx), jnp.asarray(h, jh), jnp.asarray(scale), jnp.asarray(bias), eps=1e-12)
    got = ka.layernorm_residual_plain(
        torch.from_numpy(x).to(tx), torch.from_numpy(h).to(th), torch.from_numpy(scale), torch.from_numpy(bias), eps=1e-12
    )
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_wrappers_take_the_plain_versions_on_cpu_tensors():
    ka.attention.launches.reset()
    ka.layernorm_residual.launches.reset()
    q, k, v, mask = (torch.from_numpy(a) for a in _qkv_mask(5, 3, 20, 64))
    assert torch.equal(ka.attention(q, k, v, mask.long(), num_heads=2), ka.attention_plain(q, k, v, mask, num_heads=2))
    x, h = q.bfloat16(), k
    s, b = torch.rand(64), torch.rand(64)
    assert torch.equal(ka.layernorm_residual(x, h, s, b, eps=1e-12), ka.layernorm_residual_plain(x, h, s, b, eps=1e-12))
    assert int(ka.attention.launches) == 0 and int(ka.layernorm_residual.launches) == 0


def test_wrappers_refuse_bad_shapes():
    q = torch.zeros(2, 5, 64)
    with pytest.raises(ValueError, match="heads"):
        ka.attention(q, q, q, torch.ones(2, 5), num_heads=5)
    with pytest.raises(ValueError, match="mask"):
        ka.attention(q, q, q, torch.ones(2, 4), num_heads=2)
    with pytest.raises(ValueError, match="do not fit"):
        ka.layernorm_residual(q, q, torch.ones(63), torch.zeros(64), eps=1e-12)


def test_costs_are_the_jax_packages():
    from torchmetrics_tpu._kernels.attention import attention_cost, layernorm_residual_cost

    q = jnp.zeros((3, 128, 768), jnp.float32)
    m = jnp.ones((3, 128))
    want = attention_cost(q, q, q, m, num_heads=12)
    got = ka.attention_cost(*(torch.empty(3, 128, 768, device="meta"),) * 3, torch.empty(3, 128), num_heads=12)
    assert (got.flops, got.bytes_accessed) == (want.flops, want.bytes_accessed)
    x = jnp.zeros((3, 128, 768), jnp.bfloat16)
    want = layernorm_residual_cost(x, x, jnp.ones(768), jnp.zeros(768))
    t = torch.empty(3, 128, 768, dtype=torch.bfloat16, device="meta")
    got = ka.layernorm_residual_cost(t, t, torch.ones(768), torch.zeros(768))
    assert (got.flops, got.bytes_accessed) == (want.flops, want.bytes_accessed)


# -------------------------------------------- the card kernel's number formats, emulated

ATT_F32_RTOL = 1e-5  # chip_smoke.py's tolerance for B4 in float32: of the output's scale


def _tf32_rna(x):
    """``cvt.rna.tf32.f32`` on the CPU: round float32 to 10 mantissa bits, to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """``a @ b`` as B4 forms it on the tensor cores: hi = tf32(x), lo = tf32(x - hi), lo*hi + hi*lo + hi*hi in float32."""
    a_hi, b_hi = _tf32_rna(a), _tf32_rna(b)
    a_lo, b_lo = _tf32_rna(a - a_hi), _tf32_rna(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _mm_1xtf32(a, b):
    return _tf32_rna(a) @ _tf32_rna(b)


def _attention_with(mm, q, k, v, mask, num_heads):
    """Masked attention per head with products ``mm``; scale, -1e9 bias and softmax in float32 after them."""
    bsz, length, hidden = q.shape
    d = hidden // num_heads
    split = lambda t: t.reshape(bsz, length, num_heads, d).transpose(1, 2)  # noqa: E731
    scores = mm(split(q), split(k).transpose(-1, -2)) * (1.0 / math.sqrt(d))
    scores = scores + (1.0 - mask[:, None, None, :]) * -1e9
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    ctx = mm(p, split(v)) / p.sum(dim=-1, keepdim=True)
    return ctx.transpose(1, 2).reshape(bsz, length, hidden)


@pytest.mark.parametrize(("bsz", "length", "hidden", "heads"), [(4, 37, 96, 4), (2, 128, 768, 12)])
def test_3xtf32_products_hold_the_float32_tolerance(bsz, length, hidden, heads):
    """B4's float32 design, on the CPU: 3xTF32 products stay within ATT_F32_RTOL of a float64 oracle; one TF32 pass does not.

    Ragged masks as padded sentences give, with row 0 fully masked: that row is
    still the mean of V over the L keys.
    """
    rng = np.random.default_rng(length + hidden)
    q, k, v = (torch.from_numpy(rng.normal(size=(bsz, length, hidden)).astype(np.float32)) for _ in range(3))
    lens = rng.integers(max(1, length // 10), length + 1, bsz)
    mask = torch.from_numpy((np.arange(length)[None, :] < lens[:, None]).astype(np.float32))
    mask[0] = 0.0
    want = ka.attention_plain(q.double(), k.double(), v.double(), mask.double(), num_heads=heads).float()
    scale = float(want.abs().max())
    got = _attention_with(_mm_3xtf32, q, k, v, mask, heads)
    assert float((got - want).abs().max()) <= ATT_F32_RTOL * scale
    assert float((got[0] - v[0].mean(dim=0)).abs().max()) <= ATT_F32_RTOL * scale
    one_pass = _attention_with(_mm_1xtf32, q, k, v, mask, heads)
    assert float((one_pass - want).abs().max()) > 10 * ATT_F32_RTOL * scale  # plain TF32 would break "highest"


def test_tf32_rounding_is_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-11), 1.0 + 2**-12, 3.0], dtype=torch.float32)
    want = torch.tensor([1.0 + 2**-10, 1.0 + 2 * 2**-10, -(1.0 + 2**-10), 1.0, 3.0], dtype=torch.float32)
    assert torch.equal(_tf32_rna(x), want)
    y = torch.from_numpy(np.random.default_rng(0).normal(size=1000).astype(np.float32))
    hi = _tf32_rna(y)
    assert float(((y - hi) / y).abs().max()) <= 2**-11 and float(((y - hi - _tf32_rna(y - hi)) / y).abs().max()) <= 2**-21


@pytest.mark.parametrize(("bsz", "length", "hidden", "heads"), [(4, 37, 96, 4), (2, 128, 768, 12)])
def test_bf16_design_with_p_in_two_parts_holds_one_bf16_step(bsz, length, hidden, heads):
    """B4's bf16 design: exact Q K^T, P as two bf16 parts for P V; within one bf16 step of the float32 plain version."""
    rng = np.random.default_rng(length)
    q, k, v = (torch.from_numpy(_bf16_exact(rng, (bsz, length, hidden))) for _ in range(3))
    lens = rng.integers(max(1, length // 10), length + 1, bsz)
    mask = torch.from_numpy((np.arange(length)[None, :] < lens[:, None]).astype(np.float32))
    mask[0] = 0.0

    def mm(a, b):
        if a.shape[-1] == b.shape[-2] == length:  # P V: P in two bf16 parts, V exact in bf16
            a_hi = a.bfloat16().float()
            return a_hi @ b + (a - a_hi).bfloat16().float() @ b
        return a @ b  # bf16 products are exact in float32

    got = _attention_with(mm, q, k, v, mask, heads).bfloat16().float()
    want = ka.attention_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask, num_heads=heads).float()
    scale = float(want.abs().max())
    assert bool(((got - want).abs() <= 2**-7 * want.abs() + ATT_F32_RTOL * scale).all())
