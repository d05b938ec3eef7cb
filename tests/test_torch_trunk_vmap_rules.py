"""The trunk kernels' vmap rules on the CPU: every lane of a ``torch.func.vmap`` in one call of the wrapper.

``conv_bias_act`` (B2a pointwise, B2b after a spatial conv), ``lpips_head``
(B3), ``attention`` (B4), ``layernorm_residual`` (B5) and ``biquad_bank``
(S1) each send a vmapped lane through a ``torch.library.custom_op`` whose
vmap rule folds the lanes into the batch or the rows and calls the wrapper
once; on the CPU the wrapper then takes its plain version, once. Each rule is
run with the per-lane fallback off, with the lanes at dim 0 and at dim 1, and
with an activation unbatched (shared by every lane), against a loop of one
call a lane. At these shapes the plain versions give each row of the folded
batch the bits of its own lane's call (a GEMM row, one image's conv, one
head's attention, one row's statistics, one channel's recurrence), so the
folded call is held to the loop bit for bit; a larger CPU GEMM may tile its
sums by the batch, which the card's kernels do not (``chip_smoke.py`` phase
53). A batched weight raises. The card's launches are in
``test_torch_streams_card.py``.
"""

import importlib

import pytest
import torch

from torchmetrics_tpu_torch.utilities.checks import _no_vmap_fallback

ce, lh, ka, kb = (
    importlib.import_module(f"torchmetrics_tpu_torch._kernels.{name}")
    for name in ("conv_epilogue", "lpips_head", "attention", "biquad")
)
LANES = 3
DTYPES = [torch.float32, torch.bfloat16]


def _vmap(fn, in_dims, *args):
    with torch.no_grad(), _no_vmap_fallback():
        return torch.func.vmap(fn, in_dims=in_dims)(*args)


def _stack(per_lane, dim):
    """The lanes stacked at ``dim`` (``None``: the first lane's tensor, shared by all)."""
    return per_lane[0] if dim is None else torch.stack(per_lane, dim=dim)


def _lanes(tensors, dim):
    return [tensors[0]] * LANES if dim is None else tensors


class _Calls:
    """A counting stand-in for a module-level function, recording the leading size of its first argument."""

    def __init__(self, monkeypatch, module, name):
        self.rows, self.fn = [], getattr(module, name)
        monkeypatch.setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        self.rows.append(args[0].shape[0])
        return self.fn(*args, **kwargs)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ------------------------------------------------------------------ B2a, B2b
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("lane_dim", [0, 1])
@pytest.mark.parametrize("kind", ["pointwise", "spatial"])
def test_conv_bias_act_folds_the_lanes_into_one_call(monkeypatch, kind, lane_dim, dtype):
    g = _gen(1)
    k, stride, padding = (1, 1, 0) if kind == "pointwise" else (3, 2, 1)
    xs = [torch.randn(2, 16, 9, 9, generator=g).to(dtype).contiguous(memory_format=torch.channels_last)
          for _ in range(LANES)]
    w = (torch.randn(24, 16, k, k, generator=g) * 0.2).to(dtype)
    b = torch.randn(24, generator=g).to(dtype)
    if lane_dim == 0:  # each lane channels_last, as a trunk's maps are: the folded batch needs no copy
        x = torch.stack([t.permute(0, 2, 3, 1) for t in xs]).permute(0, 1, 4, 2, 3)
    else:
        x = torch.stack(xs, dim=1)
    mm = _Calls(monkeypatch, ce, "matmul_bias_relu")
    br = _Calls(monkeypatch, ce, "bias_relu_")
    monkeypatch.setattr(ce.conv_bias_act, "layout_copies", 0)  # restored after the test: the counter is process-wide
    got = _vmap(lambda t: ce.conv_bias_act(t, w, b, stride, padding), lane_dim, x)
    copies = ce.conv_bias_act.layout_copies
    calls = (len(mm.rows), len(br.rows))
    assert calls == ((1, 0) if kind == "pointwise" else (0, 1))  # one call for every lane
    assert (mm.rows or br.rows)[0] == LANES * 2 * got.shape[-2] * got.shape[-1]
    assert copies == (0 if lane_dim == 0 else 1)  # lanes at dim 1 are folded through one channels_last copy
    want = torch.stack([ce.conv_bias_act(t, w, b, stride, padding) for t in xs])
    assert got.dtype == dtype and torch.equal(got, want)
    assert all(got[i].is_contiguous(memory_format=torch.channels_last) for i in range(LANES))
    assert int(mm.fn.launches) == int(br.fn.launches) == 0  # the CPU launches nothing


@pytest.mark.parametrize("batched", ["weight", "bias"])
def test_conv_bias_act_refuses_batched_weights(batched):
    g = _gen(2)
    x = torch.randn(LANES, 1, 4, 5, 5, generator=g)
    w, b = torch.randn(LANES, 6, 4, 1, 1, generator=g), torch.randn(LANES, 6, generator=g)
    args = (x, w, b[0]) if batched == "weight" else (x, w[0], b)
    dims = (0, 0, None) if batched == "weight" else (0, None, 0)
    with pytest.raises(ValueError, match=f"`{batched}` is batched"):
        _vmap(lambda *a: ce.conv_bias_act(*a), dims, *args)


# ------------------------------------------------------------------------ B3
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shared", [None, "f0", "f1"])
@pytest.mark.parametrize("lane_dim", [0, 1])
def test_lpips_head_folds_the_lanes_into_one_call(monkeypatch, lane_dim, shared, dtype):
    g = _gen(3)
    f0s = [torch.randn(2, 5, 6, 24, generator=g).to(dtype) for _ in range(LANES)]
    f1s = [torch.randn(2, 5, 6, 24, generator=g).to(dtype) for _ in range(LANES)]
    weight = torch.rand(1, 24, 1, 1, generator=g)
    d0, d1 = (None if shared == "f0" else lane_dim), (None if shared == "f1" else lane_dim)
    plain = _Calls(monkeypatch, lh, "lpips_head_plain")
    got = _vmap(lambda a, c: lh.lpips_head(a, c, weight), (d0, d1), _stack(f0s, d0), _stack(f1s, d1))
    assert plain.rows == [LANES * 2]
    want = torch.stack([lh.lpips_head(a, c, weight) for a, c in zip(_lanes(f0s, d0), _lanes(f1s, d1))])
    assert got.shape == (LANES, 2) and torch.equal(got, want)
    assert int(lh.lpips_head.launches) == 0


def test_lpips_head_refuses_a_batched_weight():
    f = torch.randn(LANES, 2, 3, 3, 8)
    with pytest.raises(ValueError, match="`weight` is batched"):
        _vmap(lambda a, c, w: lh.lpips_head(a, c, w), (0, 0, 0), f, f, torch.rand(LANES, 8))


# ------------------------------------------------------------------------ B4
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shared", [None, "mask", "k"])
@pytest.mark.parametrize("lane_dim", [0, 1])
def test_attention_folds_the_lanes_into_one_call(monkeypatch, lane_dim, shared, dtype):
    g = _gen(4)
    qs, ks, vs = ([torch.randn(2, 7, 16, generator=g).to(dtype) for _ in range(LANES)] for _ in range(3))
    masks = [(torch.rand(2, 7, generator=g) < 0.8).float() for _ in range(LANES)]
    dims = tuple(None if shared == name else lane_dim for name in ("q", "k", "v", "mask"))
    args = [_stack(t, d) for t, d in zip((qs, ks, vs, masks), dims)]
    plain = _Calls(monkeypatch, ka, "attention_plain")
    got = _vmap(lambda q, k, v, m: ka.attention(q, k, v, m, num_heads=4), dims, *args)
    assert plain.rows == [LANES * 2]
    lanes = [_lanes(t, d) for t, d in zip((qs, ks, vs, masks), dims)]
    want = torch.stack([ka.attention(q, k, v, m, num_heads=4) for q, k, v, m in zip(*lanes)])
    assert got.dtype == dtype and torch.equal(got, want)
    assert int(ka.attention.launches) == 0


# ------------------------------------------------------------------------ B5
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shared", [None, "h"])
@pytest.mark.parametrize("lane_dim", [0, 1])
def test_layernorm_residual_folds_the_lanes_into_one_call(monkeypatch, lane_dim, shared, dtype):
    g = _gen(5)
    xs = [torch.randn(2, 7, 16, generator=g).to(dtype) for _ in range(LANES)]
    hs = [torch.randn(2, 7, 16, generator=g) for _ in range(LANES)]
    scale, bias = torch.rand(16, generator=g), torch.randn(16, generator=g)
    dx, dh = lane_dim, (None if shared == "h" else lane_dim)
    plain = _Calls(monkeypatch, ka, "layernorm_residual_plain")
    got = _vmap(lambda x, h: ka.layernorm_residual(x, h, scale, bias, eps=1e-5), (dx, dh), _stack(xs, dx), _stack(hs, dh))
    assert plain.rows == [LANES]  # the lanes as more rows of one call
    want = torch.stack([ka.layernorm_residual(x, h, scale, bias, eps=1e-5) for x, h in zip(xs, _lanes(hs, dh))])
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert int(ka.layernorm_residual.launches) == 0


@pytest.mark.parametrize("batched", ["scale", "bias"])
def test_layernorm_residual_refuses_batched_weights(batched):
    x = torch.randn(LANES, 2, 8)
    w = torch.rand(LANES, 8)
    args = (x, x, w, w[0]) if batched == "scale" else (x, x, w[0], w)
    dims = (0, 0, 0, None) if batched == "scale" else (0, 0, None, 0)
    with pytest.raises(ValueError, match=f"`{batched}` is batched"):
        _vmap(lambda a, c, s, b: ka.layernorm_residual(a, c, s, b, eps=1e-5), dims, *args)


# ------------------------------------------------------------------------ S1
def _biquad_coefs(g, sections):
    b = torch.rand(sections, 5, 3, generator=g) * 0.1
    a = torch.cat([torch.ones(5, 1), torch.rand(5, 2, generator=g) * 0.2], dim=1)
    return b, a, (torch.rand(5, generator=g) + 1.0 if sections == 4 else None)


@pytest.mark.parametrize("sections", [1, 4])
@pytest.mark.parametrize("lane_dim", [0, 1])
def test_biquad_bank_folds_the_lanes_into_one_call(monkeypatch, lane_dim, sections):
    g = _gen(6)
    xs = [torch.randn(2, 50, generator=g) for _ in range(LANES)]
    b, a, gain = _biquad_coefs(g, sections)
    plain = _Calls(monkeypatch, kb, "biquad_bank_plain")
    got = _vmap(lambda x: kb.biquad_bank(x, b, a, gain), lane_dim, _stack(xs, lane_dim))
    assert plain.rows == [LANES * 2]  # the lanes' rows as the rows of one call
    want = torch.stack([kb.biquad_bank(x, b, a, gain) for x in xs])
    assert got.shape == (LANES, 2, 5, 50) and torch.equal(got, want)
    assert int(kb.biquad_bank.launches) == 0


def test_biquad_bank_refuses_batched_coefficients():
    g = _gen(7)
    b, a, gain = _biquad_coefs(g, 4)
    with pytest.raises(ValueError, match="`b` is batched"):
        _vmap(lambda x, bb: kb.biquad_bank(x, bb, a, gain), (0, 0), torch.randn(LANES, 2, 20), torch.stack([b] * LANES))


def test_each_op_is_registered_once_under_the_package_namespace():
    ops = [ce._conv_op(), lh._head_op(), ka._attention_op(), ka._layernorm_op(), kb._biquad_op()]
    assert ops == [ce._conv_op(), lh._head_op(), ka._attention_op(), ka._layernorm_op(), kb._biquad_op()]
    names = sorted(op._qualname for op in ops)
    assert names == [f"torchmetrics_tpu_torch::{n}"
                     for n in ("attention", "biquad_bank", "conv_bias_act", "layernorm_residual", "lpips_head")]
