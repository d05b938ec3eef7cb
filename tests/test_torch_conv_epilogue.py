"""The port's conv epilogue kernels (B2a, B2b) on the CPU, against the JAX package's ``conv_bias_act``.

On a CPU tensor :func:`conv_bias_act` runs the kernels' plain versions; the
JAX side runs its Pallas kernels in interpret mode (``pallas``) and its XLA
graph (``xla``), with no silent degradation. Shapes and tolerances are those
of ``tests/unittests/kernels/test_equivalence.py``: ``2e-5`` in float32,
``2e-2`` in bfloat16 (the two frameworks round bf16 at other places). The
CUDA kernels run only on a card (``chip_smoke.py``).
"""

import importlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu import _kernels as K
from torchmetrics_tpu._kernels.dispatch import reset_degradations

ce = importlib.import_module("torchmetrics_tpu_torch._kernels.conv_epilogue")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [
    ((1, 1, 70, 33), (1, 1), ((0, 0), (0, 0))),  # pointwise: B2a, odd C in/out
    ((3, 3, 70, 20), (2, 2), ((1, 1), (1, 1))),  # spatial: library conv + B2b
    ((1, 7, 70, 24), (1, 1), ((0, 0), (3, 3))),  # asymmetric Inception-C shape
]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _clean_kernel_state(monkeypatch):
    reset_degradations()
    monkeypatch.delenv(K.KERNELS_ENV, raising=False)
    yield
    reset_degradations()


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _inputs(kshape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 9, 11, kshape[2])).astype(np.float32)
    w = (rng.normal(size=kshape) * 0.1).astype(np.float32)
    b = rng.normal(size=(kshape[-1],)).astype(np.float32)
    return x, w, b


def _port_conv(x, w, b, strides, padding, dtype):
    """NHWC/HWIO numpy -> the port's NCHW channels_last / OIHW call -> NHWC numpy."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype).contiguous(memory_format=torch.channels_last)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1).to(dtype).contiguous()
    pad = (padding[0][0], padding[1][0])
    out = ce.conv_bias_act(xt, wt, torch.from_numpy(b).to(dtype), stride=strides, padding=pad)
    assert out.dtype == dtype and out.is_contiguous(memory_format=torch.channels_last)
    return out.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(("kshape", "strides", "padding"), SHAPES)
def test_conv_bias_act_matches_jax(monkeypatch, mode, dtype, kshape, strides, padding):
    monkeypatch.setenv(K.KERNELS_ENV, mode)
    jdt, tdt = DTYPES[dtype]
    x, w, b = _inputs(kshape, seed=sum(kshape))
    # both sides see the same (rounded) inputs
    x, w, b = (np.array(jnp.asarray(a, jdt), np.float32) for a in (x, w, b))
    want = K.conv_bias_act(jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b, jdt), strides=strides, padding=padding)
    assert not K.degraded_kernels()
    got = _port_conv(x, w, b, strides, padding, tdt)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **_tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(("m", "k", "n"), [(257, 70, 33), (130, 192, 48), (5, 3, 7)])
def test_matmul_bias_relu_plain_matches_the_pallas_gemm(dtype, m, k, n):
    """B2a's plain version against the TPU kernel ``_pallas_matmul_bias_relu`` in interpret mode, tails in M, K and N."""
    from torchmetrics_tpu._kernels.conv_epilogue import _pallas_matmul_bias_relu

    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(m + k + n)
    x = np.array(jnp.asarray(rng.normal(size=(m, k)), jdt), np.float32)
    w = np.array(jnp.asarray(rng.normal(size=(k, n)) / np.sqrt(k), jdt), np.float32)
    b = np.array(jnp.asarray(rng.normal(size=(n,)), jdt), np.float32)
    want = _pallas_matmul_bias_relu(jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b, jdt), interpret=True)
    got = ce.matmul_bias_relu(
        torch.from_numpy(x).to(tdt), torch.from_numpy(w.T.copy()).to(tdt), torch.from_numpy(b).to(tdt)
    )
    assert got.dtype == tdt and got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **_tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_bias_relu_plain_matches_the_pallas_pass(dtype):
    """B2b's plain version against ``_pallas_bias_relu`` in interpret mode, in place on the port's side."""
    from torchmetrics_tpu._kernels.conv_epilogue import _pallas_bias_relu

    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    y = np.array(jnp.asarray(rng.normal(size=(300, 20)), jdt), np.float32)
    b = np.array(jnp.asarray(rng.normal(size=(20,)), jdt), np.float32)
    want = _pallas_bias_relu(jnp.asarray(y, jdt), jnp.asarray(b, jdt), interpret=True)
    yt = torch.from_numpy(y).to(tdt)
    got = ce.bias_relu_(yt, torch.from_numpy(b).to(tdt))
    assert got.data_ptr() == yt.data_ptr()
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **_tol(dtype))


@pytest.mark.parametrize(("kshape", "strides", "padding"), SHAPES)
def test_cost_matches_jax(kshape, strides, padding):
    x, w, b = _inputs(kshape, seed=0)
    want = K.conv_bias_act_cost(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), strides=strides, padding=padding)
    meta = lambda shape: torch.empty(shape, device="meta")  # noqa: E731
    got = ce.conv_bias_act_cost(
        meta((2, kshape[2], 9, 11)), meta((kshape[3], kshape[2], kshape[0], kshape[1])), meta((kshape[3],)),
        stride=strides, padding=(padding[0][0], padding[1][0]),
    )
    assert (got.flops, got.bytes_accessed) == (want.flops, want.bytes_accessed)


def test_cpu_tensors_never_launch_or_copy():
    before = (ce.matmul_bias_relu.launches, ce.bias_relu_.launches, ce.conv_bias_act.layout_copies)
    x = torch.randn(2, 8, 5, 5).contiguous(memory_format=torch.channels_last)
    ce.conv_bias_act(x, torch.randn(4, 8, 1, 1), torch.randn(4))
    ce.conv_bias_act(x, torch.randn(4, 8, 3, 3), torch.randn(4), padding=1)
    assert (ce.matmul_bias_relu.launches, ce.bias_relu_.launches, ce.conv_bias_act.layout_copies) == before == (0, 0, 0)


def test_a_contiguous_nchw_input_is_copied_once_and_counted():
    before = ce.conv_bias_act.layout_copies
    x = torch.randn(2, 8, 5, 5)  # NCHW-contiguous, not channels_last
    want = ce.conv_bias_act(x.contiguous(memory_format=torch.channels_last), torch.ones(4, 8, 1, 1), torch.zeros(4))
    got = ce.conv_bias_act(x, torch.ones(4, 8, 1, 1), torch.zeros(4))
    assert ce.conv_bias_act.layout_copies == before + 1
    torch.testing.assert_close(got, want)
    ce.conv_bias_act.layout_copies = before


@pytest.mark.parametrize(
    ("args", "error"),
    [
        ((torch.zeros(4, 3), torch.zeros(2, 3, dtype=torch.float64), torch.zeros(2)), TypeError),
        ((torch.zeros(4, 3), torch.zeros(2, 3).bfloat16(), torch.zeros(2)), TypeError),
        ((torch.zeros(4, 3), torch.zeros(2, 5), torch.zeros(2)), ValueError),
        ((torch.zeros(4, 3), torch.zeros(2, 3), torch.zeros(3)), ValueError),
        ((torch.zeros(4, 3, device="meta"), torch.zeros(2, 3, device="meta"), torch.zeros(2, device="meta")), ValueError),
    ],
)
def test_gemm_wrapper_rejects_what_the_kernel_does_not_take(args, error):
    with pytest.raises(error):
        ce.matmul_bias_relu(*args)


def test_modules_import_and_run_without_nvcc():
    """No CUDA toolkit: the kernel modules import and their CPU paths run without touching the build."""
    code = (
        "import importlib, shutil, torch\n"
        "ce = importlib.import_module('torchmetrics_tpu_torch._kernels.conv_epilogue')\n"
        "lh = importlib.import_module('torchmetrics_tpu_torch._kernels.lpips_head')\n"
        "assert shutil.which('nvcc') is None\n"
        "x = torch.randn(1, 4, 3, 3).contiguous(memory_format=torch.channels_last)\n"
        "assert ce.conv_bias_act(x, torch.randn(2, 4, 1, 1), torch.randn(2)).shape == (1, 2, 3, 3)\n"
        "f = torch.randn(1, 3, 3, 4)\n"
        "assert lh.lpips_head(f, f, torch.ones(4)).abs().max() == 0\n"
        "assert ce._library.cache_info().currsize == 0 and lh._library.cache_info().currsize == 0\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PATH": os.path.dirname(sys.executable), "CUDA_HOME": os.path.join(ROOT, "no-cuda-here")}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize(
    ("dtype", "m", "k", "n", "aligned", "route"),
    [
        (BF16, 245000, 192, 64, True, "tma_wgmma"),  # 35x35, batch 200
        (BF16, 12800, 2048, 448, True, "tma_wgmma"),  # 8x8: two column tiles
        (BF16, 77, 1288, 72, True, "tma_wgmma"),  # ragged M and K: TMA zero-fills the boxes
        (BF16, 1, 8, 8, True, "tma_wgmma"),
        (BF16, 1001, 70, 33, True, "element"),  # K % 8 != 0: rows are not 16-byte strided
        (BF16, 129, 8, 5, True, "element"),  # N % 8 != 0: no 8-column stores
        (BF16, 1001, 64, 40, False, "element"),  # a base off 16 bytes
        (F32, 245000, 192, 64, True, "fma_f32"),
        (F32, 1001, 70, 33, False, "fma_f32"),
    ],
)
def test_gemm_route_by_dtype_shape_and_alignment(dtype, m, k, n, aligned, route):
    assert ce._mm_route(dtype, m, k, n, aligned) == route


def test_every_inception_pointwise_conv_takes_the_tma_route():
    """All 40 pointwise convs of one InceptionV3 forward meet the TMA kernel's conditions at batch 200."""
    from torchmetrics_tpu_torch.image._inception import BasicConv2d, InceptionV3

    with torch.device("meta"):
        net = InceptionV3(dtype=torch.bfloat16, fuse_bn=True)
    convs = [mod.Conv_0 for mod in net.modules() if isinstance(mod, BasicConv2d)]
    pointwise = [c for c in convs if c.kernel_size == (1, 1) and c.stride == (1, 1) and c.padding == (0, 0)]
    assert len(convs) == 94 and len(pointwise) == 40
    for conv in pointwise:
        n, k = conv.weight.shape[:2]
        assert ce._mm_route(BF16, 200 * 73 * 73, k, n, True) == "tma_wgmma", (k, n)


@pytest.mark.parametrize(("m", "n"), [(2**31, 64), (64, 2**31)])
def test_gemm_route_refuses_rows_past_a_32_bit_box_coordinate(m, n):
    with pytest.raises(ValueError, match="2\\*\\*31"):
        ce._mm_route(BF16, m, 64, n, True)
    assert ce._mm_route(BF16, m, 64, n + 1, True) == "element"  # the element kernel's 64-bit indices take it
