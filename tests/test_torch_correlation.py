"""The port's correlation metrics on the CPU, against the JAX package, on data with heavy ties.

Pearson, concordance, Spearman and Kendall (tau-a, -b and -c, each
``alternative`` of its p-value) take the same seeded inputs in both
packages. The ranks of ``_rank_data`` and Kendall's pair counts are equal to
the JAX package's exactly: the ranks are integers or half-integers in
float32, and the counts are integers. Kendall's counts are also taken in row
tiles smaller than n. A two-process gloo sync of ``PearsonCorrCoef`` with
unequal halves equals the JAX package's ``_final_aggregation`` of the same
moment sets.
"""

import importlib
import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional.regression as JF
import torchmetrics_tpu.regression as JR
import torchmetrics_tpu_torch.functional.regression as PF
import torchmetrics_tpu_torch.regression as PR
from torchmetrics_tpu.functional.regression.pearson import _final_aggregation as jax_final_aggregation
from torchmetrics_tpu.functional.regression.pearson import _pearson_corrcoef_compute as jax_pearson_compute

from tests.test_torch_regression import assert_close

# the modules by path, for their private helpers
pkendall = importlib.import_module("torchmetrics_tpu_torch.functional.regression.kendall")
jkendall = importlib.import_module("torchmetrics_tpu.functional.regression.kendall")
putils = importlib.import_module("torchmetrics_tpu_torch.functional.regression.utils")
jutils = importlib.import_module("torchmetrics_tpu.functional.regression.utils")


def tied(seed, n=150, outputs=None):
    """STS-B-like scores: gold on a 0-5 grid in steps of 0.2, predictions on a grid of 0.5 (many ties on both)."""
    rng = np.random.default_rng(seed)
    shape = (n,) if outputs is None else (n, outputs)
    t = rng.integers(0, 26, shape) * 0.2
    p = np.round((t + rng.normal(0, 1.2, shape)) * 2) / 2
    return p.astype(np.float32), t.astype(np.float32)


@pytest.mark.parametrize("outputs", [None, 3])
def test_rank_data_equals_jax_bit_for_bit(outputs):
    p, t = tied(1, outputs=outputs)
    for x in (p, t, p.T if outputs else p[::-1].copy()):
        got = putils._rank_data(torch.from_numpy(np.ascontiguousarray(x)))
        want = np.asarray(jutils._rank_data(jnp.asarray(x)))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_rank_data_on_distinct_and_equal_values():
    x = np.array([3.0, -1.0, 3.0, 3.0, 0.5, -1.0, 7.0], np.float32)
    np.testing.assert_array_equal(putils._rank_data(torch.from_numpy(x)).numpy(), [5.0, 1.5, 5.0, 5.0, 3.0, 1.5, 7.0])
    np.testing.assert_array_equal(putils._rank_data(torch.ones(4)).numpy(), [2.5] * 4)


@pytest.mark.parametrize("fn_name", ["pearson_corrcoef", "concordance_corrcoef", "spearman_corrcoef"])
@pytest.mark.parametrize("outputs", [None, 2])
def test_correlations_on_ties(fn_name, outputs):
    p, t = tied(2, outputs=outputs)
    got = getattr(PF, fn_name)(torch.from_numpy(p), torch.from_numpy(t))
    want = getattr(JF, fn_name)(jnp.asarray(p), jnp.asarray(t))
    assert_close(got, want)


@pytest.mark.parametrize("variant", ["a", "b", "c"])
@pytest.mark.parametrize("alternative", ["two-sided", "less", "greater"])
@pytest.mark.parametrize("outputs", [None, 2])
def test_kendall_variants_and_p_values(variant, alternative, outputs):
    p, t = tied(3, outputs=outputs)
    got = PF.kendall_rank_corrcoef(torch.from_numpy(p), torch.from_numpy(t), variant=variant, t_test=True,
                                   alternative=alternative)
    want = JF.kendall_rank_corrcoef(jnp.asarray(p), jnp.asarray(t), variant=variant, t_test=True,
                                    alternative=alternative)
    assert_close(got, want)
    tau = PF.kendall_rank_corrcoef(torch.from_numpy(p), torch.from_numpy(t), variant=variant)
    assert_close(tau, want[0])


def _pair_counts_numpy(x, y):
    i, j = np.triu_indices(len(x), k=1)
    sx, sy = np.sign(x[j] - x[i]), np.sign(y[j] - y[i])
    return [int(((sx * sy) > 0).sum()), int(((sx * sy) < 0).sum()), int(((sx == 0) & (sy != 0)).sum()),
            int(((sy == 0) & (sx != 0)).sum()), int(((sx == 0) & (sy == 0)).sum())]


@pytest.mark.parametrize("tile", [1, 37, 150, 1 << 24])
def test_kendall_tiled_counts_are_exact(monkeypatch, tile):
    """Row tiles of ``tile // n`` rows (at least one) give the same int64 counts and the JAX package's tau."""
    p, t = tied(4)
    monkeypatch.setattr(pkendall, "_TILE_ELEMENTS", tile * len(p))
    counts = pkendall._pair_counts(torch.from_numpy(p), torch.from_numpy(t))
    assert counts.dtype == torch.int64
    assert counts.tolist() == _pair_counts_numpy(p.astype(np.float64), t.astype(np.float64))
    for variant in ("a", "b", "c"):
        tau, diff = pkendall._kendall_corrcoef_compute_single(torch.from_numpy(p), torch.from_numpy(t), variant)
        jtau, jdiff = jkendall._kendall_corrcoef_compute_single(jnp.asarray(p), jnp.asarray(t), variant)
        assert float(diff) == float(jdiff)
        np.testing.assert_array_equal(tau.numpy(), np.asarray(jtau))


def test_kendall_without_alternative_under_t_test():
    """``alternative=None`` with ``t_test``: both packages take the lower tail."""
    p, t = tied(5)
    got = PF.kendall_rank_corrcoef(torch.from_numpy(p), torch.from_numpy(t), t_test=True, alternative=None)
    want = JF.kendall_rank_corrcoef(jnp.asarray(p), jnp.asarray(t), t_test=True, alternative=None)
    assert_close(got, want)


@pytest.mark.parametrize("name", ["PearsonCorrCoef", "ConcordanceCorrCoef", "SpearmanCorrCoef", "KendallRankCorrCoef"])
def test_classes_on_ties(name):
    kwargs = {"variant": "c", "t_test": True, "alternative": "greater"} if name == "KendallRankCorrCoef" else {}
    pm, jm = getattr(PR, name)(**kwargs, device="cpu"), getattr(JR, name)(**kwargs, auto_compile=False)
    for seed in range(3):
        p, t = tied(10 + seed, n=40 + 13 * seed)
        pm.update(torch.from_numpy(p), torch.from_numpy(t))
        jm.update(jnp.asarray(p), jnp.asarray(t))
    assert_close(pm.compute(), jm.compute())


def test_pearson_merges_stack_moment_sets():
    """Each ``merge_state`` stacks the moment sets; ``compute`` folds (3, outputs) sets as the JAX package does."""
    parts = [tied(20 + i, n=n, outputs=2) for i, n in enumerate((30, 55, 12))]
    metrics = []
    for p, t in parts:
        m = PR.PearsonCorrCoef(num_outputs=2, device="cpu")
        m.update(torch.from_numpy(p), torch.from_numpy(t))
        metrics.append(m)
    moments = [[getattr(m, k).numpy() for k in ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")]
               for m in metrics]
    metrics[0].merge_state(metrics[1])
    metrics[0].merge_state(metrics[2])
    assert metrics[0].mean_x.shape == (3, 2)
    stacked = [jnp.asarray(np.stack([mom[i] for mom in moments])) for i in range(6)]
    _, _, vx, vy, cxy, nb = jax_final_aggregation(*stacked)
    assert_close(metrics[0].compute(), jax_pearson_compute(vx, vy, cxy, nb))
    whole = JR.PearsonCorrCoef(num_outputs=2, auto_compile=False)
    whole.update(jnp.asarray(np.concatenate([p for p, _ in parts])), jnp.asarray(np.concatenate([t for _, t in parts])))
    assert_close(metrics[0].compute(), whole.compute())


_GLOO_WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
import torchmetrics_tpu_torch as tt
rank, world, port = (int(a) for a in sys.argv[1:4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
try:
    rng = np.random.default_rng(300 + rank)
    n = 40 + 27 * rank  # unequal halves
    t = (rng.integers(0, 26, (n, 2)) * 0.2).astype(np.float32)
    p = (t + rng.normal(0, 1, (n, 2))).astype(np.float32)
    m = tt.PearsonCorrCoef(num_outputs=2, device="cpu")
    for half in (slice(0, n // 2), slice(n // 2, n)):
        m.update(torch.from_numpy(p[half]), torch.from_numpy(t[half]))
    local = {k: getattr(m, k).tolist() for k in ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")}
    with m.sync_context():
        synced_shape = list(m.mean_x.shape)
    print(json.dumps({"local": local, "synced_shape": synced_shape, "value": m.compute().tolist(),
                      "restored": list(m.mean_x.shape)}))
finally:
    dist.destroy_process_group()
"""


def test_two_process_gloo_sync_of_pearson():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": root}
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_WORKER, str(rank), "2", str(port)], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for rank in range(2)]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            proc.kill()
    names = ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")
    stacked = [jnp.asarray(np.array([o["local"][k] for o in outs], np.float32)) for k in names]
    _, _, vx, vy, cxy, nb = jax_final_aggregation(*stacked)
    want = np.asarray(jax_pearson_compute(vx, vy, cxy, nb))
    for out in outs:
        assert out["synced_shape"] == [2, 2] and out["restored"] == [2]
        np.testing.assert_allclose(np.array(out["value"], np.float32), want, rtol=1e-6, atol=1e-7)
