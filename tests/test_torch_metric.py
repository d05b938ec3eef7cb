"""The port's ``Metric`` runtime and classification classes against the JAX package, on the CPU.

Each class is streamed over 4 batches of the same numpy inputs in both
packages, alternating ``forward`` and ``update``; batch values and
``compute`` are compared with the tolerances of ``test_torch_classification.py``
(counts exact, rates ``atol=1e-6, rtol=1e-5``).
"""

import json
import os
import pickle
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as JC
import torchmetrics_tpu.metric as jax_metric
import torchmetrics_tpu_torch as tt
import torchmetrics_tpu_torch.classification as TC
from torchmetrics_tpu_torch.metric import CompositionalMetric
from torchmetrics_tpu_torch.utilities import gather_all_tensors, state_from_jax
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

from tests.test_torch_classification import C, C_LARGE, L, assert_same, binary_inputs, multiclass_inputs, multilabel_inputs

BATCHES = 4

CONFIGS = {
    "binary_accuracy": ("BinaryAccuracy", {}, lambda s: binary_inputs(s)),
    "binary_stat_scores_samplewise": (
        "BinaryStatScores", {"multidim_average": "samplewise"}, lambda s: binary_inputs(s, samplewise=True)
    ),
    "binary_confusion_matrix": ("BinaryConfusionMatrix", {"ignore_index": -1}, lambda s: binary_inputs(s, ignore_index=-1)),
    "multiclass_accuracy_top2": ("MulticlassAccuracy", {"num_classes": C, "top_k": 2}, lambda s: multiclass_inputs(s)),
    "multiclass_accuracy_macro_ignore": (
        "MulticlassAccuracy", {"num_classes": C, "ignore_index": -1}, lambda s: multiclass_inputs(s, ignore_index=-1)
    ),
    "multiclass_stat_scores_samplewise": (
        "MulticlassStatScores", {"num_classes": C, "average": None, "multidim_average": "samplewise"},
        lambda s: multiclass_inputs(s, samplewise=True),
    ),
    "multiclass_confusion_matrix": (
        "MulticlassConfusionMatrix", {"num_classes": C, "normalize": "true"}, lambda s: multiclass_inputs(s)
    ),
    "multiclass_confusion_matrix_large": (
        "MulticlassConfusionMatrix", {"num_classes": C_LARGE, "ignore_index": -1},
        lambda s: multiclass_inputs(s, c=C_LARGE, ignore_index=-1),
    ),
    "multilabel_accuracy": ("MultilabelAccuracy", {"num_labels": L, "average": "weighted"}, lambda s: multilabel_inputs(s)),
    "multilabel_confusion_matrix": ("MultilabelConfusionMatrix", {"num_labels": L}, lambda s: multilabel_inputs(s)),
}


def make_pair(config):
    cls_name, kwargs, _ = CONFIGS[config]
    return getattr(JC, cls_name)(**kwargs), getattr(TC, cls_name)(device="cpu", **kwargs)


def batches(config, seed=0):
    make = CONFIGS[config][2]
    return [make(100 * seed + b) for b in range(BATCHES)]


def feed(jax_metric, torch_metric, arrays, use_forward):
    j_args, t_args = [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]
    if use_forward:
        assert_same(torch_metric(*t_args), jax_metric(*j_args))
    else:
        jax_metric.update(*j_args)
        torch_metric.update(*t_args)


def stream(jax_metric, torch_metric, data):
    for b, arrays in enumerate(data):
        feed(jax_metric, torch_metric, arrays, use_forward=b % 2 == 0)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_stream_forward_update_compute(config):
    jm, tm = make_pair(config)
    stream(jm, tm, batches(config))
    assert tm.update_count == jm.update_count == BATCHES
    assert_same(tm.compute(), jm.compute())


@pytest.mark.parametrize("config", ["multiclass_accuracy_top2", "multiclass_confusion_matrix_large"])
def test_reset_mid_stream(config):
    jm, tm = make_pair(config)
    data = batches(config)
    stream(jm, tm, data[:2])
    jm.reset()
    tm.reset()
    assert tm.update_count == 0
    stream(jm, tm, data[2:])
    assert_same(tm.compute(), jm.compute())


@pytest.mark.parametrize("config", ["multiclass_accuracy_top2", "binary_stat_scores_samplewise",
                                    "multiclass_confusion_matrix_large"])
def test_merge_state(config):
    data = batches(config)
    jm_a, tm_a = make_pair(config)
    jm_b, tm_b = make_pair(config)
    stream(jm_a, tm_a, data[:2])
    stream(jm_b, tm_b, data[2:])
    jm_a.merge_state(jm_b)
    tm_a.merge_state(tm_b)
    assert tm_a.update_count == BATCHES
    assert_same(tm_a.compute(), jm_a.compute())
    # the merge copied: streaming on into the source leaves the merged metric alone
    before = tm_a.compute()
    feed(jm_b, tm_b, data[0], use_forward=False)
    assert_same(tm_a.compute(), np.asarray(before))


@pytest.mark.parametrize("how", ["clone", "pickle"])
@pytest.mark.parametrize("config", ["multiclass_accuracy_macro_ignore", "multiclass_confusion_matrix_large",
                                    "multiclass_stat_scores_samplewise"])
def test_clone_and_pickle_mid_stream(config, how):
    jm, tm = make_pair(config)
    data = batches(config)
    stream(jm, tm, data[:2])
    copy = tm.clone() if how == "clone" else pickle.loads(pickle.dumps(tm))
    assert type(copy) is type(tm) and copy.update_count == 2
    jm_copy = jm.clone()
    stream(jm, tm, data[2:])
    stream(jm_copy, copy, data[2:])
    assert_same(copy.compute(), jm_copy.compute())
    assert_same(tm.compute(), jm.compute())


@pytest.mark.parametrize("config", ["multiclass_confusion_matrix_large", "multiclass_stat_scores_samplewise"])
def test_state_dict_round_trip(config):
    jm, tm = make_pair(config)
    stream(jm, tm, batches(config))
    assert tm.state_dict() == {}  # states are not persistent by default, as in the JAX package
    tm.persistent(True)
    jm.persistent(True)
    saved = tm.state_dict(prefix="m.")
    assert set(saved) == set(jm.state_dict(prefix="m."))
    _, fresh = make_pair(config)
    fresh.load_state_dict(saved, prefix="m.")
    fresh.update(*[torch.from_numpy(a) for a in batches(config, seed=1)[0]])
    tm.update(*[torch.from_numpy(a) for a in batches(config, seed=1)[0]])
    assert_same(fresh.compute(), tm.compute().numpy())
    strict = make_pair(config)[1]
    strict.persistent(True)
    with pytest.raises(KeyError):
        strict.load_state_dict({})


@pytest.mark.parametrize("config", ["multiclass_accuracy_top2", "multiclass_confusion_matrix_large",
                                    "binary_stat_scores_samplewise"])
def test_state_from_jax_continues_the_stream(config):
    jm, tm = make_pair(config)
    data = batches(config)
    for arrays in data[:2]:
        jm.update(*[jnp.asarray(a) for a in arrays])
    tm.load_state_dict(state_from_jax(jm.state_dict(all_states=True), device="cpu"))
    for arrays in data[2:]:
        feed(jm, tm, arrays, use_forward=False)
    assert_same(tm.compute(), jm.compute())


def test_compositional_metric_arithmetic():
    config = "multiclass_accuracy_macro_ignore"
    ja, ta = make_pair(config)
    kwargs = {"num_classes": C, "top_k": 2, "average": "micro", "ignore_index": -1}
    jb, tb = JC.MulticlassAccuracy(**kwargs), TC.MulticlassAccuracy(device="cpu", **kwargs)
    j_expr = (ja + jb) * 2 - abs(-ja) / 4
    t_expr = (ta + tb) * 2 - abs(-ta) / 4
    assert isinstance(t_expr, CompositionalMetric)
    for b, arrays in enumerate(batches(config)):
        j_args, t_args = [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]
        if b % 2:
            j_expr.update(*j_args)
            t_expr.update(*t_args)
        else:
            assert_same(t_expr(*t_args), j_expr(*j_args))
    assert_same(t_expr.compute(), j_expr.compute())
    assert_same((1 - ta).compute(), (1 - ja).compute())
    assert_same((ta >= tb).compute(), (ja >= jb).compute())
    t_expr.reset()
    assert ta.update_count == tb.update_count == 0


def test_metric_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tt.MulticlassAccuracy(num_classes=C)
    assert tt.MulticlassAccuracy(num_classes=C, device="cpu").device == torch.device("cpu")


def test_sync_without_process_group_does_nothing():
    _, tm = make_pair("multiclass_confusion_matrix_large")
    tm.update(*[torch.from_numpy(a) for a in batches("multiclass_confusion_matrix_large")[0]])
    before = tm.confmat.clone()
    tm.sync()
    assert not tm._is_synced and torch.equal(tm.confmat, before)
    with tm.sync_context():
        assert torch.equal(tm.confmat, before)
    with pytest.raises(TorchMetricsUserError):
        tm.unsync()
    x = torch.arange(6).reshape(2, 3)
    assert len(gather_all_tensors(x)) == 1 and gather_all_tensors(x)[0] is x


def test_runtime_guards():
    _, tm = make_pair("multiclass_confusion_matrix")
    with pytest.raises(RuntimeError, match="Can't change const"):
        tm.full_state_update = True
    with pytest.raises(ValueError, match="Unexpected keyword arguments"):
        TC.MulticlassAccuracy(num_classes=C, device="cpu", auto_compile=False)
    with pytest.raises(TorchMetricsUserError):
        tm.merge_state(TC.MulticlassAccuracy(num_classes=C, device="cpu"))
    with pytest.raises(NotImplementedError):
        iter(tm)
    assert tm.to("cpu") is tm and tm.device == torch.device("cpu")
    assert isinstance(TC.Accuracy(task="multiclass", num_classes=C, device="cpu"), TC.MulticlassAccuracy)
    assert isinstance(TC.ConfusionMatrix(task="binary", device="cpu"), TC.BinaryConfusionMatrix)
    assert isinstance(TC.StatScores(task="multilabel", num_labels=L, device="cpu"), TC.MultilabelStatScores)


def test_compute_result_does_not_alias_the_state():
    """States are updated in place, so a value already returned must not move with them."""
    _, tm = make_pair("multiclass_confusion_matrix_large")
    data = batches("multiclass_confusion_matrix_large")
    tm.update(*[torch.from_numpy(a) for a in data[0]])
    first = tm.compute()
    snapshot = first.clone()
    tm.update(*[torch.from_numpy(a) for a in data[1]])
    assert torch.equal(first, snapshot)
    assert not torch.equal(tm.compute(), snapshot)


_SYNC_WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from torchmetrics_tpu_torch.classification import MulticlassConfusionMatrix
from torchmetrics_tpu_torch.utilities import gather_all_tensors
rank, world, port = (int(a) for a in sys.argv[1:4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
try:
    gathered = gather_all_tensors(torch.arange(rank + 2).reshape(-1, 1) * (rank + 1))
    m = MulticlassConfusionMatrix(num_classes=300, device="cpu")
    rng = np.random.default_rng(rank)
    m.update(torch.from_numpy(rng.integers(0, 300, 64)), torch.from_numpy(rng.integers(0, 300, 64)))
    local = m.confmat.clone()
    synced = m.compute()
    print(json.dumps({"gathered": [g.tolist() for g in gathered], "synced_sum": int(synced.sum()),
                      "synced_trace": int(synced.trace()), "local_restored": bool(torch.equal(m.confmat, local))}))
finally:
    dist.destroy_process_group()
"""


def test_two_process_gloo_gather_and_sync():
    """Uneven shapes pad-and-trim through ``gather_all_tensors``; ``compute`` sums states across ranks, then unsyncs."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": root}
    procs = [
        subprocess.Popen([sys.executable, "-c", _SYNC_WORKER, str(rank), "2", str(port)], cwd=root, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)
    ]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            proc.kill()
    expected_trace = 0
    for rank in range(2):
        rng = np.random.default_rng(rank)
        p, t = rng.integers(0, 300, 64), rng.integers(0, 300, 64)
        expected_trace += int((p == t).sum())
    for out in outs:
        assert out["gathered"] == [[[0], [1]], [[0], [2], [4]]]
        assert out["synced_sum"] == 128 and out["synced_trace"] == expected_trace
        assert out["local_restored"]


class _JaxEveryReduction(jax_metric.Metric):
    full_state_update = False

    def __init__(self):
        super().__init__(auto_compile=False)
        self.add_state("s", jnp.zeros(3), dist_reduce_fx="sum")
        self.add_state("m", jnp.zeros(3), dist_reduce_fx="mean")
        self.add_state("hi", jnp.full(3, -jnp.inf), dist_reduce_fx="max")
        self.add_state("lo", jnp.full(3, jnp.inf), dist_reduce_fx="min")
        self.add_state("c", [], dist_reduce_fx="cat")
        self.add_state("n", jnp.zeros(3), dist_reduce_fx=None)
        self.add_state("f", jnp.zeros(3), dist_reduce_fx=lambda x: jnp.sum(x, axis=0))

    def update(self, x):
        self.s = self.s + x
        self.m = x
        self.hi = jnp.maximum(self.hi, x)
        self.lo = jnp.minimum(self.lo, x)
        self.c.append(x)
        self.n = x
        self.f = self.f + 2 * x

    def compute(self):
        return self.s + self.m


class _TorchEveryReduction(tt.Metric):
    full_state_update = False

    def __init__(self):
        super().__init__(device="cpu")
        self.add_state("s", torch.zeros(3), dist_reduce_fx="sum")
        self.add_state("m", torch.zeros(3), dist_reduce_fx="mean")
        self.add_state("hi", torch.full((3,), -float("inf")), dist_reduce_fx="max")
        self.add_state("lo", torch.full((3,), float("inf")), dist_reduce_fx="min")
        self.add_state("c", [], dist_reduce_fx="cat")
        self.add_state("n", torch.zeros(3), dist_reduce_fx=None)
        self.add_state("f", torch.zeros(3), dist_reduce_fx=lambda x: x.sum(0))

    def update(self, x):
        self.s += x
        self.m = x
        self.hi = torch.maximum(self.hi, x)
        self.lo = torch.minimum(self.lo, x)
        self.c.append(x)
        self.n = x
        self.f += 2 * x

    def compute(self):
        return self.s + self.m


class _JaxEveryReductionFullState(_JaxEveryReduction):
    full_state_update = True


class _TorchEveryReductionFullState(_TorchEveryReduction):
    full_state_update = True


def _assert_states_equal(torch_metric, jax_metric_):
    for name, value in torch_metric.metric_state.items():
        want = jax_metric_.metric_state[name]
        if isinstance(value, list):
            assert len(value) == len(want)
            for got_el, want_el in zip(value, want):
                assert_same(got_el, want_el)
        else:
            assert_same(value, want)


@pytest.mark.parametrize("how", ["forward", "forward_full_state", "merge_metric", "merge_dict"])
def test_every_reduction_matches_jax(how):
    """sum / mean / max / min / cat / None / callable states through both forward modes and merge_state."""
    rng = np.random.default_rng(20)
    xs = [rng.normal(size=3).astype(np.float32) for _ in range(6)]
    if how == "forward_full_state":
        jm, tm = _JaxEveryReductionFullState(), _TorchEveryReductionFullState()
    else:
        jm, tm = _JaxEveryReduction(), _TorchEveryReduction()
    for x in xs[:3]:
        assert_same(tm(torch.from_numpy(x)), jm(jnp.asarray(x)))
    if how.startswith("merge"):
        jo, to = _JaxEveryReduction(), _TorchEveryReduction()
        for x in xs[3:]:
            jo(jnp.asarray(x))
            to(torch.from_numpy(x))
        if how == "merge_metric":
            jm.merge_state(jo)
            tm.merge_state(to)
        else:
            jm.merge_state(jo.metric_state)
            tm.merge_state(to.metric_state)
    _assert_states_equal(tm, jm)
    assert tm.update_count == jm.update_count
    assert_same(tm.compute(), jm.compute())
