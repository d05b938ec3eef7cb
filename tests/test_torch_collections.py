"""``MetricCollection`` of the port against the JAX package, on the CPU.

A classification collection in the shape of BASELINE.json config 2 (accuracy,
precision, recall, F1, binned and exact AUROC, two confusion matrices) at a
small size streams the same seeded numpy batches through both packages: the
compute groups and every result must agree (counts exact, ratios
``atol=1e-6, rtol=1e-5``, AUROC ``atol=1e-6``).

The port's states are mutable tensors that the members of a compute group
share. A grouped collection is therefore held against its ungrouped twin
after mixed ``update``/``forward``/``reset``/``merge_state``/
``load_state_dict`` calls, with members whose update writes in place on the
full-state ``forward`` path: no batch may count twice. A two-process gloo
run checks that a synced collection computes what one process computes over
the concatenated data, and that ``unsync`` gives each rank its own states
back.
"""

import json
import os
import socket
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu.classification as JC
import torchmetrics_tpu_torch as tt
import torchmetrics_tpu_torch.classification as TC
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

from tests.test_torch_auroc import assert_tree

C, N = 5, 40


def config2(pkg, extra=None, **common):
    """Config 2's members at ``C`` classes, keyed by name (a dict: the collection sorts it)."""
    members = {
        "acc": pkg.MulticlassAccuracy(num_classes=C, average="micro", **common),
        "precision": pkg.MulticlassPrecision(num_classes=C, **common),
        "recall": pkg.MulticlassRecall(num_classes=C, **common),
        "f1": pkg.MulticlassF1Score(num_classes=C, **common),
        "auroc_binned": pkg.MulticlassAUROC(num_classes=C, thresholds=11, **common),
        "auroc_exact": pkg.MulticlassAUROC(num_classes=C, **common),
        "cm": pkg.MulticlassConfusionMatrix(num_classes=C, **common),
        "cm_true": pkg.MulticlassConfusionMatrix(num_classes=C, normalize="true", **common),
    }
    members.update(extra or {})
    return members


def jax_collection(**kwargs):
    return jtm.MetricCollection(config2(JC, auto_compile=False), **kwargs)


def torch_collection(extra=None, **kwargs):
    return tt.MetricCollection(config2(TC, extra, device="cpu"), **kwargs)


def batch(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(N, C)).astype(np.float32)
    target = rng.integers(0, C, N)
    logits[np.arange(N), target] += 1.0
    return logits, target


def assert_results(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert_tree(got[key], want[key]) if "auroc" in key else _assert_ratio(got[key], want[key])


def _assert_ratio(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)


def test_compute_groups_and_results_match_jax():
    jc, tc = jax_collection(), torch_collection()
    for b in range(4):
        logits, target = batch(b)
        if b % 2 == 0:
            assert_results(tc(torch.from_numpy(logits), torch.from_numpy(target)),
                           jc(jnp.asarray(logits), jnp.asarray(target)))
        else:
            jc.update(jnp.asarray(logits), jnp.asarray(target))
            tc.update(torch.from_numpy(logits), torch.from_numpy(target))
    assert tc.compute_groups == jc.compute_groups
    assert tc.compute_groups == {0: ["acc", "f1", "precision", "recall"], 1: ["auroc_binned"], 2: ["auroc_exact"],
                                 3: ["cm", "cm_true"]}
    assert_results(tc.compute(), jc.compute())


@pytest.mark.parametrize("compute_groups", [False, [["cm", "cm_true"], ["acc", "precision"]]], ids=["off", "explicit"])
def test_compute_groups_off_or_explicit_match_jax(compute_groups):
    jc, tc = jax_collection(compute_groups=compute_groups), torch_collection(compute_groups=compute_groups)
    for b in range(2):
        logits, target = batch(10 + b)
        jc.update(jnp.asarray(logits), jnp.asarray(target))
        tc.update(torch.from_numpy(logits), torch.from_numpy(target))
    assert tc.compute_groups == jc.compute_groups
    assert_results(tc.compute(), jc.compute())


class _InPlaceFullState(Metric):
    """A full-state metric whose update writes into its states in place: the hazard for shared states."""

    full_state_update = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("hits", torch.zeros(C, dtype=torch.int64), dist_reduce_fx="sum")
        self.add_state("seen", torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")

    def update(self, preds, target):
        self.hits += torch.bincount(target[preds.argmax(1) == target], minlength=C)
        self.seen += target.numel()

    def compute(self):
        return self.hits.sum() / self.seen


def _extra():
    return {"full_a": _InPlaceFullState(device="cpu"), "full_b": _InPlaceFullState(device="cpu"),
            "max": tt.MaxMetric(device="cpu"), "cat": tt.CatMetric(device="cpu")}


def _twins():
    return torch_collection(_extra()), torch_collection(_extra(), compute_groups=False)


def _call(collection, how, seed):
    """Keyword arguments: each member takes the ones its ``update`` names (``preds``/``target`` or ``value``)."""
    logits, target = (torch.from_numpy(a) for a in batch(seed))
    kwargs = {"preds": logits, "target": target, "value": logits.max(1).values}
    if how == "forward":
        return collection(**kwargs)
    collection.update(**kwargs)
    return None


def _assert_twins(grouped, plain):
    for name, member in plain.items(keep_base=True):
        twin = grouped[name]
        assert twin.update_count == member.update_count, name
        for attr, value in member.metric_state.items():
            got = twin.metric_state[attr]
            if isinstance(value, list):
                assert len(got) == len(value) and all(torch.equal(g, v) for g, v in zip(got, value)), (name, attr)
            else:
                assert torch.equal(got, value), (name, attr)
    assert_results(grouped.compute(), plain.compute())


def test_grouped_collection_equals_its_ungrouped_twin():
    """Mixed calls on a grouped collection: the same states and results as without groups, no double count."""
    grouped, plain = _twins()
    steps = ["update", "forward", "update", "forward", "forward", "update"]
    for i, how in enumerate(steps):
        out_g, out_p = _call(grouped, how, 20 + i), _call(plain, how, 20 + i)
        if how == "forward":
            assert_results(out_g, out_p)
        _assert_twins(grouped, plain)
    assert grouped.compute_groups[0] == ["acc", "f1", "precision", "recall"]
    assert ["full_a", "full_b"] in grouped.compute_groups.values()
    assert int(grouped["full_a"].seen) == len(steps) * N

    # a member updated on its own leaves its group's head alone; as in the JAX package, the next
    # sync of the groups gives the member the head's states again
    head_before = grouped["acc"].tp.clone()
    grouped["precision"].update(*(torch.from_numpy(a) for a in batch(99)))
    assert torch.equal(grouped._modules["acc"].tp, head_before)
    _assert_twins(grouped, plain)

    other_g, other_p = _twins()
    for i in range(3):
        _call(other_g, "update" if i % 2 else "forward", 40 + i)
        _call(other_p, "update" if i % 2 else "forward", 40 + i)
    grouped.merge_state(other_g)
    plain.merge_state(other_p)
    _assert_twins(grouped, plain)
    _call(grouped, "update", 50)
    _call(plain, "update", 50)
    _assert_twins(grouped, plain)

    grouped.persistent(True)
    plain.persistent(True)
    saved_g, saved_p = grouped.state_dict(prefix="c."), plain.state_dict(prefix="c.")
    assert sorted(saved_g) == sorted(saved_p)
    fresh_g, fresh_p = _twins()
    fresh_g.load_state_dict(saved_g, prefix="c.")
    fresh_p.load_state_dict(saved_p, prefix="c.")
    for i, how in enumerate(["update", "forward", "update"]):
        _call(fresh_g, how, 60 + i)
        _call(fresh_p, how, 60 + i)
    _assert_twins(fresh_g, fresh_p)

    grouped.reset()
    plain.reset()
    for i, how in enumerate(["forward", "update", "update"]):
        _call(grouped, how, 70 + i)
        _call(plain, how, 70 + i)
    _assert_twins(grouped, plain)


def test_merge_state_refuses_a_mismatch_before_changing_anything():
    tc = torch_collection()
    logits, target = (torch.from_numpy(a) for a in batch(80))
    tc.update(logits, target)
    before = tc.state_dict(all_states=True)
    renamed = tt.MetricCollection({**config2(TC, device="cpu"), "extra": TC.MulticlassAccuracy(num_classes=C, device="cpu")})
    swapped = tt.MetricCollection({**config2(TC, device="cpu"), "recall": TC.MulticlassPrecision(num_classes=C, device="cpu")})
    for incoming in (renamed, swapped):
        incoming.update(logits, target)
        with pytest.raises(TorchMetricsUserError):
            tc.merge_state(incoming)
        after = tc.state_dict(all_states=True)
        assert sorted(after) == sorted(before)
        for key, value in before.items():
            assert all(torch.equal(a, b) for a, b in zip(after[key], value)) if isinstance(value, list) \
                else torch.equal(after[key], value)
    with pytest.raises(TorchMetricsUserError):
        tc.merge_state(TC.MulticlassAccuracy(num_classes=C, device="cpu"))


class _DictResult(Metric):
    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("n", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds, target):
        self.n += target.numel()

    def compute(self):
        return {"count": self.n, "acc": -self.n}


def test_names_prefix_postfix_and_dict_behaviour():
    jc = jtm.MetricCollection([JC.MulticlassAccuracy(num_classes=C, auto_compile=False),
                               JC.MulticlassRecall(num_classes=C, auto_compile=False)], prefix="val_", postfix="_1")
    tc = tt.MetricCollection([TC.MulticlassAccuracy(num_classes=C, device="cpu"),
                              TC.MulticlassRecall(num_classes=C, device="cpu")], prefix="val_", postfix="_1")
    assert list(tc.keys()) == list(jc.keys()) and list(tc.keys(keep_base=True)) == list(jc.keys(keep_base=True))
    assert len(tc) == 2 and "MulticlassAccuracy" in tc and "val_MulticlassRecall_1" in tc and list(tc) == list(tc.keys())
    logits, target = batch(90)
    assert_results(tc(torch.from_numpy(logits), torch.from_numpy(target)), jc(jnp.asarray(logits), jnp.asarray(target)))
    clone = tc.clone(prefix="test_")
    assert list(clone.keys())[0] == "test_MulticlassAccuracy_1"
    assert clone["MulticlassAccuracy"] is not tc["MulticlassAccuracy"]
    assert "prefix=val_" in repr(tc) and "MulticlassRecall" in repr(tc)

    nested = tt.MetricCollection([tc, _DictResult(device="cpu")])
    assert sorted(nested.keys(keep_base=True)) == ["_DictResult", "val_MulticlassAccuracy_1", "val_MulticlassRecall_1"]
    nested.update(torch.from_numpy(logits), torch.from_numpy(target))
    assert sorted(nested.compute()) == ["acc", "count", "val_MulticlassAccuracy_1", "val_MulticlassRecall_1"]
    by_dict = tt.MetricCollection({"a": _DictResult(device="cpu"), "b": _DictResult(device="cpu")})
    by_dict.update(torch.from_numpy(logits), torch.from_numpy(target))
    assert sorted(by_dict.compute()) == ["acc", "b_acc", "b_count", "count"]

    with pytest.raises(ValueError, match="both named"):
        tt.MetricCollection([TC.MulticlassAccuracy(num_classes=C, device="cpu")] * 2)
    with pytest.raises(ValueError, match="not a instance of `Metric`"):
        tt.MetricCollection([object()])
    with pytest.raises(ValueError, match="prefix"):
        tt.MetricCollection([], prefix=1)
    moved = tc.to(torch.float64)
    assert moved is tc


def test_collection_without_device_puts_states_on_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tt.MetricCollection([TC.MulticlassAccuracy(num_classes=C)])


_GLOO_WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
import torchmetrics_tpu_torch as tt
rank, world, port = (int(a) for a in sys.argv[1:4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
try:
    rng = np.random.default_rng(100 + rank)
    n = 30 + 17 * rank  # uneven per-rank sizes
    logits = torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32))
    target = torch.from_numpy(rng.integers(0, 4, n))
    mc = tt.MetricCollection({
        "acc": tt.MulticlassAccuracy(num_classes=4, device="cpu"),
        "f1": tt.MulticlassF1Score(num_classes=4, device="cpu"),
        "auroc": tt.MulticlassAUROC(num_classes=4, device="cpu"),
        "cat": tt.CatMetric(device="cpu", cat_state_capacity=64),
    })
    mc.update(preds=logits, target=target, value=logits[:, 0])
    local = {k: [t.clone() for t in v] if isinstance(v, list) else v.clone()
             for k, v in mc.state_dict(all_states=True).items()}
    synced = {k: v.tolist() for k, v in mc.compute().items()}
    restored = mc.state_dict(all_states=True)
    same = all(
        all(torch.equal(a, b) for a, b in zip(restored[k], v)) if isinstance(v, list) else torch.equal(restored[k], v)
        for k, v in local.items()
    )
    print(json.dumps({"synced": synced, "local_restored": same, "cat_rows": len(mc["cat"].value)}))
finally:
    dist.destroy_process_group()
"""


def test_two_process_gloo_collection_sync():
    """Each rank's ``compute`` equals one process over the concatenated data; ``unsync`` restores the ranks."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": root}
    procs = [
        subprocess.Popen([sys.executable, "-c", _GLOO_WORKER, str(rank), "2", str(port)], cwd=root, env=env,
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

    parts = []
    for rank in range(2):
        rng = np.random.default_rng(100 + rank)
        n = 30 + 17 * rank
        parts.append((rng.normal(size=(n, 4)).astype(np.float32), rng.integers(0, 4, n)))
    logits = torch.from_numpy(np.concatenate([p[0] for p in parts]))
    target = torch.from_numpy(np.concatenate([p[1] for p in parts]))
    single = tt.MetricCollection({
        "acc": tt.MulticlassAccuracy(num_classes=4, device="cpu"),
        "f1": tt.MulticlassF1Score(num_classes=4, device="cpu"),
        "auroc": tt.MulticlassAUROC(num_classes=4, device="cpu"),
        "cat": tt.CatMetric(device="cpu", cat_state_capacity=128),
    })
    single.update(preds=logits, target=target, value=logits[:, 0])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = single.compute()
    for rank, out in enumerate(outs):
        assert out["local_restored"] and out["cat_rows"] == 30 + 17 * rank
        for key in ("acc", "f1", "auroc"):
            np.testing.assert_allclose(out["synced"][key], float(want[key]), atol=1e-6)
        np.testing.assert_array_equal(np.asarray(out["synced"]["cat"], np.float32), want["cat"].numpy())
