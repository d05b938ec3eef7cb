"""The port's pooled wrappers against the JAX package's, on the CPU.

From ``tests/unittests/streams/test_adapters.py`` (5 tests): a pooled
``MultitaskWrapper`` equals the eager wrapper (and honours its prefix and
postfix, and refuses heterogeneous tasks), a pooled ``ClasswiseWrapper``
serves independent tenants with the wrapper's labelled dicts. Each scenario
runs through both packages on the same seeded numpy batches.
"""

import numpy as np
import pytest

import torchmetrics_tpu.wrappers as j_wrappers
import torchmetrics_tpu_torch.wrappers as t_wrappers
from tests.test_torch_streams_pool import JAX, PORT, close, host

WRAPPERS = {JAX.name: j_wrappers, PORT.name: t_wrappers}
TASKS = ("head_a", "head_b", "head_c")


def test_pooled_multitask_matches_eager_wrapper():
    rng = np.random.default_rng(55)
    steps = [
        ({k: rng.standard_normal(8).astype(np.float32) for k in TASKS},
         {k: rng.standard_normal(8).astype(np.float32) for k in TASKS})
        for _ in range(4)
    ]

    def run(S):
        W = WRAPPERS[S.name]
        pooled = W.MultitaskWrapper({k: S.tm.MeanSquaredError(**S.kw) for k in TASKS}).to_stream_pool()
        eager = W.MultitaskWrapper({k: S.tm.MeanSquaredError(**S.kw) for k in TASKS})
        for preds, targets in steps:
            p = {k: S.arr(v) for k, v in preds.items()}
            t = {k: S.arr(v) for k, v in targets.items()}
            pooled.update(p, t)
            eager.update(p, t)
        got, want = pooled.compute(), eager.compute()
        assert sorted(got) == sorted(want)
        for k in want:
            close(got[k], want[k])
        first = {k: host(v) for k, v in got.items()}
        pooled.reset()
        pooled.update({k: S.ones(4) for k in TASKS}, {k: S.zeros(4) for k in TASKS})
        close(pooled.compute()["head_a"], 1.0)
        return first

    j, p = run(JAX), run(PORT)
    for k in j:
        close(j[k], p[k])


def test_pooled_multitask_prefix_postfix():
    def run(S):
        mt = WRAPPERS[S.name].MultitaskWrapper(
            {"t1": S.tm.MeanSquaredError(**S.kw), "t2": S.tm.MeanSquaredError(**S.kw)}, prefix="p_", postfix="_s"
        )
        pooled = mt.to_stream_pool()
        pooled.update({k: S.ones(4) for k in ("t1", "t2")}, {k: S.zeros(4) for k in ("t1", "t2")})
        return sorted(pooled.compute())

    assert run(JAX) == run(PORT) == ["p_t1_s", "p_t2_s"]


def test_heterogeneous_multitask_keeps_eager_path():
    def run(S):
        mt = WRAPPERS[S.name].MultitaskWrapper(
            {"cls": S.tm.BinaryAccuracy(**S.kw), "reg": S.tm.MeanSquaredError(**S.kw)}
        )
        with pytest.raises(S.streams.StreamPoolUnsupported, match="homogeneous"):
            mt.to_stream_pool()

    run(JAX)
    run(PORT)


def test_pooled_classwise_multi_tenant():
    rng = np.random.default_rng(56)
    steps = [(rng.random((2, 16, 3)).astype(np.float32), rng.integers(0, 3, (2, 16))) for _ in range(3)]

    def run(S):
        W = WRAPPERS[S.name]
        wrapper = W.ClasswiseWrapper(S.tm.MulticlassAccuracy(num_classes=3, average=None, **S.kw))
        pooled = wrapper.to_stream_pool(capacity=2)
        a, b = pooled.attach(), pooled.attach()
        eagers = {
            sid: W.ClasswiseWrapper(S.tm.MulticlassAccuracy(num_classes=3, average=None, **S.kw)) for sid in (a, b)
        }
        for p, t in steps:
            ids = np.array([a, b], np.int32)
            pooled.update(ids, S.arr(p), S.arr(t))
            for i, sid in enumerate(ids.tolist()):
                eagers[sid].update(S.arr(p[i]), S.arr(t[i]))
        out = {}
        for sid in (a, b):
            got, want = pooled.compute(sid), eagers[sid].compute()
            assert sorted(got) == sorted(want)
            for k in want:
                close(got[k], want[k], rtol=1e-5)
            out[sid] = {k: host(v) for k, v in got.items()}
        # the per-tenant lifecycle flows through
        pooled.reset(a)
        assert sorted(pooled.compute_all()) == [a, b]
        return out

    j, p = run(JAX), run(PORT)
    for sid in j:
        for k in j[sid]:
            close(j[sid][k], p[sid][k])


def test_pooled_classwise_labels():
    rng = np.random.default_rng(57)
    p, t = rng.random((1, 8, 2)).astype(np.float32), rng.integers(0, 2, (1, 8))

    def run(S):
        wrapper = WRAPPERS[S.name].ClasswiseWrapper(
            S.tm.MulticlassAccuracy(num_classes=2, average=None, **S.kw), labels=["cat", "dog"]
        )
        pooled = wrapper.to_stream_pool(capacity=1)
        s = pooled.attach()
        pooled.update(np.array([s], np.int32), S.arr(p), S.arr(t))
        return {k: host(v) for k, v in pooled.compute(s).items()}

    j, p_ = run(JAX), run(PORT)
    assert sorted(j) == sorted(p_) == ["multiclassaccuracy_cat", "multiclassaccuracy_dog"]
    for k in j:
        close(j[k], p_[k])
