"""The SPMD engine over a mesh that spans processes: bit for bit with the one-process row mesh.

``build_mesh(devices=["cpu"] * 4, process_group=...)`` in each of two real
``gloo`` processes is one mesh of 8 global rows, rank-major. A module-scoped
fixture starts one pair of children (this file run as a script), which runs
every leg once and prints its results as JSON; each case below reads its part.
Each rank feeds its share of a global batch that the parent made with numpy,
and the parent feeds the whole batch to the one-process 8-row mesh (and, on
the golden sweep's JAX subset, to the JAX engine on the 8 CPU devices of
``tests/conftest.py``):

- the golden sweep (``tests/test_torch_spmd_golden_sweep.py``'s 41 certified
  classes, 3 steps each): both ranks' values bit for bit with the one-process
  mesh's; the JAX subset and a ``CatMetric`` ring within the JAX sweep's
  ``rtol=1e-4, atol=1e-6``, counts exact;
- BASELINE config 2's in-graph members at 10 classes, without groups (one
  coalesced all-reduce a step, no gather) and under replica groups inside
  one process and across both;
- the per-key agreement: a 3-class against a 5-class matrix, and batches of
  another shape, raise ``StateStructureMismatchError`` on both ranks at the
  first step, with no step built;
- a step failure injected on both ranks folds each rank's rows and the eager
  continuation ends on the uninterrupted eager stream's value;
- a snapshot restores onto a fresh 2 x 4 engine bit for bit, and a 1 x 8
  engine refuses it, naming the layout.

In the test process itself: a world-1 ``gloo`` group over a ``HashStore``
(8 CPU rows, bit for bit with the plain mesh), ``build_mesh()`` under it, and
the refusals that need no second process. Each child and its ``gloo`` group
have a timeout of their own, so a hang fails the fixture.
"""

import datetime
import json
import os
import socket
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
PROCS, ROWS = 2, 4
WORLD = PROCS * ROWS
STEPS = 3
C2 = 10  # BASELINE config 2's members at 10 classes
C2_STEPS, C2_BATCH = 4, 64
FAULT_AT = 1  # the injected failure: step 2 of 4
LAYOUTS = {"inside": [[0, 1, 2, 3], [4, 5, 6, 7]], "across": [[0, 2, 4, 6], [1, 3, 5, 7]]}
GLOO_TIMEOUT_S = 60
CHILD_TIMEOUT_S = 100


def _flat(value):
    """A computed value's tensors in a fixed order (dict keys sorted), as numpy."""
    if isinstance(value, dict):
        return [x for k in sorted(value) for x in _flat(value[k])]
    if isinstance(value, (tuple, list)):
        return [x for v in value for x in _flat(v)]
    return [value.numpy() if isinstance(value, torch.Tensor) else np.asarray(value)]


def _encode(value):
    """Each leaf's dtype, shape and bytes: equal encodings are equal bits."""
    return [[str(a.dtype), list(a.shape), np.ascontiguousarray(a).tobytes().hex()] for a in _flat(value)]


def _decode(encoded):
    return [np.frombuffer(bytes.fromhex(h), dtype=np.dtype(d)).reshape(s) for d, s, h in encoded]


def _members(tp, **kw):
    """BASELINE config 2's in-graph members: macro accuracy and F1, the confusion matrix, MCC and Jaccard."""
    return tp.MetricCollection({
        "acc": tp.MulticlassAccuracy(num_classes=C2, device="cpu", **kw),
        "f1": tp.MulticlassF1Score(num_classes=C2, device="cpu", **kw),
        "cm": tp.MulticlassConfusionMatrix(num_classes=C2, device="cpu", **kw),
        "mcc": tp.MulticlassMatthewsCorrCoef(num_classes=C2, device="cpu", **kw),
        "jaccard": tp.MulticlassJaccardIndex(num_classes=C2, device="cpu", **kw),
    })


def _config2_batches(data, share=slice(None)):
    return [(torch.from_numpy(data["c2_logits"][i][share]), torch.from_numpy(data["c2_target"][i][share]))
            for i in range(C2_STEPS)]


# ----------------------------------------------------------------- the children
def _worker(rank: int, port: int, folder: str) -> None:
    """One rank: every leg over the 2 x 4 mesh, its results printed as one JSON line."""
    import torchmetrics_tpu_torch as tp
    from torchmetrics_tpu_torch import aggregation as ta
    from torchmetrics_tpu_torch._resilience import SnapshotManager, SnapshotPolicy, StateStructureMismatchError
    from torchmetrics_tpu_torch._spmd import build_mesh
    from torchmetrics_tpu_torch._spmd.faultinject import inject_step_failure
    from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

    warnings.simplefilter("ignore")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=PROCS,
                            timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S))
    mesh = build_mesh(devices=["cpu"] * ROWS, process_group=dist.group.WORLD)
    spec = json.loads((Path(folder) / "spec.json").read_text())
    data = np.load(Path(folder) / "data.npz")

    def share(a):
        n = a.shape[0] // PROCS
        return a[rank * n:(rank + 1) * n]

    shared = slice(rank * C2_BATCH // PROCS, (rank + 1) * C2_BATCH // PROCS)
    out = {"rank": rank, "mesh": [mesh.shape["dp"], mesh.local_rows, mesh.processes, mesh.rank]}
    try:
        out["sweep"] = {}
        for name, kwargs in spec["sweep"].items():
            cls = getattr(tp, name, None) or getattr(ta, name)
            args = [torch.from_numpy(share(data[f"{name}/{i}"])) for i in range(spec["args"][name])]
            eng = cls(device="cpu", **kwargs).to_spmd(mesh=mesh)
            values = [_encode(eng.step(*args)) for _ in range(STEPS)]
            out["sweep"][name] = {"values": values, "degraded": eng.degraded, "world": eng.world, "rows": eng.rows}

        ring = tp.CatMetric(device="cpu", cat_state_capacity=128, nan_strategy="disable").to_spmd(mesh=mesh)
        for i in range(STEPS):
            value = ring.step(torch.from_numpy(share(data[f"cat/{i}"])))
        out["ring"] = {"value": _encode(value), "degraded": ring.degraded}

        batches = _config2_batches(data, shared)
        eng = _members(tp).to_spmd(mesh=mesh)
        out["config2"] = {"values": [_encode(eng.step(p, t)) for p, t in batches],
                          "collectives": list(eng.collectives.values()),
                          "groups": sorted(len(u.members) for u in eng._units)}
        out["groups"] = {}
        for layout, groups in LAYOUTS.items():
            eng = _members(tp).to_spmd(mesh=mesh, groups=groups)
            out["groups"][layout] = {"values": [_encode(eng.step(p, t)) for p, t in batches],
                                     "collectives": list(eng.collectives.values())}

        out["handshake"] = {}
        rng = np.random.default_rng(3)
        for leg in ("classes", "batch"):
            c = (3 if rank == 0 else 5) if leg == "classes" else 5
            n = 8 if leg == "classes" or rank == 0 else 16
            eng = tp.MulticlassConfusionMatrix(num_classes=c, device="cpu").to_spmd(mesh=mesh)
            p, t = (torch.from_numpy(rng.integers(0, 3, n)) for _ in range(2))
            try:
                eng.step(p, t)
                out["handshake"][leg] = {"error": None}
            except StateStructureMismatchError as err:
                out["handshake"][leg] = {"error": str(err), "built": len(eng._step_fns), "steps": eng.steps}

        faulted = _members(tp).to_spmd(mesh=mesh)
        for i, (p, t) in enumerate(batches):
            if i == FAULT_AT:
                with inject_step_failure(times=1):
                    faulted.step(p, t)
            else:
                faulted.step(p, t)
        events = [e.detail for m in faulted.target.values() for e in m.resilience_report().events
                  if e.kind == "spmd_degraded"]
        out["degrade"] = {"degraded": faulted.degraded, "events": events, "value": _encode(faulted.target.compute())}

        live = _members(tp).to_spmd(mesh=mesh)
        folder_r = Path(folder) / f"snapshots_rank{rank}"
        mgr = SnapshotManager(live, folder_r, SnapshotPolicy(every_n_updates=2, async_write=False))
        for p, t in batches[:3]:
            live.step(p, t)
        mgr.close()  # preempted after step 3
        snapshot = live.state_dict(integrity=True)
        restored = _members(tp).to_spmd(mesh=mesh)
        mgr2 = SnapshotManager(restored, folder_r, SnapshotPolicy(async_write=False))
        mgr2.restore_latest()
        mgr2.close()
        resumed_at = restored.steps
        values = [_encode(restored.step(p, t)) for p, t in batches[resumed_at:]]
        flat = _members(tp).to_spmd(mesh=build_mesh(devices=["cpu"] * WORLD))
        try:
            flat.load_state_dict(snapshot)
            refusal = None
        except TorchMetricsUserError as err:
            refusal = str(err)
        out["snapshot"] = {"resumed_at": resumed_at, "values": values, "refusal": refusal}

        default = build_mesh()
        out["default_mesh"] = [default.shape["dp"], default.local_rows, str(default.devices[0])]
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(json.dumps(out))


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The global batches (numpy, from seeds) and the sweep's classes, on disk for the children."""
    from tests.test_torch_spmd_golden_sweep import CASES, SWEEP, _port_kwargs

    folder = tmp_path_factory.mktemp("spmd_process_group")
    arrays, nargs = {}, {}
    for name in SWEEP:
        args = [np.array(a) for a in CASES[name][1]()]
        assert all(a.shape[0] % WORLD == 0 for a in args), name
        nargs[name] = len(args)
        arrays.update({f"{name}/{i}": a for i, a in enumerate(args)})
    rng = np.random.default_rng(5)
    arrays.update({f"cat/{i}": rng.standard_normal((32, 3)).astype(np.float32) for i in range(STEPS)})
    rng = np.random.default_rng(25)
    arrays["c2_logits"] = rng.standard_normal((C2_STEPS, C2_BATCH, C2)).astype(np.float32)
    arrays["c2_target"] = rng.integers(0, C2, (C2_STEPS, C2_BATCH))
    np.savez(folder / "data.npz", **arrays)
    (folder / "spec.json").write_text(json.dumps({"sweep": {n: _port_kwargs(n) for n in SWEEP}, "args": nargs}))
    return folder, dict(np.load(folder / "data.npz"))


@pytest.fixture(scope="module")
def ranks(data):
    """Both ranks' results: one pair of children runs every leg."""
    folder, _ = data
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [
        subprocess.Popen([sys.executable, str(Path(__file__).resolve()), str(rank), str(port), str(folder)],
                         cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(PROCS)
    ]
    outs = []
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=CHILD_TIMEOUT_S)
            assert proc.returncode == 0, stderr[-4000:]
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            proc.kill()
    return outs


def _one_process(make, batches, **kw):
    """The same global batches through the one-process 8-row mesh: each step's value, encoded."""
    from torchmetrics_tpu_torch._spmd import build_mesh

    eng = make().to_spmd(mesh=build_mesh(devices=["cpu"] * WORLD), **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return [_encode(eng.step(*b)) for b in batches]


def _args(arrays, name):
    """The sweep case's global batch, its arguments in order."""
    return [arrays[f"{name}/{i}"] for i in range(sum(k.startswith(f"{name}/") for k in arrays))]


# ------------------------------------------------------------------ the cases
def test_both_ranks_see_one_mesh_of_eight_rows(ranks):
    assert [r["mesh"] for r in ranks] == [[WORLD, ROWS, PROCS, 0], [WORLD, ROWS, PROCS, 1]]
    # build_mesh() under the default group: one row a process, on the CPU under gloo
    assert [r["default_mesh"] for r in ranks] == [[PROCS, 1, "cpu"]] * PROCS


def _sweep_names():
    from tests.test_torch_spmd_golden_sweep import SWEEP

    return SWEEP


@pytest.mark.parametrize("name", _sweep_names())
def test_sweep_bit_for_bit_with_the_one_process_mesh(name, data, ranks):
    from tests.test_torch_spmd_golden_sweep import _port_ctor

    _, arrays = data
    args = tuple(torch.from_numpy(a) for a in _args(arrays, name))
    want = _one_process(_port_ctor(name), [args] * STEPS)
    for r in ranks:
        got = r["sweep"][name]
        assert not got["degraded"] and (got["world"], got["rows"]) == (WORLD, ROWS)
        assert got["values"] == want, f"{name}: rank {r['rank']} differs from the one-process mesh"


@pytest.mark.parametrize("name", ["MaxMetric", "MinMetric", "MulticlassConfusionMatrix", "PearsonCorrCoef"])
def test_jax_subset_matches_the_jax_engine(name, data, ranks):
    import jax

    from tests.test_torch_spmd_golden_sweep import CASES, _agree

    _, arrays = data
    np_args = _args(arrays, name)
    jeng = CASES[name][0]().to_spmd()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(STEPS):
            jvalue = jeng.step(*(jax.numpy.asarray(a) for a in np_args))
    assert jeng.mesh.shape["dp"] == WORLD and not jeng.degraded
    for r in ranks:
        _agree(_decode(r["sweep"][name]["values"][-1]), jax.tree_util.tree_map(np.asarray, jvalue),
               f"{name}: rank {r['rank']} vs the JAX engine")


def test_ring_state_against_the_jax_engine_and_the_one_process_mesh(data, ranks):
    """``CatMetric``'s compute has a data-dependent length: both meshes degrade and return the same rows."""
    import jax

    import torchmetrics_tpu as jtm
    import torchmetrics_tpu_torch as tp

    _, arrays = data
    xs = [arrays[f"cat/{i}"] for i in range(STEPS)]
    jeng = jtm.CatMetric(cat_state_capacity=128, nan_strategy="disable").to_spmd()
    for x in xs:
        jvalue = jeng.step(jax.numpy.asarray(x))
    jax_rows = np.sort(np.asarray(jvalue.data)[np.asarray(jvalue.valid)], axis=0)
    one = _one_process(lambda: tp.CatMetric(device="cpu", cat_state_capacity=128, nan_strategy="disable"),
                       [(torch.from_numpy(x),) for x in xs])[-1]
    want = np.sort(np.concatenate(xs), axis=0)
    np.testing.assert_array_equal(np.sort(_decode(one)[0], axis=0), want)
    for r in ranks:
        assert r["ring"]["degraded"]
        got = np.sort(_decode(r["ring"]["value"])[0], axis=0)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, jax_rows, rtol=1e-4, atol=1e-6)


def test_config2_one_coalesced_all_reduce_a_step(data, ranks):
    import torchmetrics_tpu_torch as tp

    _, arrays = data
    want = _one_process(lambda: _members(tp), _config2_batches(arrays))
    for r in ranks:
        assert r["config2"]["values"] == want, f"rank {r['rank']}"
        assert r["config2"]["groups"] == [2, 3]
        # every state of config 2's members is an integer sum: no gather, one all-reduce a (dtype, reduction)
        (collectives,) = r["config2"]["collectives"]
        assert "all_gather" not in collectives and collectives["all_reduce"] >= 1, collectives


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_config2_replica_groups_bit_for_bit(layout, data, ranks):
    import torchmetrics_tpu_torch as tp

    _, arrays = data
    want = _one_process(lambda: _members(tp), _config2_batches(arrays), groups=LAYOUTS[layout])
    for r in ranks:
        assert r["groups"][layout]["values"] == want, f"{layout}: rank {r['rank']}"
        (collectives,) = r["groups"][layout]["collectives"]
        assert "all_reduce" not in collectives and collectives["all_gather"] >= 1, collectives


@pytest.mark.parametrize("leg", ["classes", "batch"])
def test_mismatch_raises_on_every_rank_before_any_step(leg, ranks):
    for r in ranks:
        got = r["handshake"][leg]
        assert got["error"] is not None, f"rank {r['rank']} built a step"
        assert got["built"] == 0 and got["steps"] == 0
        assert ("units differ" if leg == "classes" else "batch differ") in got["error"], got["error"]
        assert "rank 0" in got["error"] and "rank 1" in got["error"]


def test_failure_on_both_ranks_folds_and_continues_to_the_uninterrupted_value(data, ranks):
    import torchmetrics_tpu_torch as tp

    _, arrays = data
    eager = _members(tp, auto_compile=False)
    for p, t in _config2_batches(arrays):
        eager.update(p, t)
    want = _encode(eager.compute())
    for r in ranks:
        assert r["degrade"]["degraded"] and len(r["degrade"]["events"]) == 1
        assert "folded its own rows" in r["degrade"]["events"][0] and "restarts" not in r["degrade"]["events"][0]
        assert r["degrade"]["value"] == want, f"rank {r['rank']}"


def test_snapshot_restores_onto_its_own_layout(data, ranks):
    import torchmetrics_tpu_torch as tp

    _, arrays = data
    want = _one_process(lambda: _members(tp), _config2_batches(arrays))
    for r in ranks:
        resumed_at = r["snapshot"]["resumed_at"]
        assert 0 < resumed_at < C2_STEPS and r["snapshot"]["values"] == want[resumed_at:], f"rank {r['rank']}"


def test_snapshot_refused_by_another_layout(ranks):
    for r in ranks:
        refusal = r["snapshot"]["refusal"]
        assert refusal is not None and "identical mesh layout" in refusal
        assert f"2 process(es) x 4 rows, rank {r['rank']}" in refusal and "1 process(es) x 8 rows" in refusal


def test_eager_sync_sum_keeps_an_int32_state_int32():
    """The eager sync's sum (``dim_zero_sum``) keeps int32 as the JAX package's does, as the engine's sync does.

    It had widened int32 to int64, so the eager continuation after a fold
    returned an int64 confusion matrix where one process returns int32.
    """
    import jax.numpy as jnp

    from torchmetrics_tpu.utilities.data import dim_zero_sum as jax_dim_zero_sum
    from torchmetrics_tpu_torch.utilities.data import dim_zero_sum

    stacked = np.arange(12, dtype=np.int32).reshape(2, 2, 3)
    for dtype in (np.int32, np.int64):
        got = dim_zero_sum(torch.from_numpy(stacked.astype(dtype)))
        assert got.dtype == getattr(torch, np.dtype(dtype).name)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_dim_zero_sum(jnp.asarray(stacked))))
    assert str(jax_dim_zero_sum(jnp.asarray(stacked)).dtype) == "int32"


# ------------------------------------------------------- in the test process
@pytest.fixture
def world_of_one():
    """A world-1 gloo group over a ``HashStore``, destroyed after the test."""
    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_world_of_one_is_bit_for_bit_with_the_plain_mesh(world_of_one, data):
    import torchmetrics_tpu_torch as tp
    from torchmetrics_tpu_torch._spmd import build_mesh

    _, arrays = data
    batches = _config2_batches(arrays)
    want = _one_process(lambda: _members(tp), batches)
    for make in (lambda: _members(tp), lambda: tp.MeanSquaredError(device="cpu")):
        eng = make().to_spmd(mesh=build_mesh(devices=["cpu"] * WORLD, process_group=world_of_one))
        assert (eng.world, eng.rows, eng.rank, eng.processes) == (WORLD, WORLD, 0, 1)
        if isinstance(eng.target, tp.MetricCollection):
            assert [_encode(eng.step(p, t)) for p, t in batches] == want
            assert list(eng.collectives.values()) == [{"all_reduce": 1}]
        else:
            pairs = [(p[:, 0], p[:, 1]) for p, _ in batches]
            assert [_encode(eng.step(*b)) for b in pairs] == _one_process(make, pairs)
            # the float sum of squares gathers, the integer count is all-reduced
            assert list(eng.collectives.values()) == [{"all_reduce": 1, "all_gather": 1}]


def test_build_mesh_default_is_one_row_over_the_group(world_of_one):
    from torchmetrics_tpu_torch._spmd import build_mesh

    mesh = build_mesh()
    assert mesh.process_group is world_of_one and mesh.devices == (torch.device("cpu"),)
    assert (mesh.shape, mesh.local_rows, mesh.processes, mesh.rank) == ({"dp": 1}, 1, 1, 0)


def test_cuda_mesh_over_a_gloo_group_refused_at_construction(world_of_one):
    import torchmetrics_tpu_torch as tp
    from torchmetrics_tpu_torch._spmd import InGraphSyncUnsupported, build_mesh

    mesh = build_mesh(devices=["cuda:0"] * 2, process_group=world_of_one)
    with pytest.raises(InGraphSyncUnsupported, match="NCCL group"):
        tp.MeanSquaredError(device="cpu").to_spmd(mesh=mesh)


def test_one_process_over_two_cards_refused():
    import torchmetrics_tpu_torch as tp
    from torchmetrics_tpu_torch._spmd import InGraphSyncUnsupported, build_mesh

    with pytest.raises(InGraphSyncUnsupported, match="one process a card.*process_group="):
        tp.MeanSquaredError(device="cpu").to_spmd(mesh=build_mesh(devices=["cuda:0", "cuda:1"]))


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
