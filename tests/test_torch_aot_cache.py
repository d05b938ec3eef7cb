"""The port's AOT cache (``torchmetrics_tpu_torch/_aot/``) against ``tests/unittests/aot/test_cache.py``.

One counterpart of each of the JAX package's 21 tests, on the same seeded
numpy batches, with every value held to the port's eager run and to the JAX
package's at rtol 1e-6. Two divergences by design (``_aot/cache.py``): a
pool's ``stream_compute_one``/``stream_compute_all`` and the engine's
``spmd_compute`` run eagerly and answer ``"ready"``, and a key this pool or
engine built already answers ``"ready"`` where the JAX package answers
``"hit"``. The fingerprint test changes torch's version where the JAX test
changes jax's.

Three of the JAX tests are red under this suite's ``tests/conftest.py``: an
XLA:CPU executable serialized by the JAX cache loads, but cannot run, in a
process with ``--xla_force_host_platform_device_count=8``, so its second
``precompile`` counts a hit and reports ``engaged: False`` ("update did not
compile"); a plain one-device process engages. The port has no XLA: its
counterparts pass under the same conftest, holding it to what the
one-device JAX process shows.

Beyond the JAX tests: the ``kernel_library`` route through ``load_c`` and
``cc`` (built into the cache, loaded in a subprocess that has no ``cc``, a
bit-flipped library rebuilt), a record naming the libraries its warm-up
launched, the shared directory (neither package lists or evicts the other's
artifacts) and the bundles both ways.
"""

import glob
import hashlib
import importlib.util
import io
import json
import os
import shutil
import struct
import socket
import subprocess
import sys
import tarfile
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as tm
from torchmetrics_tpu_torch import _aot
from torchmetrics_tpu_torch import set_aot_cache
from torchmetrics_tpu_torch._aot import __main__ as cli
from torchmetrics_tpu_torch._aot import artifacts as aot_artifacts
from torchmetrics_tpu_torch._aot import cache as aot_cache
from torchmetrics_tpu_torch._aot.cache import AotCache, aot_stats, reset_aot_stats
from torchmetrics_tpu_torch._kernels.launch_counter import LaunchCounter
from torchmetrics_tpu_torch._observability.events import BUS
from torchmetrics_tpu_torch._observability.state import OBS
from torchmetrics_tpu_torch._spmd import build_mesh
from torchmetrics_tpu_torch.functional.detection import _rle
from torchmetrics_tpu_torch.utilities import nvcc

REPO_ROOT = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(7)
N = 32
RTOL = 1e-6
CPU = "cpu"


def _bin_batch():
    return RNG.random(N).astype(np.float32), RNG.integers(0, 2, N)


def _reg_batch():
    return RNG.standard_normal(N).astype(np.float32), RNG.standard_normal(N).astype(np.float32)


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _jax_value(name, *arrays, **kw):
    """The JAX package's eager value of ``name`` on the same numpy batch."""
    metric = getattr(jtm, name)(auto_compile=False, **kw)
    metric.update(*(jnp.asarray(a) for a in arrays))
    return float(metric.compute())


def _eager_value(name, *arrays, **kw):
    metric = getattr(tm, name)(auto_compile=False, device=CPU, **kw)
    metric.update(*_t(*arrays))
    return float(metric.compute())


def _check_value(got, name, *arrays, **kw):
    np.testing.assert_allclose(float(got), _eager_value(name, *arrays, **kw), rtol=RTOL)
    np.testing.assert_allclose(float(got), _jax_value(name, *arrays, **kw), rtol=RTOL)


@pytest.fixture()
def cache_dir(tmp_path):
    d = tmp_path / "aot"
    set_aot_cache(str(d))
    reset_aot_stats()
    yield d
    set_aot_cache(None)


@pytest.fixture()
def telemetry_on():
    was = OBS.enabled
    OBS.enabled = True
    yield
    OBS.enabled = was


@pytest.fixture()
def build_dir(tmp_path, monkeypatch):
    """A fresh ``_build/`` for the kernel libraries (the RLE codec's wrapper forgets its loaded library)."""
    d = tmp_path / "build"
    monkeypatch.setattr(nvcc, "BUILD_DIR", d)
    _rle._library.cache_clear()
    yield d
    _rle._library.cache_clear()


def _delta(before, after):
    return {k: after.get(k, 0) - before.get(k, 0) for k in set(before) | set(after)}


def _records(cache_dir, kind="auto_update"):
    return glob.glob(str(cache_dir / "torch" / f"{kind}.*.aot"))


def _mesh():
    return build_mesh(devices=[CPU] * 8)


class TestPrecompile:
    def test_precompile_arms_compiled_path_and_preserves_state(self, cache_dir):
        preds, target = _bin_batch()
        metric = tm.BinaryAccuracy(device=CPU)
        report = metric.precompile(*_t(preds, target))
        assert report["engaged"], report
        # the warm-up batch left no trace on the stream
        assert metric._update_count == 0
        assert all(int(v) == 0 for v in metric.metric_state.values())
        # the FIRST real update runs the compiled step (signature pre-registered)
        metric.update(*_t(preds, target))
        assert metric._update_count == 1
        _check_value(metric.compute(), "BinaryAccuracy", preds, target)

    def test_precompile_writes_then_loads_artifact(self, cache_dir):
        # red in the JAX package under this conftest (8 forced host devices, see the module docstring)
        preds, target = _reg_batch()
        m1 = tm.MeanSquaredError(device=CPU)
        assert m1.precompile(*_t(preds, target))["engaged"]
        assert len(_records(cache_dir)) == 1
        before = aot_stats()
        m2 = tm.MeanSquaredError(device=CPU)
        assert m2.precompile(*_t(preds, target))["engaged"]
        assert _delta(before, aot_stats())["hits"] == 1
        m2.update(*_t(preds, target))
        _check_value(m2.compute(), "MeanSquaredError", preds, target)

    def test_precompile_reports_eager_pinned_classes(self, cache_dir):
        metric = tm.BinaryAccuracy(auto_compile=False, device=CPU)
        report = metric.precompile(*_t(*_bin_batch()))
        assert not report["engaged"]
        assert report["reason"]

    def test_collection_precompile_fans_out(self, cache_dir):
        preds, target = _bin_batch()
        coll = tm.MetricCollection([tm.BinaryAccuracy(device=CPU), tm.BinaryPrecision(device=CPU)])
        reports = coll.precompile(*_t(preds, target))
        assert set(reports) == {"BinaryAccuracy", "BinaryPrecision"}
        assert all(r["engaged"] for r in reports.values())
        for m in coll.values(copy_state=False):
            assert m._update_count == 0


class TestCrossProcess:
    def test_artifact_written_in_child_loads_in_parent(self, cache_dir):
        """A fresh subprocess populates the cache; this process then finds its record (a hit, the value right)."""
        # red in the JAX package under this conftest (8 forced host devices, see the module docstring)
        child = (
            "import numpy as np, torch\n"
            "import torchmetrics_tpu_torch as tm\n"
            "rng = np.random.default_rng(7)\n"
            f"preds = torch.from_numpy(rng.random({N}).astype(np.float32))\n"
            f"target = torch.from_numpy(rng.integers(0, 2, {N}))\n"
            "m = tm.BinaryF1Score(device='cpu')\n"
            "assert m.precompile(preds, target)['engaged']\n"
            "print('CHILD_OK')\n"
        )
        env = dict(os.environ, TM_TPU_AOT_CACHE=str(cache_dir))
        out = subprocess.run(
            [sys.executable, "-c", child], env=env, cwd=str(REPO_ROOT), capture_output=True, text=True, timeout=240,
        )
        assert "CHILD_OK" in out.stdout, out.stderr[-2000:]
        assert _records(cache_dir)
        before = aot_stats()
        rng = np.random.default_rng(7)
        preds, target = rng.random(N).astype(np.float32), rng.integers(0, 2, N)
        metric = tm.BinaryF1Score(device=CPU)
        assert metric.precompile(*_t(preds, target))["engaged"]
        assert _delta(before, aot_stats())["hits"] == 1
        metric.update(*_t(preds, target))
        _check_value(metric.compute(), "BinaryF1Score", preds, target)


class TestFallbacks:
    def _arm(self, cache_dir):
        preds, target = _reg_batch()
        m = tm.MeanAbsoluteError(device=CPU)
        assert m.precompile(*_t(preds, target))["engaged"]
        (art,) = _records(cache_dir)
        return Path(art), (preds, target)

    def _rerun(self, preds, target):
        m2 = tm.MeanAbsoluteError(device=CPU)
        assert m2.precompile(*_t(preds, target))["engaged"]
        return m2

    def test_truncated_artifact_falls_back_to_trace(self, cache_dir, telemetry_on):
        art, (preds, target) = self._arm(cache_dir)
        raw = art.read_bytes()
        art.write_bytes(raw[: len(raw) // 2])
        before = aot_stats()
        m2 = self._rerun(preds, target)
        delta = _delta(before, aot_stats())
        assert delta["fallbacks"] == 1
        assert delta["writes"] == 1  # built again AND a good record written back
        assert BUS.events(kind="aot_fallback")
        m2.update(*_t(preds, target))
        _check_value(m2.compute(), "MeanAbsoluteError", preds, target)

    def test_bitflipped_payload_falls_back(self, cache_dir):
        art, (preds, target) = self._arm(cache_dir)
        raw = bytearray(art.read_bytes())
        raw[-10] ^= 0xFF
        art.write_bytes(bytes(raw))
        before = aot_stats()
        m2 = self._rerun(preds, target)
        assert _delta(before, aot_stats())["fallbacks"] == 1
        m2.update(*_t(preds, target))
        _check_value(m2.compute(), "MeanAbsoluteError", preds, target)

    def test_unparsable_record_self_heals(self, cache_dir):
        """A record whose checksum holds but whose payload is no record (the JAX test's undeserializable
        payload) falls back, is rebuilt, and the record written back loads next time."""
        art, (preds, target) = self._arm(cache_dir)
        raw = art.read_bytes()
        (hlen,) = aot_cache._HEADER_LEN.unpack(raw[len(aot_cache._MAGIC): len(aot_cache._MAGIC) + 8])
        header = json.loads(raw[len(aot_cache._MAGIC) + 8:][:hlen].decode("utf-8"))
        assert header["format"] == aot_artifacts.FORMAT_STEP_RECORD
        bad_payload = json.dumps(["not", "a", "record"]).encode()
        header["payload_sha256"] = hashlib.sha256(bad_payload).hexdigest()
        header["payload_bytes"] = len(bad_payload)
        blob = json.dumps(header, sort_keys=True).encode("utf-8")
        art.write_bytes(aot_cache._MAGIC + struct.pack("<Q", len(blob)) + blob + bad_payload)
        before = aot_stats()
        self._rerun(preds, target)
        delta = _delta(before, aot_stats())
        assert delta["fallbacks"] == 1 and delta["writes"] == 1
        (entry,) = AotCache(str(cache_dir)).entries()
        assert entry["status"] == "ok" and entry["format"] == aot_artifacts.FORMAT_STEP_RECORD
        record = aot_artifacts.load_step_record(_payload(Path(entry["path"])))
        assert record is not None and record["capture"] == "eager" and record["libraries"] == []
        before = aot_stats()
        m3 = self._rerun(preds, target)
        assert _delta(before, aot_stats())["hits"] == 1
        m3.update(*_t(preds, target))
        _check_value(m3.compute(), "MeanAbsoluteError", preds, target)

    def test_torch_version_mismatch_falls_back(self, cache_dir, monkeypatch):
        art, (preds, target) = self._arm(cache_dir)
        # a replica running another torch must refuse the record
        fp = dict(aot_artifacts.backend_fingerprint())
        fp["torch"] = "0.0.0-other"
        monkeypatch.setattr(aot_artifacts, "_FINGERPRINT", fp)
        before = aot_stats()
        m2 = self._rerun(preds, target)
        delta = _delta(before, aot_stats())
        assert delta["fallbacks"] >= 1
        assert delta["hits"] == 0
        m2.update(*_t(preds, target))
        _check_value(m2.compute(), "MeanAbsoluteError", preds, target)

    def test_unwritable_cache_dir_degrades_with_event(self, tmp_path, telemetry_on):
        """The cache dir path is a FILE: every write fails, an ``aot_cache_unwritable`` event is
        published, nothing raises, and the metric stream is value-correct throughout."""
        blocker = tmp_path / "not_a_dir"
        blocker.write_text("occupied")
        set_aot_cache(str(blocker))
        try:
            preds, target = _reg_batch()
            metric = tm.MeanSquaredError(device=CPU)
            assert metric.precompile(*_t(preds, target))["engaged"]
            metric.update(*_t(preds, target))
            _check_value(metric.compute(), "MeanSquaredError", preds, target)
            events = BUS.events(kind="aot_cache_unwritable")
            assert events and "artifact write failed" in events[-1].detail
        finally:
            set_aot_cache(None)


def _payload(path: Path) -> bytes:
    raw = path.read_bytes()
    (hlen,) = aot_cache._HEADER_LEN.unpack(raw[len(aot_cache._MAGIC): len(aot_cache._MAGIC) + 8])
    return raw[len(aot_cache._MAGIC) + 8 + hlen:]


class TestWarmStart:
    def test_pool_warm_start_cold_then_hit(self, cache_dir):
        # red in the JAX package under this conftest (8 forced host devices, see the module docstring)
        preds, target = _t(*_reg_batch())
        pool = tm.MeanSquaredError(device=CPU).to_stream_pool(capacity=4)
        ids = [pool.attach() for _ in range(3)]
        out = pool.warm_start(ids, preds[:3], target[:3])
        assert out["stream_step"] == "compiled"
        pool.update(ids, preds[:3], target[:3])
        values = pool.compute_all()
        # a fresh pool in the same process: its key's record is a hit (the computes run eagerly: "ready")
        pool2 = tm.MeanSquaredError(device=CPU).to_stream_pool(capacity=4)
        ids2 = [pool2.attach() for _ in range(3)]
        out2 = pool2.warm_start(ids2, preds[:3], target[:3])
        assert out2 == {"stream_step": "hit", "stream_compute_one": "ready", "stream_compute_all": "ready"}
        pool2.update(ids2, preds[:3], target[:3])
        for i, (sid, val) in enumerate(pool2.compute_all().items()):
            np.testing.assert_allclose(float(val), float(values[sid]), rtol=RTOL)
            want = _jax_value("MeanSquaredError", preds[i: i + 1].numpy(), target[i: i + 1].numpy())
            np.testing.assert_allclose(float(val), want, rtol=RTOL)

    def test_engine_warm_start_cold_then_hit(self, cache_dir):
        p, t = _reg_batch()
        preds, target = _t(p, t)
        eng = tm.MeanSquaredError(device=CPU).to_spmd(mesh=_mesh())
        out = eng.warm_start(preds, target)
        assert out == {"spmd_step": "compiled", "spmd_compute": "ready"}
        v1 = float(eng.step(preds, target))
        assert eng.steps == 1  # warm_start consumed no batch
        eng2 = tm.MeanSquaredError(device=CPU).to_spmd(mesh=_mesh())
        out2 = eng2.warm_start(preds, target)
        assert out2 == {"spmd_step": "hit", "spmd_compute": "ready"}
        v2 = float(eng2.step(preds, target))
        np.testing.assert_allclose(v2, v1, rtol=RTOL)
        np.testing.assert_allclose(v2, _jax_value("MeanSquaredError", p, t), rtol=RTOL)

    def test_engine_record_names_the_mesh_layout(self, cache_dir):
        """An engine's step record names its mesh's layout: the process count, the rows a process and the group.

        A 1 x 8 record is no hit for a 1 x 8 mesh over a group of one, nor
        for a 2 x 4 engine whose ranks (two gloo processes) each take the
        1 x 8 engine's whole batch; each layout then hits its own record.
        """
        rng = np.random.default_rng(11)
        preds, target = _t(rng.standard_normal(N).astype(np.float32), rng.standard_normal(N).astype(np.float32))

        def outcomes(mesh):
            return [tm.MeanSquaredError(device=CPU).to_spmd(mesh=mesh).warm_start(preds, target)["spmd_step"]
                    for _ in range(2)]

        assert outcomes(_mesh()) == ["compiled", "hit"]
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
        try:
            assert outcomes(build_mesh(devices=[CPU] * 8, process_group=dist.group.WORLD)) == ["compiled", "hit"]
        finally:
            dist.destroy_process_group()
        child = (
            "import sys, datetime, numpy as np, torch, torch.distributed as dist\n"
            "import torchmetrics_tpu_torch as tm\n"
            "from torchmetrics_tpu_torch._spmd import build_mesh\n"
            "rank, port = int(sys.argv[1]), int(sys.argv[2])\n"
            "dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}', rank=rank, world_size=2,\n"
            "                        timeout=datetime.timedelta(seconds=60))\n"
            "rng = np.random.default_rng(11)\n"
            f"p, t = (torch.from_numpy(rng.standard_normal({N}).astype(np.float32)) for _ in range(2))\n"
            "mesh = build_mesh(devices=['cpu'] * 4, process_group=dist.group.WORLD)\n"
            "got = [tm.MeanSquaredError(device='cpu').to_spmd(mesh=mesh).warm_start(p, t)['spmd_step'] for _ in range(2)]\n"
            "dist.destroy_process_group()\n"
            "print(','.join(got))\n"
        )
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        env = dict(os.environ, TM_TPU_AOT_CACHE=str(cache_dir), PYTHONPATH=str(REPO_ROOT))
        procs = [subprocess.Popen([sys.executable, "-c", child, str(rank), str(port)], env=env, cwd=str(REPO_ROOT),
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for rank in range(2)]
        try:
            results = [proc.communicate(timeout=120) for proc in procs]
        finally:
            for proc in procs:
                proc.kill()
        for (out, err), proc in zip(results, procs):
            assert proc.returncode == 0, err[-2000:]
            assert out.strip().splitlines()[-1] == "compiled,hit"

    def test_warm_start_without_cache_dir_precompiles_in_memory(self):
        set_aot_cache(None)
        preds, target = _t(*_reg_batch())
        pool = tm.MeanSquaredError(device=CPU).to_stream_pool(capacity=2)
        ids = [pool.attach() for _ in range(2)]
        out = pool.warm_start(ids, preds[:2], target[:2])
        assert out["stream_step"] == "compiled"
        # a second warm of the same signature finds the key built ("ready"; the JAX package says "hit")
        assert pool.warm_start(ids, preds[:2], target[:2])["stream_step"] == "ready"
        pool.update(ids, preds[:2], target[:2])
        assert set(pool.compute_all()) == set(ids)

    def test_concurrent_warm_start(self, cache_dir):
        """Threads warming one pool's signatures race benignly: cold resolution runs under the cache's one
        lock with a second probe of the pool's steps, and every thread ends with a ready step. The JAX test
        arms its lock sanitizer; the port takes plain locks."""
        p, t = _reg_batch()
        preds, target = _t(p, t)
        pool = tm.MeanSquaredError(device=CPU).to_stream_pool(capacity=4)
        ids = [pool.attach() for _ in range(4)]
        pool.warm_start(ids[:2], preds[:2], target[:2])  # units prepared serially
        outcomes, errors = [], []

        def warm(rows):
            try:
                outcomes.append(pool.warm_start(ids[:rows], preds[:rows], target[:rows]))
            except BaseException as err:  # noqa: BLE001
                errors.append(err)

        threads = [threading.Thread(target=warm, args=(r,)) for r in (3, 3, 4, 4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert not errors, errors
        assert len(outcomes) == 4
        assert all(o["stream_step"] in ("hit", "compiled", "ready") for o in outcomes)
        assert sorted(o["stream_step"] for o in outcomes).count("compiled") <= 2  # one build a signature
        pool.update(ids, preds[:4], target[:4])
        values = pool.compute_all()
        assert set(values) == set(ids)
        for i, sid in enumerate(ids):
            np.testing.assert_allclose(float(values[sid]), _jax_value("MeanSquaredError", p[i: i + 1], t[i: i + 1]),
                                       rtol=RTOL)


class TestCliSurface:
    def test_entries_verify_and_evict(self, cache_dir):
        preds, target = _reg_batch()
        assert tm.MeanSquaredError(device=CPU).precompile(*_t(preds, target))["engaged"]
        cache = AotCache(str(cache_dir))
        entries = cache.entries()
        assert len(entries) == 1 and entries[0]["status"] == "ok" and not entries[0]["stale"]
        assert entries[0]["kind"] == "auto_update"
        # corrupt it: the listing flags it, stale-eviction removes it
        p = Path(entries[0]["path"])
        p.write_bytes(p.read_bytes()[:40])
        assert cache.entries()[0]["status"] != "ok"
        removed = cache.evict(stale_only=True)
        assert removed == [str(p)]
        assert cache.entries() == []

    def test_cli_list_and_verify_json(self, cache_dir, capsys):
        """``list`` through ``python -m`` (the module runs as a program), ``verify`` through the same ``main``."""
        preds, target = _reg_batch()
        assert tm.MeanSquaredError(device=CPU).precompile(*_t(preds, target))["engaged"]
        out = subprocess.run(
            [sys.executable, "-m", "torchmetrics_tpu_torch._aot", "list", "--json", "--dir", str(cache_dir)],
            cwd=str(REPO_ROOT), capture_output=True, text=True, timeout=240,
        )
        assert out.returncode == 0, out.stderr[-2000:]
        blob = json.loads(out.stdout)
        assert len(blob["artifacts"]) == 1
        capsys.readouterr()
        assert cli.main(["verify", "--dir", str(cache_dir)]) == 0, capsys.readouterr().out
        assert "1/1 artifacts verified ok" in capsys.readouterr().out


class TestPackUnpack:
    """``pack``/``unpack`` bundle the port's artifacts into one checksummed tarball; a corrupt or
    tampered bundle is refused whole (target untouched), and round trips are byte-identical."""

    @staticmethod
    def _jax_cli():
        spec = importlib.util.spec_from_file_location("aot_cache_cli", str(REPO_ROOT / "tools" / "aot_cache.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    @pytest.fixture()
    def store(self, tmp_path):
        src = tmp_path / "src"
        (src / "torch").mkdir(parents=True)
        (src / "torch" / "a.aot").write_bytes(b"\x00\x01artifact-a" * 100)
        (src / "torch" / "b.aot").write_bytes(b"artifact-b-payload" * 37)
        return src

    def test_round_trip(self, store, tmp_path):
        bundle = tmp_path / "bundle.tar.gz"
        assert cli.cmd_pack(str(store), str(bundle)) == 0
        dest = tmp_path / "dst"
        assert cli.cmd_unpack(str(dest), str(bundle), force=False) == 0
        for name in ("a.aot", "b.aot"):
            assert (dest / "torch" / name).read_bytes() == (store / "torch" / name).read_bytes()
        # a second install refuses to clobber without --force, allows with
        assert cli.cmd_unpack(str(dest), str(bundle), force=False) == 1
        assert cli.cmd_unpack(str(dest), str(bundle), force=True) == 0

    def test_corrupt_bundle_refused_whole(self, store, tmp_path):
        bundle = tmp_path / "bundle.tar.gz"
        assert cli.cmd_pack(str(store), str(bundle)) == 0
        blob = bytearray(bundle.read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        corrupt = tmp_path / "corrupt.tar.gz"
        corrupt.write_bytes(bytes(blob))
        dest = tmp_path / "never"
        assert cli.cmd_unpack(str(dest), str(corrupt), force=False) == 1
        assert not dest.exists()  # refusal leaves the target untouched

    def test_tampered_member_refused(self, store, tmp_path):
        bundle = tmp_path / "bundle.tar.gz"
        assert cli.cmd_pack(str(store), str(bundle)) == 0
        # the gzip stream is valid, but the manifest checksum must catch the swapped payload
        tampered = tmp_path / "tampered.tar.gz"
        with tarfile.open(bundle, "r:gz") as src_tar, tarfile.open(tampered, "w:gz") as dst_tar:
            for m in src_tar.getmembers():
                data = src_tar.extractfile(m).read()
                if m.name == "a.aot":
                    data = b"swapped" + data[7:]
                info = tarfile.TarInfo(m.name)
                info.size = len(data)
                dst_tar.addfile(info, io.BytesIO(data))
        dest = tmp_path / "never2"
        assert cli.cmd_unpack(str(dest), str(tampered), force=False) == 1
        assert not dest.exists()

    def test_traversal_member_refused(self, store, tmp_path):
        bundle = tmp_path / "bundle.tar.gz"
        assert cli.cmd_pack(str(store), str(bundle)) == 0
        evil = tmp_path / "evil.tar.gz"
        with tarfile.open(bundle, "r:gz") as src_tar, tarfile.open(evil, "w:gz") as dst_tar:
            for m in src_tar.getmembers():
                dst_tar.addfile(m, io.BytesIO(src_tar.extractfile(m).read()))
            info = tarfile.TarInfo("../escape.aot")
            info.size = 4
            dst_tar.addfile(info, io.BytesIO(b"evil"))
        dest = tmp_path / "never3"
        assert cli.cmd_unpack(str(dest), str(evil), force=False) == 1
        assert not dest.exists()

    def test_empty_store_refuses_pack(self, tmp_path):
        empty = tmp_path / "empty"
        (empty / "torch").mkdir(parents=True)
        assert cli.cmd_pack(str(empty), str(tmp_path / "x.tar.gz")) == 1

    def test_bundles_cross_between_the_packages(self, store, tmp_path):
        """The JAX CLI's bundle unpacks with the port's and the reverse, byte for byte; each installs where
        its package keeps artifacts (the JAX package at the top level, the port under ``torch/``)."""
        jax_cli = self._jax_cli()
        jax_src = tmp_path / "jax_src"
        jax_src.mkdir()
        (jax_src / "c.aot").write_bytes(b"jax-artifact" * 50)
        jax_bundle, port_bundle = tmp_path / "jax.tar.gz", tmp_path / "port.tar.gz"
        assert jax_cli.cmd_pack(str(jax_src), str(jax_bundle)) == 0
        assert cli.cmd_unpack(str(tmp_path / "into_port"), str(jax_bundle), force=False) == 0
        assert (tmp_path / "into_port" / "torch" / "c.aot").read_bytes() == (jax_src / "c.aot").read_bytes()
        assert cli.cmd_pack(str(store), str(port_bundle)) == 0
        assert jax_cli.cmd_unpack(str(tmp_path / "into_jax"), str(port_bundle), force=False) == 0
        for name in ("a.aot", "b.aot"):
            assert (tmp_path / "into_jax" / name).read_bytes() == (store / "torch" / name).read_bytes()


class TestKernelLibraries:
    """The ``kernel_library`` route, driven for real through ``load_c`` and the system ``cc``."""

    MASK = (np.arange(24 * 17).reshape(24, 17) % 7 < 3).astype(np.uint8)

    def _artifact(self, cache_dir):
        (art,) = glob.glob(str(cache_dir / "torch" / "kernel_library.*.aot"))
        return Path(art)

    def test_build_stores_the_library(self, cache_dir, build_dir):
        before = aot_stats()
        counts = _rle.mask_to_rle_counts(self.MASK)
        assert counts == _rle.mask_to_rle_counts_plain(self.MASK)
        delta = _delta(before, aot_stats())
        assert delta["library_builds"] == 1 and delta["library_writes"] == 1 and delta["library_misses"] == 1
        (entry,) = AotCache(str(cache_dir)).entries()
        assert entry["status"] == "ok" and not entry["stale"] and entry["kind"] == "kernel_library"
        assert entry["owner"] == "rle.c" and entry["fingerprint"]["target"] == "host"
        assert _payload(Path(entry["path"])) == next(build_dir.glob("librle-*.so")).read_bytes()

    def test_fresh_replica_without_cc_loads_from_the_cache(self, cache_dir, build_dir, tmp_path):
        want = _rle.rle_string_encode(_rle.mask_to_rle_counts(self.MASK))
        child = (
            "import json, sys, numpy as np\n"
            "from pathlib import Path\n"
            "from torchmetrics_tpu_torch.utilities import nvcc\n"
            "nvcc.BUILD_DIR = Path(sys.argv[1])\n"
            "from torchmetrics_tpu_torch.functional.detection import _rle\n"
            "from torchmetrics_tpu_torch._aot import aot_stats\n"
            "mask = (np.arange(24 * 17).reshape(24, 17) % 7 < 3).astype(np.uint8)\n"
            "rle = _rle.rle_string_encode(_rle.mask_to_rle_counts(mask))\n"
            "print(json.dumps({'rle': rle, 'stats': aot_stats(), 'lib': _rle._library()._name}))\n"
        )
        fresh = tmp_path / "fresh_build"
        env = {k: v for k, v in os.environ.items() if k != "CC"}
        env.update(TM_TPU_AOT_CACHE=str(cache_dir), PATH=str(tmp_path / "no_compilers_here"))
        out = subprocess.run([sys.executable, "-c", child, str(fresh)], env=env, cwd=str(REPO_ROOT),
                             capture_output=True, text=True, timeout=240)
        assert out.returncode == 0, out.stderr[-2000:]
        got = json.loads(out.stdout.strip().splitlines()[-1])
        assert got["rle"] == want
        assert got["stats"]["library_hits"] == 1 and got["stats"]["library_builds"] == 0
        assert got["lib"].startswith(str(fresh))  # loaded from its own build dir, never from the cache

    def test_bitflipped_library_falls_back_and_is_rewritten(self, cache_dir, build_dir, tmp_path, monkeypatch,
                                                           telemetry_on):
        _rle.mask_to_rle_counts(self.MASK)
        art = self._artifact(cache_dir)
        raw = bytearray(art.read_bytes())
        raw[-100] ^= 0xFF
        art.write_bytes(bytes(raw))
        monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "second")
        _rle._library.cache_clear()
        before = aot_stats()
        assert _rle.mask_to_rle_counts(self.MASK) == _rle.mask_to_rle_counts_plain(self.MASK)
        delta = _delta(before, aot_stats())
        assert delta["library_fallbacks"] == 1 and delta["library_builds"] == 1 and delta["library_writes"] == 1
        assert any(e.data.get("kind") == "kernel_library" for e in BUS.events(kind="aot_fallback"))
        assert AotCache(str(cache_dir)).entries()[0]["status"] == "ok"
        monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "third")
        _rle._library.cache_clear()
        before = aot_stats()
        _rle.mask_to_rle_counts(self.MASK)
        assert _delta(before, aot_stats())["library_hits"] == 1

    def test_driver_older_than_nvcc_release_is_refused(self, monkeypatch):
        monkeypatch.setattr(aot_artifacts, "cuda_driver_version", lambda: 12040)
        newer = {"compiler": "nvcc", "nvcc_release": "12.6"}
        assert "older than the nvcc release 12.6" in aot_artifacts.library_refusal(newer)
        assert aot_artifacts.load_library_artifact(newer, b"\x7fELF...") is None
        older = {"compiler": "nvcc", "nvcc_release": "12.4"}
        assert aot_artifacts.library_refusal(older) is None
        assert aot_artifacts.load_library_artifact(older, b"\x7fELF...") == b"\x7fELF..."
        assert aot_artifacts.library_refusal({"compiler": "cc", "nvcc_release": None}) is None

    def test_record_names_the_libraries_its_warm_up_launched(self, cache_dir, build_dir, monkeypatch):
        """A counter of ``confmat.cu`` hit during a key's first run puts that library in the record; the next
        process's hit loads it (here a stand-in library at its ``_build/`` name) before the warm-up."""
        confmat = nvcc.CSRC_DIR / "confmat.cu"
        counter = LaunchCounter(confmat)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)  # a CPU build of torch
        preds, target = _t(*_reg_batch())
        metric = tm.MeanSquaredError(device=CPU)
        update = type(metric).update

        def launching_update(self, *args, **kwargs):
            counter.hit(torch.device(CPU))
            return update(self, *args, **kwargs)

        try:
            type(metric).update = launching_update
            metric = tm.MeanSquaredError(device=CPU)
            assert metric.precompile(preds, target)["engaged"]
        finally:
            type(metric).update = update
        (art,) = _records(cache_dir)
        record = aot_artifacts.load_step_record(_payload(Path(art)))
        assert record["libraries"] == [{"source": "confmat.cu", "digest": nvcc.source_digest(confmat)}]
        # with no library in `_build/` and no nvcc here, the record cannot be served: building raises
        before = aot_stats()
        with pytest.raises(FileNotFoundError, match="nvcc not found"):
            aot_cache.wrap_executable(owner=record["owner"], kind=record["kind"], components=record["components"],
                                      extra=record["extra"])
        assert _delta(before, aot_stats())["library_misses"] == 1
        build_dir.mkdir(parents=True, exist_ok=True)
        shutil.copy(_rle._library()._name, nvcc.library_path(confmat))  # any shared object stands in
        res = aot_cache.wrap_executable(owner=record["owner"], kind=record["kind"], components=record["components"],
                                        extra=record["extra"])
        assert res.outcome == "hit"


class TestSharedDirectory:
    def test_neither_package_lists_or_evicts_the_others_artifacts(self, cache_dir):
        from torchmetrics_tpu._aot import set_aot_cache as jax_set_aot_cache
        from torchmetrics_tpu._aot.cache import AotCache as JaxAotCache

        preds, target = _reg_batch()
        jax_set_aot_cache(str(cache_dir))
        try:
            jtm.MeanSquaredError().precompile(jnp.asarray(preds), jnp.asarray(target))
        finally:
            jax_set_aot_cache(None)
        assert tm.MeanSquaredError(device=CPU).precompile(*_t(preds, target))["engaged"]
        jax_entries, port_entries = JaxAotCache(str(cache_dir)).entries(), AotCache(str(cache_dir)).entries()
        assert [Path(e["path"]).parent for e in jax_entries] == [cache_dir]
        assert [Path(e["path"]).parent for e in port_entries] == [cache_dir / "torch"]
        assert JaxAotCache(str(cache_dir)).evict(stale_only=True) == []
        assert AotCache(str(cache_dir)).evict(stale_only=True) == []
        assert len(JaxAotCache(str(cache_dir)).entries()) == 1 and len(AotCache(str(cache_dir)).entries()) == 1

    def test_the_surface_equals_the_jax_package(self):
        import torchmetrics_tpu._aot as jax_aot

        assert _aot.__all__ == jax_aot.__all__
        assert tm.get_aot_cache is _aot.get_aot_cache and tm.set_aot_cache is _aot.set_aot_cache
        set_aot_cache("  /somewhere  ")
        try:
            assert tm.get_aot_cache() == "/somewhere" and _aot.AOT.active
        finally:
            set_aot_cache(None)
        assert tm.get_aot_cache() is None and not _aot.AOT.active


class TestProfiling:
    def test_recorded_cost_stands_in_for_the_count(self, cache_dir, monkeypatch):
        """While profiling, a hit's recorded flops and bytes are the step's cost, and the warm-up is not counted."""
        from torchmetrics_tpu_torch._observability import costs
        from torchmetrics_tpu_torch._observability.profiling import LEDGER

        preds, target = _t(*_reg_batch())
        was = OBS.profiling
        OBS.profiling = True
        try:
            assert tm.MeanSquaredError(device=CPU).precompile(preds, target)["engaged"]
            (art,) = _records(cache_dir)
            recorded = aot_artifacts.load_step_record(_payload(Path(art)))["cost"]
            assert recorded and recorded["bytes_accessed"] > 0

            def no_count(*a, **k):
                raise AssertionError("a hit's warm-up was counted")

            monkeypatch.setattr(costs, "count_costs", no_count)
            seen = []
            monkeypatch.setattr(LEDGER, "note_executable", lambda **kw: seen.append(kw))
            before = aot_stats()
            assert tm.MeanSquaredError(device=CPU).precompile(preds, target)["engaged"]
            assert _delta(before, aot_stats())["hits"] == 1
            assert seen and seen[-1]["cost"].to_json() == recorded
        finally:
            OBS.profiling = was
