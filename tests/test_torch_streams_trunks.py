"""The trunk metrics in a stream pool, on the CPU, against the JAX package's pool.

FrechetInceptionDistance, LearnedPerceptualImagePatchSimilarity, CLIPScore and
SpeechReverberationModulationEnergyRatio read ``safe`` in the JAX package's
eligibility manifest; both packages pool them. The same seeded numpy
micro-batches go through a capacity-3 pool of each package: two lanes a step,
a stream that skips a step, a detach and an attach between steps, a padding
lane (``-1``). The JAX pool runs once a class (a module-scoped fixture);
LPIPS's runs its Pallas head in interpret mode and must not degrade, FID's
takes the JAX package's plain XLA reference (``PALLAS_POOLS`` says why), as
do the eager JAX instances, as the JAX package's own CPU tests may.

Held, per class:

- every stream's stacked states to the JAX pool's rows (``STATE_RTOL``: the
  classes' own tolerances in their single-metric tests, float32 trunks);
- each stream's ``compute(i)`` to one eager JAX instance fed that stream's
  batches (``VALUE_RTOL``; FID's 2e-2 is ``test_torch_image.py``'s: a handful
  of 64-d features make both covariances singular, and the two libraries'
  float32 eigensolvers differ on the clipped near-zero eigenvalues);
- the port's pool to eager port twins fed the same batches: FID's and LPIPS's
  states and values bit for bit (at these float32 sizes each plain kernel
  version gives a row of the folded batch the bits of its lane's own call),
  CLIPScore's and SRMR's within ``TWIN_RTOL`` (a batched matmul or FFT over the
  lanes may sum in another order than one lane's);
- a pooled step's calls of each kernel's plain version to one eager update's,
  whatever the number of lanes: on the card, one launch a micro-batch.

CLIPScore's captions are a static of the step in both packages, shared by the
lanes of a micro-batch; a new caption list is a new key. Its towers launch no
B4 or B5 (plain LayerNorm and softmax, as the JAX package's flax towers), so
its pooled step calls neither. Also here: FID's ``compute_all`` raises in the
port as the JAX pool's ``compute`` raises; KID pools as in the JAX package
(refused by the manifest, and with ``enforce_manifest=False`` its first update
raises); a collection of two FIDs in one compute group (the JAX side on its
XLA reference); the pool's graph
memory bound; a trunk's ``CapturedForward`` on a vmapped lane; SRMR's host
check skipped on a lane.
"""

import importlib
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu._streams as j_streams
import torchmetrics_tpu_torch as ttm
from tests.test_torch_multimodal import EOS, Tokenizer, small_config
from torchmetrics_tpu import _kernels as JK
from torchmetrics_tpu._kernels.dispatch import reset_degradations
from torchmetrics_tpu.multimodal._clip_encoder import ClipExtractor as JClip
from torchmetrics_tpu.utilities.exceptions import TorchMetricsUserError as JUserError
from torchmetrics_tpu_torch import _compile
from torchmetrics_tpu_torch._streams import StreamPoolUnsupported
from torchmetrics_tpu_torch.image._inception import InceptionV3, init_weights_
from torchmetrics_tpu_torch.image._lpips import LPIPSNet
from torchmetrics_tpu_torch.multimodal._clip_encoder import _ClipModel, init_clip_weights_
from torchmetrics_tpu_torch.utilities.checks import _no_vmap_fallback
from torchmetrics_tpu_torch.utilities.convert import build_on_cpu, clip_variables_from_state_dict, variables_from_state_dict
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError as TUserError

ce, lh, ka, kb = (
    importlib.import_module(f"torchmetrics_tpu_torch._kernels.{name}")
    for name in ("conv_epilogue", "lpips_head", "attention", "biquad")
)
psrmr = importlib.import_module("torchmetrics_tpu_torch.functional.audio.srmr")

CLASSES = ("fid", "lpips", "clip", "srmr")
# the JAX pools run in Pallas interpret mode where it costs seconds: LPIPS's head (B3). FID's B2b in interpret mode
# loops over every pixel row of each 149x149 map, ~1.2 s an image on this CPU, so FID's pool takes the JAX package's
# XLA reference, as its kernel tests hold it to (FID's Pallas route is held to the port in `test_torch_image.py`).
# CLIPScore's and SRMR's JAX towers and filters have no Pallas kernel.
PALLAS_POOLS = ("lpips",)
STATE_RTOL = {"fid": 1e-4, "lpips": 1e-4, "clip": 1e-4, "srmr": 5e-3}
VALUE_RTOL = {"fid": 2e-2, "lpips": 1e-4, "clip": 1e-4, "srmr": 5e-3}
TWIN_RTOL = {"fid": 0.0, "lpips": 0.0, "clip": 1e-6, "srmr": 1e-6}
# (ids, batch, statics) a step; ("churn", slot) detaches the slot and attaches it again (the lowest free slot)
SCHEDULE = [((0, 1), 0), ((2, 0), 1), ("churn", 1), ((1, 2), 2), ((1, -1), 3)]
FID_REAL = (True, False, True, False)
CAPTIONS = (["a cat on a mat", "two dogs", "a red car"], ["a mat", "three cats in a row", ""])
PLAIN = {  # the plain versions a pooled step calls once for all its lanes, by module
    "B2a": (ce, "matmul_bias_relu"), "B2b": (ce, "bias_relu_"), "B3": (lh, "lpips_head_plain"),
    "B4": (ka, "attention_plain"), "B5": (ka, "layernorm_residual_plain"), "S1": (kb, "biquad_bank_plain"),
}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """One seeded ``.npz`` each, written by the port in the JAX package's layout, for both packages."""
    folder = tmp_path_factory.mktemp("trunks")
    inception = init_weights_(build_on_cpu(InceptionV3, fuse_bn=False), seed=0)
    rng = np.random.default_rng(1)
    state = inception.state_dict()
    for key, value in state.items():  # random BatchNorm statistics, so that folding is exercised
        if key.endswith(("running_mean", "BatchNorm_0.bias")):
            value.copy_(torch.from_numpy(rng.normal(0.0, 0.1, value.shape[0]).astype(np.float32)))
        elif key.endswith(("running_var", "BatchNorm_0.weight")):
            value.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, value.shape[0]).astype(np.float32)))
    np.savez(folder / "inception.npz", **variables_from_state_dict(state))
    lpips = init_weights_(build_on_cpu(LPIPSNet, net_type="alex"), seed=1)
    with torch.no_grad():
        for name, param in lpips.named_parameters():
            if name.startswith("lin"):
                param.abs_()  # non-negative heads, as real LPIPS heads are
    np.savez(folder / "lpips.npz", **variables_from_state_dict(lpips.state_dict()))
    cfg = small_config(EOS)
    clip = init_clip_weights_(build_on_cpu(_ClipModel, cfg), seed=EOS)
    np.savez(folder / "clip.npz", **clip_variables_from_state_dict(clip.state_dict(), cfg))
    return {name: str(folder / f"{name}.npz") for name in ("inception", "lpips", "clip")}


def _batches(name):
    """Four micro-batches of two lanes each, numpy, from one seed a class."""
    rng = np.random.default_rng(CLASSES.index(name) + 40)
    out = []
    for step in range(4):
        if name == "fid":
            imgs = rng.integers(0, 256, (2, 2, 3, 16, 16), dtype=np.uint8)
            if not FID_REAL[step]:
                imgs = np.clip(imgs.astype(np.int64) + 40, 0, 255).astype(np.uint8)
            out.append((imgs,))
        elif name == "lpips":
            img0 = (rng.random((2, 2, 3, 65, 65)) * 2 - 1).astype(np.float32)
            img1 = np.clip(img0 + rng.normal(0.0, 0.3, img0.shape), -1, 1).astype(np.float32)
            out.append((img0, img1))
        elif name == "clip":
            out.append((rng.random((2, 3, 3, 45, 70)).astype(np.float32),))  # resized to 32x32 in the tower
        else:
            t = np.arange(2560) / 8000.0
            tone = np.sin(2 * np.pi * rng.uniform(100, 400, (2, 2, 1)) * t) * rng.uniform(0.2, 1.0, (2, 2, 1))
            out.append(((tone + 0.05 * rng.standard_normal((2, 2, 2560))).astype(np.float32),))
    return out


def _statics(name, step):
    if name == "fid":
        return (), {"real": FID_REAL[step]}
    if name == "clip":
        return (CAPTIONS[step % 2],), {}
    return (), {}


def _side(is_jax):
    if is_jax:
        return types.SimpleNamespace(tm=jtm, arr=lambda a: jnp.asarray(a), kw={}, ids=lambda i: np.asarray(i, np.int32))
    return types.SimpleNamespace(tm=ttm, arr=torch.from_numpy, kw={"device": "cpu"}, ids=lambda i: np.asarray(i, np.int64))


def _make(name, S, weights, **kw):
    kw = {**S.kw, **kw}
    if name == "fid":
        dtype = jnp.float32 if S.tm is jtm else torch.float32
        return S.tm.FrechetInceptionDistance(feature=64, weights_path=weights["inception"], compute_dtype=dtype, **kw)
    if name == "lpips":
        dtype = jnp.float32 if S.tm is jtm else torch.float32
        return S.tm.LearnedPerceptualImagePatchSimilarity(
            net_type="alex", weights_path=weights["lpips"], compute_dtype=dtype, **kw)
    if name == "clip":
        if S.tm is jtm:
            return jtm.CLIPScore(model=JClip(weights["clip"], tokenizer=Tokenizer()), **kw)
        return ttm.CLIPScore(weights_path=weights["clip"], tokenizer=Tokenizer(), **kw)
    return S.tm.SpeechReverberationModulationEnergyRatio(fs=8000, **kw)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _run_pool(name, S, weights):
    """The schedule through one package's pool; returns the pool and each stream's (batch, lane, step) feed."""
    batches = _batches(name)
    pool = _make(name, S, weights).to_stream_pool(capacity=3)
    fed = {pool.attach(): [] for _ in range(3)}
    step = 0
    for entry in SCHEDULE:
        if entry[0] == "churn":
            pool.detach(entry[1])
            assert pool.attach() == entry[1]
            fed[entry[1]] = []
            continue
        ids, k = entry
        args, kw = _statics(name, step)
        pool.update(S.ids(ids), *(S.arr(a) for a in batches[k]), *args, **kw)
        for lane, sid in enumerate(ids):
            if sid >= 0:
                fed[sid].append((k, lane, step))
        step += 1
    return pool, fed


def _eager(name, S, metric, feed):
    """``metric`` reset, then fed one stream's rows; its value and states."""
    batches = _batches(name)
    metric.reset()
    for k, lane, step in feed:
        args, kw = _statics(name, step)
        metric.update(*(S.arr(a[lane]) for a in batches[k]), *args, **kw)
    return metric


def _pallas_interpret():
    mp = pytest.MonkeyPatch()
    reset_degradations()
    mp.setenv(JK.KERNELS_ENV, "pallas")
    return mp


@pytest.fixture(scope="module", params=CLASSES)
def jax_run(request, weights):
    """The JAX pool of one class over the schedule, and an eager JAX instance's value a stream (one instance, reset)."""
    name, S = request.param, _side(True)
    mp = _pallas_interpret() if name in PALLAS_POOLS else None
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            pool, fed = _run_pool(name, S, weights)
            states = {k: v for k, v in pool.state_dict().items() if not k.startswith("#")}
        assert not JK.degraded_kernels()
    finally:
        if mp is not None:
            mp.undo()
        reset_degradations()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        twin = _make(name, S, weights, auto_compile=False)  # the eager form, the one the port carries
        values = {sid: np.asarray(_eager(name, S, twin, feed).compute()) for sid, feed in fed.items()}
    return types.SimpleNamespace(name=name, pool=pool, fed=fed, states=states, values=values)


@pytest.fixture(scope="module")
def port_runs(weights):
    """The port's pool of each class over the schedule, with the plain kernels' calls of each step."""
    runs = {}
    for name in CLASSES:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.MonkeyPatch.context() as mp:
                calls = {}
                for kernel, (module, attr) in PLAIN.items():
                    fn = getattr(module, attr)

                    def counted(*a, _fn=fn, _k=kernel, **kw):
                        calls[_k] = calls.get(_k, 0) + 1
                        return _fn(*a, **kw)

                    mp.setattr(module, attr, counted)
                S = _side(False)
                ce.conv_bias_act.layout_copies = 0
                pool, fed = _run_pool(name, S, weights)
                copies = ce.conv_bias_act.layout_copies
                pooled_calls = dict(calls)
                calls.clear()
                twin = _make(name, S, weights)
                first = fed[0][:1]  # one eager update: the calls of one forward
                _eager(name, S, twin, first)
                eager_calls = dict(calls)
        runs[name] = types.SimpleNamespace(pool=pool, fed=fed, pooled_calls=pooled_calls, eager_calls=eager_calls,
                                           layout_copies=copies)
    return runs


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if rtol == 0.0:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1e-12, float(np.abs(want).max())), err_msg=what)


def test_each_stream_is_fed_as_the_schedule_says(jax_run, port_runs):
    port = port_runs[jax_run.name]
    assert port.fed == jax_run.fed == {0: [(0, 0, 0), (1, 1, 1)], 1: [(2, 0, 2), (3, 0, 3)], 2: [(1, 0, 1), (2, 1, 2)]}
    assert [port.pool.stream_update_count(s) for s in range(3)] == [2, 2, 2]


def test_pooled_states_match_the_jax_pool(jax_run, port_runs):
    got = {k: v for k, v in port_runs[jax_run.name].pool.state_dict().items() if not k.startswith("#")}
    assert sorted(got) == sorted(jax_run.states)
    for key, want in jax_run.states.items():
        assert got[key].shape == want.shape, key
        for sid in range(3):  # the scratch row past them takes the padding lane
            _close(got[key][sid], want[sid], STATE_RTOL[jax_run.name], f"{key}[{sid}]")


def test_each_stream_computes_as_an_eager_jax_instance(jax_run, port_runs):
    pool = port_runs[jax_run.name].pool
    for sid, want in jax_run.values.items():
        _close(_host(pool.compute(sid)), want, VALUE_RTOL[jax_run.name], f"stream {sid}")


@pytest.mark.parametrize("name", CLASSES)
def test_pooled_streams_match_eager_port_twins(name, port_runs, weights):
    run = port_runs[name]
    twin = _make(name, _side(False), weights)
    states = run.pool.state_dict()
    for sid, feed in run.fed.items():
        _eager(name, _side(False), twin, feed)
        for key in twin._defaults:
            _close(states[key][sid], _host(getattr(twin, key)), TWIN_RTOL[name], f"{key} of stream {sid}")
        _close(_host(run.pool.compute(sid)), _host(twin.compute()), TWIN_RTOL[name], f"stream {sid}")


@pytest.mark.parametrize("name", CLASSES)
def test_a_pooled_step_calls_each_kernel_once_for_all_its_lanes(name, port_runs):
    """On the card each call is one launch: a step launches what one eager update launches, whatever its lanes."""
    run = port_runs[name]
    expected = {"fid": {"B2b": 3}, "lpips": {"B3": 5}, "clip": {}, "srmr": {"S1": 2}}[name]
    assert run.eager_calls == expected
    steps = sum(1 for entry in SCHEDULE if entry[0] != "churn")
    # plus one eager update: the pool's first batch probes the template's states on a copy (`_prepare`)
    assert run.pooled_calls == {k: v * (steps + 1) for k, v in expected.items()}
    assert run.layout_copies == 0  # the lanes' maps stay channels_last: no conv input or output is copied


@pytest.mark.parametrize("jax_run", ["fid"], indirect=True)
def test_pooled_fid_compute_all_raises_as_the_jax_pool_compute_does(port_runs, jax_run):
    with pytest.raises(jax.errors.TracerBoolConversionError):
        jax_run.pool.compute(0)  # the host read of `compute` under the pool's jit
    with pytest.raises(RuntimeError, match="data-dependent control flow"):
        port_runs["fid"].pool.compute_all()  # the same read under the pool's vmap


def test_kid_pools_as_the_jax_package_pools_it(weights):
    kw = {"feature": 64, "subset_size": 2, "cat_state_capacity": 8, "weights_path": weights["inception"]}
    imgs = np.random.default_rng(3).integers(0, 256, (2, 2, 3, 16, 16), dtype=np.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jkid, tkid = jtm.KernelInceptionDistance(**kw), ttm.KernelInceptionDistance(device="cpu", **kw)
    with pytest.raises(j_streams.StreamPoolUnsupported, match="host_bound"):
        jkid.to_stream_pool(capacity=2)
    with pytest.raises(StreamPoolUnsupported, match="host_bound"):
        tkid.to_stream_pool(capacity=2)
    jpool, tpool = jkid.to_stream_pool(capacity=2, enforce_manifest=False), tkid.to_stream_pool(capacity=2, enforce_manifest=False)
    for pool in (jpool, tpool):
        pool.attach(), pool.attach()
    # a first batch of real images leaves the fake ring's row shape unknown, in both packages
    with pytest.raises(JUserError, match="row shape could not be learned"):
        jpool.update(np.arange(2, dtype=np.int32), jnp.asarray(imgs), real=True)
    with pytest.raises(TUserError, match="row shape could not be learned"):
        tpool.update(np.arange(2), torch.from_numpy(imgs), real=True)


def test_a_collection_of_fids_in_one_compute_group_pools_as_in_the_jax_package(weights):
    imgs = np.random.default_rng(4).integers(0, 256, (2, 2, 3, 16, 16), dtype=np.uint8)
    got = {}
    with warnings.catch_warnings():  # the JAX side on its XLA reference: its Pallas pool runs in `jax_run`
        warnings.simplefilter("ignore")
        for S in (_side(True), _side(False)):
            dtype = jnp.float32 if S.tm is jtm else torch.float32
            kw = {"feature": 64, "weights_path": weights["inception"], "compute_dtype": dtype, **S.kw}
            mc = S.tm.MetricCollection({
                "fid": S.tm.FrechetInceptionDistance(**kw),
                "fid_keep_real": S.tm.FrechetInceptionDistance(reset_real_features=False, **kw),
            })
            pool = mc.to_stream_pool(capacity=2)
            pool.attach(), pool.attach()
            pool.update(S.ids((0, 1)), S.arr(imgs), real=True)  # the first batch forms the groups
            units = [[n for n, _ in u.members] for u in pool._units]
            got[S.tm is jtm] = (units, {k: v for k, v in pool.state_dict().items() if not k.startswith("#")})
    (j_units, j_states), (t_units, t_states) = got[True], got[False]
    assert j_units == t_units == [["fid", "fid_keep_real"]]  # one trunk forward a step for both members
    assert sorted(j_states) == sorted(t_states)
    for key, want in j_states.items():
        _close(t_states[key][:2], want[:2], STATE_RTOL["fid"], key)


def test_a_capture_past_the_graph_memory_bound_keeps_the_key_eager(monkeypatch):
    """The card's route, with the capture faked: a pool whose graphs would pass an eighth of the card stays eager."""
    from torchmetrics_tpu_torch._observability import set_telemetry_enabled
    from torchmetrics_tpu_torch._observability.events import BUS
    from torchmetrics_tpu_torch._observability.telemetry import telemetry_for

    pool = ttm.MeanSquaredError(device="cpu").to_stream_pool(capacity=2)
    a, b = pool.attach(), pool.attach()
    dyn = [torch.tensor([a, b]), torch.ones(2, 3), torch.zeros(2, 3)]
    pool.update(dyn[0], dyn[1], dyn[2])
    ((key, step),) = pool._step_fns.items()
    captured = []
    monkeypatch.setattr(_compile, "CapturedStep", lambda *args, **kw: captured.append(args) or object())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: ("pool",))
    monkeypatch.setattr(_compile, "pool_bytes", lambda p: 11 * 2**30)
    monkeypatch.setattr(_compile, "_pool_bound", lambda device: 10 * 2**30)
    set_telemetry_enabled(True)
    try:
        with pytest.warns(UserWarning, match="did not capture into a CUDA graph.*over the bound"):
            got = pool._capture(key, step, dyn)
        assert telemetry_for(pool, create=False).counters.get("auto_path_disabled") == 1
        (event,) = [e for e in BUS.events("auto_path_disabled") if e.source == "StreamPool[MeanSquaredError]"][-1:]
        assert event.data == {"seam": "stream_step", "key": repr(key)} and "over the bound" in event.detail
    finally:
        set_telemetry_enabled(False)
    assert len(captured) == 1 and got is step
    assert pool._step_fns == {} and pool._graph_pool is None  # every graph of the pool goes with it
    assert pool.capture_failures[key].startswith("_PoolBoundExceeded: the pool's graphs hold 11811160064 bytes")


def test_a_trunk_runs_inline_on_a_vmapped_lane():
    """No signature is seen and no graph is made for a lane: the pool's step holds the trunk."""
    cap = _compile.CapturedForward()
    proj = torch.randn(12, 4, generator=torch.Generator().manual_seed(5))
    fn = lambda x: x.reshape(len(x), -1) @ proj  # noqa: E731
    x = torch.randn(3, 2, 3, 2, 2, generator=torch.Generator().manual_seed(6))
    before = _compile.stats()
    with torch.no_grad(), _no_vmap_fallback():
        got = torch.func.vmap(lambda lane: cap(fn, lane, statics=("lane",)))(x)
    assert torch.equal(got, torch.stack([fn(lane) for lane in x]))
    assert cap.seen == set() and cap.graphs == {} and cap.eager == set() and _compile.stats() == before


def test_srmr_skips_its_host_check_on_a_vmapped_lane(monkeypatch):
    """A lane has no host value: outside a compiled step the range check must not read it (it would raise)."""
    x = torch.from_numpy(_batches("srmr")[0][0])
    with torch.no_grad(), _no_vmap_fallback():
        got = torch.func.vmap(lambda lane: psrmr.speech_reverberation_modulation_energy_ratio(lane, 8000))(x)
    want = torch.stack([psrmr.speech_reverberation_modulation_energy_ratio(lane, 8000) for lane in x])
    _close(_host(got), _host(want), TWIN_RTOL["srmr"], "SRMR")
