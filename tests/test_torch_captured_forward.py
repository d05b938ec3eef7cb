"""The trunks' captured forwards (``_compile.CapturedForward``), with no JAX: the file runs on a card as it is.

On CPU tensors a trunk runs eagerly and nothing is captured; a returned
feature is never a buffer a later call writes; moves and copies drop the
graphs. The tests marked ``cuda`` hold the rules of the card: a signature's
first call runs eagerly and its second captures, the pool bound, the
numerics settings in the signature, and a compiling metric's graph as the
only holder of its trunk. They skip where there is no card; on one, run
``python -m pytest --noconftest tests/test_torch_captured_forward.py``
(the suite's ``conftest.py`` imports JAX).
"""

import copy
import pickle

import numpy as np
import pytest
import torch
from torch import nn

import torchmetrics_tpu_torch.image as PI
from torchmetrics_tpu_torch import _compile
from torchmetrics_tpu_torch._compile import CapturedForward, device_constant


class _Doubler(nn.Module):
    """A trunk that runs its forward through a CapturedForward and counts the calls that reach its Python."""

    num_features = 8

    def __init__(self):
        super().__init__()
        self.proj = nn.Parameter(torch.randn(3 * 4 * 4, 8, generator=torch.Generator().manual_seed(3)))
        self.captured = CapturedForward()
        self.calls = 0

    def forward(self, imgs):
        self.calls += 1
        return self.captured(self._features, imgs, statics=("features",))

    def _features(self, imgs):
        return imgs.reshape(len(imgs), -1).to(torch.float32) @ self.proj


def _never_overwritten(device):
    trunk = _Doubler().to(device)
    a = torch.ones((2, 3, 4, 4), device=device)
    first = trunk(a)  # the signature's first call runs eagerly
    kept = first.clone()
    for v in (2.0, 3.0):  # a capture, then a replay of the same signature
        trunk(torch.full((2, 3, 4, 4), v, device=device))
    assert torch.equal(first, kept)
    again = trunk(a)
    assert torch.equal(again, kept) and again.data_ptr() != first.data_ptr()
    assert len(trunk.captured.graphs) == (1 if device == "cuda" else 0)


def test_a_returned_feature_is_never_overwritten():
    _never_overwritten("cpu")


@pytest.mark.cuda
def test_a_replayed_feature_is_never_overwritten_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("graphs are captured only on a CUDA card")
    _never_overwritten("cuda")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("graphs are captured only on a CUDA card")


@pytest.mark.cuda
def test_a_shape_met_once_holds_no_graph_on_the_card():
    _card()
    trunk = _Doubler().to("cuda")
    before = _compile.stats()["forward_captured"]
    for n in (2, 3, 4):
        trunk(torch.ones((n, 3, 4, 4), device="cuda"))
    assert trunk.captured.graphs == {} and trunk.captured.pool is None and len(trunk.captured.seen) == 3
    trunk(torch.ones((3, 3, 4, 4), device="cuda"))
    assert len(trunk.captured.graphs) == 1 and _compile.stats()["forward_captured"] == before + 1


@pytest.mark.cuda
def test_the_pool_bound_drops_every_graph_and_keeps_the_signature_eager_on_the_card(monkeypatch):
    _card()
    trunk = _Doubler().to("cuda")
    x = torch.ones((2, 3, 4, 4), device="cuda")
    for _ in range(3):
        trunk(x)
    assert len(trunk.captured.graphs) == 1 and _compile.pool_bytes(trunk.captured.pool) > 0
    monkeypatch.setattr(_compile, "_pool_bound", lambda device: 0)
    y = torch.ones((5, 3, 4, 4), device="cuda")
    want = trunk._features(y)
    got = [trunk(y) for _ in range(3)]  # eager, captured past the bound, then eager from then on
    assert all(torch.equal(g, want) for g in got)
    assert len(trunk.captured.eager) == 1 and trunk.captured.graphs == {} and trunk.captured.pool is None
    monkeypatch.undo()
    calls = trunk.calls
    for _ in range(2):
        assert torch.equal(trunk(x), trunk._features(x)) and torch.equal(trunk(y), want)
    # x is captured again at its next call, y stays eager
    assert trunk.calls == calls + 4 and len(trunk.captured.graphs) == 1 and len(trunk.captured.eager) == 1


@pytest.mark.cuda
def test_a_capture_out_of_memory_keeps_the_signature_eager_on_the_card(monkeypatch):
    _card()

    def no_memory(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("no memory for the capture")

    trunk = _Doubler().to("cuda")
    x = torch.ones((2, 3, 4, 4), device="cuda")
    monkeypatch.setattr(_compile, "CapturedStep", no_memory)
    got = [trunk(x) for _ in range(3)]  # eager, the capture fails after the warm-up, eager
    assert all(torch.equal(g, trunk._features(x)) for g in got)
    assert trunk.captured.graphs == {} and len(trunk.captured.eager) == 1 and trunk.calls == 3


@pytest.mark.cuda
def test_a_changed_tf32_setting_is_a_new_signature_on_the_card():
    _card()
    trunk = _Doubler().to("cuda")
    x = torch.ones((2, 3, 4, 4), device="cuda")
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = flag
            trunk(x)
            trunk(x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert len(trunk.captured.graphs) == 2


@pytest.mark.cuda
def test_a_compiling_metric_holds_the_only_graph_of_its_trunk_on_the_card():
    _card()
    trunk = _Doubler().to("cuda")
    metric = PI.FrechetInceptionDistance(feature=trunk, device="cuda")
    for i in range(6):
        metric.update(torch.full((4, 3, 4, 4), float(i), device="cuda"), real=bool(i % 2))
    assert metric._auto_disabled_reason is None and len(metric._auto_update_fn) == 2
    assert trunk.captured.graphs == {} and trunk.captured.seen == set()


def test_a_metric_on_cuda_without_an_index_takes_the_current_card(monkeypatch):
    """``device="cuda"`` resolves to the current card's index, as a batch's device has one (else no step compiles)."""
    from torchmetrics_tpu_torch.metric import _resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert _resolve_device("cuda") == torch.device("cuda", 3)
    assert _resolve_device(torch.device("cuda")) == torch.device("cuda", 3)
    assert _resolve_device("cuda:1") == torch.device("cuda", 1)
    assert _resolve_device("cpu") == torch.device("cpu")


def test_the_signature_holds_the_tf32_settings():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        keys = set()
        for matmul, conv in ((False, False), (True, False), (False, True)):
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, conv
            keys.add(_compile._numerics())
        assert len(keys) == 3
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert _compile._numerics() == _compile._numerics()


def test_trunks_inline_nests_and_restores():
    depth = lambda: getattr(_compile._GRAPH_WORK, "inline", 0)  # noqa: E731
    with _compile.trunks_inline(False):
        assert depth() == 0
        with _compile.trunks_inline():
            with _compile.trunks_inline(True):
                assert depth() == 2
            assert depth() == 1
    assert depth() == 0
    with pytest.raises(ValueError), _compile.trunks_inline():
        raise ValueError
    assert depth() == 0


def test_captured_forward_on_the_cpu_captures_nothing():
    before = _compile.stats()
    trunk = _Doubler()
    x = torch.arange(96, dtype=torch.float32).reshape(2, 3, 4, 4)
    out = trunk(x)
    assert torch.equal(out, trunk._features(x)) and trunk.calls == 1
    assert trunk(x).data_ptr() != out.data_ptr() and trunk.calls == 2  # a repeat runs eagerly too
    assert _compile.stats() == before and trunk.captured.graphs == {} and trunk.captured.pool is None
    assert trunk.captured.seen == set() and _compile.pool_bytes(trunk.captured.pool) == 0


def test_captured_forward_drops_its_graphs_on_a_move_and_in_a_copy():
    trunk = _Doubler()
    trunk.captured.graphs["sentinel"] = object()  # a graph reads the parameters' memory at capture time
    for clone in (copy.deepcopy(trunk), pickle.loads(pickle.dumps(trunk))):
        assert clone.captured.graphs == {} and torch.equal(clone.proj, trunk.proj)
    assert trunk.captured.graphs
    trunk.captured.constants["sentinel"] = torch.zeros(1)
    trunk.captured.seen.add("sentinel")
    trunk.captured.eager.add("sentinel")
    trunk.to(torch.float64)
    assert trunk.captured.graphs == {} and trunk.captured.constants == {} and trunk.proj.dtype == torch.float64
    assert trunk.captured.seen == set() and trunk.captured.eager == set()
    assert trunk.state_dict().keys() == {"proj"}  # the wrapper holds no state


def test_device_constant_on_the_cpu_is_as_tensor():
    store = {}
    with _compile._graph_work(store):
        got = device_constant(np.arange(3, dtype=np.float32), torch.device("cpu"))
    assert torch.equal(got, torch.arange(3, dtype=torch.float32)) and store == {}
    assert device_constant([1, 2], torch.device("cpu"), torch.int64).dtype == torch.int64
