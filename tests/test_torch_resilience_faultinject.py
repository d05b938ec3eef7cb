"""The port's fault injectors against the JAX package's, on the CPU.

From ``tests/unittests/resilience/test_faultinject.py``: the simulated world
and its transport seam, the failure and stall injectors, checkpoint
corruption and NaN poisoning, each run through both packages on the same
numpy inputs. Added for the port: poisoning and corruption stay on the
tensor's own device and dtype, and the seam's gathers route through
``process_allgather`` only while an override is active.
"""

import time

import numpy as np
import pytest
import torch

from tests.test_torch_resilience_integrity import JAX, PORT, both, host


def _gather(S, values):
    return S.dist.gather_all_tensors(S.arr(np.float32(values)))


def test_flips_distributed_available():
    for S in (JAX, PORT):
        assert not S.dist.distributed_available()
        with S.fi.simulated_world(2):
            assert S.dist.distributed_available() and S.dist.world_size() == 2
        assert not S.dist.distributed_available() and S.dist.world_size() == 1


def test_gather_returns_world_copies():
    def run(S):
        with S.fi.simulated_world(3):
            return [host(x).tolist() for x in _gather(S, [1.0, 2.0])]

    assert both(run) == ([[1.0, 2.0]] * 3, [[1.0, 2.0]] * 3)


def test_seams_restored_on_exit():
    for S in (JAX, PORT):
        before = (S.dist._world_override, S.dist._transport)
        with S.fi.simulated_world(2):
            pass
        assert (S.dist._world_override, S.dist._transport) == before


def test_custom_transport():
    def run(S):
        def doubler(x):
            # perturb only floating payloads: the shape pre-gather (int32) stays consistent
            arr = host(x)
            out = np.stack([arr, arr * (2 if np.issubdtype(arr.dtype, np.floating) else 1)])
            return out if S is JAX else torch.as_tensor(out)

        with S.fi.simulated_world(2, transport=doubler):
            return host(_gather(S, [1.0])[1]).tolist()

    assert both(run) == ([2.0], [2.0])


def test_invalid_size():
    for S in (JAX, PORT):
        with pytest.raises(ValueError, match="size must be >= 1"):
            with S.fi.simulated_world(0):
                pass


def test_failure_counts_and_recovers():
    def run(S):
        with S.fi.simulated_world(2), S.fi.inject_collective_failure(first_n=2) as stats:
            for _ in range(2):
                with pytest.raises(ConnectionError, match="injected collective failure"):
                    _gather(S, [1.0])
            out = _gather(S, [1.0])
        return len(out), stats.injected, stats.calls

    j, p = both(run)
    assert j == p and p[0] == 2 and p[1] == 2 and p[2] >= 3


def test_custom_exception_factory():
    for S in (JAX, PORT):
        with S.fi.simulated_world(2), S.fi.inject_collective_failure(first_n=1, exc_factory=lambda: OSError("link down")):
            with pytest.raises(OSError, match="link down"):
                _gather(S, [1.0])


def test_timeout_released_at_exit():
    for S in (JAX, PORT):
        start = time.perf_counter()
        with S.fi.simulated_world(2), S.fi.inject_collective_timeout(first_n=1, hang=0.1) as stats:
            with pytest.raises(TimeoutError, match="injected collective stall"):
                _gather(S, [1.0])
        assert stats.injected == 1 and time.perf_counter() - start < 5.0


def _sum_sd(S, integrity=False):
    m = S.DummySum(**S.eager)
    m.persistent(True)
    m.update(5.0)
    return m.state_dict(integrity=integrity)


def test_corruption_is_deterministic():
    def run(S):
        sd = _sum_sd(S, integrity=True)
        a = S.fi.corrupt_state_dict(sd, mode="bitflip", seed=3)
        b = S.fi.corrupt_state_dict(sd, mode="bitflip", seed=3)
        np.testing.assert_array_equal(host(a["x"]), host(b["x"]))
        assert not np.array_equal(host(a["x"]), host(sd["x"]))
        return host(a["x"]).tobytes()

    j, p = both(run)
    assert j == p  # the same byte flipped in both packages


def test_original_untouched():
    for S in (JAX, PORT):
        sd = _sum_sd(S)
        S.fi.corrupt_state_dict(sd, mode="nan")
        assert float(host(sd["x"])) == 5.0


def test_nan_mode_requires_float():
    for S in (JAX, PORT):
        with pytest.raises(ValueError, match="floating"):
            S.fi.corrupt_state_dict({"k": np.zeros(3, np.int32)}, key="k", mode="nan")


def test_unknown_mode():
    for S in (JAX, PORT):
        with pytest.raises(ValueError, match="unknown corruption mode"):
            S.fi.corrupt_state_dict({"k": np.zeros(3)}, mode="scramble")


def test_poison_nans_deterministic():
    def run(S):
        a = S.fi.poison_nans(S.arr(np.ones(8, np.float32)), frac=0.5)
        with pytest.raises(ValueError, match="floating"):
            S.fi.poison_nans(S.arr(np.ones(4, np.int32)))
        return np.isnan(host(a)).tolist()

    j, p = both(run)
    assert j == p and sum(p) == 4 and p[:4] == [True] * 4  # the first half, in C order


def test_nan_batches_restores_update():
    for S in (JAX, PORT):
        m = S.DummySum(**S.eager)
        orig = m.update
        with S.fi.nan_batches(m, indices=(0,)):
            assert m.update is not orig
        assert m.update is orig


# ------------------------------------------------------- added for the port
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.float16])
def test_poison_and_corrupt_keep_device_and_dtype(dtype):
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4).to(dtype)
    poisoned = PORT.fi.poison_nans(x.t(), frac=0.25)  # a transposed view: poisoned in C order of the view
    assert poisoned.dtype == dtype and poisoned.device == x.device and poisoned.shape == (4, 3)
    assert torch.isnan(poisoned.reshape(-1)[:3]).all() and not torch.isnan(poisoned.reshape(-1)[3:]).any()
    assert not torch.isnan(x).any()
    sd = {"s": x, "#integrity": {"version": 1}}
    for mode in ("bitflip", "nan"):
        bad = PORT.fi.corrupt_state_dict(sd, mode=mode)
        assert bad["s"].dtype == dtype and bad["s"].device == x.device and not torch.equal(bad["s"], x)
        assert torch.equal(sd["s"], x) and bad["#integrity"] is not sd["#integrity"]


def test_real_gathers_leave_the_transport_alone(monkeypatch):
    """Without an injector or a simulated world, no gather goes through ``process_allgather``."""
    calls = []
    monkeypatch.setattr(PORT.dist, "_default_transport", lambda x: calls.append(x) or x)
    x = torch.arange(3.0)
    assert PORT.dist.gather_all_tensors(x)[0] is x and not calls
    with PORT.fi.simulated_world(2):
        assert len(PORT.dist.gather_all_tensors(x)) == 2
    assert not calls  # the simulated world brings its own transport
