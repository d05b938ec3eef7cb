"""The port's lint rules R1-R4 and R7-R9 over the seeded fixtures, held to the JAX package's analyzer.

Each ``viol_*`` fixture in ``tests/torch_analysis_fixtures/`` plants known
violations at known lines; each ``clean_*`` twin exercises the same code
shapes in their capture-safe (or lock-disciplined) form and must stay
silent. The fixtures are torch twins of the JAX package's
(``tests/unittests/analysis/fixtures/``), line for line, so both analyzers
must report the same ``(rule, line)`` sets.
"""

from pathlib import Path

import pytest

from torchmetrics_tpu._analysis import analyze_paths as jax_analyze_paths
from torchmetrics_tpu_torch._analysis import RULES, analyze_paths, analyze_source

FIXTURES = Path(__file__).parent / "torch_analysis_fixtures"
JAX_FIXTURES = Path(__file__).parent / "unittests" / "analysis" / "fixtures"

EXPECTED = {
    "viol_r1.py": [("R1", 17), ("R1", 18), ("R1", 22)],
    "viol_r2.py": [("R2", 19), ("R2", 20), ("R2", 24)],
    "viol_r3.py": [("R3", 14), ("R3", 16), ("R3", 19)],
    "viol_r4.py": [("R4", 14), ("R4", 15), ("R4", 16)],
    # note() rmw, top() iterate, HalfGuarded.close inconsistent iterate, _enqueue module-global rmw
    "viol_r7.py": [("R7", 13), ("R7", 16), ("R7", 34), ("R7", 41)],
    # sleep + fsync under the lock, Event.wait under the lock, a card synchronization under a module lock
    "viol_r8.py": [("R8", 16), ("R8", 17), ("R8", 21), ("R8", 31)],
    # B->A closes the A->B cycle, non-daemon never joined, abandoned daemon
    "viol_r9.py": [("R9", 17), ("R9", 23), ("R9", 27)],
}
CLEAN = sorted(f"clean_r{n}.py" for n in (1, 2, 3, 4, 7, 8, 9))

_HEADER = (
    "import torch\n"
    "from torchmetrics_tpu_torch.metric import Metric\n"
    "class M(Metric):\n"
    "    def __init__(self, **kw):\n"
    "        super().__init__(**kw)\n"
    "        self.add_state('total', default=torch.tensor(0.0), dist_reduce_fx='sum')\n"
)


def _rule_lines(result):
    return [(v.rule, v.line) for v in result.violations]


@pytest.mark.parametrize("fixture", sorted(EXPECTED))
def test_true_positives_fire_with_exact_lines(fixture):
    result = analyze_paths([str(FIXTURES / fixture)])
    assert not result.parse_errors
    assert _rule_lines(result) == EXPECTED[fixture]


@pytest.mark.parametrize("fixture", CLEAN)
def test_clean_twins_stay_silent(fixture):
    result = analyze_paths([str(FIXTURES / fixture)])
    assert not result.parse_errors
    assert result.violations == []


@pytest.mark.parametrize("fixture", sorted(EXPECTED) + CLEAN)
def test_each_fixture_gives_the_jax_analyzers_rule_lines(fixture):
    """The torch twin and the JAX fixture give the same ``(rule, line)`` set."""
    got = set(_rule_lines(analyze_paths([str(FIXTURES / fixture)])))
    want = set(_rule_lines(jax_analyze_paths([str(JAX_FIXTURES / fixture)])))
    assert got == want


def test_every_rule_fires_on_its_fixture():
    fired = set()
    for rule_id in RULES:
        fired |= {v.rule for v in analyze_paths([str(FIXTURES / f"viol_{rule_id.lower()}.py")]).violations}
    assert fired == set(RULES) == {"R1", "R2", "R3", "R4", "R7", "R8", "R9"}


def test_functional_kernel_scope_is_scanned():
    # analyze_source treats every `*_update`/`*_compute`-named module function
    # as a compiled kernel; the seeded float() in viol_r2's kernel must fire
    result = analyze_source((FIXTURES / "viol_r2.py").read_text(), path="viol_r2.py")
    assert [(v.rule, v.line) for v in result.violations if v.scope == "_bad_kernel_update"] == [("R2", 28)]


def test_clean_r1_twin_is_certified():
    assert analyze_paths([str(FIXTURES / "clean_r1.py")]).certified == ["clean_r1.GoodRegisteredState"]


def test_r1_violation_blocks_certification():
    assert analyze_paths([str(FIXTURES / "viol_r1.py")]).certified == []


def test_inline_lint_ok_suppresses_only_named_rule():
    src = _HEADER + (
        "    def update(self, preds) -> None:\n"
        "        a = float(preds.sum())  # lint-ok: R2 measured host fold\n"
        "        b = float(preds.min())  # lint-ok: R3 wrong rule id does not suppress R2\n"
        "        self.total = self.total + a + b\n"
        "    def compute(self):\n"
        "        return self.total\n"
    )
    assert _rule_lines(analyze_source(src, path="inline.py")) == [("R2", 9)]


def test_inline_lint_ok_multi_rule_with_reason():
    # `# lint-ok: R2, R4 reason` must suppress BOTH rules, reason and all
    src = _HEADER + (
        "    def update(self, preds) -> None:\n"
        "        k = float(torch.unique(preds).sum())  # lint-ok: R2, R4 host bucketing, reviewed\n"
        "        self.total = self.total + k\n"
        "    def compute(self):\n"
        "        return self.total\n"
    )
    assert analyze_source(src, path="multi.py").violations == []


def test_getattr_mutation_blocks_certification():
    # a dynamically-addressed mutation can't be proven state-safe: the class
    # must keep the runtime fingerprint guard (stay un-certified)
    src = _HEADER + (
        "    def _stash(self, v):\n"
        "        getattr(self, 'bucket_' + str(int(v.ndim))).append(v)\n"
        "    def update(self, preds) -> None:\n"
        "        self.total = self.total + preds.sum()\n"
        "    def compute(self):\n"
        "        return self.total\n"
    )
    assert analyze_source(src, path="dyn.py").certified == []


def test_eager_helper_marker_disables_compiled_path_rules():
    src = _HEADER + (
        "    def update(self, preds) -> None:  # lint: eager-helper\n"
        "        self.total = self.total + float(preds.sum())\n"
        "    def compute(self):\n"
        "        return self.total\n"
    )
    assert analyze_source(src, path="marker.py").violations == []


def test_inherited_states_resolve_across_classes():
    # a subclass mutating state registered by its base must NOT flag R1
    src = _HEADER + (
        "    def update(self, preds) -> None:\n"
        "        self.total = self.total + preds.sum()\n"
        "    def compute(self):\n"
        "        return self.total\n"
        "class Child(M):\n"
        "    def update(self, preds) -> None:\n"
        "        self.total = self.total + 2 * preds.sum()\n"
    )
    result = analyze_source(src, path="inherit.py")
    assert result.violations == []
    assert sorted(result.certified) == ["inherit.Child", "inherit.M"]


@pytest.mark.parametrize(
    "line, rule",
    [
        ("n = preds.sum().item()", "R2"),
        ("n = preds.tolist()", "R2"),
        ("n = preds.cpu()", "R2"),
        ("n = preds.numpy()", "R2"),
        ("n = bool(preds.any())", "R2"),
        ("n = preds.nonzero()", "R4"),
        ("n = torch.argwhere(preds)", "R4"),
        ("n = torch.masked_select(preds, preds > 0)", "R4"),
        ("n = preds.unique_consecutive()", "R4"),
        ("n = torch.repeat_interleave(preds, preds.long())", "R4"),
        ("n = preds.repeat_interleave(preds.long())", "R4"),
        ("n = torch.where(preds > 0)", "R4"),
    ],
)
def test_torch_host_reads_and_data_dependent_shapes_fire(line, rule):
    src = _HEADER + f"    def update(self, preds) -> None:\n        {line}\n        self.total = self.total + 1\n"
    assert [v.rule for v in analyze_source(src, path="torch_ops.py").violations] == [rule]


@pytest.mark.parametrize(
    "line",
    [
        "n = preds.size(0) + preds.numel() + preds.dim()",  # torch's metadata calls never touch the card
        "n = int(preds.shape[0]) + int(preds.size(0))",
        "n = torch.repeat_interleave(preds, 2)",  # an int repeat is static
        "n = torch.repeat_interleave(preds, preds.long(), output_size=8)",  # a static output size
        "n = torch.where(preds > 0, preds, 0.0)",
        "n = preds.to(torch.float32).sum()",
    ],
)
def test_torch_metadata_and_static_shapes_stay_silent(line):
    src = _HEADER + f"    def update(self, preds) -> None:\n        {line}\n        self.total = self.total + 1\n"
    assert analyze_source(src, path="torch_ok.py").violations == []


@pytest.mark.parametrize(
    "line",
    [
        "torch.cuda.synchronize()",
        "self._event.synchronize()",
        "self._stats['x'] = self._x.item()",
        "dist.all_reduce(self._x)",
        "torch.distributed.barrier()",
        "self._store.get('key')",
        "subprocess.run(['nvcc', '--version'])",
    ],
)
def test_r8_knows_the_ports_blocking_calls(line):
    src = (
        "import subprocess\n"
        "import threading\n"
        "import torch\n"
        "import torch.distributed as dist\n"
        "class Holder:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def work(self):\n"
        "        with self._lock:\n"
        f"            {line}\n"
    )
    assert _rule_lines(analyze_source(src, path="blocking.py")) == [("R8", 10)]


def test_r8_leaves_dict_get_and_string_join_alone():
    src = (
        "import threading\n"
        "class Holder:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._table = {}\n"
        "    def work(self):\n"
        "        with self._lock:\n"
        "            return ', '.join(self._table.get('k', ()))\n"
    )
    assert analyze_source(src, path="quiet.py").violations == []


def test_a_lock_from_the_reentrant_factory_is_a_lock_to_r8():
    """``new_rlock`` (the AOT cache's resolution lock) opens a critical section as ``new_lock`` does."""
    src = (
        "import time\n"
        "from torchmetrics_tpu_torch._analysis.locksan import new_rlock as _san_rlock\n"
        "RESOLVE_LOCK = _san_rlock('aot.RESOLVE_LOCK')\n"
        "def resolve():\n"
        "    with RESOLVE_LOCK:\n"
        "        time.sleep(0.1)\n"
    )
    assert _rule_lines(analyze_source(src, path="rlock.py")) == [("R8", 6)]
