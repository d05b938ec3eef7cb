"""Fleet-scale chaos: composed faults against a 3-level in-process tree.

Port of ``torchmetrics_tpu/_fleet/chaos.py``; a ``compute()`` result is
flattened to host numpy by the port itself (``_tree_leaves_np``). The
serving chaos suite (``_serving/chaos.py``) proves one server's
degradation envelope; this suite proves the *aggregation tier's*: with
child kills/restarts, corrupt payloads, transient and exhausted KV
publish faults, stragglers past the fan-in deadline, and zombie replays
all composed against one edge -> region -> global tree, every fenced
epoch's global rollup must still equal the golden fold of exactly its
contributing children — no double-count, no corrupt fold, no stall.

Fault schedule is **deterministic by epoch** (not probabilistic): each
fault class fires at a known epoch against a known victim, so the
expected degradation ledger — and the flight-recorder dump set, exactly
one per fault event — is computable in the test, not eyeballed. Row
payloads are pre-drawn from one seeded ``numpy`` Generator, and the
harness tracks every row it feeds per ``(leaf, epoch)``; golden equality
is checked per epoch by replaying exactly ``root.folded_sources`` into a
fresh metric sequentially (the flat ``merge_state``-free fold the tree
must agree with).

Invariants asserted (mirrors ``FleetChaosResult.ok``):

1. **Golden equality per fenced epoch** — tree rollup == sequential
   replay of its contributing sources, every epoch, byte-tolerance.
2. **Exactly-once fold** — zombie replays and redeliveries are dropped
   (``duplicates_dropped`` > 0 proves the fence was exercised).
3. **Quarantine, don't poison** — the corrupted payload never folds; its
   sources are the only ones missing from the final rollup besides rows
   never published.
4. **Degrade, don't await** — rollups complete within the deadline with
   missing children recorded; stragglers fold late, bounded staleness.
5. **One flight dump per fault event** — dump count per ``fleet_*``
   degradation kind equals the degradation event count of that kind.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch._fleet.node import Rollup
from torchmetrics_tpu_torch._fleet.transport import InProcessKV, contribution_prefix
from torchmetrics_tpu_torch._fleet.tree import FleetTree
from torchmetrics_tpu_torch._fleet.wire import decode_contribution
from torchmetrics_tpu_torch._observability.events import BUS as _BUS
from torchmetrics_tpu_torch._observability.flight import (
    arm_flight_recorder,
    disarm_flight_recorder,
)
from torchmetrics_tpu_torch._observability.state import OBS as _OBS
from torchmetrics_tpu_torch._observability.state import set_telemetry_enabled
from torchmetrics_tpu_torch._resilience.policy import RetryPolicy

__all__ = ["FleetChaosSpec", "FleetChaosResult", "run_fleet_chaos"]

_FLEET_KINDS = ("fleet_partial", "fleet_corrupt", "fleet_publish_degraded")


@dataclass(frozen=True)
class FleetChaosSpec:
    """Deterministic fault schedule for one chaos run."""

    epochs: int = 10
    branching: Tuple[int, ...] = (4, 4)  # 3 levels: global -> 4 regions -> 16 edges
    rows_per_epoch: int = 3
    deadline_s: float = 0.25  # per-level fan-in deadline
    epoch_window: int = 4
    seed: int = 1234
    # fault schedule: epoch index per fault class (None disables the fault)
    kill_epoch: Optional[int] = 1  # victim leaf down (restarts next epoch)
    zombie_capture_epoch: int = 2  # clean epoch whose payload gets replayed
    corrupt_epoch: Optional[int] = 3  # victim payload bit-flipped in the KV
    publish_fail_epoch: Optional[int] = 5  # victim's retries exhausted
    transient_fault_epoch: Optional[int] = 6  # single fault; retry recovers
    straggler_epoch: Optional[int] = 7  # victim publish stalls past deadline
    zombie_epoch: Optional[int] = 8  # captured payload replayed (fence test)
    stall_s: float = 0.0  # 0 -> 4x the deadline
    drain_epochs: int = 2  # extra clean epochs to fold late arrivals
    staleness_budget_ms: float = 60_000.0
    wallclock_budget_s: float = 120.0
    flight_dir: Optional[str] = None  # armed recorder's dump directory
    rtol: float = 1e-5
    atol: float = 1e-6

    def __post_init__(self) -> None:
        if self.epochs < 1:
            raise ValueError(f"epochs must be >= 1, got {self.epochs}")
        if len(self.branching) < 2:
            raise ValueError("fleet chaos needs >= 3 tree levels (branching of >= 2 fan-outs)")
        if self.rows_per_epoch < 1:
            raise ValueError(f"rows_per_epoch must be >= 1, got {self.rows_per_epoch}")
        if self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive, got {self.deadline_s}")
        for name in ("kill_epoch", "corrupt_epoch", "publish_fail_epoch",
                     "transient_fault_epoch", "straggler_epoch", "zombie_epoch"):
            e = getattr(self, name)
            if e is not None and not (0 <= e < self.epochs):
                raise ValueError(f"{name}={e} outside [0, {self.epochs})")
        if self.zombie_epoch is not None and not (
            0 <= self.zombie_capture_epoch < self.zombie_epoch
        ):
            raise ValueError("zombie_capture_epoch must precede zombie_epoch")

    @property
    def effective_stall_s(self) -> float:
        return self.stall_s if self.stall_s > 0 else 4.0 * self.deadline_s


@dataclass
class FleetChaosResult:
    """What one chaos run observed; ``ok`` is the acceptance verdict."""

    epochs_run: int = 0
    leaves: int = 0
    rows_fed: int = 0
    rollups: List[Rollup] = field(default_factory=list)
    partial_rollups: int = 0
    duplicates_dropped: int = 0
    corrupt_quarantined: int = 0
    late_folds: int = 0
    transient_recovered: int = 0
    publish_degraded: int = 0
    ttl_reaped: int = 0
    max_staleness_ms: float = 0.0
    golden_checks: int = 0
    golden_equal: bool = True
    lost_sources: Set[Tuple[str, int]] = field(default_factory=set)
    events_by_kind: Dict[str, int] = field(default_factory=dict)
    dumps_by_kind: Dict[str, int] = field(default_factory=dict)
    fault_events: int = 0  # chaos_fault bus publishes
    elapsed_s: float = 0.0
    within_budget: bool = True
    failures: List[str] = field(default_factory=list)

    @property
    def dumps_match_events(self) -> bool:
        return all(
            self.dumps_by_kind.get(kind, 0) == count
            for kind, count in self.events_by_kind.items()
        )

    @property
    def ok(self) -> bool:
        return not self.failures and self.golden_equal and self.within_budget

    def describe(self) -> str:
        verdict = "OK" if self.ok else "FAILED"
        return (
            f"fleet-chaos[{verdict}] epochs={self.epochs_run} leaves={self.leaves} "
            f"rows={self.rows_fed} partial={self.partial_rollups} "
            f"dup_dropped={self.duplicates_dropped} corrupt={self.corrupt_quarantined} "
            f"late={self.late_folds} staleness_max={self.max_staleness_ms:.1f}ms "
            f"golden={'equal' if self.golden_equal else 'DIVERGED'} "
            f"dumps={dict(sorted(self.dumps_by_kind.items()))} "
            f"elapsed={self.elapsed_s:.2f}s"
            + (f" failures={self.failures}" if self.failures else "")
        )


def _tree_leaves_np(value: Any) -> List[np.ndarray]:
    """A ``compute()`` result's leaves as host arrays: a tensor, or a dict (by sorted key), tuple or list of them.

    The JAX package flattens with ``jax.tree_util.tree_leaves``, which orders
    a dict's leaves by key too.
    """
    if isinstance(value, dict):
        return [leaf for key in sorted(value) for leaf in _tree_leaves_np(value[key])]
    if isinstance(value, (tuple, list)):
        return [leaf for item in value for leaf in _tree_leaves_np(item)]
    if value is None:
        return []
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.dtype == torch.bfloat16:
            value = value.float()
        return [value.cpu().numpy()]
    return [np.asarray(value)]


def _fleet_event_counts(tree: FleetTree) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for node in tree.nodes.values():
        for ev in node.metric.resilience_report().events:
            if ev.kind.startswith("fleet_"):
                counts[ev.kind] = counts.get(ev.kind, 0) + 1
    return counts


def run_fleet_chaos(
    template: Any,
    make_update: Callable[[np.random.Generator], Tuple[Any, ...]],
    spec: Optional[FleetChaosSpec] = None,
) -> FleetChaosResult:
    """Run the composed fault schedule against a fresh tree; never raises
    for chaos-detected divergence (inspect ``result.failures``).

    ``make_update(rng)`` returns one positional-args tuple for
    ``template.update``. Telemetry is force-enabled for the duration (the
    degradation bus and flight recorder are part of what is under test)
    and restored afterwards; any previously-armed flight recorder is
    replaced by this run's.
    """
    spec = spec if spec is not None else FleetChaosSpec()
    result = FleetChaosResult()
    rng = np.random.default_rng(spec.seed)
    t_start = time.perf_counter()

    prev_enabled = _OBS.enabled
    set_telemetry_enabled(True)
    recorder = arm_flight_recorder(spec.flight_dir)
    kv = InProcessKV(ttl_s=3600.0)
    retry = RetryPolicy(max_retries=2, backoff_base=0.01, backoff_factor=2.0, backoff_max=0.05)
    tree = FleetTree.build(
        template,
        spec.branching,
        kv=kv,
        namespace="chaos",
        deadline_s=spec.deadline_s,
        retry=retry,
        epoch_window=spec.epoch_window,
    )
    leaves = tree.leaves
    result.leaves = len(leaves)
    victim = leaves[0]
    victim_region = victim.region

    # pre-draw every row up front: the schedule perturbs WHICH rows flow,
    # never their values, so two runs with one seed feed identical data
    rows: Dict[Tuple[str, int], List[Tuple[Any, ...]]] = {
        (leaf.node_id, e): [make_update(rng) for _ in range(spec.rows_per_epoch)]
        for e in range(spec.epochs)
        for leaf in leaves
    }
    fed: Set[Tuple[str, int]] = set()
    # two zombies probe two fences: the RECENT one (inside the sweep window)
    # must be dropped by the fold ledger; the STALE one (below the watermark)
    # is never even swept and must be reaped by the TTL janitor instead
    stale_zombie: Optional[Tuple[str, bytes]] = None
    recent_zombie: Optional[Tuple[str, bytes]] = None
    recent_capture_epoch = (
        max(spec.zombie_epoch - 2, 0) if spec.zombie_epoch is not None else None
    )
    stale_zombie_key: Optional[str] = None

    def _golden_check(epoch: int) -> None:
        """Root accumulator vs sequential replay of exactly its sources."""
        sources = set(tree.root.folded_sources)
        if not sources or tree.root.sources_truncated:
            return
        golden = template.clone()
        golden.reset()
        for src in sorted(sources):
            for args in rows.get(src, ()):
                golden.update(*args)
        result.golden_checks += 1
        got = _tree_leaves_np(tree.root.metric.compute())
        want = _tree_leaves_np(golden.compute())
        same = len(got) == len(want) and all(
            g.shape == w.shape and np.allclose(g, w, rtol=spec.rtol, atol=spec.atol)
            for g, w in zip(got, want)
        )
        if not same:
            result.golden_equal = False
            result.failures.append(
                f"epoch {epoch}: rollup diverged from golden fold of {len(sources)} sources"
            )

    try:
        for epoch in range(spec.epochs):
            dead: Set[str] = set()
            if spec.kill_epoch == epoch:
                dead.add(victim.node_id)
                _BUS.publish(
                    "chaos_fault", "FleetTree",
                    f"leaf kill: {victim.node_id} down for epoch {epoch}",
                    data={"seam": "fleet.publish", "fault": "leaf_kill", "epoch": epoch},
                )
                result.fault_events += 1

            # feed this epoch's rows to every live leaf
            for leaf in leaves:
                if leaf.node_id in dead:
                    continue  # a killed edge serves no traffic
                for args in rows[(leaf.node_id, epoch)]:
                    leaf.update(*args)
                    result.rows_fed += 1
                fed.add((leaf.node_id, epoch))

            # --- targeted publish faults fire against the victim FIRST,
            # synchronously, so the global fault injectors cannot leak onto
            # an unrelated concurrent publisher
            if spec.publish_fail_epoch == epoch:
                kv.fail_publishes(retry.attempts)
                assert not victim.publish(epoch)  # retries exhausted -> degraded
                result.publish_degraded += 1
                dead.add(victim.node_id)  # delta retained; no second publish
                _BUS.publish(
                    "chaos_fault", "FleetTree",
                    f"publish retries exhausted for {victim.node_id} at epoch {epoch}",
                    data={"seam": "fleet.publish", "fault": "publish_exhausted", "epoch": epoch},
                )
                result.fault_events += 1
            elif spec.transient_fault_epoch == epoch:
                kv.fail_publishes(1)
                if victim.publish(epoch):
                    result.transient_recovered += 1
                else:  # pragma: no cover - retry policy must absorb one fault
                    result.failures.append(f"epoch {epoch}: transient fault not absorbed by retry")
                dead.add(victim.node_id)
                result.fault_events += 1
                _BUS.publish(
                    "chaos_fault", "FleetTree",
                    f"transient KV fault absorbed by retry ({victim.node_id}, epoch {epoch})",
                    data={"seam": "fleet.publish", "fault": "kv_transient", "epoch": epoch},
                )
            elif spec.straggler_epoch == epoch:
                kv.stall_publishes(1, spec.effective_stall_s)
                victim.publish_async(epoch)  # grabs the armed stall
                dead.add(victim.node_id)  # skip the normal publish path
                _BUS.publish(
                    "chaos_fault", "FleetTree",
                    f"straggler: {victim.node_id} publish stalled "
                    f"{spec.effective_stall_s:.2f}s past the {spec.deadline_s:.2f}s deadline",
                    data={"seam": "fleet.rollup", "fault": "straggler", "epoch": epoch},
                )
                result.fault_events += 1

            # remaining leaves publish asynchronously (the production shape)
            for leaf in leaves:
                if leaf.node_id not in dead:
                    leaf.publish_async(epoch)

            # wait for the expected contributions to land (stalled/killed
            # victims excluded), then inject the on-the-wire faults
            live = [lf.node_id for lf in leaves if lf.node_id not in dead]
            kv.wait_until(
                lambda snap: all(
                    any(k.startswith(contribution_prefix("chaos", lid, epoch)) for k in snap)
                    for lid in live
                ),
                spec.deadline_s,
            )
            if spec.corrupt_epoch == epoch:
                prefix = contribution_prefix("chaos", victim.node_id, epoch)
                for key, blob in sorted(kv.scan(prefix).items()):
                    result.lost_sources.update(decode_contribution(blob).sources)
                    flipped = bytearray(blob)
                    flipped[-1] ^= 0xFF  # payload bit-flip: outer checksum must catch it
                    kv.set(key, bytes(flipped))
                    _BUS.publish(
                        "chaos_fault", "FleetTree",
                        f"payload corruption on the wire: {key}",
                        data={"seam": "fleet.fold", "fault": "corrupt_payload", "epoch": epoch},
                    )
                    result.fault_events += 1
                    break
            if spec.zombie_epoch is not None and epoch in (
                spec.zombie_capture_epoch,
                recent_capture_epoch,
            ):
                prefix = contribution_prefix("chaos", leaves[1].node_id, epoch)
                for key, blob in sorted(kv.scan(prefix).items()):
                    if epoch == spec.zombie_capture_epoch:
                        stale_zombie = (key, blob)
                    if epoch == recent_capture_epoch:
                        recent_zombie = (key, blob)
                    break
            if spec.zombie_epoch == epoch:
                for payload in (stale_zombie, recent_zombie):
                    if payload is None:
                        continue
                    key, blob = payload
                    kv.set(key, blob)  # at-least-once redelivery of a folded epoch
                    if payload is stale_zombie and spec.zombie_capture_epoch <= (
                        epoch - spec.epoch_window
                    ):
                        stale_zombie_key = key  # below the fence window: TTL's problem
                    _BUS.publish(
                        "chaos_fault", "FleetTree",
                        f"zombie replay of folded contribution {key}",
                        data={"seam": "fleet.fold", "fault": "zombie_replay", "epoch": epoch},
                    )
                    result.fault_events += 1

            # interior levels roll up bottom-up, then the root
            for level in reversed(tree.levels[1:-1]):
                for node in level:
                    rollup = node.rollup(epoch)
                    result.duplicates_dropped += rollup.duplicates_dropped
                    result.corrupt_quarantined += rollup.corrupt_quarantined
                    result.late_folds += rollup.late_arrivals
                    if rollup.partial:
                        result.partial_rollups += 1
                        if node.region != victim_region:
                            result.failures.append(
                                f"epoch {epoch}: unexpected partial rollup at {node.node_id}"
                            )
                    node.publish_async(epoch)
            root_rollup = tree.root.rollup(epoch)
            result.rollups.append(root_rollup)
            result.duplicates_dropped += root_rollup.duplicates_dropped
            result.corrupt_quarantined += root_rollup.corrupt_quarantined
            result.late_folds += root_rollup.late_arrivals
            if root_rollup.partial:
                result.partial_rollups += 1
            result.max_staleness_ms = max(result.max_staleness_ms, root_rollup.staleness_ms)
            result.epochs_run += 1
            _golden_check(epoch)

        # drain: land every in-flight publish, then clean epochs fold the
        # late arrivals (straggler + retained deltas) into the rollup
        tree.join_pending(timeout=2.0 * spec.effective_stall_s + 5.0)
        for extra in range(spec.drain_epochs):
            epoch = spec.epochs + extra
            for leaf in leaves:
                leaf.publish_async(epoch)
            for level in reversed(tree.levels[1:-1]):
                for node in level:
                    rollup = node.rollup(epoch)
                    result.duplicates_dropped += rollup.duplicates_dropped
                    result.late_folds += rollup.late_arrivals
                    node.publish_async(epoch)
            root_rollup = tree.root.rollup(epoch)
            result.rollups.append(root_rollup)
            result.late_folds += root_rollup.late_arrivals
            result.epochs_run += 1
            _golden_check(epoch)
        tree.join_pending(timeout=5.0)

        # the stale zombie (below every fence window) is the janitor's:
        # nothing sweeps its epoch anymore, TTL cleanup must reap it
        if stale_zombie_key is not None and kv.get(stale_zombie_key) is not None:
            reaped = kv.janitor.sweep(kv.delete, now=time.monotonic() + 7200.0)
            result.ttl_reaped = len(reaped)
            if stale_zombie_key not in reaped:
                result.failures.append("stale zombie contribution survived the TTL sweep")

        # every fed-and-published source must fold eventually, except the
        # quarantined payload's (data loss by design) and the killed epoch's
        expected = {
            src for src in fed if src not in result.lost_sources
        }
        folded = set(tree.root.folded_sources)
        missing = expected - folded
        if missing:
            result.failures.append(
                f"{len(missing)} published source(s) never folded: {sorted(missing)[:4]}..."
            )
        extra_folded = folded - expected
        if extra_folded:
            result.failures.append(
                f"rollup folded {len(extra_folded)} unexpected source(s) "
                f"(double count or quarantine leak): {sorted(extra_folded)[:4]}"
            )

        result.events_by_kind = _fleet_event_counts(tree)
        for dump in recorder.dumps():
            trig = dump.get("trigger", {})
            if trig.get("kind") == "degradation":
                kind = str(trig.get("data", {}).get("kind", ""))
                if kind.startswith("fleet_"):
                    result.dumps_by_kind[kind] = result.dumps_by_kind.get(kind, 0) + 1
        if not result.dumps_match_events:
            result.failures.append(
                f"flight dumps {result.dumps_by_kind} != degradation events {result.events_by_kind}"
            )
        if spec.zombie_epoch is not None and result.duplicates_dropped < 1:
            result.failures.append(
                "zombie replay within the fence window was not dropped as a duplicate"
            )
        if result.max_staleness_ms > spec.staleness_budget_ms:
            result.failures.append(
                f"rollup staleness {result.max_staleness_ms:.0f}ms exceeded the "
                f"{spec.staleness_budget_ms:.0f}ms budget"
            )
    finally:
        disarm_flight_recorder()
        set_telemetry_enabled(prev_enabled)

    result.elapsed_s = time.perf_counter() - t_start
    result.within_budget = result.elapsed_s <= spec.wallclock_budget_s
    if not result.within_budget:
        result.failures.append(
            f"chaos run took {result.elapsed_s:.1f}s > {spec.wallclock_budget_s:.1f}s budget"
        )
    return result
