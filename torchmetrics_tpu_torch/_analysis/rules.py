"""Rule catalog for the port's trace-safety and concurrency lint.

Each rule encodes one hazard class of this codebase: the compiled update
path for R1-R4 (a step captured into a CUDA graph and replayed, see
``_compile.py`` and ``metric.py``), and thread-safety of the serving
runtime for R7-R9. Rules keep the reference analyzer's stable short IDs,
which appear in violations, baseline entries and inline suppressions; the
eligibility rules (R5, R6) and the memory rules (R10, R11) are not part of
this catalog yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class Rule:
    """One entry of the rule catalog."""

    id: str
    name: str
    summary: str
    rationale: str


RULES: Dict[str, Rule] = {
    r.id: r
    for r in (
        Rule(
            id="R1",
            name="unregistered-state-mutation",
            summary="`self.<attr>` mutated inside `update`/`compute` without `add_state` registration",
            rationale=(
                "The compiled path captures `update()` into a CUDA graph whose buffers are the"
                " registered states; a replay re-runs the recorded kernels and nothing else, so a"
                " mutation of a plain attribute would be silently frozen at its capture-time value."
                " This is the static twin of the runtime `_host_attr_snapshot` fingerprint guard"
                " (`metric.py`), and classes proven clean here skip that guard entirely."
            ),
        ),
        Rule(
            id="R2",
            name="host-sync-leak",
            summary=(
                "`float()`/`int()`/`bool()`/`.item()`/`.tolist()`/`.cpu()`/`.numpy()`/`np.*`"
                " applied to tensor values in a compiled path"
            ),
            rationale=(
                "Reading a device value on the host blocks until the card has finished every"
                " queued kernel: eagerly that is one synchronization per call, and during a CUDA"
                " graph capture it either raises (a sync is not allowed while capturing) or, on"
                " the CPU route, bakes the value of the capture batch into every replay."
            ),
        ),
        Rule(
            id="R3",
            name="traced-control-flow",
            summary="python `if`/`while`/`assert` branching on a tensor value",
            rationale=(
                "`if preds.sum() > 0:` calls `Tensor.__bool__`, which copies the value to the"
                " host: it syncs the card on every eager call and breaks or freezes a capture"
                " (the replay keeps the branch the capture batch took). Data-dependent choices"
                " must stay on the device with `torch.where`."
            ),
        ),
        Rule(
            id="R4",
            name="recompile-hazard",
            summary=(
                "value-dependent output shapes (`torch.unique`, `torch.nonzero`, one-argument"
                " `torch.where`, `masked_select`, boolean-mask indexing) in compiled paths"
            ),
            rationale=(
                "An op whose output shape depends on the data must read a count back to the host"
                " before it can allocate its output: it syncs eagerly and cannot be captured into"
                " a CUDA graph, whose buffers have fixed shapes. Such ops are only allowed inside"
                " whitelisted eager helpers (`# lint: eager-helper`) that run on host by design."
            ),
        ),
        Rule(
            id="R7",
            name="unguarded-cross-thread-access",
            summary="shared mutable state accessed without (or with inconsistent) lock discipline",
            rationale=(
                "The serving runtime has real concurrency: watchdog workers, the off-thread"
                " snapshot writer, Prometheus scrapes against live registries, multi-tenant"
                " ingestion, fleet publishers. A container field reachable from more than one"
                " thread that is mutated at one site and iterated/mutated at another without one"
                " common lock is a 'dict changed size during iteration' / lost-update bug waiting"
                " for load."
            ),
        ),
        Rule(
            id="R8",
            name="blocking-call-under-lock",
            summary=(
                "blocking call (card synchronization, host copy, collective, store wait, build,"
                " file IO/fsync, Event.wait, sleep) while holding a lock"
            ),
            rationale=(
                "A lock held across a host-blocking call serializes every other thread behind"
                " the card, a collective, a store round-trip, a compiler run or the disk: the"
                " stall shape the guarded-sync watchdog exists to catch at runtime. Locks in"
                " this runtime guard host-side bookkeeping only; anything that can block must"
                " run outside the critical section."
            ),
        ),
        Rule(
            id="R9",
            name="lock-order-and-thread-lifecycle",
            summary="lock-acquisition-order cycles, or spawned threads with no join/daemon lifecycle",
            rationale=(
                "Two locks taken in opposite orders on two paths deadlock under load; a"
                " non-daemon thread that is started and never joined blocks interpreter exit,"
                " and an abandoned-by-design daemon worker must say so explicitly (baseline"
                " entry with a justification) so the abandonment is a decision, not an"
                " accident."
            ),
        ),
    )
}


def rule(rule_id: str) -> Rule:
    if rule_id not in RULES:
        raise KeyError(f"Unknown rule id {rule_id!r}; known: {sorted(RULES)}")
    return RULES[rule_id]
