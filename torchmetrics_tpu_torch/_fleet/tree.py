"""Fleet tree construction + epoch loop: edge -> region -> global in one object.

Port of ``torchmetrics_tpu/_fleet/tree.py``. :meth:`FleetTree.build` wires an
N-level tree of :class:`~torchmetrics_tpu_torch._fleet.node.AggregationNode`
over one shared KV transport: ``branching=(8, 8)`` is the canonical 3-level
shape (one global root, 8 regions, 64 edge leaves). Node ids double as KV key
components (``global``, ``region-03``, ``edge-03-07``), and every node below
the root carries its level-1 ancestor as its ``region=`` telemetry label.
Every node's metrics live on the template's device.

:meth:`FleetTree.run_epoch` drives one fenced epoch through the tree in
fan-in order: leaves publish **asynchronously** (a stalled edge blocks its
own daemon thread, never the caller), then each interior level rolls up
under its fan-in deadline and forwards its delta, then the root rolls up.
``skip`` models dead nodes: a skipped node neither publishes nor rolls up,
which is exactly what its parent's deadline-degrade path is for.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from torchmetrics_tpu_torch._fleet.node import AggregationNode, Rollup
from torchmetrics_tpu_torch._fleet.observe import RegionLabeler
from torchmetrics_tpu_torch._fleet.transport import InProcessKV
from torchmetrics_tpu_torch._resilience.policy import RetryPolicy

__all__ = ["FleetTree"]


class FleetTree:
    """An assembled aggregation tree: ``levels[0]`` is ``[root]``, ``levels[-1]`` the leaves."""

    def __init__(self, levels: List[List[AggregationNode]], kv: Any, namespace: str) -> None:
        if not levels or len(levels[0]) != 1:
            raise ValueError("FleetTree needs levels with exactly one root")
        self.levels = levels
        self.kv = kv
        self.namespace = namespace
        self.nodes: Dict[str, AggregationNode] = {n.node_id: n for level in levels for n in level}

    @property
    def root(self) -> AggregationNode:
        return self.levels[0][0]

    @property
    def leaves(self) -> List[AggregationNode]:
        return self.levels[-1]

    @classmethod
    def build(
        cls,
        template: Any,
        branching: Sequence[int] = (8, 8),
        *,
        kv: Optional[Any] = None,
        namespace: str = "default",
        deadline_s: float = 2.0,
        retry: Optional[RetryPolicy] = None,
        epoch_window: int = 4,
        labeler: Optional[RegionLabeler] = None,
    ) -> "FleetTree":
        """Build an ``len(branching)+1``-level tree with the given fan-outs."""
        if not branching or any(int(b) < 1 for b in branching):
            raise ValueError(f"branching must be non-empty positive fan-outs, got {branching!r}")
        kv = kv if kv is not None else InProcessKV()
        labeler = labeler if labeler is not None else RegionLabeler()

        # ids first, top-down: a parent's ctor needs its children's names
        id_levels: List[List[Tuple[str, str]]] = [[("global", "global")]]  # (node_id, region)
        for depth, fan in enumerate(branching):
            nxt: List[Tuple[str, str]] = []
            for parent_id, parent_region in id_levels[-1]:
                for i in range(int(fan)):
                    if depth == 0:
                        nid = f"region-{i:02d}"
                        region = nid
                    else:
                        suffix = parent_id.split("-", 1)[1] if "-" in parent_id else parent_id
                        nid = f"{'edge' if depth == len(branching) - 1 else 'zone'}-{suffix}-{i:02d}"
                        region = parent_region
                    nxt.append((nid, region))
            id_levels.append(nxt)

        children_of: Dict[str, List[str]] = {}
        for depth in range(len(id_levels) - 1):
            fan = int(branching[depth])
            parents = id_levels[depth]
            kids = id_levels[depth + 1]
            for p_idx, (parent_id, _) in enumerate(parents):
                children_of[parent_id] = [nid for nid, _ in kids[p_idx * fan:(p_idx + 1) * fan]]

        levels: List[List[AggregationNode]] = []
        for level_ids in id_levels:
            levels.append([
                AggregationNode(
                    nid,
                    template,
                    kv,
                    children=children_of.get(nid, ()),
                    namespace=namespace,
                    region=region,
                    deadline_s=deadline_s,
                    retry=retry,
                    epoch_window=epoch_window,
                    labeler=labeler,
                )
                for nid, region in level_ids
            ])
        return cls(levels, kv, namespace)

    # ------------------------------------------------------------------ drive
    def run_epoch(self, epoch: int, *, skip: Iterable[str] = ()) -> Rollup:
        """Drive one fenced epoch bottom-up; returns the root's rollup receipt.

        Nodes named in ``skip`` are treated as dead for this epoch: they do
        not publish (leaves) or roll up (interior), and their parents degrade
        to partial rollups at the fan-in deadline.
        """
        dead: Set[str] = {str(s) for s in skip}
        for leaf in self.leaves:
            if leaf.node_id not in dead:
                leaf.publish_async(epoch)
        # interior levels bottom-up, root excluded
        for level in reversed(self.levels[1:-1]):
            for node in level:
                if node.node_id in dead:
                    continue
                node.rollup(epoch)
                node.publish_async(epoch)
        return self.root.rollup(epoch)

    def join_pending(self, timeout: Optional[float] = None) -> None:
        """Drain all in-flight publish threads (test teardown / shutdown)."""
        for node in self.nodes.values():
            node.join_pending(timeout)

    def sweep_expired(self) -> List[str]:
        """TTL-reap orphaned contribution keys from the shared transport."""
        return self.kv.sweep_expired()
