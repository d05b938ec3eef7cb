"""Structural rule R1 (unregistered-state mutation) and the R1 certificate.

R1 reasons about class structure (registered states, inherited
declarations) rather than value flow, so it lives on top of the
``Registry``'s static chain resolution instead of the taint tracker.
"""

from __future__ import annotations

from typing import List, Set

from torchmetrics_tpu_torch._analysis.model import SourceInfo, Violation
from torchmetrics_tpu_torch._analysis.registry import ClassInfo, MutationSite, Registry, iter_self_mutations

# methods whose bodies a compiled step replays, and that are fingerprint-guarded
TRACED_METHODS = ("update", "compute")

# how one MutationSite kind reads in the R1 message
_SITE_VERBS = {
    "assign": "assignment to",
    "item": "item-assignment into",
    "setattr": "assignment to",
}

_DYNAMIC_SITE_MESSAGES = {
    "setattr": "dynamic `setattr(self, ...)` in a compiled method cannot be proven state-safe",
    "getattr-call": (
        "mutating call on a dynamic `getattr(self, ...)` receiver in a compiled method"
        " cannot be proven state-safe"
    ),
}


def _site_verb(site: MutationSite) -> str:
    if site.kind in ("call", "getattr-call"):
        return f"`.{site.method}()` on"
    return _SITE_VERBS[site.kind]


def check_r1(cls: ClassInfo, registry: Registry, source: SourceInfo) -> List[Violation]:
    """Flag ``self.<attr>`` mutation in ``update``/``compute`` for attrs never
    registered via ``add_state`` (underscore attrs are metric machinery and
    exempt, mirroring the runtime guard). Mutation discovery is shared with
    the registry's certification index (:func:`iter_self_mutations`), so any
    site that uncertifies a class also reports here."""
    out: List[Violation] = []
    states, dynamic = registry.registered_states(cls)

    for method_name in TRACED_METHODS:
        func = cls.methods.get(method_name)
        if func is None:
            continue
        scope = f"{cls.name}.{method_name}"
        for site in iter_self_mutations(func):
            if site.attr is None:
                if dynamic:
                    # some chain class registers states dynamically, so a
                    # dynamic site is as likely a registered-state mutation
                    # as not — same guesswork gate as named attrs below
                    # (certification still refuses the class either way)
                    continue
                v = source.violation("R1", site.lineno, scope, _DYNAMIC_SITE_MESSAGES[site.kind])
                if v:
                    out.append(v)
            else:
                _flag_attr(out, cls, source, scope, site.lineno, site.attr, states, dynamic,
                           verb=_site_verb(site))
    return out


def _flag_attr(
    out: List[Violation],
    cls: ClassInfo,
    source: SourceInfo,
    scope: str,
    lineno: int,
    attr: str,
    states: Set[str],
    dynamic_states: bool,
    verb: str = "assignment to",
) -> None:
    if attr.startswith("_") or attr in states:
        return
    if dynamic_states:
        # some chain class registers states dynamically; R1 would be guesswork
        return
    v = source.violation(
        "R1", lineno, scope,
        f"{verb} `self.{attr}` which is not registered via `add_state` — a graph replay would freeze this mutation",
    )
    if v:
        out.append(v)


def r1_certifiable(cls: ClassInfo, registry: Registry) -> bool:
    """True when the whole static chain is provably free of unregistered-
    attribute mutation in ANY method (not just update/compute — helpers
    called from a compiled update mutate just the same), making it safe for the
    runtime to skip the `_host_attr_snapshot` fingerprint for this class."""
    chain, reaches_metric, fully_resolved = registry.chain(cls)
    if not (reaches_metric and fully_resolved):
        return False
    states, dynamic = registry.registered_states(cls)
    if dynamic:
        return False
    for c in chain:
        for method_name, mutated in c.mutated_attrs.items():
            if method_name in ("__init__", "__new__", "__init_subclass__"):
                continue
            for attr in mutated:
                if not attr.startswith("_") and attr not in states:
                    return False
        if any(m not in ("__init__",) for m in c.dynamic_setattr_methods):
            return False
    return True
