"""Concurrency-safety pass: thread inventory, shared-state discovery, lock
discipline (rules R7/R8/R9) and the ``thread_safety.json`` guard-map manifest.

The reference design is single-threaded Python, but this runtime is not:
guarded-sync watchdog workers (``_resilience/guard.py``), the off-thread
snapshot writer (``_resilience/snapshot.py``), the process-wide
``TelemetryRegistry``/``EventBus`` scraped by exporters while hot paths
mutate them, the multi-tenant ``StreamLabeler``, the serving ingest worker
and the fleet publishers. This pass proves thread-safety the same way the
compiled-path rules prove capture-safety: pure
AST, never importing the scanned code, with ``path:line``-cited findings
and a machine-readable manifest the serving runtime (and the ``locksan``
runtime sanitizer) consume.

Three cooperating analyses per module:

1. **Thread-spawn inventory** — every ``threading.Thread(...)`` call:
   its target, daemon flag, whether it is ever joined, and what closure
   state the target captures.
2. **Shared-mutable-state discovery** — which objects more than one thread
   can reach: classes that spawn threads, classes instantiated at module
   level (process-wide singletons), classes explicitly marked
   ``# concurrency: shared``, and module-level mutable-container globals
   in threading-aware modules.
3. **Lock-discipline inference** — for each *tracked* field of a shared
   class (container state, or read-modify-write counters), the set of
   locks held at every access site. One common lock across all
   mutate/iterate sites certifies the field into the guard map;
   anything else is an R7 finding.

Soundness trades (deliberate, the reference analyzer's): plain stores of
scalars/references are GIL-atomic and exempt; membership tests and ``len``
are exempt; fields holding intrinsically thread-safe types
(``queue.Queue``, ``threading.Event``, locks) are exempt; a pure memo
cache (keyed stores + keyed reads, never iterated, never read-modify-write)
is exempt. What remains — iterate-while-mutate pairs and compound
read-modify-write — is exactly the bug class that produced the
"dict changed size during iteration" failures this pass exists to prevent.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from torchmetrics_tpu_torch._analysis.model import SourceInfo, Violation
from torchmetrics_tpu_torch._analysis.registry import ClassInfo, ModuleInfo

__all__ = [
    "THREAD_SAFETY_VERSION",
    "AccessSite",
    "ClassConcurrency",
    "ModuleConcurrency",
    "ThreadSite",
    "check_module",
    "is_runtime_path",
    "thread_safety_to_json",
]

THREAD_SAFETY_VERSION = 1

# the serving-runtime surface the manifest certifies; the
# rules themselves run on every scanned module — they are inert where no
# threads/locks/shared markers exist
_RUNTIME_PREFIXES = (
    "torchmetrics_tpu_torch/_aot/",
    "torchmetrics_tpu_torch/_fleet/",
    "torchmetrics_tpu_torch/_observability/",
    "torchmetrics_tpu_torch/_resilience/",
    "torchmetrics_tpu_torch/_serving/",
    "torchmetrics_tpu_torch/_streams/",
    "torchmetrics_tpu_torch/_spmd/",
)
_RUNTIME_FILES = (
    "torchmetrics_tpu_torch/metric.py",
    "torchmetrics_tpu_torch/_compile.py",
    "torchmetrics_tpu_torch/collections.py",
    "torchmetrics_tpu_torch/utilities/distributed.py",
)

# `# concurrency: shared <reason>` on (or right above) a class def line
# declares that instances are reachable from more than one thread even
# though the class neither spawns threads nor lives in a module singleton
# (e.g. StreamLabeler: ingestion threads note() while a scrape labels)
_SHARED_MARK_RE = re.compile(r"#\s*concurrency:\s*shared\b(?:\s+(?P<reason>.*))?")

# `# concurrency: guarded-by <lock>[, <lock>]` on (or right above) a def line
# declares a locked-caller precondition: the method's body is analyzed as if
# those locks were already held (the `_drain_retired` idiom — private
# helpers documented "caller holds _lock"). The locksan runtime sanitizer
# verifies the precondition live wherever the helper is instrumented.
_GUARDED_BY_RE = re.compile(r"#\s*concurrency:\s*guarded-by\s+(?P<locks>[\w_,\s]+)")

# ctor names that create locks: the threading.* ctors plus the locksan
# factory under its conventional import aliases
_LOCK_CTORS = {
    "Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore",
    "new_lock", "san_lock", "_san_lock", "make_lock", "SanLock",
    "new_rlock", "_san_rlock", "SanRLock",
}
# ctor names / literals that create plain mutable containers worth tracking
_CONTAINER_CTORS = {"dict", "list", "set", "OrderedDict", "defaultdict", "Counter", "deque"}
# intrinsically thread-safe types: their own API is the synchronization.
# NOTE: `deque` is deliberately NOT here — single-element append/popleft are
# GIL-atomic, but iterating a deque during a concurrent append raises
# "deque mutated during iteration", which is exactly the R7 hazard shape
_SAFE_TYPE_CTORS = {"Queue", "LifoQueue", "PriorityQueue", "SimpleQueue", "Event"} | _LOCK_CTORS

# container-mutating method names (same inventory as the R1 walker, plus the
# deque/list left-side ops); `put`/`get` are excluded — on the tracked plain
# containers they don't exist, and on Queue the field is type-exempt anyway
_MUTATOR_METHODS = {
    "append", "appendleft", "extend", "extendleft", "insert", "remove", "pop",
    "popleft", "popitem", "clear", "add", "discard", "update", "setdefault",
}
# calls that iterate their container argument wholesale
_ITERATING_CALLS = {"dict", "list", "tuple", "set", "frozenset", "sorted", "sum", "max", "min", "any", "all"}
_ITERATING_METHODS = {"items", "keys", "values", "copy"}

# methods where access happens before the instance is published to other
# threads (or on a fresh clone), so lock discipline is not required yet
_PREPUBLICATION_METHODS = {"__init__", "__new__", "__reduce__", "__deepcopy__", "__copy__", "__getstate__", "__setstate__"}

# R8: calls that can block the calling thread for unbounded/IO time. A
# dotted call is matched on its head as written and on the module the head
# was imported as (`dist.barrier` -> `torch.distributed.barrier`)
_BLOCKING_NAME_CALLS = {"open"}
_COLLECTIVES = (
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object", "all_to_all",
    "all_to_all_single", "barrier", "monitored_barrier", "broadcast", "broadcast_object_list",
    "gather", "gather_object", "reduce", "reduce_scatter", "reduce_scatter_tensor", "scatter",
    "scatter_object_list", "recv", "send",
)
_BLOCKING_DOTTED = {
    ("time", "sleep"),
    ("os", "fsync"),
    ("torch.cuda", "synchronize"),
    ("subprocess", "run"),
    ("subprocess", "call"),
    ("subprocess", "check_call"),
    ("subprocess", "check_output"),
} | {("torch.distributed", name) for name in _COLLECTIVES}
# attribute calls that block regardless of receiver module: Event.wait,
# Condition.wait, Store.wait, a process's communicate, fd.fsync, the
# synchronize of the card, an event or a stream, and the tensor methods that
# copy a device value to the host; `.join` is handled separately with a
# thread-receiver check so `", ".join(...)` never fires
_BLOCKING_ATTR_CALLS = {"wait", "fsync", "communicate", "synchronize", "item", "tolist", "cpu", "numpy"}
# a `torch.distributed.Store` round-trip (`get` blocks until the key is set;
# `wait` is caught above). Matched only on a receiver named as a store, so
# `dict.get` stays silent
_STORE_BLOCKING_CALLS = {"get", "add", "compare_set"}


def is_runtime_path(path: str) -> bool:
    """True for files inside the serving-runtime manifest scope."""
    return path in _RUNTIME_FILES or any(path.startswith(p) for p in _RUNTIME_PREFIXES)


# ---------------------------------------------------------------------------
# data model
# ---------------------------------------------------------------------------


@dataclass
class ThreadSite:
    """One ``threading.Thread(...)`` spawn site."""

    scope: str  # "ClassName.method" or module-level function
    lineno: int
    target: str  # rendered target expression ("self._loop", "watchdog", "?")
    daemon: Optional[bool]  # None when not statically decidable
    stored: Optional[str]  # "self.<attr>" / local name the Thread binds to
    joined: bool = False
    captures: List[str] = field(default_factory=list)  # closure state of a local target

    def to_json(self) -> Dict[str, object]:
        return {
            "scope": self.scope,
            "line": self.lineno,
            "target": self.target,
            "daemon": self.daemon,
            "stored": self.stored,
            "joined": self.joined,
            "captures": sorted(self.captures),
        }


@dataclass
class AccessSite:
    """One access to a tracked field/global, with the locks held there."""

    method: str
    lineno: int
    held: Tuple[str, ...]  # sorted lock names held at the site
    kind: str  # "mutate" | "rmw" | "iterate"


@dataclass
class FieldDiscipline:
    name: str
    sites: List[AccessSite] = field(default_factory=list)
    guards: List[str] = field(default_factory=list)
    verdict: str = "guarded"  # "guarded" | "unguarded" | "inconsistent"

    def to_json(self) -> Dict[str, object]:
        return {"guards": list(self.guards), "verdict": self.verdict}


@dataclass
class ClassConcurrency:
    name: str
    shared_reason: Optional[str]  # None when the class is not in the shared set
    locks: List[str] = field(default_factory=list)
    fields: Dict[str, FieldDiscipline] = field(default_factory=dict)

    def to_json(self) -> Dict[str, object]:
        return {
            "shared": self.shared_reason,
            "locks": sorted(self.locks),
            "fields": {k: v.to_json() for k, v in sorted(self.fields.items())},
        }


@dataclass
class ModuleConcurrency:
    """Everything the pass learned about one module (manifest unit)."""

    module: str
    path: str
    runtime: bool
    threads: List[ThreadSite] = field(default_factory=list)
    classes: Dict[str, ClassConcurrency] = field(default_factory=dict)
    global_guards: Dict[str, FieldDiscipline] = field(default_factory=dict)
    finding_count: int = 0  # pre-baseline R7-R9 findings in this module

    @property
    def verdict(self) -> str:
        if self.finding_count:
            return "baselined_hazards"  # CI requires every finding baselined
        if self.threads or self.global_guards or any(c.shared_reason for c in self.classes.values()):
            return "guarded"
        return "no_concurrency"

    def to_json(self) -> Dict[str, object]:
        return {
            "verdict": self.verdict,
            "findings": self.finding_count,
            "threads": [t.to_json() for t in sorted(self.threads, key=lambda t: t.lineno)],
            "classes": {
                name: info.to_json()
                for name, info in sorted(self.classes.items())
                if info.shared_reason or info.locks
            },
            "globals": {k: v.to_json() for k, v in sorted(self.global_guards.items())},
        }


def thread_safety_to_json(reports: Iterable[ModuleConcurrency]) -> Dict[str, object]:
    """Versioned manifest payload over the serving-runtime modules only."""
    modules = {
        r.path: r.to_json()
        for r in sorted(reports, key=lambda r: r.path)
        if r.runtime
    }
    return {"version": THREAD_SAFETY_VERSION, "rules": ["R7", "R8", "R9"], "modules": modules}


# ---------------------------------------------------------------------------
# AST helpers
# ---------------------------------------------------------------------------


def _render(expr: ast.expr) -> str:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return f"{_render(expr.value)}.{expr.attr}"
    if isinstance(expr, ast.Constant):
        return repr(expr.value)
    return "?"


def _is_lock_ctor(call: ast.expr) -> bool:
    if not isinstance(call, ast.Call):
        return False
    name = call.func.attr if isinstance(call.func, ast.Attribute) else getattr(call.func, "id", None)
    return name in _LOCK_CTORS


def _ctor_name(value: ast.expr) -> Optional[str]:
    """Container/thread-safe-type classification of an assigned value."""
    if isinstance(value, (ast.Dict, ast.DictComp)):
        return "dict"
    if isinstance(value, (ast.List, ast.ListComp)):
        return "list"
    if isinstance(value, (ast.Set, ast.SetComp)):
        return "set"
    if isinstance(value, ast.Call):
        fn = value.func
        return fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", None)
    return None


def _self_attr(expr: ast.expr) -> Optional[str]:
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name) and expr.value.id == "self":
        return expr.attr
    return None


def _references_self_attr(expr: ast.expr, attr: str) -> bool:
    return any(_self_attr(sub) == attr for sub in ast.walk(expr))


def _shared_marker(source: SourceInfo, lineno: int) -> Optional[str]:
    for ln in (lineno, lineno - 1):
        m = _SHARED_MARK_RE.search(source.line_text(ln))
        if m:
            return (m.group("reason") or "marked shared").strip() or "marked shared"
    return None


def _initial_held(source: SourceInfo, fn: ast.FunctionDef) -> Tuple[str, ...]:
    """Locks a ``# concurrency: guarded-by`` marker declares pre-held."""
    for ln in (fn.lineno, fn.lineno - 1):
        m = _GUARDED_BY_RE.search(source.line_text(ln))
        if m:
            return tuple(sorted(n.strip() for n in m.group("locks").split(",") if n.strip()))
    return ()


def _walk_held(
    stmts: Sequence[ast.stmt],
    held: Tuple[str, ...],
    lock_names: Set[str],
) -> Iterable[Tuple[ast.stmt, Tuple[str, ...]]]:
    """Yield every statement with the sorted tuple of lock names held there.

    ``with self._lock:`` / ``with _mod_lock:`` scopes push their lock onto
    the held set for the duration of the body; non-lock ``with`` contexts
    (files, warnings, injectors) pass the held set through unchanged.
    """
    for stmt in stmts:
        yield stmt, held
        if isinstance(stmt, ast.With):
            inner = set(held)
            for item in stmt.items:
                ctx = item.context_expr
                name = _self_attr(ctx) or (ctx.id if isinstance(ctx, ast.Name) else None)
                if name in lock_names:
                    inner.add(name)
            yield from _walk_held(stmt.body, tuple(sorted(inner)), lock_names)
        elif isinstance(stmt, (ast.If, ast.While)):
            yield from _walk_held(list(stmt.body) + list(stmt.orelse), held, lock_names)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            yield from _walk_held(list(stmt.body) + list(stmt.orelse), held, lock_names)
        elif isinstance(stmt, ast.Try):
            inner_stmts = list(stmt.body) + list(stmt.orelse) + list(stmt.finalbody)
            for handler in stmt.handlers:
                inner_stmts += list(handler.body)
            yield from _walk_held(inner_stmts, held, lock_names)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def's body runs later, on whatever thread calls it —
            # never under the locks held at definition time
            yield from _walk_held(stmt.body, (), lock_names)


def _expr_children(stmt: ast.stmt) -> List[ast.expr]:
    """Expression roots of one statement (bodies of compound statements are
    walked separately by :func:`_walk_held`)."""
    out: List[ast.expr] = []
    for fld, value in ast.iter_fields(stmt):
        if fld in ("body", "orelse", "finalbody", "handlers"):
            continue
        if isinstance(value, ast.expr):
            out.append(value)
        elif isinstance(value, list):
            out.extend(v for v in value if isinstance(v, ast.expr))
    return out


def _walk_exprs(stmt: ast.stmt) -> Iterable[ast.AST]:
    for root in _expr_children(stmt):
        yield from ast.walk(root)


# ---------------------------------------------------------------------------
# per-function collectors
# ---------------------------------------------------------------------------


def _nested_captures(fn: ast.FunctionDef) -> List[str]:
    """Free-variable names a nested thread target reads from its closure."""
    bound: Set[str] = {a.arg for a in list(fn.args.posonlyargs) + list(fn.args.args) + list(fn.args.kwonlyargs)}
    if fn.args.vararg:
        bound.add(fn.args.vararg.arg)
    if fn.args.kwarg:
        bound.add(fn.args.kwarg.arg)
    loads: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name):
            if isinstance(node.ctx, ast.Store):
                bound.add(node.id)
            elif isinstance(node.ctx, ast.Load):
                loads.add(node.id)
    import builtins

    return sorted(n for n in loads - bound if not hasattr(builtins, n))


def _thread_ctor(call: ast.Call, imports: Dict[str, str]) -> bool:
    fn = call.func
    if isinstance(fn, ast.Attribute) and fn.attr == "Thread":
        head = fn.value.id if isinstance(fn.value, ast.Name) else None
        return head is not None and imports.get(head, head) == "threading"
    if isinstance(fn, ast.Name):
        return imports.get(fn.id) == "threading.Thread"
    return False


def _collect_threads(
    func: ast.FunctionDef,
    scope: str,
    imports: Dict[str, str],
    nested_defs: Dict[str, ast.FunctionDef],
) -> List[ThreadSite]:
    out: List[ThreadSite] = []
    # local name -> ThreadSite for join attribution within this function
    local_threads: Dict[str, ThreadSite] = {}
    assigned_ctors = {
        id(node.value): node
        for node in ast.walk(func)
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) and _thread_ctor(node.value, imports)
    }
    for node in ast.walk(func):
        if not (isinstance(node, ast.Call) and _thread_ctor(node, imports)):
            continue
        site = _thread_site(node, scope, nested_defs)
        assign = assigned_ctors.get(id(node))
        if assign is not None:
            tgt = assign.targets[0] if len(assign.targets) == 1 else None
            if isinstance(tgt, ast.Name):
                site.stored = tgt.id
                local_threads[tgt.id] = site
            elif tgt is not None and (attr := _self_attr(tgt)) is not None:
                site.stored = f"self.{attr}"
        out.append(site)
    # join attribution for locally-bound threads
    for node in ast.walk(func):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "join"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id in local_threads
        ):
            local_threads[node.func.value.id].joined = True
    return out


def _thread_site(call: ast.Call, scope: str, nested_defs: Dict[str, ast.FunctionDef]) -> ThreadSite:
    target_expr = next((kw.value for kw in call.keywords if kw.arg == "target"), None)
    daemon_expr = next((kw.value for kw in call.keywords if kw.arg == "daemon"), None)
    daemon: Optional[bool] = None
    if daemon_expr is None:
        daemon = False  # threading's default
    elif isinstance(daemon_expr, ast.Constant) and isinstance(daemon_expr.value, bool):
        daemon = daemon_expr.value
    target = _render(target_expr) if target_expr is not None else "?"
    captures: List[str] = []
    if target_expr is not None and isinstance(target_expr, ast.Name) and target_expr.id in nested_defs:
        captures = _nested_captures(nested_defs[target_expr.id])
    elif target_expr is not None and _self_attr(target_expr) is not None:
        captures = ["self"]  # a bound method captures the whole instance
    return ThreadSite(scope=scope, lineno=call.lineno, target=target, daemon=daemon, stored=None, captures=captures)


# ---------------------------------------------------------------------------
# the per-module pass
# ---------------------------------------------------------------------------


def check_module(mod: ModuleInfo, source: SourceInfo) -> Tuple[List[Violation], ModuleConcurrency]:
    """Run R7/R8/R9 over one indexed module; return findings + the report."""
    report = ModuleConcurrency(module=mod.module, path=mod.path, runtime=is_runtime_path(mod.path))
    violations: List[Violation] = []
    threading_aware = "threading" in mod.imports.values() or any(
        origin.startswith("threading.") for origin in mod.imports.values()
    )

    # ---------------------------------------------------- module-level facts
    module_locks: Set[str] = set()
    module_containers: Set[str] = set()
    module_instances: Dict[str, str] = {}  # global name -> class name
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and isinstance(stmt.targets[0], ast.Name):
            name, value = stmt.targets[0].id, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name) and stmt.value is not None:
            name, value = stmt.target.id, stmt.value
        else:
            continue
        ctor = _ctor_name(value)
        if _is_lock_ctor(value):
            module_locks.add(name)
        elif ctor in _CONTAINER_CTORS or isinstance(value, (ast.Dict, ast.List, ast.Set)):
            module_containers.add(name)
        elif ctor in mod.classes:
            module_instances[name] = ctor

    # ------------------------------------------------------ thread inventory
    nested_defs_by_scope: Dict[str, Dict[str, ast.FunctionDef]] = {}

    def _nested(fn: ast.FunctionDef) -> Dict[str, ast.FunctionDef]:
        return {n.name: n for n in ast.walk(fn) if isinstance(n, ast.FunctionDef) and n is not fn}

    spawning_classes: Set[str] = set()
    class_threads: Dict[str, List[ThreadSite]] = {}
    for cls in mod.classes.values():
        for mname, fn in cls.methods.items():
            scope = f"{cls.name}.{mname}"
            sites = _collect_threads(fn, scope, mod.imports, _nested(fn))
            if sites:
                spawning_classes.add(cls.name)
                class_threads.setdefault(cls.name, []).extend(sites)
                report.threads.extend(sites)
    for fname, fn in mod.functions.items():
        sites = _collect_threads(fn, fname, mod.imports, _nested(fn))
        report.threads.extend(sites)

    # join attribution for threads stored on self: any `self.<attr>.join(`
    # anywhere in the owning class counts
    for cls_name, sites in class_threads.items():
        cls = mod.classes[cls_name]
        joined_attrs: Set[str] = set()
        for fn in cls.methods.values():
            for node in ast.walk(fn):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "join"
                    and (attr := _self_attr(node.func.value)) is not None
                ):
                    joined_attrs.add(attr)
        for site in sites:
            if site.stored is not None and site.stored.startswith("self.") and site.stored[5:] in joined_attrs:
                site.joined = True

    # ------------------------------------------------------------- per class
    for cls in mod.classes.values():
        info = _analyze_class(cls, mod, source, module_locks, module_instances, spawning_classes, violations)
        report.classes[cls.name] = info

    # ------------------------------------------------------- module globals
    if threading_aware and module_containers:
        _analyze_globals(mod, source, module_locks, module_containers, report, violations)

    # ------------------------------------------------------------ R8 sweep
    all_lock_names = set(module_locks)
    for cls in mod.classes.values():
        all_lock_names |= _class_locks(cls)
    if all_lock_names:
        _check_r8(mod, source, module_locks, violations)

    # ------------------------------------------------------------ R9 sweep
    _check_lock_order(mod, source, module_locks, violations)
    for site in report.threads:
        if site.joined:
            continue
        if site.daemon is False:
            v = source.violation(
                "R9", site.lineno, site.scope,
                f"non-daemon thread (target `{site.target}`) is started but never joined —"
                " it blocks interpreter exit and leaks on every respawn",
            )
        else:
            v = source.violation(
                "R9", site.lineno, site.scope,
                f"thread (target `{site.target}`, daemon={site.daemon}) is never joined;"
                " abandoned-by-design workers must be baselined with a justification",
            )
        if v:
            violations.append(v)

    report.finding_count = len(violations)
    return violations, report


def _class_locks(cls: ClassInfo) -> Set[str]:
    locks: Set[str] = set()
    for fn in cls.methods.values():
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
                for tgt in node.targets:
                    attr = _self_attr(tgt)
                    if attr is not None:
                        locks.add(attr)
    return locks


def _class_field_types(cls: ClassInfo) -> Tuple[Set[str], Set[str]]:
    """(container fields, thread-safe-type fields) by ctor classification."""
    containers: Set[str] = set()
    safe: Set[str] = set()
    for fn in cls.methods.values():
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                targets: List[ast.expr] = list(node.targets)
                value = node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
                value = node.value
            else:
                continue
            ctor = _ctor_name(value)
            for tgt in targets:
                attr = _self_attr(tgt)
                if attr is None:
                    continue
                if ctor in _SAFE_TYPE_CTORS or _is_lock_ctor(value):
                    safe.add(attr)
                elif ctor in _CONTAINER_CTORS or isinstance(value, (ast.Dict, ast.List, ast.Set)):
                    containers.add(attr)
    return containers - safe, safe


def _shared_reason(
    cls: ClassInfo,
    source: SourceInfo,
    module_instances: Dict[str, str],
    spawning_classes: Set[str],
) -> Optional[str]:
    marker = _shared_marker(source, cls.lineno)
    if marker is not None:
        return marker
    if cls.name in spawning_classes:
        return "spawns worker threads"
    singles = sorted(g for g, c in module_instances.items() if c == cls.name)
    if singles:
        return f"module-level singleton ({', '.join(singles)})"
    return None


_ACCESS_VERBS = {"mutate": "mutation of", "rmw": "read-modify-write of", "iterate": "iteration over"}


def _judge_discipline(
    name: str,
    site_list: List[AccessSite],
    scope_of,
    message_of,
    source: SourceInfo,
    violations: List[Violation],
) -> Optional[FieldDiscipline]:
    """The single R7 judgment both class fields and module globals share.

    Exempt (returns None) when the accesses are safe by GIL semantics: no
    mutation after publication, or a pure memo cache (keyed stores only —
    never iterated, never compound). Otherwise the guard is the intersection
    of locks held across every mutate/iterate site; an empty intersection
    emits one finding per unlocked site via ``message_of(site, guards_note)``.
    """
    mutations = [s for s in site_list if s.kind in ("mutate", "rmw")]
    iterations = [s for s in site_list if s.kind == "iterate"]
    if not mutations:
        return None  # read-only after __init__: immutable-by-convention
    # memo-cache exemption: keyed stores that are never iterated and never
    # compound — idempotent single-slot writes are GIL-atomic
    if not iterations and not any(s.kind == "rmw" for s in mutations):
        return None
    disc = FieldDiscipline(name=name, sites=site_list)
    checked = mutations + iterations
    common = set(checked[0].held)
    for s in checked[1:]:
        common &= set(s.held)
    if common:
        disc.guards = sorted(common)
        disc.verdict = "guarded"
        return disc
    any_held = any(s.held for s in checked)
    disc.verdict = "inconsistent" if any_held else "unguarded"
    guards_note = (
        f" and other sites guard it with `{sorted({lock for x in checked for lock in x.held})}`"
        if any_held
        else " and no site declares any lock discipline"
    )
    for s in checked:
        if s.held:
            continue
        v = source.violation("R7", s.lineno, scope_of(s), message_of(s, guards_note))
        if v:
            violations.append(v)
    return disc


def _analyze_class(
    cls: ClassInfo,
    mod: ModuleInfo,
    source: SourceInfo,
    module_locks: Set[str],
    module_instances: Dict[str, str],
    spawning_classes: Set[str],
    violations: List[Violation],
) -> ClassConcurrency:
    locks = _class_locks(cls)
    reason = _shared_reason(cls, source, module_instances, spawning_classes)
    info = ClassConcurrency(name=cls.name, shared_reason=reason, locks=sorted(locks))
    if reason is None:
        return info

    containers, safe_fields = _class_field_types(cls)
    lock_names = locks | module_locks
    sites: Dict[str, List[AccessSite]] = {}
    seen: Set[Tuple[str, str, int, str]] = set()  # the walkers can visit one site twice

    for mname, fn in cls.methods.items():
        if mname in _PREPUBLICATION_METHODS:
            continue
        for stmt, held in _walk_held(fn.body, _initial_held(source, fn), lock_names):
            for attr, kind, lineno in _classify_accesses(stmt, containers, locks | safe_fields):
                key = (attr, kind, lineno, mname)
                if key in seen:
                    continue
                seen.add(key)
                sites.setdefault(attr, []).append(AccessSite(mname, lineno, held, kind))

    for attr in sorted(sites):
        disc = _judge_discipline(
            attr,
            sites[attr],
            scope_of=lambda s: f"{cls.name}.{s.method}",
            message_of=lambda s, guards_note, attr=attr: (
                f"{_ACCESS_VERBS[s.kind]} `self.{attr}` without a lock, but `{cls.name}` is"
                f" shared across threads ({info.shared_reason}){guards_note}"
            ),
            source=source,
            violations=violations,
        )
        if disc is not None:
            info.fields[attr] = disc
    return info


def _classify_accesses(
    stmt: ast.stmt, container_fields: Set[str], exempt: Set[str]
) -> List[Tuple[str, str, int]]:
    """``(attr, kind, lineno)`` tracked-field accesses in one statement.

    Kinds: ``mutate`` (container mutation), ``rmw`` (compound
    read-modify-write), ``iterate`` (wholesale read of a container).
    Plain stores, keyed reads, membership tests, and ``len`` are exempt
    (GIL-atomic); fields holding thread-safe types are exempt wholesale.
    """
    out: List[Tuple[str, str, int]] = []

    def note(attr: Optional[str], kind: str, lineno: int) -> None:
        if attr is not None and attr not in exempt:
            out.append((attr, kind, lineno))

    if isinstance(stmt, ast.Assign):
        for tgt in stmt.targets:
            if isinstance(tgt, ast.Subscript):
                attr = _self_attr(tgt.value)
                if attr is not None:
                    kind = "rmw" if _references_self_attr(stmt.value, attr) else "mutate"
                    note(attr, kind, tgt.lineno)
    elif isinstance(stmt, ast.AugAssign):
        attr = _self_attr(stmt.target)
        if attr is not None:
            note(attr, "rmw", stmt.lineno)
        elif isinstance(stmt.target, ast.Subscript):
            note(_self_attr(stmt.target.value), "rmw", stmt.lineno)
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        out.extend(_iteration_reads(stmt.iter, container_fields, exempt))

    for node in _walk_exprs(stmt):
        if isinstance(node, ast.Call):
            fn = node.func
            # self.<attr>.append(...) style mutators — only on known containers,
            # so `self.metric.update(...)` (a Metric, not a dict) stays silent
            if isinstance(fn, ast.Attribute) and fn.attr in _MUTATOR_METHODS:
                attr = _self_attr(fn.value)
                if attr is not None and attr in container_fields:
                    note(attr, "mutate", node.lineno)
            out.extend(_iteration_call_reads(node, container_fields, exempt))
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
            for gen in node.generators:
                out.extend(_iteration_reads(gen.iter, container_fields, exempt))
    return out


def _iteration_reads(
    expr: ast.expr, container_fields: Set[str], exempt: Set[str]
) -> List[Tuple[str, str, int]]:
    attr = _self_attr(expr)
    if attr is not None and attr in container_fields and attr not in exempt:
        return [(attr, "iterate", expr.lineno)]
    if (
        isinstance(expr, ast.Call)
        and isinstance(expr.func, ast.Attribute)
        and expr.func.attr in _ITERATING_METHODS
    ):
        attr = _self_attr(expr.func.value)
        if attr is not None and attr in container_fields and attr not in exempt:
            return [(attr, "iterate", expr.lineno)]
    return []


def _iteration_call_reads(
    node: ast.Call, container_fields: Set[str], exempt: Set[str]
) -> List[Tuple[str, str, int]]:
    out: List[Tuple[str, str, int]] = []
    fn = node.func
    name = fn.id if isinstance(fn, ast.Name) else None
    if name in _ITERATING_CALLS:
        for arg in node.args:
            out.extend(_iteration_reads(arg, container_fields, exempt))
    if isinstance(fn, ast.Attribute) and fn.attr in _ITERATING_METHODS:
        attr = _self_attr(fn.value)
        if attr is not None and attr in container_fields and attr not in exempt:
            out.append((attr, "iterate", node.lineno))
    return out


# ---------------------------------------------------------------------------
# module-global discipline
# ---------------------------------------------------------------------------


def _analyze_globals(
    mod: ModuleInfo,
    source: SourceInfo,
    module_locks: Set[str],
    module_containers: Set[str],
    report: ModuleConcurrency,
    violations: List[Violation],
) -> None:
    sites: Dict[str, List[AccessSite]] = {}
    seen: Set[Tuple[str, str, int, str]] = set()

    def scan(fn: ast.FunctionDef, scope: str, lock_names: Set[str]) -> None:
        for stmt, held in _walk_held(fn.body, _initial_held(source, fn), lock_names):
            for name, kind, lineno in _classify_global_accesses(stmt, module_containers):
                key = (name, kind, lineno, scope)
                if key in seen:
                    continue
                seen.add(key)
                sites.setdefault(name, []).append(AccessSite(scope, lineno, held, kind))

    for fname, fn in mod.functions.items():
        scan(fn, fname, module_locks)
    for cls in mod.classes.values():
        cls_locks = _class_locks(cls) | module_locks
        for mname, fn in cls.methods.items():
            scan(fn, f"{cls.name}.{mname}", cls_locks)

    for name in sorted(sites):
        disc = _judge_discipline(
            name,
            sites[name],
            scope_of=lambda s: s.method,
            message_of=lambda s, guards_note, name=name: (
                f"{_ACCESS_VERBS[s.kind]} module global `{name}` without a lock in a"
                f" threading-aware module{guards_note} — cross-thread container state"
                " needs one consistent guard"
            ),
            source=source,
            violations=violations,
        )
        if disc is not None:
            report.global_guards[name] = disc


def _classify_global_accesses(stmt: ast.stmt, globals_: Set[str]) -> List[Tuple[str, str, int]]:
    out: List[Tuple[str, str, int]] = []
    if isinstance(stmt, ast.Assign):
        for tgt in stmt.targets:
            if isinstance(tgt, ast.Subscript) and isinstance(tgt.value, ast.Name) and tgt.value.id in globals_:
                kind = "rmw" if any(
                    isinstance(s, ast.Name) and s.id == tgt.value.id for s in ast.walk(stmt.value)
                ) else "mutate"
                out.append((tgt.value.id, kind, tgt.lineno))
    elif isinstance(stmt, ast.AugAssign):
        tgt = stmt.target
        if isinstance(tgt, ast.Name) and tgt.id in globals_:
            out.append((tgt.id, "rmw", stmt.lineno))
        elif isinstance(tgt, ast.Subscript) and isinstance(tgt.value, ast.Name) and tgt.value.id in globals_:
            out.append((tgt.value.id, "rmw", stmt.lineno))
    elif isinstance(stmt, (ast.For, ast.AsyncFor)) and isinstance(stmt.iter, ast.Name) and stmt.iter.id in globals_:
        out.append((stmt.iter.id, "iterate", stmt.iter.lineno))

    for node in _walk_exprs(stmt):
        if isinstance(node, ast.Call):
            fn = node.func
            if (
                isinstance(fn, ast.Attribute)
                and fn.attr in _MUTATOR_METHODS
                and isinstance(fn.value, ast.Name)
                and fn.value.id in globals_
            ):
                out.append((fn.value.id, "mutate", node.lineno))
            name = fn.id if isinstance(fn, ast.Name) else None
            if name in _ITERATING_CALLS:
                for arg in node.args:
                    if isinstance(arg, ast.Name) and arg.id in globals_:
                        out.append((arg.id, "iterate", arg.lineno))
            if isinstance(fn, ast.Attribute) and fn.attr in _ITERATING_METHODS and isinstance(fn.value, ast.Name) and fn.value.id in globals_:
                out.append((fn.value.id, "iterate", node.lineno))
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
            for gen in node.generators:
                if isinstance(gen.iter, ast.Name) and gen.iter.id in globals_:
                    out.append((gen.iter.id, "iterate", gen.iter.lineno))
    return out


# ---------------------------------------------------------------------------
# R8: blocking calls while holding a lock
# ---------------------------------------------------------------------------


def _dotted(expr: ast.expr) -> Optional[str]:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        inner = _dotted(expr.value)
        return f"{inner}.{expr.attr}" if inner else None
    return None


def _is_blocking_call(node: ast.Call, thread_attrs: Set[str], imports: Dict[str, str]) -> Optional[str]:
    fn = node.func
    if isinstance(fn, ast.Name):
        if fn.id in _BLOCKING_NAME_CALLS | {"sleep", "fsync"}:
            return fn.id
        return None
    if not isinstance(fn, ast.Attribute):
        return None
    head = _dotted(fn.value)
    if head is not None:
        first, _, rest = head.partition(".")
        origin = imports.get(first, first) + (f".{rest}" if rest else "")
        if (head, fn.attr) in _BLOCKING_DOTTED or (origin, fn.attr) in _BLOCKING_DOTTED:
            return f"{head}.{fn.attr}"
        if fn.attr in _STORE_BLOCKING_CALLS and head.rsplit(".", 1)[-1].lstrip("_").lower().endswith("store"):
            return f"{head}.{fn.attr}"
    if fn.attr in _BLOCKING_ATTR_CALLS and not isinstance(fn.value, ast.Constant):
        return f".{fn.attr}()"
    if fn.attr == "join":
        # only thread joins block; `", ".join(...)` and friends never fire
        attr = _self_attr(fn.value)
        if attr is not None and attr in thread_attrs:
            return f"self.{attr}.join"
        if isinstance(fn.value, ast.Name) and ("thread" in fn.value.id.lower() or "worker" in fn.value.id.lower()):
            return f"{fn.value.id}.join"
    return None


def _check_r8(
    mod: ModuleInfo, source: SourceInfo, module_locks: Set[str], violations: List[Violation]
) -> None:
    def sweep(fn: ast.FunctionDef, scope: str, lock_names: Set[str], thread_attrs: Set[str]) -> None:
        for stmt, held in _walk_held(fn.body, _initial_held(source, fn), lock_names):
            if not held:
                continue
            for node in _walk_exprs(stmt):
                if isinstance(node, ast.Call):
                    what = _is_blocking_call(node, thread_attrs, mod.imports)
                    if what is not None:
                        v = source.violation(
                            "R8", node.lineno, scope,
                            f"blocking call `{what}` while holding lock(s) {sorted(held)} —"
                            " every other thread serializes behind this IO/wait/sync; move it"
                            " outside the critical section",
                        )
                        if v:
                            violations.append(v)

    for fname, fn in mod.functions.items():
        sweep(fn, fname, module_locks, set())
    for cls in mod.classes.values():
        lock_names = _class_locks(cls) | module_locks
        thread_attrs = {
            site_attr
            for m in cls.methods.values()
            for node in ast.walk(m)
            if isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Call)
            and _thread_ctor(node.value, mod.imports)
            for site_attr in [_self_attr(node.targets[0]) if len(node.targets) == 1 else None]
            if site_attr is not None
        }
        for mname, fn in cls.methods.items():
            sweep(fn, f"{cls.name}.{mname}", lock_names, thread_attrs)


# ---------------------------------------------------------------------------
# R9: lock-order cycles
# ---------------------------------------------------------------------------


def _check_lock_order(
    mod: ModuleInfo, source: SourceInfo, module_locks: Set[str], violations: List[Violation]
) -> None:
    """Module-wide lock-acquisition graph; any cycle is a deadlock shape.

    Lock identity is the lock's *name* (self attrs by attribute name),
    which deliberately merges same-named locks across instances: two
    instances locking each other in opposite orders is exactly the ABBA
    case the merge is conservative about.
    """
    edges: Dict[str, Dict[str, Tuple[str, int]]] = {}

    def sweep(fn: ast.FunctionDef, scope: str, lock_names: Set[str]) -> None:
        for stmt, held in _walk_held(fn.body, _initial_held(source, fn), lock_names):
            if not isinstance(stmt, ast.With):
                continue
            for item in stmt.items:
                ctx = item.context_expr
                name = _self_attr(ctx) or (ctx.id if isinstance(ctx, ast.Name) else None)
                if name in lock_names:
                    for outer in held:
                        if outer != name:
                            edges.setdefault(outer, {}).setdefault(name, (scope, stmt.lineno))

    for fname, fn in mod.functions.items():
        sweep(fn, fname, module_locks)
    for cls in mod.classes.values():
        lock_names = _class_locks(cls) | module_locks
        for mname, fn in cls.methods.items():
            sweep(fn, f"{cls.name}.{mname}", lock_names)

    # DFS cycle detection over the per-module graph
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}
    reported: Set[Tuple[str, str]] = set()

    def dfs(node: str, path: List[str]) -> None:
        color[node] = GRAY
        for nxt, (scope, lineno) in sorted(edges.get(node, {}).items()):
            if color.get(nxt, WHITE) == GRAY:
                cycle = path[path.index(nxt):] + [nxt] if nxt in path else [node, nxt]
                key = (min(cycle), max(cycle))
                if key not in reported:
                    reported.add(key)
                    v = source.violation(
                        "R9", lineno, scope,
                        f"lock-order cycle: {' -> '.join(cycle + [cycle[0]])} — two paths acquire"
                        " these locks in opposite orders and can deadlock under load",
                    )
                    if v:
                        violations.append(v)
            elif color.get(nxt, WHITE) == WHITE:
                dfs(nxt, path + [nxt])
        color[node] = BLACK

    for node in sorted(edges):
        if color.get(node, WHITE) == WHITE:
            dfs(node, [node])
