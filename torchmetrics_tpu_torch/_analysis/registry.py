"""Cross-module class registry with static base-class resolution.

The analyzer never imports the code it scans (imports would pull in torch
and execute module side effects; AST parsing keeps the full-package scan
fast). Instead this registry indexes every class
definition in the scanned tree, records the names its bases were written
as, resolves those names through each module's imports, and answers the
questions the rules need:

- is this class (transitively) a ``Metric`` subclass?
- which state names did ``add_state`` register anywhere along its chain?
- does any class along the chain declare ``_traced_value_flags``?
- is the whole chain "R1-certifiable" (every ancestor inside the package
  and free of unregistered-attribute mutation)?
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from torchmetrics_tpu_torch._analysis.model import SourceInfo

PACKAGE = "torchmetrics_tpu_torch"
METRIC_QUALNAMES = {f"{PACKAGE}.metric.Metric", f"{PACKAGE}.Metric"}

# Container-mutating method names: `self.x.append(...)` counts as mutation
MUTATOR_METHODS = {"append", "extend", "insert", "remove", "pop", "clear", "add", "update", "popitem", "setdefault"}


@dataclass(frozen=True)
class MutationSite:
    """One ``self``-attribute mutation found inside a method body.

    The single source of truth for "what counts as a mutation": both the
    registry's per-class index (certification) and the R1 rule (reporting)
    consume :func:`iter_self_mutations`, so a pattern one side recognizes can
    never silently escape the other (the pre-fix drift: getattr-receiver
    mutations uncertified a class but produced no R1 report).

    ``attr`` is None for dynamic sites (receiver or attribute name not
    statically known). ``kind`` is one of ``"assign"`` (plain/aug/ann
    assignment), ``"item"`` (subscript assignment), ``"call"``
    (``self.x.append(...)``-style mutator), ``"setattr"``
    (``setattr(self, "x", ...)``), ``"getattr-call"``
    (``getattr(self, "x").append(...)``). ``method`` carries the mutator
    method name for the call kinds.
    """

    attr: Optional[str]
    lineno: int
    kind: str
    method: Optional[str] = None


def iter_self_mutations(func: ast.FunctionDef) -> List[MutationSite]:
    """Every ``self``-attribute mutation site in ``func``'s body."""
    out: List[MutationSite] = []
    for sub in ast.walk(func):
        if isinstance(sub, ast.Call):
            fn = sub.func
            # setattr(self, <name>, ...)
            if isinstance(fn, ast.Name) and fn.id == "setattr" and sub.args:
                tgt = sub.args[0]
                if isinstance(tgt, ast.Name) and tgt.id == "self":
                    name_arg = sub.args[1] if len(sub.args) > 1 else None
                    if isinstance(name_arg, ast.Constant) and isinstance(name_arg.value, str):
                        out.append(MutationSite(name_arg.value, sub.lineno, "setattr"))
                    else:
                        out.append(MutationSite(None, sub.lineno, "setattr"))
            # self.<attr>.append(...) / getattr(self, <name>).append(...)
            if isinstance(fn, ast.Attribute) and fn.attr in MUTATOR_METHODS:
                if (
                    isinstance(fn.value, ast.Attribute)
                    and isinstance(fn.value.value, ast.Name)
                    and fn.value.value.id == "self"
                ):
                    out.append(MutationSite(fn.value.attr, sub.lineno, "call", method=fn.attr))
                elif (
                    isinstance(fn.value, ast.Call)
                    and isinstance(fn.value.func, ast.Name)
                    and fn.value.func.id == "getattr"
                    and fn.value.args
                    and isinstance(fn.value.args[0], ast.Name)
                    and fn.value.args[0].id == "self"
                ):
                    name_arg = fn.value.args[1] if len(fn.value.args) > 1 else None
                    if isinstance(name_arg, ast.Constant) and isinstance(name_arg.value, str):
                        out.append(MutationSite(name_arg.value, sub.lineno, "getattr-call", method=fn.attr))
                    else:
                        out.append(MutationSite(None, sub.lineno, "getattr-call", method=fn.attr))
            continue
        targets: Iterable[ast.expr] = ()
        if isinstance(sub, ast.Assign):
            targets = sub.targets
        elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)):
            targets = (sub.target,)
        for tgt in targets:
            for leaf in _assign_leaves(tgt):
                if isinstance(leaf, ast.Attribute) and isinstance(leaf.value, ast.Name) and leaf.value.id == "self":
                    out.append(MutationSite(leaf.attr, leaf.lineno, "assign"))
                elif (
                    isinstance(leaf, ast.Subscript)
                    and isinstance(leaf.value, ast.Attribute)
                    and isinstance(leaf.value.value, ast.Name)
                    and leaf.value.value.id == "self"
                ):
                    out.append(MutationSite(leaf.value.attr, leaf.lineno, "item"))
    return out


@dataclass(frozen=True)
class StateSite:
    """One lexical ``self.add_state(...)`` call site inside a method body.

    The memory prover (``memory.py``) replays these sites symbolically to
    derive per-class byte formulas; ``default`` is the raw default-argument
    expression (None when absent), ``method`` the enclosing method name, and
    ``under_if`` marks config-dependent registration (same branch semantics
    as :func:`_walk_with_branch_flag`). ``name`` is None for dynamic
    (non-literal) state names — the enclosing ``for`` loop, if any, is the
    prover's to unroll.
    """

    name: Optional[str]
    default: Optional[ast.expr]
    reduction: str  # same encoding as ClassInfo.state_reductions values
    lineno: int
    method: str
    under_if: bool


@dataclass
class ClassInfo:
    name: str
    module: str  # dotted module name, e.g. "torchmetrics_tpu_torch.regression.mae"
    path: str  # repo-relative file path
    lineno: int
    base_names: List[str] = field(default_factory=list)  # as written in source
    own_states: Set[str] = field(default_factory=set)  # literal add_state names
    # literal add_state names whose default is a list literal (append-mode
    # "cat" states — they grow on host and pin the class to the eager path);
    # a name in BOTH sets is config-dependent (e.g. list only for
    # `reduction="none"`), which softens the eligibility blocker
    list_states: Set[str] = field(default_factory=set)
    array_states: Set[str] = field(default_factory=set)
    # list registrations nested under an `if` (config-dependent branches like
    # `thresholds=None` / `num_classes=None` / `return_full_image=True`)
    conditional_list_states: Set[str] = field(default_factory=set)
    dynamic_add_state: bool = False  # add_state with a non-literal name
    # literal add_state name -> statically-decided `dist_reduce_fx` kind:
    # a string literal carries through as-is, an absent/None argument becomes
    # "none", and any non-literal expression (a ctor-parameter pass-through, a
    # callable) becomes "?" — the in-graph-sync facet treats "?" as
    # runtime-decidable, not as a blocker
    state_reductions: Dict[str, str] = field(default_factory=dict)
    # reduction kinds of dynamically-named add_state calls (stat-scores style
    # `for name in (...): self.add_state(name, ...)` loops): names are
    # unknown, the reduction kind usually still a literal
    dynamic_state_reductions: Set[str] = field(default_factory=set)
    # class-body function aliases (`_update_fn = staticmethod(f)` style):
    # alias name -> name of the aliased function as written in source
    fn_aliases: Dict[str, str] = field(default_factory=dict)
    sets_validate_args: bool = False
    declares_traced_flags: bool = False
    methods: Dict[str, ast.FunctionDef] = field(default_factory=dict)
    # `self.<plain-attr>` assignment targets per method (mutation candidates)
    mutated_attrs: Dict[str, Set[str]] = field(default_factory=dict)
    dynamic_setattr_methods: Set[str] = field(default_factory=set)
    # every lexical add_state call site, in source order (memory prover input)
    state_sites: List[StateSite] = field(default_factory=list)

    @property
    def qualname(self) -> str:
        return f"{self.module}.{self.name}"


@dataclass
class ModuleInfo:
    module: str
    path: str
    tree: ast.Module
    source: SourceInfo
    imports: Dict[str, str] = field(default_factory=dict)  # local name -> dotted origin
    classes: Dict[str, ClassInfo] = field(default_factory=dict)
    functions: Dict[str, ast.FunctionDef] = field(default_factory=dict)


def _record_imports(tree: ast.Module, module: str, out: Dict[str, str]) -> None:
    pkg_parts = module.split(".")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                out[alias.asname or alias.name.split(".")[0]] = alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                # relative import: resolve against this module's package
                base = pkg_parts[: len(pkg_parts) - node.level]
                origin = ".".join(base + ([node.module] if node.module else []))
            else:
                origin = node.module or ""
            for alias in node.names:
                out[alias.asname or alias.name] = f"{origin}.{alias.name}" if origin else alias.name


def _base_name(expr: ast.expr) -> Optional[str]:
    """Render a base-class expression back to a dotted name (best effort)."""
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        inner = _base_name(expr.value)
        return f"{inner}.{expr.attr}" if inner else None
    if isinstance(expr, ast.Subscript):  # Generic[...] style
        return _base_name(expr.value)
    return None


def _scan_class(node: ast.ClassDef, module: str, path: str) -> ClassInfo:
    info = ClassInfo(
        name=node.name,
        module=module,
        path=path,
        lineno=node.lineno,
        base_names=[b for b in (_base_name(e) for e in node.bases) if b],
    )
    for item in node.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # `_update_fn = staticmethod(_foo)` / `_update_fn = _foo` class
            # attributes dispatch into the functional mirror; the eligibility
            # pass resolves them like direct calls
            if isinstance(item, ast.Assign) and len(item.targets) == 1 and isinstance(item.targets[0], ast.Name):
                value = item.value
                if (
                    isinstance(value, ast.Call)
                    and isinstance(value.func, ast.Name)
                    and value.func.id in ("staticmethod", "classmethod")
                    and value.args
                ):
                    value = value.args[0]
                if isinstance(value, ast.Name):
                    info.fn_aliases[item.targets[0].id] = value.id
            continue
        if isinstance(item, ast.AsyncFunctionDef):
            continue
        info.methods[item.name] = item
        # params whose declared default IS None: `if <param> is None:` branches
        # in this method are then statically decidable as the default config
        none_defaults: Set[str] = set()
        fn_args = list(item.args.posonlyargs) + list(item.args.args)
        defaults = list(item.args.defaults)
        for arg, default in zip(fn_args[len(fn_args) - len(defaults):], defaults):
            if isinstance(default, ast.Constant) and default.value is None:
                none_defaults.add(arg.arg)
        for arg, default in zip(item.args.kwonlyargs, item.args.kw_defaults):
            if isinstance(default, ast.Constant) and default.value is None:
                none_defaults.add(arg.arg)
        for sub, under_if in _walk_with_branch_flag(item.body, False, none_defaults):
            if isinstance(sub, ast.Call):
                fn = sub.func
                # self.add_state("name", ...)
                if (
                    isinstance(fn, ast.Attribute)
                    and fn.attr == "add_state"
                    and isinstance(fn.value, ast.Name)
                    and fn.value.id == "self"
                ):
                    name_arg = sub.args[0] if sub.args else next(
                        (kw.value for kw in sub.keywords if kw.arg == "name"), None
                    )
                    default_arg = sub.args[1] if len(sub.args) > 1 else next(
                        (kw.value for kw in sub.keywords if kw.arg == "default"), None
                    )
                    reduce_arg = sub.args[2] if len(sub.args) > 2 else next(
                        (kw.value for kw in sub.keywords if kw.arg == "dist_reduce_fx"), None
                    )
                    if reduce_arg is None or (
                        isinstance(reduce_arg, ast.Constant) and reduce_arg.value is None
                    ):
                        reduction = "none"
                    elif isinstance(reduce_arg, ast.Constant) and isinstance(reduce_arg.value, str):
                        reduction = reduce_arg.value
                    else:
                        reduction = "?"  # ctor pass-through / callable: runtime-decidable
                    literal_name: Optional[str] = None
                    if isinstance(name_arg, ast.Constant) and isinstance(name_arg.value, str):
                        literal_name = name_arg.value
                        info.own_states.add(name_arg.value)
                        info.state_reductions.setdefault(name_arg.value, reduction)
                        if isinstance(default_arg, ast.List):
                            info.list_states.add(name_arg.value)
                            if under_if:
                                info.conditional_list_states.add(name_arg.value)
                        else:
                            info.array_states.add(name_arg.value)
                    else:
                        info.dynamic_add_state = True
                        info.dynamic_state_reductions.add(reduction)
                    info.state_sites.append(
                        StateSite(
                            name=literal_name,
                            default=default_arg,
                            reduction=reduction,
                            lineno=sub.lineno,
                            method=item.name,
                            under_if=under_if,
                        )
                    )
        # the mutation index and the R1 rule share one walker (MutationSite),
        # so certification and reporting can never drift apart again
        mutated: Set[str] = set()
        for site in iter_self_mutations(item):
            if site.attr is None:
                info.dynamic_setattr_methods.add(item.name)
                continue
            mutated.add(site.attr)
            if site.kind == "assign" and site.attr == "validate_args":
                info.sets_validate_args = True
        if mutated:
            info.mutated_attrs[item.name] = mutated
    info.declares_traced_flags = "_traced_value_flags" in info.methods
    return info


class Registry:
    """Index of every scanned module, with chain-resolution helpers."""

    def __init__(self) -> None:
        self.modules: Dict[str, ModuleInfo] = {}
        # class qualname -> ClassInfo for direct lookup
        self.classes: Dict[str, ClassInfo] = {}

    def add_module(self, module: str, path: str, tree: ast.Module, source: SourceInfo) -> ModuleInfo:
        mod = ModuleInfo(module=module, path=path, tree=tree, source=source)
        _record_imports(tree, module, mod.imports)
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                info = _scan_class(node, module, path)
                mod.classes[node.name] = info
                self.classes[info.qualname] = info
            elif isinstance(node, ast.FunctionDef):
                mod.functions[node.name] = node
        self.modules[module] = mod
        return mod

    # ------------------------------------------------------------ resolution
    def resolve_base(self, owner: ClassInfo, base_name: str) -> Optional[ClassInfo]:
        """Resolve a base written as ``base_name`` inside ``owner``'s module."""
        mod = self.modules.get(owner.module)
        if mod is None:
            return None
        head, _, rest = base_name.partition(".")
        # same-module class
        if not rest and head in mod.classes:
            return mod.classes[head]
        origin = mod.imports.get(head)
        if origin is None:
            return None
        dotted = f"{origin}.{rest}" if rest else origin
        # `from x import Cls` -> dotted is already module.Cls;
        # `import x.y as z; z.Cls` -> origin is module, rest the class
        if dotted in self.classes:
            return self.classes[dotted]
        # `from torchmetrics_tpu_torch import Metric` style re-export
        if dotted in METRIC_QUALNAMES:
            return None
        # try interpreting the last segment as a class re-exported via __init__
        cls_name = dotted.rsplit(".", 1)[-1]
        for qual, info in self.classes.items():
            if info.name == cls_name and qual.endswith(f".{cls_name}"):
                # unique name match only — ambiguity means unresolved
                matches = [i for i in self.classes.values() if i.name == cls_name]
                if len(matches) == 1:
                    return matches[0]
                return None
        return None

    def base_is_metric(self, owner: ClassInfo, base_name: str) -> bool:
        mod = self.modules.get(owner.module)
        if base_name == "Metric":
            return True
        if mod is not None:
            origin = mod.imports.get(base_name.partition(".")[0])
            if origin in METRIC_QUALNAMES:
                return True
            dotted = origin or base_name
            if dotted in METRIC_QUALNAMES or base_name in METRIC_QUALNAMES:
                return True
        return False

    def chain(self, cls: ClassInfo) -> Tuple[List[ClassInfo], bool, bool]:
        """Static ancestor chain of ``cls`` inside the scanned tree.

        Returns ``(chain, reaches_metric, fully_resolved)`` where ``chain``
        includes ``cls`` itself and every resolvable ancestor (depth-first,
        de-duplicated), ``reaches_metric`` is True when some branch bottoms
        out at the trusted ``Metric`` base, and ``fully_resolved`` is False
        when any base could not be resolved to a scanned class or Metric.
        """
        out: List[ClassInfo] = []
        seen: Set[str] = set()
        reaches_metric = False
        fully_resolved = True
        stack = [cls]
        while stack:
            cur = stack.pop()
            if cur.qualname in seen:
                continue
            seen.add(cur.qualname)
            out.append(cur)
            for base in cur.base_names:
                if self.base_is_metric(cur, base):
                    reaches_metric = True
                    continue
                if base in ("ABC", "abc.ABC", "object", "Generic", "Protocol"):
                    continue
                resolved = self.resolve_base(cur, base)
                if resolved is None:
                    fully_resolved = False
                else:
                    stack.append(resolved)
        return out, reaches_metric, fully_resolved

    def is_metric_subclass(self, cls: ClassInfo) -> bool:
        _, reaches, _ = self.chain(cls)
        return reaches

    def registered_states(self, cls: ClassInfo) -> Tuple[Set[str], bool]:
        """All literal ``add_state`` names along the chain, plus a flag that
        is True when any chain class registers states dynamically (in which
        case R1 cannot be decided soundly and the class is not certified)."""
        chain, _, fully_resolved = self.chain(cls)
        states: Set[str] = set()
        dynamic = not fully_resolved
        for c in chain:
            states |= c.own_states
            dynamic = dynamic or c.dynamic_add_state
        return states, dynamic

    def state_reductions(self, cls: ClassInfo) -> Tuple[Dict[str, str], Set[str]]:
        """``(name -> reduction-kind, dynamic-call reduction kinds)`` along the chain.

        Chain order is subclass-first, so a re-registered name keeps the
        most-derived declaration. Kinds are the literal ``dist_reduce_fx``
        strings, ``"none"`` for an absent/None argument, and ``"?"`` for a
        non-literal expression (decidable only at runtime from the live
        instance's ``_reductions``).
        """
        chain, _, fully_resolved = self.chain(cls)
        reductions: Dict[str, str] = {}
        dynamic: Set[str] = set()
        for c in chain:
            for name, kind in c.state_reductions.items():
                reductions.setdefault(name, kind)
            dynamic |= c.dynamic_state_reductions
        if not fully_resolved:
            dynamic.add("?")  # an unscanned base may register anything
        return reductions, dynamic

    def declares_traced_flags(self, cls: ClassInfo) -> bool:
        chain, _, _ = self.chain(cls)
        return any(c.declares_traced_flags for c in chain)

    def list_states(self, cls: ClassInfo) -> Tuple[Set[str], Set[str]]:
        """``(always_list, config_dependent)`` append-mode state names.

        A name registered with a list default in one branch and an array
        default in another (``reduction="none"`` idiom) is config-dependent:
        the default configuration may still compile.
        """
        chain, _, _ = self.chain(cls)
        lists: Set[str] = set()
        arrays: Set[str] = set()
        conditional: Set[str] = set()
        for c in chain:
            lists |= c.list_states
            arrays |= c.array_states
            conditional |= c.conditional_list_states
        return lists - arrays - conditional, lists & (arrays | conditional)

    def resolve_method(self, cls: ClassInfo, name: str) -> Optional[Tuple[ClassInfo, ast.FunctionDef]]:
        """First definition of method ``name`` along ``cls``'s static chain."""
        chain, _, _ = self.chain(cls)
        for c in chain:
            if name in c.methods:
                return c, c.methods[name]
        return None

    def resolve_function(self, module: str, name: str) -> Optional[Tuple["ModuleInfo", ast.FunctionDef]]:
        """Resolve a bare function name used inside ``module`` to its def.

        Looks at same-module functions first, then follows ``from x import f``
        imports into other indexed modules (the class → functional-mirror →
        utilities edge the eligibility pass walks).
        """
        mod = self.modules.get(module)
        if mod is None:
            return None
        if name in mod.functions:
            return mod, mod.functions[name]
        origin = mod.imports.get(name)
        if origin is None:
            return None
        owner_mod, _, fname = origin.rpartition(".")
        owner = self.modules.get(owner_mod)
        if owner is not None and fname in owner.functions:
            return owner, owner.functions[fname]
        # `from package import module` then `module.f` is resolved by the
        # caller via resolve_module_attr; a dotted origin naming a module
        # re-exported function lands here
        whole = self.modules.get(origin)
        if whole is not None and name in whole.functions:  # pragma: no cover
            return whole, whole.functions[name]
        return None

    def resolve_module_attr(self, module: str, head: str, attr: str) -> Optional[Tuple["ModuleInfo", ast.FunctionDef]]:
        """Resolve ``head.attr`` calls where ``head`` is an imported module."""
        mod = self.modules.get(module)
        if mod is None:
            return None
        origin = mod.imports.get(head)
        if origin is None:
            return None
        owner = self.modules.get(origin)
        if owner is not None and attr in owner.functions:
            return owner, owner.functions[attr]
        return None


def _none_default_test(test: ast.expr, none_defaults: Set[str]) -> Optional[bool]:
    """For ``x is None`` / ``x is not None`` tests on a parameter whose
    declared default IS None: True when the BODY is the default-config branch,
    False when the ELSE is. None when undecidable."""
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1 and isinstance(test.left, ast.Name)):
        return None
    if test.left.id not in none_defaults:
        return None
    comparator = test.comparators[0]
    if not (isinstance(comparator, ast.Constant) and comparator.value is None):
        return None
    if isinstance(test.ops[0], ast.Is):
        return True
    if isinstance(test.ops[0], ast.IsNot):
        return False
    return None


def _walk_with_branch_flag(
    body: Iterable[ast.stmt], under_if: bool, none_defaults: Optional[Set[str]] = None
) -> Iterable[Tuple[ast.AST, bool]]:
    """Yield every AST node in ``body`` with a flag marking whether it sits
    under a config-dependent ``if``/``else`` branch.

    The one statically-decidable case keeps its default branch unconditional:
    ``if x is None:`` where parameter ``x`` defaults to None (the
    ``thresholds=None`` idiom) — its body IS the out-of-the-box path.
    """
    none_defaults = none_defaults or set()
    for stmt in body:
        if isinstance(stmt, ast.If):
            for node in ast.walk(stmt.test):
                yield node, under_if
            default_is_body = _none_default_test(stmt.test, none_defaults)
            body_flag = under_if if default_is_body is True else True
            else_flag = under_if if default_is_body is False else True
            yield from _walk_with_branch_flag(stmt.body, body_flag, none_defaults)
            yield from _walk_with_branch_flag(stmt.orelse, else_flag, none_defaults)
        elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            yield stmt, under_if
            yield from _walk_with_branch_flag(
                list(getattr(stmt, "body", [])) + list(getattr(stmt, "orelse", [])), under_if, none_defaults
            )
            for node in ast.walk(stmt.iter if isinstance(stmt, (ast.For, ast.AsyncFor)) else stmt.test):
                yield node, under_if
        elif isinstance(stmt, (ast.With, ast.Try)):
            inner = list(getattr(stmt, "body", [])) + list(getattr(stmt, "orelse", [])) + list(
                getattr(stmt, "finalbody", [])
            )
            for handler in getattr(stmt, "handlers", []):
                inner += list(handler.body)
            yield from _walk_with_branch_flag(inner, under_if, none_defaults)
        else:
            for node in ast.walk(stmt):
                yield node, under_if


def _assign_leaves(tgt: ast.expr) -> Iterable[ast.expr]:
    if isinstance(tgt, (ast.Tuple, ast.List)):
        for elt in tgt.elts:
            yield from _assign_leaves(elt)
    elif isinstance(tgt, ast.Starred):
        yield from _assign_leaves(tgt.value)
    else:
        yield tgt
