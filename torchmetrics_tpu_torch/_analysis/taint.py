"""Lightweight intra-function taint inference for tensor values.

A value is *tainted* when it (may) be a ``torch.Tensor`` flowing in from
the function's batch arguments or from registered metric states: exactly
the values a compiled step holds in its CUDA graph's buffers when the
surrounding ``update``/``compute``/kernel is captured. The compiled-path
rules (R2/R3/R4) only fire on tainted expressions, which is what keeps the
analyzer quiet on the host-by-design code (string kernels taking
``Sequence[str]``, config ints, ``.shape`` arithmetic).

The model is deliberately simple — one forward pass per statement in source
order, no fixpoint iteration, containers taint as a whole — because metric
``update`` bodies are short and straight-line. Loops get two passes so taint
introduced at the bottom of a loop body reaches uses at the top.
"""

from __future__ import annotations

import ast
from typing import Optional, Set

# attribute reads that launder taint away: a tensor's metadata lives on the
# host and reading it never touches the card
SANITIZER_ATTRS = {"shape", "ndim", "dtype", "itemsize", "device", "is_cuda", "layout", "name", "names"}

# calls that always return host scalars/metadata regardless of args; torch
# spells a tensor's size, element count and rank as calls (`x.size(0)`,
# `x.numel()`, `x.dim()`), where the JAX arrays carry them as attributes
SANITIZER_CALLS = {
    "len", "isinstance", "hasattr", "callable", "type", "id", "repr", "str", "format",
    "ndim", "shape", "size", "numel", "nelement", "dim", "ndimension", "element_size",
    "stride", "is_floating_point", "is_complex", "get_device",
}

# explicit host-converting calls: their *call* is the R2 hazard, but the
# result is a concrete python scalar — treating it as clean keeps each
# site to exactly one finding instead of cascading R3s off the result
HOST_CONVERTERS = {"float", "int", "bool", "complex"}

# naming-convention predicates (`is_*`, `_try_*`, ...) return host booleans
PREDICATE_PREFIXES = {"is", "has", "should", "can", "try"}

_SCALAR_LEAVES = {
    "int", "float", "bool", "str", "bytes", "complex", "None", "NoneType", "type",
    "Literal", "Callable", "Enum",
    # numpy arrays are host values by definition: never a device tensor
    "ndarray",
}
_WRAPPERS = {"Optional", "Union", "Sequence", "List", "Tuple", "Dict", "Mapping", "Set", "FrozenSet", "Iterable", "Collection"}


def annotation_is_host_only(ann: Optional[ast.expr]) -> bool:
    """True when a parameter annotation guarantees a host (non-tensor) value.

    Unannotated or array-ish (``Array``, ``Any``, unions containing arrays)
    parameters are conservatively treated as tensors.
    """
    if ann is None:
        return False
    leaves: Set[str] = set()

    def walk(e: ast.expr) -> bool:
        if isinstance(e, ast.Name):
            if e.id in _WRAPPERS:
                return True
            leaves.add(e.id)
            return True
        if isinstance(e, ast.Attribute):  # typing.Optional, enums, torch.Tensor
            leaves.add(e.attr)
            return True
        if isinstance(e, ast.Constant):
            if e.value is None or e.value is Ellipsis:
                leaves.add("None")
                return True
            if isinstance(e.value, str):  # string annotation: re-parse
                try:
                    return walk(ast.parse(e.value, mode="eval").body)
                except SyntaxError:
                    return False
            leaves.add(type(e.value).__name__)
            return True
        if isinstance(e, ast.Subscript):
            if not walk(e.value):
                return False
            return walk(e.slice)
        if isinstance(e, ast.Tuple):
            return all(walk(elt) for elt in e.elts)
        if isinstance(e, ast.BinOp) and isinstance(e.op, ast.BitOr):  # X | Y unions
            return walk(e.left) and walk(e.right)
        if isinstance(e, ast.Index):  # py<3.9 compat nodes in old trees
            return walk(e.value)  # pragma: no cover
        return False

    if not walk(ann):
        return False
    leaves -= _WRAPPERS
    return bool(leaves) and leaves <= _SCALAR_LEAVES


class TaintTracker(ast.NodeVisitor):
    """Infers the set of tainted local names for one function body."""

    def __init__(self, func: ast.FunctionDef, tainted_self_attrs: Set[str], is_method: bool) -> None:
        self.tainted: Set[str] = set()
        self.tainted_self_attrs = set(tainted_self_attrs)
        args = func.args
        params = list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
        if is_method and params and params[0].arg in ("self", "cls"):
            params = params[1:]
        for p in params:
            if not annotation_is_host_only(p.annotation):
                self.tainted.add(p.arg)
        if args.vararg is not None and not annotation_is_host_only(args.vararg.annotation):
            self.tainted.add(args.vararg.arg)
        if args.kwarg is not None and not annotation_is_host_only(args.kwarg.annotation):
            self.tainted.add(args.kwarg.arg)
        # two passes over the body so back-edges (loop carried taint) settle
        for _ in range(2):
            for stmt in func.body:
                self._stmt(stmt)

    # ------------------------------------------------------------ statements
    def _stmt(self, node: ast.stmt) -> None:
        if isinstance(node, ast.Assign):
            t = self.is_tainted(node.value)
            for tgt in node.targets:
                self._bind(tgt, t)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            host_only = annotation_is_host_only(node.annotation)
            self._bind(node.target, self.is_tainted(node.value) and not host_only)
        elif isinstance(node, ast.AugAssign):
            if self.is_tainted(node.value) and isinstance(node.target, ast.Name):
                self.tainted.add(node.target.id)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            self._bind(node.target, self.is_tainted(node.iter))
            for s in node.body + node.orelse:
                self._stmt(s)
        elif isinstance(node, (ast.While, ast.If)):
            for s in node.body + node.orelse:
                self._stmt(s)
        elif isinstance(node, ast.With):
            for item in node.items:
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, self.is_tainted(item.context_expr))
            for s in node.body:
                self._stmt(s)
        elif isinstance(node, ast.Try):
            for s in node.body + node.orelse + node.finalbody:
                self._stmt(s)
            for handler in node.handlers:
                for s in handler.body:
                    self._stmt(s)
        elif isinstance(node, ast.FunctionDef):
            # nested defs (vmapped closures): names bound there stay local
            pass

    def _bind(self, tgt: ast.expr, tainted: bool) -> None:
        if isinstance(tgt, ast.Name):
            if tainted:
                self.tainted.add(tgt.id)
            else:
                self.tainted.discard(tgt.id)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for elt in tgt.elts:
                self._bind(elt, tainted)
        elif isinstance(tgt, ast.Starred):
            self._bind(tgt.value, tainted)
        elif isinstance(tgt, ast.Attribute):
            if isinstance(tgt.value, ast.Name) and tgt.value.id == "self" and tainted:
                self.tainted_self_attrs.add(tgt.attr)
        # subscript writes don't change the container's taint

    # ----------------------------------------------------------- expressions
    def is_tainted(self, node: Optional[ast.expr]) -> bool:
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Attribute):
            if node.attr in SANITIZER_ATTRS:
                return False
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                return node.attr in self.tainted_self_attrs
            return self.is_tainted(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_tainted(node.value)
        if isinstance(node, (ast.BinOp,)):
            return self.is_tainted(node.left) or self.is_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tainted(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.is_tainted(v) for v in node.values)
        if isinstance(node, ast.Compare):
            # identity tests (`x is None`) read object metadata, never values
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            # `"key" in target`: dict-key membership probes structure, not data
            if (
                all(isinstance(op, (ast.In, ast.NotIn)) for op in node.ops)
                and isinstance(node.left, ast.Constant)
                and isinstance(node.left.value, str)
            ):
                return False
            return self.is_tainted(node.left) or any(self.is_tainted(c) for c in node.comparators)
        if isinstance(node, ast.Call):
            return self._call_tainted(node)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.is_tainted(e) for e in node.elts)
        if isinstance(node, ast.Dict):
            return any(self.is_tainted(v) for v in list(node.keys) + list(node.values) if v is not None)
        if isinstance(node, ast.IfExp):
            return self.is_tainted(node.body) or self.is_tainted(node.orelse)
        if isinstance(node, ast.Starred):
            return self.is_tainted(node.value)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)):
            # iterating a tainted container yields tainted loop variables, but
            # the comprehension's taint is decided by what it *produces*
            for gen in node.generators:
                self._bind(gen.target, self.is_tainted(gen.iter))
            if isinstance(node, ast.DictComp):
                return self.is_tainted(node.key) or self.is_tainted(node.value)
            return self.is_tainted(node.elt)
        if isinstance(node, ast.JoinedStr):
            return False
        if isinstance(node, ast.Lambda):
            return False
        if isinstance(node, ast.NamedExpr):
            t = self.is_tainted(node.value)
            self._bind(node.target, t)
            return t
        return False

    def _call_tainted(self, node: ast.Call) -> bool:
        fn = node.func
        name = fn.id if isinstance(fn, ast.Name) else fn.attr if isinstance(fn, ast.Attribute) else None
        if name in SANITIZER_CALLS or name in HOST_CONVERTERS:
            return False
        if name is not None and name.lstrip("_").split("_")[0] in PREDICATE_PREFIXES:
            # `is_/has_/should_/can_/try_`-style predicates return host bools
            return False
        if name in ("item", "tolist", "cpu", "numpy"):
            # host converters as methods: the call is the hazard, result clean
            return False
        args_tainted = any(self.is_tainted(a) for a in node.args) or any(
            self.is_tainted(kw.value) for kw in node.keywords
        )
        if isinstance(fn, ast.Attribute):
            # method call on a tainted object (x.sum(), x.to(...)) — or a
            # module function fed tainted args (torch.sum(preds))
            return args_tainted or self.is_tainted(fn.value)
        return args_tainted
