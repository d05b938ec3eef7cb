"""Compiled-path rules: R2 (host-sync leak), R3 (tensor control flow), and
R4 (value-dependent shapes).

All three only fire on *tainted* expressions: values flowing from batch
arguments or registered states, i.e. the tensors a compiled step holds in
its CUDA graph's buffers (see ``taint.py``). Functions marked
``# lint: eager-helper`` on their ``def`` line are host-by-design and
skipped wholesale.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from torchmetrics_tpu_torch._analysis.model import SourceInfo, Violation
from torchmetrics_tpu_torch._analysis.taint import HOST_CONVERTERS, TaintTracker

NUMPY_MODULE_ALIASES = {"np", "numpy"}

# torch ops whose output shape depends on data values: each reads a count
# back to the host before it can allocate its output
DATA_DEPENDENT_SHAPE_FNS = {"unique", "unique_consecutive", "nonzero", "argwhere", "masked_select"}

# the same hazard where only some arguments make it one: `repeat_interleave`
# with a tensor of repeats sums them on the host (an int repeat is static,
# and `output_size=` removes the read)
_REPEATS_FNS = {"repeat_interleave"}

# tensor methods that copy a device value to the host
HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}

# keywords that fix an output size up front and so remove the R4 hazard
_STATIC_SIZE_KWARGS = {"size", "output_size"}


def check_traced_function(
    func: ast.FunctionDef,
    source: SourceInfo,
    scope: str,
    tainted_self_attrs: Set[str],
    is_method: bool,
) -> List[Violation]:
    """Run R2/R3/R4 over one compiled-path function (method or functional kernel)."""
    if source.is_eager_helper(func.lineno):
        return []
    tracker = TaintTracker(func, tainted_self_attrs, is_method=is_method)
    out: List[Violation] = []

    def emit(rule_id: str, lineno: int, message: str) -> None:
        v = source.violation(rule_id, lineno, scope, message)
        if v:
            out.append(v)

    for node in ast.walk(func):
        if isinstance(node, ast.Call):
            _check_call(node, tracker, emit)
        elif isinstance(node, (ast.If, ast.While)):
            if tracker.is_tainted(node.test):
                kind = "if" if isinstance(node, ast.If) else "while"
                emit(
                    "R3", node.lineno,
                    f"python `{kind}` branches on a tensor value (`Tensor.__bool__` syncs the card)"
                    " — use `torch.where` to stay on device",
                )
        elif isinstance(node, ast.Assert):
            if tracker.is_tainted(node.test):
                emit("R3", node.lineno, "`assert` on a tensor value syncs the card and breaks a graph capture")
        elif isinstance(node, ast.IfExp):
            if tracker.is_tainted(node.test):
                emit(
                    "R3", node.lineno,
                    "conditional expression branches on a tensor value — use `torch.where` instead",
                )
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
            for gen in node.generators:
                for cond in gen.ifs:
                    if tracker.is_tainted(cond):
                        emit("R3", cond.lineno, "comprehension filters on a tensor value")
        elif isinstance(node, ast.Subscript) and not isinstance(node.ctx, ast.Store):
            _check_bool_mask_index(node, tracker, emit)
    return out


def _call_name(fn: ast.expr) -> Optional[str]:
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def _module_of(fn: ast.expr) -> Optional[str]:
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
        return fn.value.id
    return None


def _check_call(node: ast.Call, tracker: TaintTracker, emit) -> None:
    fn = node.func
    name = _call_name(fn)
    mod = _module_of(fn)
    any_tainted_arg = any(tracker.is_tainted(a) for a in node.args) or any(
        tracker.is_tainted(kw.value) for kw in node.keywords
    )

    # R2: python scalar conversion of a tensor value
    if isinstance(fn, ast.Name) and fn.id in HOST_CONVERTERS and any_tainted_arg:
        emit(
            "R2", node.lineno,
            f"`{fn.id}()` on a tensor value copies it to the host: a card sync per call, and a"
            " value frozen into (or a failed) graph capture",
        )
        return
    # R2: .item()/.tolist()/.cpu()/.numpy() on a tensor value
    if isinstance(fn, ast.Attribute) and fn.attr in HOST_SYNC_METHODS and tracker.is_tainted(fn.value):
        emit("R2", node.lineno, f"`.{fn.attr}()` on a tensor value forces a blocking host copy")
        return
    # R2: numpy applied to tensor values (silently copies to host)
    if mod in NUMPY_MODULE_ALIASES and any_tainted_arg:
        emit(
            "R2", node.lineno,
            f"`{mod}.{name}` on a tensor value pulls it to the host — use the `torch` equivalent",
        )
        return

    # R4: value-dependent output shapes, as `torch.<op>(x)` or `x.<op>()`. A
    # static size keyword removes the hazard.
    if any(kw.arg in _STATIC_SIZE_KWARGS for kw in node.keywords):
        return
    is_function = mod == "torch" or isinstance(fn, ast.Name)
    receiver_tainted = isinstance(fn, ast.Attribute) and not is_function and tracker.is_tainted(fn.value)
    if not (is_function or receiver_tainted):
        return
    if name in DATA_DEPENDENT_SHAPE_FNS and (any_tainted_arg or receiver_tainted):
        emit(
            "R4", node.lineno,
            f"`{name}` has a value-dependent output shape: it reads a count back to the host and"
            " cannot be captured (use masking, or mark the enclosing helper `# lint: eager-helper`)",
        )
        return
    if name in _REPEATS_FNS:
        repeats = node.args[1] if is_function and len(node.args) > 1 else node.args[0] if not is_function and node.args else None
        repeats = next((kw.value for kw in node.keywords if kw.arg == "repeats"), repeats)
        if repeats is not None and tracker.is_tainted(repeats):
            emit(
                "R4", node.lineno,
                "`repeat_interleave` with tensor repeats sums them on the host — pass `output_size=`",
            )
        return
    if name == "where" and is_function and len(node.args) == 1 and any_tainted_arg:
        emit(
            "R4", node.lineno,
            "single-argument `where` is `nonzero` in disguise — value-dependent output shape",
        )


def _check_bool_mask_index(node: ast.Subscript, tracker: TaintTracker, emit) -> None:
    """``x[mask]`` with a boolean mask: output length = number of True values."""
    sl = node.slice
    if not tracker.is_tainted(node.value) or not tracker.is_tainted(sl):
        return
    boolean_shaped = isinstance(sl, (ast.Compare, ast.BoolOp)) or (
        isinstance(sl, ast.UnaryOp) and isinstance(sl.op, ast.Invert)
    )
    if boolean_shaped:
        emit(
            "R4", node.lineno,
            "boolean-mask indexing on tensor values has a value-dependent output shape —"
            " use `torch.where(mask, x, fill)` to keep shapes static",
        )
