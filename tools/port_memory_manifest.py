"""Write the port's stream-pool admission data from the JAX package's manifests.

Run from the repository root:

    python tools/port_memory_manifest.py

It writes, under ``torchmetrics_tpu_torch/``:

- ``_eligibility.json["in_graph_sync"]``: each class's ``in_graph_sync``
  verdict from ``torchmetrics_tpu/_analysis/eligibility.json``, under the
  port's qualname (``classes`` is left as it is);
- ``_memory.json``: each class's state formulas from
  ``torchmetrics_tpu/_analysis/memory.json``, priced in the port's state
  dtypes. Each class is built on the CPU with small constructor arguments,
  and a state whose registered default has another item size than the JAX
  record's dtype gets its terms scaled by the ratio (an int64 count doubles
  the JAX package's int32 bytes). A class that cannot be built here keeps
  the JAX terms, with ``"port_dtypes_checked": false``.

Both JAX files are read as JSON; nothing of the JAX package is imported.
``tests/test_torch_streams_golden_sweep.py`` fails when the checked-in files
differ from what this tool writes (a state's dtype changed in the port, or
the JAX manifests moved): run it again then.
"""

from __future__ import annotations

import importlib
import inspect
import json
import sys
import warnings
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

JAX_ANALYSIS = REPO / "torchmetrics_tpu" / "_analysis"
PORT = REPO / "torchmetrics_tpu_torch"

# what a required constructor argument takes when a class is built to read its state dtypes
_ARGS = {
    "num_classes": 3, "num_labels": 3, "num_groups": 2, "num_outputs": 1, "p": 2.0, "num_tasks": 1, "beta": 1.0,
    "threshold": 0.5, "min_precision": 0.5, "min_recall": 0.5, "min_sensitivity": 0.5, "min_specificity": 0.5,
}


def _port_name(qualname: str) -> str:
    return qualname.replace("torchmetrics_tpu.", "torchmetrics_tpu_torch.", 1)


def _build(qualname: str):
    module, _, name = qualname.rpartition(".")
    try:
        cls = getattr(importlib.import_module(module), name)
    except (ImportError, AttributeError):
        return None
    kwargs = {}
    # a constructor that passes `*args` on takes the parameters of the first one up the MRO that names them
    init = next(
        k.__init__ for k in cls.__mro__
        if not any(q.kind == q.VAR_POSITIONAL for q in inspect.signature(k.__init__).parameters.values())
    )
    for param in inspect.signature(init).parameters.values():
        if param.name == "self" or param.kind in (param.VAR_POSITIONAL, param.VAR_KEYWORD):
            continue
        if param.default is inspect.Parameter.empty:
            if param.name not in _ARGS:
                return None
            kwargs[param.name] = _ARGS[param.name]
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return cls(device="cpu", **kwargs)
    except Exception:  # noqa: BLE001 - a class that needs more than small defaults keeps the JAX terms
        return None


def payloads():
    """``(eligibility, memory, rescaled, not_built)``: both files' contents as this tool writes them, and what it did."""
    eligibility = json.loads((JAX_ANALYSIS / "eligibility.json").read_text())["classes"]
    port_elig = json.loads((PORT / "_eligibility.json").read_text())
    port_elig["in_graph_sync"] = {
        _port_name(q): (v.get("in_graph_sync") or {}).get("verdict", "")
        for q, v in sorted(eligibility.items())
        if v.get("in_graph_sync")
    }

    memory = json.loads((JAX_ANALYSIS / "memory.json").read_text())["classes"]
    out, scaled, unchecked = {}, [], []
    for qualname, entry in sorted(memory.items()):
        port_q = _port_name(qualname)
        metric = _build(port_q)
        states = []
        for state in entry.get("states", ()):
            record = {k: state[k] for k in ("name", "kind", "conditional", "dtype") if k in state}
            terms = [dict(t) for t in state.get("terms", ())]
            default = None if metric is None else getattr(metric, "_defaults", {}).get(state.get("name"))
            if state.get("kind") == "array" and hasattr(default, "dtype") and "dtype" in state:
                jax_size = np.dtype(state["dtype"]).itemsize
                port_size = default.element_size()
                record["dtype"] = str(default.dtype).replace("torch.", "")
                if port_size != jax_size:
                    for t in terms:
                        t["coeff"] = t.get("coeff", 0.0) * port_size / jax_size
                    scaled.append(f"{port_q}.{state['name']}")
            if terms:
                record["terms"] = terms
            states.append(record)
        item = {"verdict": entry.get("verdict"), "peak_factor": entry.get("peak_factor", 1.0), "states": states}
        if metric is None:
            item["port_dtypes_checked"] = False
            unchecked.append(port_q)
        out[port_q] = item
    payload = {
        "classes": out,
        "source": "torchmetrics_tpu/_analysis/memory.json, priced in the port's state dtypes by tools/port_memory_manifest.py",
        "version": 1,
    }
    return port_elig, payload, scaled, unchecked


def dump(payload: dict) -> str:
    return json.dumps(payload, indent=1, sort_keys=True) + "\n"


def main() -> None:
    port_elig, payload, scaled, unchecked = payloads()
    (PORT / "_eligibility.json").write_text(dump(port_elig))
    (PORT / "_memory.json").write_text(dump(payload))
    out = payload["classes"]
    print(f"{len(out)} classes, {len(scaled)} states rescaled to the port's dtypes, {len(unchecked)} classes not built")
    for name in scaled:
        print("  rescaled", name)
    for name in unchecked:
        print("  not built", name)


if __name__ == "__main__":
    main()
