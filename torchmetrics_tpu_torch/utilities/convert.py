"""Carry a metric's accumulated state, and a trunk's weights, from the JAX package into this one.

``torchmetrics_tpu``'s ``Metric.state_dict(all_states=True)`` returns host
numpy arrays (or lists of them for append-mode states) under the state names.
The port registers the same names, so the mapping is a copy onto the device;
:meth:`torchmetrics_tpu_torch.metric.Metric.load_state_dict` takes the result.
Trunk weights come as the JAX package's flat ``.npz`` variables; see below.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor


def state_from_jax(
    state: Dict[str, Union[np.ndarray, List[np.ndarray]]], device: Union[str, torch.device]
) -> Dict[str, Union[Tensor, List[Tensor]]]:
    """Copy a JAX metric's ``state_dict(all_states=True)`` onto ``device`` as tensors.

    Dtypes are kept as numpy gives them (int32 counts stay int32). A checkpoint
    saved with ``integrity=True`` carries a non-identifier ``#integrity`` key
    whose check is not ported yet, so it is refused rather than dropped.
    """
    out: Dict[str, Union[Tensor, List[Tensor]]] = {}
    for key, value in state.items():
        if not key.replace(".", "_").isidentifier():
            raise ValueError(f"Cannot carry over state entry {key!r}: integrity blocks are not supported yet")
        if isinstance(value, list):
            out[key] = [torch.tensor(np.asarray(v), device=device) for v in value]
        else:
            out[key] = torch.tensor(np.asarray(value), device=device)
    return out


# ----------------------------------------------------------------- weights
#
# The JAX package's trunks take converted checkpoints as a flat ``.npz``
# ``{"collection/module/.../leaf": array}`` (``tools/convert_weights.py``).
# The port's trunks name their submodules after the flax modules, so a flax
# path maps onto a ``state_dict`` key leaf by leaf: conv kernels HWIO -> OIHW,
# Dense kernels ``(in, out)`` -> ``(out, in)``, BatchNorm ``scale`` -> ``weight``
# and ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``.

_COLLECTIONS = ("params", "batch_stats")
_BN_TO_TORCH = {
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}
_BN_TO_FLAX = {v: k for k, v in _BN_TO_TORCH.items()}


def load_variables_npz(path: str) -> Dict[str, np.ndarray]:
    """The flat ``{path: array}`` mapping of a converted ``.npz``, read with numpy."""
    with np.load(path) as data:
        return {key: data[key] for key in data.files}


def _route(key: str) -> Tuple[str, List[str]]:
    """``(collection, module path + leaf)`` of a flat key; a bare key is a parameter, as in the JAX package."""
    parts = key.split("/")
    if parts[0] in _COLLECTIONS:
        return parts[0], parts[1:]
    return "params", parts


def state_dict_from_variables(flat: Mapping[str, np.ndarray], collections: Sequence[str] = _COLLECTIONS) -> Dict[str, Tensor]:
    """The port's ``state_dict`` of the flax variables in ``flat`` that belong to ``collections``."""
    out: Dict[str, Tensor] = {}
    for key, value in flat.items():
        collection, path = _route(key)
        if collection not in collections:
            continue
        *modules, leaf = path
        arr = np.asarray(value)
        if modules and modules[-1].startswith("BatchNorm"):
            if (collection, leaf) not in _BN_TO_TORCH:
                raise KeyError(f"Unknown BatchNorm entry {key!r}")
            name = _BN_TO_TORCH[(collection, leaf)]
        elif collection == "params" and leaf == "kernel":
            name = "weight"
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        elif collection == "params" and leaf == "bias":
            name = "bias"
        else:
            raise KeyError(f"Cannot map flax variable {key!r} onto a torch parameter")
        out[".".join([*modules, name])] = torch.from_numpy(np.array(arr))  # a writable copy
    return out


def variables_from_state_dict(state: Mapping[str, Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of :func:`state_dict_from_variables`: a port ``state_dict`` as flat flax variables."""
    out: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        *modules, name = key.split(".")
        arr = value.detach().cpu().numpy()
        if modules and modules[-1].startswith("BatchNorm"):
            collection, leaf = _BN_TO_FLAX[name]
        elif name == "weight":
            collection, leaf = "params", "kernel"
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        elif name == "bias":
            collection, leaf = "params", "bias"
        else:
            raise KeyError(f"Cannot map state entry {key!r} onto a flax variable")
        out["/".join([collection, *modules, leaf])] = np.ascontiguousarray(arr)
    return out


def inception_state_dict_from_variables(flat: Mapping[str, np.ndarray]) -> Dict[str, Tensor]:
    """InceptionV3 ``params`` + ``batch_stats`` (unfused conv+BN layout, or BN-folded) as the port's ``state_dict``."""
    return state_dict_from_variables(flat)


def lpips_state_dict_from_variables(flat: Mapping[str, np.ndarray]) -> Dict[str, Tensor]:
    """LPIPS trunk + ``lin`` heads as the port's ``state_dict``; like the JAX package, only ``params`` are read."""
    return state_dict_from_variables(flat, collections=("params",))
