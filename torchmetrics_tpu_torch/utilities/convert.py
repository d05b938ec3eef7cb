"""Carry a metric's accumulated state, and a trunk's weights, from the JAX package into this one.

``torchmetrics_tpu``'s ``Metric.state_dict(all_states=True)`` returns host
numpy arrays (or lists of them for append-mode states) under the state names.
The port registers the same names, so the mapping is a copy onto the device;
:meth:`torchmetrics_tpu_torch.metric.Metric.load_state_dict` takes the result.
Trunk weights come as the JAX package's flat ``.npz`` variables; see below.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Tuple, Union

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


def build_on_cpu(cls, *args, **kwargs) -> torch.nn.Module:
    """Construct ``cls(*args, **kwargs)`` without running torch's default initialisers (or its global RNG)."""
    with torch.device("meta"):
        module = cls(*args, **kwargs)
    return module.to_empty(device="cpu")


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


# BERT (``tools/convert_weights.py::convert_bert_state_dict``) adds three kinds of
# entry to the flat layout: scalar ``config/*`` entries, flax ``nn.Embed`` tables
# (``embedding``, the same ``(num, features)`` layout as ``nn.Embedding.weight``)
# and flax ``nn.LayerNorm`` ``scale``/``bias`` under the modules named below.
_BERT_LAYERNORMS = ("ln", "embeddings_ln", "transform_ln")
_BERT_CONFIG_KEYS = (
    "vocab_size", "hidden_size", "num_layers", "num_heads", "intermediate_size", "max_position", "type_vocab",
)


def bert_state_dict_from_variables(flat: Mapping[str, np.ndarray]) -> Tuple[Dict[str, Tensor], Any]:
    """A converted BERT ``.npz`` mapping as the port's ``_BertWithHead`` ``state_dict`` and its ``BertConfig``.

    ``config/*`` scalars become the config (``with_mlm_head`` 0 when absent,
    as in the JAX package); ``embedding`` maps to ``weight`` as it is, a
    LayerNorm's ``scale`` to ``weight``, a Dense ``kernel`` ``(in, out)`` to
    ``weight`` ``(out, in)``, ``bias`` to ``bias``.
    """
    from torchmetrics_tpu_torch.text._bert_encoder import BertConfig

    state: Dict[str, Tensor] = {}
    for key, value in flat.items():
        if key.startswith("config/"):
            continue
        collection, path = _route(key)
        if collection != "params" or len(path) < 2:
            raise KeyError(f"Cannot map BERT variable {key!r} onto a torch parameter")
        *modules, leaf = path
        arr = np.asarray(value)
        if leaf == "embedding":
            name = "weight"
        elif leaf == "scale" and modules[-1] in _BERT_LAYERNORMS:
            name = "weight"
        elif leaf == "kernel":
            name, arr = "weight", arr.T
        elif leaf == "bias":
            name = "bias"
        else:
            raise KeyError(f"Cannot map BERT variable {key!r} onto a torch parameter")
        state[".".join([*modules, name])] = torch.from_numpy(np.array(arr))  # a writable copy
    config = BertConfig(
        **{name: int(flat[f"config/{name}"]) for name in _BERT_CONFIG_KEYS},
        with_mlm_head=bool(int(flat.get("config/with_mlm_head", 0))),
    )
    return state, config


def bert_variables_from_state_dict(state: Mapping[str, Tensor], config: Any) -> Dict[str, np.ndarray]:
    """The inverse of :func:`bert_state_dict_from_variables`: the flat ``.npz`` mapping, ``config/*`` included."""
    out: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        *modules, name = key.split(".")
        arr = value.detach().cpu().numpy()
        if name == "weight" and modules[-1].endswith("_embeddings"):
            leaf = "embedding"
        elif name == "weight" and modules[-1] in _BERT_LAYERNORMS:
            leaf = "scale"
        elif name == "weight":
            leaf, arr = "kernel", arr.T
        elif name == "bias":
            leaf = "bias"
        else:
            raise KeyError(f"Cannot map state entry {key!r} onto a BERT variable")
        out["/".join(["params", *modules, leaf])] = np.ascontiguousarray(arr)
    for name in _BERT_CONFIG_KEYS:
        out[f"config/{name}"] = np.asarray(getattr(config, name))
    out["config/with_mlm_head"] = np.asarray(int(config.with_mlm_head))
    return out


# CLIP (``tools/convert_weights.py::convert_clip_state_dict``): both towers under ``params/vision`` and
# ``params/text``, the projections, scalar ``config/*`` entries. Leaves: a Conv ``kernel`` (HWIO -> OIHW), a
# Dense ``kernel`` (``(in, out)`` -> ``(out, in)``), ``bias``, a LayerNorm ``scale`` (-> ``weight``), an
# ``nn.Embed`` ``embedding`` (-> ``weight``) and the vision tower's bare ``class_embedding``.
_CLIP_LAYERNORMS = ("ln1", "ln2", "pre_ln", "post_ln", "final_ln")


def clip_state_dict_from_variables(flat: Mapping[str, np.ndarray]) -> Tuple[Dict[str, Tensor], Any]:
    """A converted CLIP ``.npz`` mapping as the port's ``_ClipModel`` ``state_dict`` and its ``ClipConfig``."""
    from torchmetrics_tpu_torch.multimodal._clip_encoder import CONFIG_KEYS, ClipConfig

    state: Dict[str, Tensor] = {}
    for key, value in flat.items():
        if key.startswith("config/"):
            continue
        collection, path = _route(key)
        if collection != "params":
            raise KeyError(f"Cannot map CLIP variable {key!r} onto a torch parameter")
        *modules, leaf = path
        arr = np.asarray(value)
        if leaf == "class_embedding":
            name = leaf
        elif leaf in ("embedding", "scale"):
            name = "weight"
        elif leaf == "kernel":
            name, arr = "weight", (arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T)
        elif leaf == "bias":
            name = "bias"
        else:
            raise KeyError(f"Cannot map CLIP variable {key!r} onto a torch parameter")
        state[".".join([*modules, name])] = torch.from_numpy(np.array(arr))  # a writable copy
    config = ClipConfig(**{name: int(flat[f"config/{name}"]) for name in CONFIG_KEYS})
    return state, config


def clip_variables_from_state_dict(state: Mapping[str, Tensor], config: Any) -> Dict[str, np.ndarray]:
    """The inverse of :func:`clip_state_dict_from_variables`: the flat ``.npz`` mapping, ``config/*`` included."""
    from torchmetrics_tpu_torch.multimodal._clip_encoder import CONFIG_KEYS

    out: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        *modules, name = key.split(".")
        arr = value.detach().cpu().float().numpy()
        if name == "class_embedding":
            leaf = name
        elif name == "weight" and modules[-1] in _CLIP_LAYERNORMS:
            leaf = "scale"
        elif name == "weight" and arr.ndim == 4:
            leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
        elif name == "weight" and modules[-1].endswith("_embedding"):
            leaf = "embedding"
        elif name == "weight":
            leaf, arr = "kernel", arr.T
        elif name == "bias":
            leaf = "bias"
        else:
            raise KeyError(f"Cannot map state entry {key!r} onto a CLIP variable")
        out["/".join(["params", *modules, leaf])] = np.ascontiguousarray(arr)
    for name in CONFIG_KEYS:
        out[f"config/{name}"] = np.asarray(getattr(config, name))
    return out
