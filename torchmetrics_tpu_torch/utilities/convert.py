"""Carry a metric's accumulated state from the JAX package into this one.

``torchmetrics_tpu``'s ``Metric.state_dict(all_states=True)`` returns host
numpy arrays (or lists of them for append-mode states) under the state names.
The port registers the same names, so the mapping is a copy onto the device;
:meth:`torchmetrics_tpu_torch.metric.Metric.load_state_dict` takes the result.
"""

from __future__ import annotations

from typing import Dict, List, Union

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
