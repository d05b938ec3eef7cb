"""MultioutputWrapper (port of ``torchmetrics_tpu/wrappers/multioutput.py``)."""

from __future__ import annotations

from copy import deepcopy
from typing import Any, List, Optional, Tuple

import torch
from torch import Tensor, nn

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric


class MultioutputWrapper(WrapperMetric):
    """Evaluate one metric independently per output dimension.

    Keeps ``num_outputs`` clones of the base metric (an ``nn.ModuleList``, so
    ``.to()`` moves them); inputs are split along ``output_dim`` and routed to
    the matching clone. ``remove_nans`` drops the rows where any input is NaN,
    with a boolean index.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.wrappers import MultioutputWrapper
        >>> from torchmetrics_tpu_torch.regression import R2Score
        >>> metric = MultioutputWrapper(R2Score(device="cpu"), num_outputs=2)
        >>> preds = torch.tensor([[1.0, 10.0], [2.0, 20.0], [3.0, 30.0]])
        >>> target = torch.tensor([[1.0, 11.0], [2.0, 19.0], [3.0, 31.0]])
        >>> metric.update(preds, target)
        >>> metric.compute().shape
        torch.Size([2])
    """

    is_differentiable = False

    def __init__(
        self,
        base_metric: Metric,
        num_outputs: int,
        output_dim: int = -1,
        remove_nans: bool = True,
        squeeze_outputs: bool = True,
    ) -> None:
        super().__init__(device=base_metric.device)
        self.metrics = nn.ModuleList([deepcopy(base_metric) for _ in range(num_outputs)])
        self.output_dim = output_dim
        self.remove_nans = remove_nans
        self.squeeze_outputs = squeeze_outputs

    def _get_args_kwargs_by_output(self, *args: Tensor, **kwargs: Tensor) -> List[Tuple[tuple, dict]]:
        args_kwargs = []
        for i in range(len(self.metrics)):
            selected_args = [arg.narrow(self.output_dim, i, 1) for arg in args]
            selected_kwargs = {k: v.narrow(self.output_dim, i, 1) for k, v in kwargs.items()}
            if self.remove_nans:
                all_vals = list(selected_args) + list(selected_kwargs.values())
                if all_vals:
                    nan_idxs = torch.zeros(all_vals[0].shape[0], dtype=torch.bool, device=all_vals[0].device)
                    for v in all_vals:
                        nan_idxs = nan_idxs | torch.isnan(v).reshape(v.shape[0], -1).any(dim=1)
                    keep = ~nan_idxs
                    selected_args = [v[keep] for v in selected_args]
                    selected_kwargs = {k: v[keep] for k, v in selected_kwargs.items()}
            if self.squeeze_outputs:
                selected_args = [v.squeeze(self.output_dim) for v in selected_args]
                selected_kwargs = {k: v.squeeze(self.output_dim) for k, v in selected_kwargs.items()}
            args_kwargs.append((tuple(selected_args), selected_kwargs))
        return args_kwargs

    def update(self, *args: Any, **kwargs: Any) -> None:
        for (sel_args, sel_kwargs), metric in zip(self._get_args_kwargs_by_output(*args, **kwargs), self.metrics):
            metric.update(*sel_args, **sel_kwargs)

    def compute(self) -> Tensor:
        return torch.stack([m.compute() for m in self.metrics], dim=0)

    def forward(self, *args: Any, **kwargs: Any) -> Optional[Tensor]:
        results = [
            m(*sel_args, **sel_kwargs)
            for (sel_args, sel_kwargs), m in zip(self._get_args_kwargs_by_output(*args, **kwargs), self.metrics)
        ]
        if any(r is None for r in results):
            return None
        return torch.stack(results, dim=0)

    def reset(self) -> None:
        for m in self.metrics:
            m.reset()
        super().reset()

    def _filter_kwargs(self, **kwargs: Any) -> dict:
        return self.metrics[0]._filter_kwargs(**kwargs)
