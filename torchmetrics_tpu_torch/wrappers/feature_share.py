"""FeatureShare (port of ``torchmetrics_tpu/wrappers/feature_share.py``).

One feature extractor (e.g. one InceptionV3 trunk for FID, KID and MiFID)
shared by the members of a collection: each member's extractor is replaced
by one :class:`NetworkCache`, which runs the trunk once for a given input
object and hands its output to every member that asks for it. The cache is
an ``nn.Module`` holding the trunk as its submodule: a port metric is an
``nn.Module`` whose extractor is a child module, which only a module may
replace, and ``.to()`` and ``state_dict`` still reach the trunk.

The cache hits only if every member hands the trunk the same tensor object:
``MetricCollection.update`` passes each member the arguments it was given,
and FID, KID and MiFID call their extractor on the images as given. Unlike
a JAX array, a tensor can be rewritten in place, so the key also holds each
tensor's version counter: a buffer refilled between two updates misses the
cache. An inference tensor (made under ``torch.inference_mode``) has no
version counter, so its features are kept only for the length of one
``FeatureShare.update`` or ``forward``.
"""

from __future__ import annotations

from collections import OrderedDict
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional, Sequence, Union

from torch import Tensor, nn

from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.metric import Metric


class _HashableRef:
    """Hashable identity key that keeps its object alive.

    Tensors hash by identity already, but the key must hold a strong
    reference: otherwise a freed input's id could be reused by a new
    allocation and return stale features.
    """

    __slots__ = ("obj",)

    def __init__(self, obj: Any) -> None:
        self.obj = obj

    def __hash__(self) -> int:
        return id(self.obj)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, _HashableRef) and other.obj is self.obj


_UNVERSIONED = -1  # the version slot of an inference tensor's key


class NetworkCache(nn.Module):
    """A feature extractor behind a least-recently-used cache keyed on the identity and version of its inputs."""

    def __init__(self, network: Any, max_size: int = 100) -> None:
        super().__init__()
        self.network = network
        self.max_size = max_size
        self._cache: "OrderedDict[tuple, Any]" = OrderedDict()
        self._in_batch = False  # set while one collection call hands a batch to every member

    @contextmanager
    def one_batch(self) -> Iterator[None]:
        """Cache inference tensors too while one batch goes to every member; forget them after."""
        self._in_batch = True
        try:
            yield
        finally:
            self._in_batch = False
            for key in [k for k in self._cache if any(v == _UNVERSIONED for _, v in k)]:
                del self._cache[key]

    def _key(self, args: tuple) -> Optional[tuple]:
        key = []
        for a in args:
            if not isinstance(a, Tensor):
                key.append((_HashableRef(a), None))
            elif not a.is_inference():
                key.append((_HashableRef(a), a._version))  # an in-place write (views included) bumps it
            elif self._in_batch:
                key.append((_HashableRef(a), _UNVERSIONED))
            else:
                return None  # an inference tensor outside a collection call: it may be rewritten unseen
        return tuple(key)

    def forward(self, *args: Any) -> Any:
        # a multi-input extractor (e.g. LPIPS' pair of images) caches on the identities of all its inputs
        key = self._key(args)
        if key is None:
            return self.network(*args)
        if key in self._cache:
            self._cache.move_to_end(key)
            return self._cache[key]
        out = self.network(*args)
        self._cache[key] = out
        if len(self._cache) > self.max_size:
            self._cache.popitem(last=False)
        return out

    def __getattr__(self, name: str) -> Any:
        try:
            return super().__getattr__(name)
        except AttributeError:
            network = self._modules["network"] if "network" in self._modules else self.__dict__["network"]
            return getattr(network, name)


class FeatureShare(MetricCollection):
    """A MetricCollection whose members share one feature extractor.

    Each member names its extractor's attribute in ``feature_network``; the
    first member's extractor is the one kept.
    """

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        max_cache_size: Optional[int] = None,
    ) -> None:
        super().__init__(metrics=metrics, compute_groups=False)
        if max_cache_size is None:
            max_cache_size = len(self)
        if not isinstance(max_cache_size, int):
            raise TypeError(f"max_cache_size should be an integer, but got {max_cache_size}")

        try:
            first = next(iter(self._modules.values()))
            network_name = str(first.feature_network)
            shared_net = getattr(first, network_name)
        except AttributeError as err:
            raise AttributeError(
                "Tried to extract the network to share from the first metric, but it did not have a"
                " `feature_network` attribute. Please make sure that the metric has an attribute with that name,"
                " else it cannot be shared."
            ) from err
        cached = NetworkCache(shared_net, max_size=max_cache_size)
        for metric in self._modules.values():
            if not hasattr(metric, "feature_network"):
                raise AttributeError(
                    "Tried to set the cached network to all metrics, but one of the metrics did not have a"
                    " `feature_network` attribute."
                )
            setattr(metric, str(metric.feature_network), cached)

    def _network_cache(self) -> NetworkCache:
        first = next(iter(self._modules.values()))
        return getattr(first, str(first.feature_network))

    def update(self, *args: Any, **kwargs: Any) -> None:
        with self._network_cache().one_batch():
            super().update(*args, **kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        with self._network_cache().one_batch():
            return super().forward(*args, **kwargs)
