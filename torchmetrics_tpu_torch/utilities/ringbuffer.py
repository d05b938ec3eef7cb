"""Fixed-capacity ring buffers for append-mode ("cat") metric states.

Port of ``torchmetrics_tpu/utilities/ringbuffer.py``. A list state grows
without bound; a :class:`RingBuffer` is one preallocated
``(capacity, *item_shape)`` tensor on the metric's device plus a count of
the rows ever appended. Once more than ``capacity`` rows have been appended
the oldest are overwritten, and a warning is given once.

Metrics opt in with the ``cat_state_capacity`` constructor argument (read by
the ``Metric`` base class): every list state declared with
``dist_reduce_fx="cat"`` or ``None`` becomes a ring buffer of that capacity.

Rows are written at ``count % capacity``, so the live rows are always the
first ``min(count, capacity)`` slots: :meth:`values` is a slice in storage
order (insertion order until the buffer wraps, as in the JAX package) and
reads nothing back to the host. The count lives on the host.

Inside a compiled update step (``utilities.checks._in_compiled_step``) a
Python slice taken from the host count would be frozen into the captured
graph and rewrite the same rows on every replay. There :meth:`append` keeps a
device cursor (``_cursor``, the rows ever appended as an int64 scalar) and
writes through :func:`ring_push`; the host count still advances by the
batch's row count, which the argument signature fixes, so it stays exact
with no read back, and the overflow warning keeps firing.

:meth:`copy` shares the storage and either side copies it before its next
append (copy on write), so a copy costs nothing until one side writes: the
JAX package's copies share immutable arrays, and this keeps that cost.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.checks import _in_compiled_step
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn


def ring_push(
    data: Tensor, valid: Optional[Tensor], count: Tensor, batch: Tensor
) -> Tuple[Tensor, Optional[Tensor], Tensor]:
    """Pure ring-buffer push (JAX ``ringbuffer.py:38``): scatter ``batch``'s rows in at the write cursor.

    ``data``: ``(capacity, *item_shape)`` storage; ``valid``: its ``(capacity,)``
    bool mask of written slots, or None; ``count``: a scalar integer tensor,
    the rows ever pushed (the cursor is ``count % capacity``); ``batch``:
    ``(n, *item_shape)`` rows, of which only the last ``capacity`` survive.
    Returns new ``(data, valid, count)`` with ``count`` grown by the full
    ``n``. Every shape is fixed by the arguments' shapes and nothing is read
    back, so the push can be captured into a CUDA graph.
    """
    capacity = data.shape[0]
    n = batch.shape[0]
    offset = max(0, n - capacity)
    batch = batch[offset:]
    idx = (count.to(torch.int64) + offset + torch.arange(batch.shape[0], device=data.device)) % capacity
    data = data.index_copy(0, idx, batch.to(data.dtype))
    if valid is not None:
        valid = valid.index_fill(0, idx, True)
    return data, valid, count + n


class RingBuffer:
    """Fixed-capacity buffer standing in for an append-mode list state.

    Storage is allocated on the first :meth:`append` (item shape and dtype
    are taken from the first batch) on ``device``, or on the batch's device
    when none is given, so it can be declared before the metric has seen
    data, like an empty list state.
    """

    def __init__(self, capacity: int, device: Optional[Union[str, torch.device]] = None) -> None:
        if not (isinstance(capacity, int) and capacity > 0):
            raise ValueError(f"Argument `capacity` must be a positive integer, but got {capacity}")
        self.capacity = capacity
        self.device = None if device is None else torch.device(device)
        self.data: Optional[Tensor] = None
        self.count = 0  # rows ever appended; the write cursor is count % capacity
        self._shared = False  # storage also held by a copy: clone it before writing
        self._warned_overflow = False
        self._cursor: Optional[Tensor] = None  # device copy of `count`, used inside compiled steps

    # ------------------------------------------------------------- properties
    @property
    def initialized(self) -> bool:
        return self.data is not None

    @property
    def item_shape(self) -> Optional[Tuple[int, ...]]:
        return None if self.data is None else tuple(self.data.shape[1:])

    @property
    def num_valid(self) -> int:
        """Number of live rows."""
        return min(self.count, self.capacity)

    @property
    def num_dropped(self) -> int:
        """Rows overwritten because more than ``capacity`` were appended."""
        return max(0, self.count - self.capacity)

    def __len__(self) -> int:
        return self.num_valid

    def __repr__(self) -> str:
        shape = None if self.data is None else tuple(self.data.shape)
        return f"RingBuffer(capacity={self.capacity}, shape={shape}, valid={self.num_valid})"

    # ----------------------------------------------------------------- update
    def append(self, x: Any) -> "RingBuffer":
        """Insert the rows of ``x`` (its leading axis; a scalar becomes one row)."""
        batch = torch.atleast_1d(torch.as_tensor(x))
        if self.data is None:
            device = self.device if self.device is not None else batch.device
            self.data = torch.zeros((self.capacity, *batch.shape[1:]), dtype=batch.dtype, device=device)
            self.device = device
        if tuple(batch.shape[1:]) != self.item_shape:
            raise ValueError(
                f"RingBuffer expects rows of shape {self.item_shape}, but got a batch of shape {tuple(batch.shape)}"
            )
        n = batch.shape[0]
        if _in_compiled_step():
            if self._cursor is None:
                self._cursor = torch.full((), self.count, dtype=torch.int64, device=self.data.device)
            self.data, _, self._cursor = ring_push(self.data, None, self._cursor, batch)
            self._shared = False  # the push wrote a new tensor
            self._advance(n)
            return self
        if self._shared:
            self.data = self.data.clone()
            self._shared = False
        # only the last `capacity` rows of a batch survive; they land where
        # the JAX package's scatter puts them
        kept = batch[-self.capacity:].to(device=self.data.device, dtype=self.data.dtype)
        start = (self.count + n - kept.shape[0]) % self.capacity
        first = min(kept.shape[0], self.capacity - start)
        self.data[start:start + first] = kept[:first]
        self.data[:kept.shape[0] - first] = kept[first:]
        self._advance(n)
        return self

    def _advance(self, n: int) -> None:
        """Count ``n`` more rows, warning once when the oldest start being overwritten."""
        if self.count + n > self.capacity and not self._warned_overflow:
            rank_zero_warn(
                f"RingBuffer capacity ({self.capacity}) exceeded; oldest rows are being overwritten."
                " Increase `cat_state_capacity` if the metric should see every sample.",
                UserWarning,
            )
            self._warned_overflow = True
        self.count += n

    def extend(self, values: Any) -> "RingBuffer":
        """Append an iterable of batches, another :class:`RingBuffer`, or one tensor."""
        if isinstance(values, RingBuffer):
            if values.num_valid:
                self.append(values.values())
        elif isinstance(values, (list, tuple)):
            for v in values:
                self.append(v)
        else:
            self.append(values)
        return self

    # ------------------------------------------------------------------ reads
    def values(self) -> Tensor:
        """The live rows as one ``(num_valid, *item_shape)`` tensor, in storage order.

        Storage order is insertion order until the buffer wraps; after that
        the newest rows sit in the first slots. Cat states feed
        order-agnostic reductions. Empty storage gives a ``(0,)`` float32
        tensor, as in the JAX package. The rows are a view of the storage,
        which later appends overwrite: clone what must outlive them.
        """
        if self.data is None:
            return torch.zeros((0,), dtype=torch.float32, device=self.device)
        return self.data[: self.num_valid]

    def masked(self) -> Tuple[Tensor, Tensor]:
        """``(data, valid)``: the whole storage and its ``(capacity,)`` bool mask of live rows."""
        if self.data is None:
            raise ValueError("RingBuffer has no storage yet (nothing appended)")
        return self.data, torch.arange(self.capacity, device=self.data.device) < self.num_valid

    # ------------------------------------------------------------ lifecycle
    def copy(self) -> "RingBuffer":
        """A buffer with the same rows; the storage is shared until either side appends."""
        out = RingBuffer(self.capacity, self.device)
        out.data, out.count, out._warned_overflow = self.data, self.count, self._warned_overflow
        if self.data is not None:
            self._shared = out._shared = True
        return out

    def copy_empty(self) -> "RingBuffer":
        """A fresh buffer with the same capacity and device (storage allocated at the first append)."""
        return RingBuffer(self.capacity, self.device)

    def to_device(self, device: Union[str, torch.device]) -> "RingBuffer":
        return self._apply(lambda t: t.to(device), torch.device(device))

    def _apply(self, fn: Callable[[Tensor], Tensor], device: torch.device) -> "RingBuffer":
        """Map the storage through ``fn`` (a ``Module._apply`` function) that puts it on ``device``."""
        if self.data is not None:
            moved = fn(self.data)
            self._shared = self._shared and moved is self.data
            self.data = moved
        self.device = device
        return self

    def __getstate__(self) -> dict:
        state = dict(self.__dict__)
        if self._shared:  # a pickle or deep copy must not share storage with a buffer that may append in place
            state["data"], state["_shared"] = self.data.clone(), False
        return state

