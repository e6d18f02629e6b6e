"""The ``tatp_outputs`` remat policy's saved outputs (counterpart of the
reference's ``checkpoint_name(..., "tatp_y")`` tags and
``jax.checkpoint_policies.save_only_these_names("tatp_y")``,
``repro.models.lm._stack``).

Under ``ParallelConfig(remat=True, remat_policy="tatp_outputs")`` each
layer rep runs under ``torch.utils.checkpoint`` inside
:meth:`SavedOutputs.run`.  Its first pass records, in call order, what the
tagged computations produce, through :func:`saved_or_run`: every TATP
linear's output (:func:`repro_torch.core.tatp.tatp_matmul`, kind
``"linear"``) and the attention core's output with its row log-sum-exp
(the flash-attention wrapper's ``autograd.Function``, kind
``"attention"``; its backward reads both; above model degree 1 ring
attention's hook Function records its merged fp32 output and global row
LSE the same way, so the recompute relays no K/V block, and every rank
replays in step).  The backward's recompute runs
the rep again, and each tagged computation takes its recorded output
instead of computing it: the recompute launches no forward GEMM and no
flash forward.  The recompute's autograd nodes are the first pass's own
kinds and save the same tensors, so the gradients are those of full remat.
Each kind keeps its own queue, so a hook that records nothing (a plain
attention function) leaves the other kind's order intact.  An
encoder-decoder's cross-attention blocks run inside the decoder's reps,
so their linears and attention cores are recorded and replayed with the
rep's own; its encoder is checkpointed in full outside any rep's pass
(``models/lm.py:_encoder``), so it records nothing and its recompute
takes nothing.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable, Optional

import torch

_active: Optional["SavedOutputs"] = None


def active() -> Optional["SavedOutputs"]:
    """The rep whose pass is running under ``tatp_outputs``, or None."""
    return _active


def _detach(item):
    if isinstance(item, tuple):
        return tuple(_detach(t) for t in item)
    return item.detach() if isinstance(item, torch.Tensor) else item


def saved_or_run(kind: str, fn: Callable[[], Any]):
    """``fn()``, a tagged computation of ``kind``: outside ``tatp_outputs``
    it just runs; in a rep's first pass its result is also recorded
    (detached); in the recompute the recorded result is returned
    (detached anew) and ``fn`` does not run."""
    saved = _active
    if saved is None:
        return fn()
    if saved.replaying:
        return _detach(saved.take(kind))
    out = fn()
    saved.put(kind, _detach(out))
    return out


class SavedOutputs:
    """One rep's saved outputs, a queue for each kind: recorded by its
    first pass, replayed in the same order by every later pass (the
    backward's recompute)."""

    def __init__(self):
        self._items: dict[str, list[Any]] = {}
        self._recorded = False
        self._next: Optional[dict[str, int]] = None

    @property
    def replaying(self) -> bool:
        return self._next is not None

    def put(self, kind: str, item):
        if self._recorded:
            raise RuntimeError("a replayed pass cannot record outputs")
        self._items.setdefault(kind, []).append(item)

    def take(self, kind: str):
        i = self._next.get(kind, 0)
        items = self._items.get(kind, [])
        if i >= len(items):
            raise RuntimeError(
                f"the recompute asked for more saved {kind} outputs than "
                f"the first pass recorded")
        self._next[kind] = i + 1
        return items[i]

    def __len__(self) -> int:
        return sum(len(items) for items in self._items.values())

    def run(self, fn, *args):
        """``fn(*args)`` as this rep's next pass."""
        with self._pass():
            return fn(*args)

    @contextmanager
    def _pass(self):
        global _active
        prev, _active = _active, self
        self._next = {} if self._recorded else None
        try:
            yield
        finally:
            _active = prev
            self._recorded = True
            self._next = None
