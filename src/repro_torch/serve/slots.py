"""Fixed-width slot-array scheduling — the continuous-batching core.

The port's copy of the JAX package's ``serve/slots.py`` (framework-free).
Used by the token :class:`~repro_torch.serve.engine.ServeEngine`; in the
reference the DSE serving engine (``api/service.py``) shares the identical
admission / free / harvest discipline.  The invariant both
engines rely on: the slot array never changes width, so whatever rides the
slots (a ``[slots, 1]`` token batch, a fixed-width candidate block) keeps a
fixed leading dimension and the downstream jitted calls never re-trace as
requests come and go.

Bookkeeping contract (each rule fixes a real bug in the original engine):

* a rid is *owned* from ``submit`` until its item is harvested, and
  submitting an owned rid raises — two live requests sharing a rid used to
  silently corrupt the active map (the second overwrote the first, whose
  slot then fed stale state forever);
* finished items accumulate **in completion order** until ``harvest()``
  hands them back exactly once — ``run_until_drained`` used to return a
  never-appended empty list no matter how much work was done;
* admission fills the lowest free slot from a FIFO queue, so slot indices
  are reused with the admitting engine explicitly resetting per-slot state.
"""

from __future__ import annotations

from typing import (Any, Dict, Generic, Iterator, List, Optional, Set, Tuple,
                    TypeVar)

__all__ = ["SlotArray"]

T = TypeVar("T")


class SlotArray(Generic[T]):
    """Fixed-width slot array with a FIFO admission queue.

    ``submit(rid, item)`` queues; ``admit()`` moves queued items into free
    slots (lowest index first) and returns what was admitted this call so
    the owner can initialise per-slot state; ``finish(slot)`` frees a slot
    and records the item in completion order; ``harvest()`` pops the
    completed items exactly once and releases their rids.
    """

    def __init__(self, slots: int):
        if slots < 1:
            raise ValueError(f"SlotArray needs at least one slot, got {slots}")
        self.slots = slots
        self._slot_rid: List[Optional[Any]] = [None] * slots
        self._active: Dict[Any, T] = {}
        self._queue: List[Tuple[Any, T]] = []
        self._finished: List[Tuple[Any, T]] = []   # completion order
        self._owned: Set[Any] = set()

    # ------------------------------------------------------------ frontend
    def submit(self, rid: Any, item: T) -> None:
        """Queue ``item`` under ``rid``; raises on a rid that is still owned
        (queued, active, or finished-but-unharvested)."""
        if rid in self._owned:
            raise ValueError(
                f"request id {rid!r} is already in flight (queued, active, "
                "or awaiting harvest); rids must be unique per batch")
        self._owned.add(rid)
        self._queue.append((rid, item))

    def admit(self) -> List[Tuple[int, Any, T]]:
        """Fill free slots from the queue; returns [(slot, rid, item)] newly
        admitted so the owner can reset per-slot state."""
        admitted: List[Tuple[int, Any, T]] = []
        for i in range(self.slots):
            if self._slot_rid[i] is None and self._queue:
                rid, item = self._queue.pop(0)
                self._slot_rid[i] = rid
                self._active[rid] = item
                admitted.append((i, rid, item))
        return admitted

    # ------------------------------------------------------------- queries
    def __len__(self) -> int:
        """Occupied slot count."""
        return len(self._active)

    @property
    def queued(self) -> int:
        return len(self._queue)

    @property
    def drained(self) -> bool:
        return not self._queue and not self._active

    def rid_at(self, slot: int) -> Optional[Any]:
        return self._slot_rid[slot]

    def item_at(self, slot: int) -> Optional[T]:
        rid = self._slot_rid[slot]
        return None if rid is None else self._active[rid]

    def active_slots(self) -> Iterator[Tuple[int, Any, T]]:
        """(slot, rid, item) for every occupied slot, in slot order."""
        for i, rid in enumerate(self._slot_rid):
            if rid is not None:
                yield i, rid, self._active[rid]

    # ------------------------------------------------------------- retire
    def finish(self, slot: int) -> T:
        """Free ``slot``; its item joins the completion-ordered finished
        list (the rid stays owned until the item is harvested)."""
        rid = self._slot_rid[slot]
        if rid is None:
            raise ValueError(f"slot {slot} is already free")
        item = self._active.pop(rid)
        self._slot_rid[slot] = None
        self._finished.append((rid, item))
        return item

    def harvest(self) -> List[T]:
        """Pop the finished items (completion order), releasing their rids."""
        done, self._finished = self._finished, []
        for rid, _ in done:
            self._owned.discard(rid)
        return [item for _, item in done]
