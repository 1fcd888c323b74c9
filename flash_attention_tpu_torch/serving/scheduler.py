"""ctypes wrapper over the native C++ continuous-batching scheduler.

Counterpart of the JAX package's ``serving/scheduler.py``, over the same
C++ state machine (the port's copy, ``native/src/scheduler.cpp``), loaded
through the port's own native loader.
"""

from __future__ import annotations

import ctypes
import dataclasses

from flash_attention_tpu_torch import native


@dataclasses.dataclass(frozen=True)
class SchedulerStats:
    queued: int
    prefilling: int
    decoding: int
    free_slots: int
    completed: int
    rejected: int


class ContinuousBatchScheduler:
    """Fixed-slot continuous batching: FIFO admission, per-slot token budget."""

    def __init__(self, max_slots: int, max_seq: int):
        self._lib = native.load()
        self._h = self._lib.fat_sched_create(max_slots, max_seq)
        if not self._h:
            raise ValueError(f"bad scheduler config: {max_slots=} {max_seq=}")
        self.max_slots = max_slots
        self.max_seq = max_seq

    def close(self):
        if self._h:
            self._lib.fat_sched_destroy(self._h)
            self._h = None

    def __del__(self):
        # Interpreter shutdown may already have torn down ctypes or the
        # library; a destructor must not raise then.
        try:
            self.close()
        except Exception:
            pass

    def submit(self, req_id: int, prompt_len: int, max_new_tokens: int) -> bool:
        """Enqueue a request; False if it can never fit (rejected)."""
        return self._lib.fat_sched_submit(self._h, req_id, prompt_len, max_new_tokens) == 0

    def admit(self) -> list[tuple[int, int]]:
        """Move queued requests into free slots; returns [(req_id, slot)]."""
        cap = self.max_slots
        ids = (ctypes.c_int64 * cap)()
        slots = (ctypes.c_int32 * cap)()
        n = self._lib.fat_sched_admit(self._h, ids, slots, cap)
        return [(int(ids[i]), int(slots[i])) for i in range(n)]

    def prefill_done(self, slot: int) -> None:
        if self._lib.fat_sched_prefill_done(self._h, slot) != 0:
            raise ValueError(f"slot {slot} not in prefill state")

    def active_slots(self) -> list[int]:
        out = (ctypes.c_int32 * self.max_slots)()
        n = self._lib.fat_sched_active_slots(self._h, out, self.max_slots)
        return [int(out[i]) for i in range(n)]

    def record_token(self, slot: int, is_eos: bool) -> bool:
        """Report one generated token; True if the request just finished."""
        r = self._lib.fat_sched_record_token(self._h, slot, int(is_eos))
        if r < 0:
            raise ValueError(f"slot {slot} not decoding")
        return bool(r)

    def slot_request(self, slot: int) -> int | None:
        r = self._lib.fat_sched_slot_request(self._h, slot)
        return None if r < 0 else int(r)

    def stats(self) -> SchedulerStats:
        buf = (ctypes.c_int64 * 6)()
        self._lib.fat_sched_stats(self._h, buf)
        return SchedulerStats(*[int(x) for x in buf])
