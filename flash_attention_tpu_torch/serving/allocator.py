"""ctypes wrapper over the native page allocator.

Counterpart of the JAX package's ``serving/allocator.py``, over the port's
own loader of its copy of the C++ sources (``native.load()``).
"""

from __future__ import annotations

import ctypes

from flash_attention_tpu_torch import native


class PageAllocator:
    """Free-list allocator over a fixed pool of KV-cache pages."""

    def __init__(self, num_pages: int):
        self._lib = native.load()
        self._h = self._lib.fat_alloc_create(num_pages)
        if not self._h:
            raise ValueError(f"bad pool size {num_pages}")
        self.num_pages = num_pages

    def close(self) -> None:
        if self._h:
            self._lib.fat_alloc_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def acquire(self, n: int) -> list[int] | None:
        """Take n pages (all-or-nothing); None if the pool can't cover it."""
        buf = (ctypes.c_int32 * max(n, 1))()
        if self._lib.fat_alloc_acquire(self._h, n, buf) < 0:
            return None
        return [int(buf[i]) for i in range(n)]

    def release(self, pages: list[int]) -> None:
        if not pages:
            return
        buf = (ctypes.c_int32 * len(pages))(*pages)
        self._lib.fat_alloc_release(self._h, buf, len(pages))

    @property
    def free_count(self) -> int:
        return int(self._lib.fat_alloc_free_count(self._h))
