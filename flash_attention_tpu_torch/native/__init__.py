"""Native (C++) runtime components, built on demand and loaded via ctypes.

The scheduler, page allocator and oracle are C++ (``native/src/{scheduler,
oracle,allocator}.cpp``), copies of the JAX package's sources kept in the
port, so the port reads no file of that package. g++ compiles them into the
port's build directory.
"""

from __future__ import annotations

import ctypes
import threading

from flash_attention_tpu_torch.ops._build import PKG_DIR, build_shared

SRC_DIR = PKG_DIR / "native" / "src"
_SOURCES = ["scheduler.cpp", "oracle.cpp", "allocator.cpp"]
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.fat_sched_create.restype = c.c_void_p
    lib.fat_sched_create.argtypes = [c.c_int32, c.c_int32]
    lib.fat_sched_destroy.restype = None
    lib.fat_sched_destroy.argtypes = [c.c_void_p]
    lib.fat_sched_submit.restype = c.c_int32
    lib.fat_sched_submit.argtypes = [c.c_void_p, c.c_int64, c.c_int32, c.c_int32]
    lib.fat_sched_admit.restype = c.c_int32
    lib.fat_sched_admit.argtypes = [
        c.c_void_p, c.POINTER(c.c_int64), c.POINTER(c.c_int32), c.c_int32,
    ]
    lib.fat_sched_prefill_done.restype = c.c_int32
    lib.fat_sched_prefill_done.argtypes = [c.c_void_p, c.c_int32]
    lib.fat_sched_active_slots.restype = c.c_int32
    lib.fat_sched_active_slots.argtypes = [
        c.c_void_p, c.POINTER(c.c_int32), c.c_int32,
    ]
    lib.fat_sched_record_token.restype = c.c_int32
    lib.fat_sched_record_token.argtypes = [c.c_void_p, c.c_int32, c.c_int32]
    lib.fat_sched_slot_request.restype = c.c_int64
    lib.fat_sched_slot_request.argtypes = [c.c_void_p, c.c_int32]
    lib.fat_sched_stats.restype = None
    lib.fat_sched_stats.argtypes = [c.c_void_p, c.POINTER(c.c_int64)]
    lib.fat_alloc_create.restype = c.c_void_p
    lib.fat_alloc_create.argtypes = [c.c_int32]
    lib.fat_alloc_destroy.restype = None
    lib.fat_alloc_destroy.argtypes = [c.c_void_p]
    lib.fat_alloc_acquire.restype = c.c_int32
    lib.fat_alloc_acquire.argtypes = [c.c_void_p, c.c_int32, c.POINTER(c.c_int32)]
    lib.fat_alloc_release.restype = None
    lib.fat_alloc_release.argtypes = [c.c_void_p, c.POINTER(c.c_int32), c.c_int32]
    lib.fat_alloc_free_count.restype = c.c_int32
    lib.fat_alloc_free_count.argtypes = [c.c_void_p]
    lib.fat_oracle_attention.restype = None
    lib.fat_oracle_attention.argtypes = [
        c.POINTER(c.c_float), c.POINTER(c.c_float), c.POINTER(c.c_float),
        c.POINTER(c.c_float),
        c.c_int32, c.c_int32, c.c_int32, c.c_int32, c.c_int32, c.c_int32,
        c.c_int32, c.c_float, c.POINTER(c.c_int32),
    ]


def load() -> ctypes.CDLL:
    """Build (if needed) and load the native library. Thread-safe, cached."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = build_shared(
                "libfat_native",
                [SRC_DIR / s for s in _SOURCES],
                ["g++", "-O2", "-std=c++17", "-fPIC"],
                ["g++", "-shared"],
            )
            lib = ctypes.CDLL(str(path))
            _declare(lib)
            _LIB = lib
        return _LIB
