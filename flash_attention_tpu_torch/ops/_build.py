"""Build the port's native code at first use, and bind it with ctypes.

The CUDA kernels (``csrc/*.cu``) compile with nvcc, one process per source
file, all started together, and link into one shared library with a plain C
interface; the C++ scheduler compiles with g++ (``native/__init__.py``).
Both land in ``flash_attention_tpu_torch/_build/``, keyed by a hash of their
sources and commands, so an edited source rebuilds and an unchanged one
loads at once. Nothing is built when a module is
imported: ``kernels()`` runs on the first CUDA launch.

Each C entry returns ``cudaGetLastError()`` after its launch; ``check``
raises on a nonzero code, since a refused launch never runs and
``torch.cuda.synchronize()`` would not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

# Element types the kernels are instantiated for, by csrc/common.cuh's codes;
# head_dim is instantiated for 32, 64 and 128.
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
HEAD_DIMS = (32, 64, 128)

_LOCK = threading.Lock()
_KERNELS: ctypes.CDLL | None = None


def build_shared(stem: str, sources, compile_cmd, link_cmd, *, headers=()) -> pathlib.Path:
    """Compile each of ``sources`` with ``compile_cmd + ['-c', src, '-o',
    obj]``, all at once in parallel, and link the objects with ``link_cmd``
    into a shared library in BUILD_DIR, unless a library of the same
    sources, headers and commands exists."""
    digest = hashlib.sha256()
    for p in [*sources, *headers]:
        digest.update(p.name.encode() + b"\0" + p.read_bytes() + b"\0")
    digest.update(" ".join([*compile_cmd, "|", *link_cmd]).encode())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"{stem}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    # Build in a temporary directory beside the library, then rename: the
    # publish is atomic, so a concurrent process never loads a partial file.
    with tempfile.TemporaryDirectory(prefix=out.stem + ".", dir=BUILD_DIR) as tmp_dir:
        tmp = pathlib.Path(tmp_dir)
        objs = [tmp / f"{src.stem}.o" for src in sources]
        procs = [
            (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for cmd in ([*compile_cmd, "-c", str(src), "-o", str(obj)] for src, obj in zip(sources, objs))
        ]
        results = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in procs]
        link = [*link_cmd, *map(str, objs), "-o", str(tmp / out.name)]
        if all(rc == 0 for _, _, rc in results):
            res = subprocess.run(link, capture_output=True, text=True)
            results.append((link, res.stdout + res.stderr, res.returncode))
        for cmd, output, rc in results:
            if rc:
                raise RuntimeError(f"build of {stem} failed ({rc}): {' '.join(cmd)}\n{output}")
        os.replace(tmp / out.name, out)
    return out


def nvcc() -> str:
    """The nvcc on PATH, else the CUDA toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return str(path)


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    ptr, i64, i32, f32 = c.c_void_p, c.c_int64, c.c_int32, c.c_float
    lib.fat_flash_fwd.restype = c.c_int
    lib.fat_flash_fwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr,  # q, k, v, o, lse
        i64, i64, i64, i64, i64, i64,  # batch, Hq, Hkv, Sq, Skv, D
        i64, i64, i64, i64, i64, i64, i64, i64, i64,  # q/k/v strides
        f32, i32, i32, ptr,  # scale2, causal, dtype, stream
    ]
    lib.fat_paged_prefill.restype = c.c_int
    lib.fat_paged_prefill.argtypes = [
        ptr, ptr, ptr, ptr, ptr,  # q, k pages, v pages, o, table row
        i64, i64, i64, i64, i64, i64, i64,  # Hq, Hkv, num_pages, page_size, T, kv_end, D
        i64, i64, i64, i64, i64, i64, i64, i64,  # q/k/v strides
        f32, i32, ptr,  # scale2, dtype, stream
    ]
    lib.fat_decode.restype = c.c_int
    lib.fat_decode.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,  # q, k, v, o, lse, lengths
        i64, i64, i64, i64, i64,  # batch, Hq, Hkv, max_seq, D
        i64, i64, i64, i64, i64, i64, i64, i64,  # q/k/v strides
        f32, i32, ptr,  # scale2, dtype, stream
    ]
    lib.fat_paged_decode.restype = c.c_int
    lib.fat_paged_decode.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # q, k pages, v pages, o, lse, lengths, table
        i64, i64, i64, i64, i64, i64, i64,  # slots, Hq, Hkv, num_pages, page_size, pages_per_slot, D
        i64, i64, i64, i64, i64, i64, i64, i64,  # q/k/v strides
        f32, i32, ptr,  # scale2, dtype, stream
    ]
    lib.fat_paged_write.restype = c.c_int
    lib.fat_paged_write.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # k/v new, k/v pool, lengths, table, slots, valid
        i64, i64, i64, i64,  # layers, n, heads, row bytes
        i64, i64, i64,  # num_pages, page_size, pages_per_slot
        i64, i64, i64, i64, ptr,  # pool byte strides (layer, page, head, row), stream
    ]
    lib.fat_error_string.restype = c.c_char_p
    lib.fat_error_string.argtypes = [c.c_int]


def kernels() -> ctypes.CDLL:
    """Build (once per source change) and load the kernel library."""
    global _KERNELS
    with _LOCK:
        if _KERNELS is None:
            path = build_shared(
                "libfat_kernels",
                sorted(CSRC_DIR.glob("*.cu")),
                [nvcc(), *NVCC_FLAGS],
                [nvcc(), "-shared"],
                headers=sorted(CSRC_DIR.glob("*.cuh")),
            )
            lib = ctypes.CDLL(str(path))
            _declare(lib)
            _KERNELS = lib
        return _KERNELS


def check_operands(what: str, head_dim: int, *tensors: torch.Tensor) -> None:
    """Raise on operands no kernel instantiation takes."""
    first = tensors[0]
    if first.dtype not in DTYPE_CODES:
        raise ValueError(f"{what}: the CUDA kernel takes float32, float16 or bfloat16, got {first.dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"{what}: the CUDA kernel takes head_dim in {HEAD_DIMS}, got {head_dim}")
    for t in tensors[1:]:
        if t.dtype != first.dtype or t.device != first.device:
            raise ValueError(
                f"{what}: operands differ in dtype or device "
                f"({first.dtype} on {first.device} vs {t.dtype} on {t.device})"
            )


def unit_last_stride(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself if its last dimension is contiguous, else a copy."""
    return x if x.stride(-1) == 1 else x.contiguous()


def check(err: int, what: str) -> None:
    if err:
        msg = kernels().fat_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
