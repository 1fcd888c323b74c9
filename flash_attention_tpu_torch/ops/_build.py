"""Build the port's native code at first use, and bind it with ctypes.

The CUDA kernels (``csrc/*.cu``) compile with nvcc into one shared library
with a plain C interface; the C++ scheduler compiles with g++
(``native/__init__.py``). Both land in ``flash_attention_tpu_torch/_build/``,
keyed by a hash of their sources and command, so an edited source rebuilds
and an unchanged one loads at once. Nothing is built when a module is
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
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

# Element types the kernels are instantiated for, by csrc/common.cuh's codes;
# head_dim is instantiated for 32, 64 and 128.
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
HEAD_DIMS = (32, 64, 128)

_LOCK = threading.Lock()
_KERNELS: ctypes.CDLL | None = None


def build_shared(stem: str, sources, command, *, headers=()) -> pathlib.Path:
    """Compile ``sources`` with ``command + sources + ['-o', out]`` into
    BUILD_DIR unless a library of the same sources and command exists."""
    digest = hashlib.sha256()
    for p in [*sources, *headers]:
        digest.update(p.name.encode() + b"\0" + p.read_bytes() + b"\0")
    digest.update(" ".join(command).encode())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"{stem}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    # Build into a temporary name in the same directory, then rename: the
    # publish is atomic, so a concurrent process never loads a partial file.
    fd, tmp_name = tempfile.mkstemp(prefix=out.stem + ".", suffix=".tmp.so", dir=BUILD_DIR)
    os.close(fd)
    tmp = pathlib.Path(tmp_name)
    try:
        cmd = [*command, *[str(p) for p in sources], "-o", str(tmp)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(
                f"build of {stem} failed ({res.returncode}): {' '.join(cmd)}\n"
                f"{res.stdout}{res.stderr}"
            )
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
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
    lib.fat_decode.restype = c.c_int
    lib.fat_decode.argtypes = [
        ptr, ptr, ptr, ptr, ptr,  # q, k, v, o, lengths
        i64, i64, i64, i64, i64,  # batch, Hq, Hkv, max_seq, D
        i64, i64, i64, i64, i64, i64, i64, i64,  # q/k/v strides
        f32, i32, ptr,  # scale2, dtype, stream
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
