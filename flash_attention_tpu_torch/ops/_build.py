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

import contextlib
import ctypes
import functools
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
# --split-compile=0: each nvcc spreads its device-code optimisation over the
# machine's cores; the masked and unmasked instantiations of every kernel
# body made one-thread-per-file builds take minutes.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "--split-compile=0"]

# Element types the kernels are instantiated for, by csrc/common.cuh's codes:
# the query / output types, and the payload types of a quantized KV cache
# (int8, fp8 e4m3 and e5m2, each row with an fp32 scale); head_dim is
# instantiated for 32, 64 and 128.
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
PAYLOAD_CODES = {torch.int8: 3, torch.float8_e4m3fn: 4, torch.float8_e5m2: 5}
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
        failed = [f"({rc}): {' '.join(cmd)}\n{output}" for cmd, output, rc in results if rc]
        if failed:
            raise RuntimeError(f"build of {stem} failed " + "\n".join(failed))
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
        ptr, ptr, ptr, ptr,  # segment ids of q and kv, their tile ranges (K1d)
        ptr, i64,  # the K / V batch row of each query batch row (device int32) and K / V's batch rows, or null
        i64, i64, i64, i64, i64, i64,  # batch, Hq, Hkv, Sq, Skv, D
        i64, i64, i64, i64, i64, i64, i64, i64, i64,  # q/k/v strides
        f32, i32,  # scale2, causal
        i32, f32, i32,  # window, softcap2, band (K2)
        i32, ptr, i32,  # dtype, stream, q rows a block (the tensor-core body)
    ]
    lib.fat_paged_prefill.restype = c.c_int
    lib.fat_paged_prefill.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,  # q, k pages, v pages, k/v scales, o
        ptr, ptr, i64, i64,  # the page table, the slot (device int32), the table's rows and row stride
        i64, i64, i64, i64, i64, i64, i64,  # Hq, Hkv, num_pages, page_size, T, kv_end, D
        i64, i64, i64, i64, i64, i64, i64, i64,  # q/k/v strides
        c.POINTER(i64), f32,  # scale strides, scale2
        i32, i32, f32,  # window, sinks, softcap2
        i32, i32, ptr, i32,  # dtype, payload, stream, q rows a block (the tensor-core body)
    ]
    lib.fat_cache_fwd.restype = c.c_int
    lib.fat_cache_fwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # q, the cache's k, v, their scales (or null), o, lse (or null)
        ptr, i64,  # the slot (device int32) and the cache's slots
        i64, i64, i64, i64, i64, i64,  # Hq, Hkv, T, kv_end, the rows a slot, D
        i64, i64, i64, i64, i64, i64, i64, i64,  # q's head / row strides, k's and v's slot / head / row strides
        c.POINTER(i64), f32,  # scale strides, scale2
        i32, i32, i64, i64, f32,  # window, sinks, the ring's modulus and sink rows (0, 0: no ring), softcap2
        i32, i32, ptr, i32,  # dtype, payload, stream, (ignored: fp32 only)
    ]
    # K1q and K1r in bf16 / fp16 (csrc/chunk_fwd_sm90.cu): fat_cache_fwd's
    # arguments, the last the blocks of a cluster the walk is split over.
    lib.fat_chunk_fwd.restype = c.c_int
    lib.fat_chunk_fwd.argtypes = lib.fat_cache_fwd.argtypes
    shape = c.POINTER(i64)
    # q, k, v, k/v scales, o, lse, lengths, then the fp32 workspace and the
    # ticket counters; shape: csrc/decode.cu's Shape array; scale2, softcap2.
    lib.fat_decode.restype = c.c_int
    lib.fat_decode.argtypes = [ptr] * 8 + [ptr, ptr, shape, f32, f32, ptr]
    lib.fat_paged_decode.restype = c.c_int
    # The page table after lengths; then the self term's new K and V rows (or null).
    lib.fat_paged_decode.argtypes = [ptr] * 9 + [ptr, ptr, shape, f32, f32, ptr, ptr, ptr]
    # The decode step's glue (csrc/fused.cu): F1, F3, F2.
    lib.fat_add_rms_norm.restype = c.c_int
    lib.fat_add_rms_norm.argtypes = [ptr] * 5 + [i64, i64, f32, i32, ptr]  # x, delta, weight, x_new, h
    lib.fat_swiglu_act.restype = c.c_int
    lib.fat_swiglu_act.argtypes = [ptr, ptr, ptr, i64, i32, ptr]
    lib.fat_rope.restype = c.c_int
    lib.fat_rope.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # q, k, v, q_out, k_out, freqs, positions
        ptr, ptr, ptr, ptr, ptr,  # K / V cache rows, their scales, new lengths
        shape, i32, i32, ptr,  # csrc/fused.cu's RopeShape array, dtype, payload, stream
    ]
    lib.fat_rope_chunk.restype = c.c_int
    lib.fat_rope_chunk.argtypes = [
        ptr, ptr, ptr, ptr, ptr,  # q, k, v, q_out, freqs
        ptr, ptr, ptr,  # the slot (device int32), lengths, new lengths
        ptr, ptr, ptr, ptr, ptr,  # K / V cache rows or pages, their scales, the page table (or null: dense)
        shape, i32, i32, ptr,  # csrc/fused.cu's ChunkShape array, dtype, payload, stream
    ]
    # W8A16 products (csrc/w8.cu): x, int8 weight, scales, out, the shape
    # array, dtype, stream; a W1 group launch: x, the (weight, scales, out)
    # pointers of each weight, the shape array, dtype, stream.
    lib.fat_w8_matmul.restype = c.c_int
    lib.fat_w8_matmul.argtypes = [ptr] * 4 + [shape, i32, ptr]
    lib.fat_w8_group.restype = c.c_int
    lib.fat_w8_group.argtypes = [ptr, shape, shape, i32, ptr]
    # S1 (csrc/sampling.cu): logits and their row stride; temperature, top_k,
    # top_p, seeds, positions; tokens; the detail mode's noise, greedy picks,
    # kth and thresh (or null); batch, vocab, stream.
    lib.fat_sample.restype = c.c_int
    lib.fat_sample.argtypes = [ptr, i64] + [ptr] * 10 + [i64, i64, ptr]
    lib.fat_paged_write.restype = c.c_int
    lib.fat_paged_write.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,  # k/v new, k/v pool, lengths, table
        ptr, i32, ptr,  # slots, whether they are int64, new lengths
        i64, i64, i64, i64, i64,  # layers, n, slots in the table, heads, row bytes
        i64, i64, i64,  # num_pages, page_size, pages_per_slot
        i64, i64, i64, i64, ptr,  # pool byte strides (layer, page, head, row), stream
    ]
    lib.fat_paged_write_quant.restype = c.c_int
    lib.fat_paged_write_quant.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,  # k/v new, k/v payload pools, k/v scale pools
        ptr, ptr, ptr, i32, ptr,  # lengths, table, slots, whether they are int64, new lengths
        i64, i64, i64, i64, i64,  # layers, n, slots in the table, heads, head_dim
        i64, i64, i64,  # num_pages, page_size, pages_per_slot
        i64, i64, i64, i64,  # payload element strides (layer, page, head, row)
        i64, i64, i64,  # scale strides (layer, page, head)
        i32, i32, ptr,  # dtype, payload, stream
    ]
    bwd_args = [
        i64, i64, i64, i64, i64, i64,  # batch, Hq, Hkv, Sq, Skv, D
        i64, i64, i64, i64, i64, i64, i64, i64, i64, i64, i64, i64,  # q/k/v/dO strides
        f32, f32, i32,  # scale2, sm_scale, causal
        i32, f32, ptr, ptr, ptr, ptr,  # window, softcap2, segment ids of q and kv, their tile ranges
        i32, ptr,  # dtype, stream
    ]
    # q, k, v, dO, lse, delta, then the outputs: dq (K4); dk, dv (K5); fp32
    # dq accumulator, dk, dv (K3). Each then takes the lse / delta row pitch,
    # and K5 its split count and fp32 workspace.
    tails = {"fat_flash_bwd_dq": [i64], "fat_flash_bwd_dkv": [i64, i32, ptr], "fat_flash_bwd_fused": [i64]}
    for entry, n_out in (("fat_flash_bwd_dq", 1), ("fat_flash_bwd_dkv", 2), ("fat_flash_bwd_fused", 3)):
        fn = getattr(lib, entry)
        fn.restype = c.c_int
        fn.argtypes = [ptr] * (6 + n_out) + bwd_args + tails[entry]
    lib.fat_flash_bwd_dkv_sum.restype = c.c_int
    lib.fat_flash_bwd_dkv_sum.argtypes = [
        ptr, ptr, ptr, i64, i32, i64,  # workspace, dk, dv, B * Hkv, splits, Skv * D
        i32, ptr,  # dtype, stream
    ]
    # The probes' bodies (csrc/probes.cu; flash_attention_tpu_torch/tools/probes.py).
    lib.fat_probe_tiled.restype = c.c_int
    lib.fat_probe_tiled.argtypes = [
        ptr, ptr, ptr, ptr, i64, i64,  # q, k, v, o, heads, seq
        i32, i32, i32, i32, i32, i32, ptr,  # bm, bn, arith, skip, mask, grid, stream
    ]
    lib.fat_probe_single.restype = c.c_int
    lib.fat_probe_single.argtypes = [
        ptr, ptr, ptr, ptr, i64, i64, f32,  # q, k, v, o, heads, seq, scale2
        i32, i32, i32, i32, ptr,  # stage, epilogue, mask, hb, stream
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


def kv_payload_code(what: str, head_dim: int, q, k, v, k_scales=None, v_scales=None) -> int:
    """Raise on a query and K/V cache no kernel instantiation takes, and
    return the cache's element code for the C entries: q's own dtype code
    for an unquantized cache, else the payload's (``k_scales``/``v_scales``
    given, fp32)."""
    if k_scales is None:
        check_operands(what, head_dim, q, k, v)
        return DTYPE_CODES[q.dtype]
    check_operands(what, head_dim, q)
    if k.dtype not in PAYLOAD_CODES or v.dtype != k.dtype:
        raise ValueError(f"{what}: a quantized cache is int8, float8_e4m3fn or float8_e5m2, got {k.dtype} / {v.dtype}")
    for t in (k, v, k_scales, v_scales):
        if t.device != q.device:
            raise ValueError(f"{what}: operands on {t.device} and {q.device}")
    if k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32:
        raise ValueError(f"{what}: scales must be float32, got {k_scales.dtype} / {v_scales.dtype}")
    return PAYLOAD_CODES[k.dtype]


def int64_array(values) -> ctypes.Array:
    """``values`` as a C int64 array, for the entries that take strides by pointer."""
    values = list(values)
    return (ctypes.c_int64 * len(values))(*values)


@functools.lru_cache(maxsize=256)
def int64_tuple_array(values: tuple) -> ctypes.Array:
    """``int64_array`` of a tuple, built once per distinct tuple: a decode
    step passes the same strides every call. Never written by the kernels."""
    return int64_array(values)


def on_device(device: torch.device):
    """A context making ``device`` current, or nothing when it is already
    (entering ``torch.cuda.device`` costs host time on every call)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def current_stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream, for a launch (one C
    call, where ``torch.cuda.current_stream(device).cuda_stream`` builds a
    Stream object on every call)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def as_int32(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when it is contiguous int32 (no dispatch at all), else a
    contiguous int32 copy."""
    return x if x.dtype == torch.int32 and x.is_contiguous() else x.to(torch.int32).contiguous()


def unit_last_stride(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself if its last dimension is contiguous, else a copy."""
    return x if x.stride(-1) == 1 else x.contiguous()


def check(err: int, what: str) -> None:
    if err:
        msg = kernels().fat_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
