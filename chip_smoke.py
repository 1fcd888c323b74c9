#!/usr/bin/env python3
"""Drive the PyTorch port (flash_attention_tpu_torch) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

  1. device   — requires a CUDA card; prints its name and power limit and
                the torch, CUDA and nvcc versions.
  2. build    — builds the CUDA kernels and the native scheduler from the
                repository's sources, and prints the build seconds.
  3. kernels  — K1 (flash_fwd.cu) and K6 (decode.cu) at the serving path's
                shapes in bf16, against their plain PyTorch versions and the
                fp32 oracle, with CUDA-event times of kernel and plain; then
                every dtype / head_dim instantiation at ragged shapes.
  4. tiny     — a tiny fp32 model served on the card (through the kernels)
                and on the CPU (through the plain versions): the greedy
                tokens must be identical.
  5. full     — ModelConfig() at full width, bf16, random weights from a
                seed; ServingEngine serves 10 greedy requests on 8 slots;
                every completion must have 32 tokens, the logits must be
                finite, and both kernels must have been launched by the run.
  6. paged    — K7 (decode.cu, paged), K8 (flash_fwd.cu, paged) and K9/K10
                (paged_write.cu) at the paged path's shapes in bf16 over a
                shuffled page table, against their plain versions (K9/K10
                bit-exact) and the fp32 oracle, the outputs also row by row
                relative to the row's largest value; then every dtype /
                head_dim instantiation at ragged shapes and two page sizes.
  7. tiny paged — the tiny fp32 model through PagedServingEngine on the
                card and on the CPU: tokens identical to each other and to
                the dense engine's; the prefix cache gives the same tokens.
  8. full paged — PagedServingEngine at full width on phase 5's weights:
                phase 5's requests, then requests sharing a 1024-token
                prefix through the prefix cache; K7, K8 and K10 launched,
                K1 and K6 not.
  9. quant    — the quantized kernels with bf16 queries, for int8, fp8
                e4m3 and fp8 e5m2 caches whose rows are scaled one by one:
                K6q and K7q at phase 3's and 6's shapes and at 32 slots x
                8192 rows, K8q at kv_end 256 / 1024 / 2048, K9q/K10q (32
                layers x 8 slots, bit-equal to plain, payload and scales);
                each against its plain version, the fp32 oracle on the
                dequantized cache and, as information, the oracle on the
                unquantized rows. K6q and K7q at 8192 rows must allocate
                under 1 % of a bf16 copy of the cache; K6 over every finite
                code of each payload type must return the codes exactly.
                Then every (query dtype, payload, head_dim) instantiation
                of K6q, K7q, K8q and K9q/K10q at ragged shapes.
 10. tiny quant — the tiny fp32 model with each kv_quant mode and with int8
                weights through both engines on the card and on the CPU:
                each engine's tokens identical on both; paged and dense
                agree on every prefill token (after it, over a quantized
                cache, the paged engine merges the current token at full
                precision and the dense one attends it quantized, as in the
                JAX package; where they part is printed); prefix cache on
                == off.
 11. full quant — phase 5's weights at full width: ServingEngine with int8
                weights and an int8 cache on phase 5's requests, and
                PagedServingEngine with an fp8_e4m3 cache on phase 8's runs;
                K6q, K7q, K8q and K10q launched, K6, K7, K8 and K10 not.

Every phase prints kernel, plain-version, library-call and bound times
(the bound: the larger of the bytes over 3.35 TB/s and the operations over
989 TFLOP/s, from this run's shapes) with the card's name and power limit.
The last lines of standard output are one JSON object describing the
kernels, the card's name and power limit, then {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import time

# The JAX package's name. The kernels' report labels each CUDA kernel with
# the file:line of the TPU kernel it replaces, under that package's
# directory; the script reads nothing there.
REFERENCE = "flash_attention_tpu"
ORACLE_BAR = 0.1  # the repository's pass bar against the fp32 oracle
PLAIN_BAR = 1e-2  # kernel vs plain in bf16: the same fp32 math in another order
# Base-2 LSE, fp32, kernel vs plain and oracle: measured within 2e-6 on the
# H100; one row dropped from 2048 moves it by log2(2048/2047) = 7e-4.
LSE_BAR = 1e-4
# The paged kernels' outputs, row by row (one query row of one head):
# max|kernel - ref| / max|ref| in the row. Two roundings of nearly equal
# fp32 values differ by at most one unit in the last place, 2^-7 of the
# element in bf16, 2^-10 in fp16; an output of means over thousands of
# rows is smaller than any absolute bar worth having, so the bar is relative.
REL_BAR = {"float32": 1e-3, "float16": 1e-2, "bfloat16": 1e-2}
TINY_CFG = dict(
    vocab_size=128, model_dim=128, num_layers=2, num_q_heads=4,
    num_kv_heads=2, head_dim=32, mlp_dim=256, dtype="float32",
)
FULL_PROMPT_LENS = (1, 37, 255, 256, 257, 600, 1024, 1100, 1500, 1791)
FULL_NEW_TOKENS = 32
PAGED_LENGTHS = (0, 1, 127, 128, 129, 1000, 2047, 2048)  # phase 6, K7; slot 0 on the dump page
QUANT_MODES = ("int8", "fp8_e4m3", "fp8_e5m2")
LONG = dict(slots=32, rows=8192)  # BASELINE config 4: 32 slots x 8192 rows, 32 q / 8 kv heads, head_dim 128
PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, warmup: int = 5, iters: int = 20) -> float:
    """Median CUDA-event time of ``fn`` in milliseconds."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take (ms), and what bounds it."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def causal_pairs(q_len: int, kv_len: int) -> int:
    """(query, key) pairs an end-aligned causal mask leaves visible."""
    return sum(min(kv_len, i + kv_len - q_len + 1) for i in range(q_len))


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    from flash_attention_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True, text=True, check=True)
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> float:
    from flash_attention_tpu_torch import native
    from flash_attention_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.kernels()
    native.load()
    secs = time.perf_counter() - t0
    log(f"[build] CUDA kernels + native scheduler built and loaded in {secs:.1f} s")
    return secs


def _max_diff(a, b) -> float:
    import torch

    finite = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)) or not torch.equal(a[~finite], b[~finite]):
        return float("inf")  # non-finite entries (the -inf LSE of an empty row) must agree exactly
    return float((a[finite].float() - b[finite].float()).abs().max()) if finite.any() else 0.0


def _rel_diff(a, b) -> float:
    """max over rows (all dims but the last) of max|a - b| / max|b| in the
    row; a row where b is all 0 (an empty slot's) must be 0 in a as well."""
    import torch

    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    err, scale = (a - b).abs().amax(1), b.abs().amax(1)
    empty = torch.where(err > 0, torch.full_like(err, float("inf")), torch.zeros_like(err))
    rel = torch.where(scale > 0, err / scale.clamp(min=1e-30), empty)
    return float(rel.max()) if rel.numel() else 0.0


def phase_k1(card: str) -> dict:
    """K1 at the chunked-prefill shapes (q [1,32,256,128] against a cache
    slice of kv_len rows) and the one-shot prefill shape (Sq = Skv = 512)."""
    import torch
    import torch.nn.functional as F

    from flash_attention_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from flash_attention_tpu_torch.ops.reference import reference_attention_with_lse
    from flash_attention_tpu_torch.utils.testing import make_qkv

    dev = torch.device("cuda")
    scale = 1.0 / 128**0.5
    worst_plain, rep = 0.0, None
    cases = [(256, kv, True) for kv in (256, 1024, 2048)] + [(512, 512, False)]
    for q_len, kv_len, from_cache in cases:
        q, k, v = make_qkv(1, 1, 32, q_len, 128, num_kv_heads=8, kv_seq=kv_len, dtype=torch.bfloat16, device=dev)
        if from_cache:
            # The main path's operand: a strided view of slot 3 of a
            # [8, 8, 2048, 128] cache, not a contiguous copy.
            k_cache = torch.zeros((8, 8, 2048, 128), dtype=torch.bfloat16, device=dev)
            v_cache = torch.zeros_like(k_cache)
            k_cache[3, :, :kv_len] = k[0]
            v_cache[3, :, :kv_len] = v[0]
            k, v = k_cache[3:4, :, :kv_len], v_cache[3:4, :, :kv_len]
        out, lse = flash_attention(q, k, v, causal=True, save_residuals=True)
        p_out, p_lse = flash_attention_plain(q, k, v, causal=True, sm_scale=scale, save_residuals=True)
        o_out, o_lse = reference_attention_with_lse(q, k, v, causal=True)
        torch.cuda.synchronize()
        d_oracle, d_plain = _max_diff(out, o_out), _max_diff(out, p_out)
        d_lse = max(_max_diff(lse, p_lse), _max_diff(lse, o_lse))
        ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True, save_residuals=True))
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=True, sm_scale=scale, save_residuals=True))
        log(
            f"[K1] q [1,32,{q_len},128] kv [1,8,{kv_len},128] bf16 causal+lse: "
            f"|out-oracle| {d_oracle:.3e} (bar {ORACLE_BAR}), |out-plain| {d_plain:.3e} (bar {PLAIN_BAR}), "
            f"|lse| {d_lse:.3e} (bar {LSE_BAR}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms ({card})"
        )
        if not (d_oracle < ORACLE_BAR and d_plain < PLAIN_BAR and d_lse < LSE_BAR):
            raise RuntimeError(f"K1 disagrees at q_len={q_len} kv_len={kv_len}")
        worst_plain = max(worst_plain, d_plain)
        if (q_len, kv_len) == (256, 2048):
            # The library yardstick: one SDPA call with the end-aligned mask.
            mask = torch.arange(kv_len, device=dev)[None, :] <= torch.arange(q_len, device=dev)[:, None] + (kv_len - q_len)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True))
            flops = 4 * 128 * 32 * causal_pairs(q_len, kv_len)
            nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse.numel()
            bound_ms, bound_by = bound(flops, nbytes)
            log(
                f"[K1] at kv 2048: SDPA (library) {lib_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} "
                f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) ({card})"
            )
            rep = (ms, plain_ms, lib_ms, bound_ms, bound_by)
    return {
        "name": "flash_fwd (K1)", "route": "cuda",
        "source": "flash_attention_tpu_torch/csrc/flash_fwd.cu",
        "replaces": f"{REFERENCE}/ops/flash_attention.py:57",
        "max_abs_err": worst_plain, "ms": rep[0], "plain_ms": rep[1],
        "library_ms": rep[2], "bound_ms": rep[3], "bound_by": rep[4],
    }


def phase_k6(card: str) -> dict:
    """K6 at the decode shape: q [8,32,128] against a [8,8,2048,128] cache."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from flash_attention_tpu_torch.ops.decode import decode_attention, decode_attention_plain
    from flash_attention_tpu_torch.ops.reference import reference_attention

    dev = torch.device("cuda")
    rng = np.random.default_rng(6)

    def uniform(shape):
        return torch.from_numpy(rng.uniform(-0.5, 0.5, shape).astype(np.float32)).to(dev, torch.bfloat16)

    q = uniform((8, 32, 128))
    k_cache, v_cache = uniform((8, 8, 2048, 128)), uniform((8, 8, 2048, 128))
    lengths = torch.tensor([0, 1, 255, 256, 1000, 2047, 2048, 7], dtype=torch.int32, device=dev)
    out = decode_attention(q, k_cache, v_cache, lengths)
    p_out = decode_attention_plain(q, k_cache, v_cache, lengths, sm_scale=1.0 / 128**0.5)
    o_out = reference_attention(q[:, :, None, :], k_cache, v_cache, kv_length=lengths)[:, :, 0]
    torch.cuda.synchronize()
    d_oracle, d_plain = _max_diff(out, o_out), _max_diff(out, p_out)
    if not bool((out[0] == 0).all()):
        raise RuntimeError("K6: an empty slot (length 0) must give output 0")
    ms = cuda_ms(lambda: decode_attention(q, k_cache, v_cache, lengths))
    plain_ms = cuda_ms(lambda: decode_attention_plain(q, k_cache, v_cache, lengths, sm_scale=1.0 / 128**0.5))
    # The library yardstick: one SDPA call with a length mask (the empty
    # slot's row comes out NaN there; it is timed, not compared).
    mask = (torch.arange(2048, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], k_cache, v_cache, attn_mask=mask, enable_gqa=True))
    rows = int(lengths.sum())
    flops = 4 * 128 * 32 * rows
    nbytes = 2 * (2 * rows * 8 * 128) + 2 * (2 * q.numel()) + 4 * lengths.numel()  # K+V rows, q+out, bf16
    bound_ms, bound_by = bound(flops, nbytes)
    log(
        f"[K6] q [8,32,128] cache [8,8,2048,128] bf16 lengths {lengths.tolist()}: "
        f"|out-oracle| {d_oracle:.3e} (bar {ORACLE_BAR}), |out-plain| {d_plain:.3e} (bar {PLAIN_BAR}); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA (library) {lib_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB) ({card})"
    )
    if not (d_oracle < ORACLE_BAR and d_plain < PLAIN_BAR):
        raise RuntimeError("K6 disagrees")
    return {
        "name": "decode (K6)", "route": "cuda",
        "source": "flash_attention_tpu_torch/csrc/decode.cu",
        "replaces": f"{REFERENCE}/ops/decode.py:56",
        "max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms,
        "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
    }


def phase_kernel_sweep() -> None:
    """Every (dtype, head_dim) instantiation of both kernels at ragged
    shapes: Sq and Skv off the 64-row tiles, causal and not, GQA groups of
    1, 4 and 16 (K6 spreads a group over 8-row blocks)."""
    import torch

    from flash_attention_tpu_torch.ops.decode import decode_attention, decode_attention_plain
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from flash_attention_tpu_torch.ops.reference import reference_attention
    from flash_attention_tpu_torch.utils.testing import make_qkv

    plain_bar = {torch.float32: 1e-4, torch.float16: PLAIN_BAR, torch.bfloat16: PLAIN_BAR}
    worst = 0.0
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        for d in (32, 64, 128):
            for hq, hkv in ((4, 4), (4, 1), (16, 1)):
                q, k, v = make_qkv(d, 2, hq, 100, d, num_kv_heads=hkv, kv_seq=130, dtype=dtype, device="cuda")
                for causal in (True, False):
                    out = flash_attention(q, k, v, causal=causal)
                    plain = flash_attention_plain(q, k, v, causal=causal, sm_scale=d**-0.5, save_residuals=False)
                    d_oracle = _max_diff(out, reference_attention(q, k, v, causal=causal))
                    d_plain = _max_diff(out, plain)
                    if not (d_oracle < ORACLE_BAR and d_plain < plain_bar[dtype]):
                        raise RuntimeError(f"K1 {dtype} d={d} {hq}/{hkv} causal={causal}: {d_oracle} {d_plain}")
                    worst = max(worst, d_plain / plain_bar[dtype])
                lengths = torch.tensor([0, 130], dtype=torch.int32, device="cuda")
                out = decode_attention(q[:, :, 0], k, v, lengths)
                plain = decode_attention_plain(q[:, :, 0], k, v, lengths, sm_scale=d**-0.5)
                want = reference_attention(q[:, :, :1], k, v, kv_length=lengths)[:, :, 0]
                d_oracle, d_plain = _max_diff(out, want), _max_diff(out, plain)
                if not (d_oracle < ORACLE_BAR and d_plain < plain_bar[dtype]):
                    raise RuntimeError(f"K6 {dtype} d={d} {hq}/{hkv}: {d_oracle} {d_plain}")
                worst = max(worst, d_plain / plain_bar[dtype])
    log(
        "[sweep] K1 and K6 at fp32/fp16/bf16 x head_dim 32/64/128 x groups 1/4/16, ragged shapes: "
        f"all within 0.1 of the oracle; worst |kernel-plain| at {worst:.3f} of its bar "
        f"(fp32 1e-4, fp16/bf16 {PLAIN_BAR})"
    )


def _tensors(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples (NamedTuples: caches,
    QuantizedTensors), skipping None."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _tensors(sub)]
    return [] if tree is None else [tree]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    if isinstance(tree, tuple):  # a QuantizedTensor
        return type(tree)(*(_to_device(v, device) for v in tree))
    return tree.to(device)


def _counters() -> dict:
    """Every kernel's launch count, by name: (wrapper, attribute). A wrapper
    counts the launches over an unquantized cache in .launches and those over
    a quantized one (the K*q instantiations) in .quant_launches."""
    from flash_attention_tpu_torch.ops.decode import decode_attention
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention
    from flash_attention_tpu_torch.ops.paged import paged_decode_attention, paged_prefill_attention, paged_write_tokens_multi

    return {
        "K1": (flash_attention, "launches"),
        "K6": (decode_attention, "launches"), "K6q": (decode_attention, "quant_launches"),
        "K7": (paged_decode_attention, "launches"), "K7q": (paged_decode_attention, "quant_launches"),
        "K8": (paged_prefill_attention, "launches"), "K8q": (paged_prefill_attention, "quant_launches"),
        "K9/K10": (paged_write_tokens_multi, "launches"), "K9q/K10q": (paged_write_tokens_multi, "quant_launches"),
    }


def zero_counts() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in _counters().items()}


def check_launches(what: str, launches: dict, used) -> None:
    """The path launched every kernel in ``used`` and no other."""
    missing = [k for k in used if launches[k] < 1]
    stray = [k for k, n in launches.items() if n and k not in used]
    if missing or stray:
        raise RuntimeError(f"{what}: kernels {missing} not launched, {stray} launched: {launches}")


def tiny_requests():
    from flash_attention_tpu_torch.serving.engine import Request

    return [
        Request(id=1, prompt=(5, 9, 2), max_new_tokens=6),
        Request(id=2, prompt=(100, 3, 44, 8, 21, 60, 7), max_new_tokens=9),
        Request(id=3, prompt=(64,), max_new_tokens=4),
        Request(id=4, prompt=(11, 12, 13, 14), max_new_tokens=5),
        Request(id=5, prompt=(90, 2), max_new_tokens=3),
    ]


def phase_tiny() -> dict:
    """The same tiny fp32 params served on the card and on the CPU; returns
    the card's tokens."""
    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params
    from flash_attention_tpu_torch.serving.engine import ServingEngine

    cfg = ModelConfig(**TINY_CFG)
    params = init_model_params(torch.Generator().manual_seed(0), cfg)
    reqs = tiny_requests()
    results = {}
    for device in ("cuda", "cpu"):
        eng = ServingEngine(_to_device(params, device), cfg, max_slots=3, max_seq=64, prefill_chunk=16)
        results[device] = {rid: c.tokens for rid, c in eng.run(reqs).items()}
    log(f"[tiny] fp32 engine, 5 greedy requests on 3 slots: card {results['cuda']}")
    if results["cuda"] != results["cpu"]:
        raise RuntimeError(f"card and CPU tokens differ: {results['cuda']} vs {results['cpu']}")
    log("[tiny] card tokens == CPU tokens")
    return results["cuda"]


def phase_full(card: str):
    """ModelConfig() at full width, bf16, on 8 slots x 2048 positions.
    Returns the launch counts of the served run, the params and the
    engine's numbers."""
    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params

    cfg = ModelConfig()
    t0 = time.perf_counter()
    params = init_model_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _tensors(params))
    log(f"[full] ModelConfig() bf16: {n_params / 1e9:.3f} B params initialised on the card in {time.perf_counter() - t0:.1f} s")
    launches, numbers = serve_full_dense(card, "full", cfg, params, used=("K1", "K6"))
    return launches, params, numbers


def serve_full_dense(card: str, label: str, cfg, params, *, used, ref: dict | None = None):
    """ServingEngine over ``cfg`` / ``params`` at full width: a prefill-only
    run, then the main path (phase 5's 10 requests on 8 slots x 2048
    positions) with every launch count set to 0 just before and read just
    after; it must launch the kernels in ``used`` and no other. ``ref``: the
    bf16 run's numbers of this call, printed beside these. Returns the
    launch counts and the engine's numbers."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.models.transformer import decode_step_logits, init_caches, prefill
    from flash_attention_tpu_torch.serving.engine import Request, ServingEngine

    rng = np.random.default_rng(0)
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab_size, n)) for n in FULL_PROMPT_LENS]
    eng = ServingEngine(params, cfg, max_slots=8, max_seq=2048, prefill_chunk=256)

    # Prefill-only run (one sampled token per request): measures prefill
    # throughput and warms every path the main run takes.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = eng.run([Request(id=i, prompt=p, max_new_tokens=1) for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if any(len(first[i].tokens) != 1 for i in range(len(prompts))):
        raise RuntimeError("prefill-only run: every request must give exactly one token")
    n_prompt = sum(FULL_PROMPT_LENS)

    # The main path: counters to 0, serve, read the counters.
    eng.steps, eng.decode_tokens, eng.decode_time_s = 0, 0, 0.0
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run([Request(id=100 + i, prompt=p, max_new_tokens=FULL_NEW_TOKENS) for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[{label}] 10 requests on 8 slots: kernel launches {launches}; decode steps {eng.steps}")
    for i in range(len(prompts)):
        toks = done[100 + i].tokens
        if len(toks) != FULL_NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in toks):
            raise RuntimeError(f"request {100 + i}: {len(toks)} tokens, want {FULL_NEW_TOKENS} in vocab")
        if toks[0] != first[i].tokens[0]:
            raise RuntimeError(f"request {100 + i}: first greedy token differs between runs")
    check_launches(f"[{label}] the main path", launches, used)
    numbers = {
        "prefill_tok_s": n_prompt / prefill_s, "decode_tok_s": eng.decode_tokens / eng.decode_time_s,
        "peak_gib": peak / 2**30, "cache_gb": _nbytes([(c.k, c.v, c.k_scales, c.v_scales) for c in eng.caches]) / 1e9,
        "weights_gb": _nbytes(params) / 1e9,
    }
    decode_tokens, decode_s = eng.decode_tokens, eng.decode_time_s
    del eng

    # Logits of the same model, straight from the model functions: finite
    # and of the expected shape, one-shot prefill (K1) then one decode step.
    caches = init_caches(cfg, 1, 2048, device="cuda")
    toks = torch.as_tensor(prompts[5], device="cuda")[None]
    logits, caches = prefill(params, cfg, toks, caches)
    step_logits, _ = decode_step_logits(params, cfg, logits[:, -1:].argmax(-1).to(torch.int32), caches)
    if logits.shape != (1, len(prompts[5]), cfg.vocab_size) or step_logits.shape != (1, cfg.vocab_size):
        raise RuntimeError(f"logits shapes {tuple(logits.shape)} {tuple(step_logits.shape)}")
    if not (bool(torch.isfinite(logits).all()) and bool(torch.isfinite(step_logits).all())):
        raise RuntimeError("non-finite logits at full width")
    del caches, logits, step_logits

    def beside(key: str, fmt: str = ".1f") -> str:
        return "" if ref is None else f" (bf16, phase 5: {ref[key]:{fmt}})"

    n_gen = sum(len(c.tokens) for c in done.values())
    log(
        f"[{label}] prefill: {n_prompt} prompt tokens in {prefill_s:.3f} s = {numbers['prefill_tok_s']:.1f} tok/s"
        f"{beside('prefill_tok_s')} (max_new_tokens=1 run, wall clock) ({card})"
    )
    log(
        f"[{label}] decode: {decode_tokens} tokens in {decode_s:.3f} s of decode section = "
        f"{numbers['decode_tok_s']:.1f} tok/s{beside('decode_tok_s')}; whole run {n_gen} tokens in {run_s:.3f} s ({card})"
    )
    log(
        f"[{label}] allocated: weights {numbers['weights_gb']:.3f} GB{beside('weights_gb', '.3f')}, KV cache with its "
        f"scales {numbers['cache_gb']:.4f} GB{beside('cache_gb', '.4f')}; peak device memory (max_memory_allocated) "
        f"{numbers['peak_gib']:.2f} GiB{beside('peak_gib', '.2f')} ({card})"
    )
    return launches, numbers


def _shuffled_table(rng, num_slots: int, pages_per_slot: int, num_pages: int, *, dump_slot: bool = True):
    """The slots' page tables as a random permutation of pages 1..num_pages-1,
    so a kernel reading pages in order fails; with ``dump_slot``, slot 0's
    row is all dump page 0, like a released slot's."""
    import numpy as np

    table = rng.permutation(np.arange(1, num_pages))[: num_slots * pages_per_slot]
    table = table.reshape(num_slots, pages_per_slot).astype(np.int32)
    if dump_slot:
        table[0] = 0
    return table


def _dense_from_pages(pages, table):
    """[slots, kv_heads, pages_per_slot * page_size, D] gathered from the
    pages here, independently of the port's own gather."""
    x = pages[table.long()]  # [S, n, H, page, D]
    s, n, h, page, d = x.shape
    return x.permute(0, 2, 1, 3, 4).reshape(s, h, n * page, d)


def _filled_cache(num_layers, *, num_pages, num_slots, pages_per_slot, kv_heads, head_dim, dtype, gen, page_size=128):
    """A PagedModelCache whose pools hold U(-0.5, 0.5)."""
    from flash_attention_tpu_torch.ops.paged import init_paged_model_cache

    cache = init_paged_model_cache(
        num_layers, num_pages=num_pages, num_slots=num_slots, pages_per_slot=pages_per_slot,
        kv_heads=kv_heads, page_size=page_size, head_dim=head_dim, dtype=dtype, device="cuda",
    )
    for pool in (cache.k_pool, cache.v_pool):
        pool.copy_(torch_uniform(pool.shape, dtype, gen))
    return cache


def torch_uniform(shape, dtype, gen):
    import torch

    return (torch.rand(shape, generator=gen, device="cuda") - 0.5).to(dtype)


def phase_paged_kernels(card: str):
    """K7, K8 and K9/K10 at the paged path's shapes, bf16, over one layer's
    pool [129, 8, 128, 128] (K10: 32 layers) with shuffled page tables."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.ops.paged import (
        PagedModelCache,
        paged_decode_attention,
        paged_decode_attention_plain,
        paged_prefill_attention,
        paged_prefill_attention_plain,
        paged_write_tokens,
        paged_write_tokens_multi,
        paged_write_tokens_plain,
    )
    from flash_attention_tpu_torch.ops.reference import reference_attention, reference_attention_with_lse

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    rel_bar = REL_BAR["bfloat16"]
    rng = np.random.default_rng(7)
    gen = torch.Generator(device=dev).manual_seed(7)
    scale = 1.0 / 128**0.5
    cache = _filled_cache(1, num_pages=129, num_slots=8, pages_per_slot=16, kv_heads=8, head_dim=128, dtype=bf16,
                          gen=gen).layers()[0]
    table = torch.from_numpy(_shuffled_table(rng, 8, 16, 129)).to(dev)
    cache.page_table.copy_(table)
    lengths = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device=dev)
    cache = cache._replace(lengths=lengths)
    k_dense, v_dense = _dense_from_pages(cache.k_pages, table), _dense_from_pages(cache.v_pages, table)

    # K7: decode with LSE through the page table.
    q = torch_uniform((8, 32, 128), bf16, gen)
    out, lse = paged_decode_attention(q, cache, save_residuals=True)
    p_out, p_lse = paged_decode_attention_plain(q, cache, sm_scale=scale, save_residuals=True)
    o_out, o_lse = reference_attention_with_lse(q[:, :, None], k_dense, v_dense, kv_length=lengths)
    torch.cuda.synchronize()
    d_oracle, d_plain = _max_diff(out, o_out[:, :, 0]), _max_diff(out, p_out)
    d_rel = max(_rel_diff(out, o_out[:, :, 0]), _rel_diff(out, p_out))
    d_lse = max(_max_diff(lse, p_lse), _max_diff(lse, o_lse[:, :, 0]))
    if not (bool((out[0] == 0).all()) and bool(torch.isneginf(lse[0]).all())):
        raise RuntimeError("K7: the dump-page slot of length 0 must give output 0 and LSE -inf")
    ms = cuda_ms(lambda: paged_decode_attention(q, cache, save_residuals=True))
    plain_ms = cuda_ms(lambda: paged_decode_attention_plain(q, cache, sm_scale=scale, save_residuals=True))
    rows = sum(PAGED_LENGTHS)
    pages_read = sum(-(-n // 128) for n in PAGED_LENGTHS)
    nbytes = 2 * (2 * rows * 8 * 128) + 2 * (2 * q.numel()) + 4 * (lse.numel() + lengths.numel() + pages_read)
    bound_ms, bound_by = bound(4 * 128 * 32 * rows, nbytes)
    log(
        f"[K7] q [8,32,128] pages [129,8,128,128] bf16, shuffled table [8,16], lengths {list(PAGED_LENGTHS)}: "
        f"|out-oracle| {d_oracle:.3e} (bar {ORACLE_BAR}), |out-plain| {d_plain:.3e} (bar {PLAIN_BAR}), "
        f"row-relative vs plain and oracle {d_rel:.3e} (bar {rel_bar}), |lse| {d_lse:.3e} (bar {LSE_BAR}); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library none, "
        f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB) ({card})"
    )
    if not (d_oracle < ORACLE_BAR and d_plain < PLAIN_BAR and d_rel < rel_bar and d_lse < LSE_BAR):
        raise RuntimeError("K7 disagrees")
    k7 = {
        "name": "paged_decode (K7)", "route": "cuda",
        "source": "flash_attention_tpu_torch/csrc/decode.cu",
        "replaces": f"{REFERENCE}/ops/paged.py:980",
        "max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }

    # K8: a 256-row chunk at [kv_end - 256, kv_end) of slot 7 (16 pages).
    worst_plain = 0.0
    for kv_end in (256, 1024, 2048):
        qc = torch_uniform((1, 32, 256, 128), bf16, gen)
        out = paged_prefill_attention(qc, cache, 7, kv_end, chunk_len=256)
        p_out = paged_prefill_attention_plain(qc, cache, 7, kv_end, sm_scale=scale)
        o_out = reference_attention(qc, k_dense[7:8, :, :kv_end], v_dense[7:8, :, :kv_end], causal=True)
        torch.cuda.synchronize()
        d_oracle, d_plain = _max_diff(out, o_out), _max_diff(out, p_out)
        d_rel = max(_rel_diff(out, o_out), _rel_diff(out, p_out))
        ms = cuda_ms(lambda: paged_prefill_attention(qc, cache, 7, kv_end, chunk_len=256))
        plain_ms = cuda_ms(lambda: paged_prefill_attention_plain(qc, cache, 7, kv_end, sm_scale=scale))
        flops = 4 * 128 * 32 * causal_pairs(256, kv_end)
        nbytes = 2 * (2 * qc.numel() + 2 * kv_end * 8 * 128) + 4 * (kv_end // 128)
        bound_ms, bound_by = bound(flops, nbytes)
        log(
            f"[K8] q [1,32,256,128] over slot 7's pages to kv_end {kv_end}, bf16: |out-oracle| {d_oracle:.3e} "
            f"(bar {ORACLE_BAR}), |out-plain| {d_plain:.3e} (bar {PLAIN_BAR}), row-relative vs plain and "
            f"oracle {d_rel:.3e} (bar {rel_bar}); kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, library none, bound {bound_ms:.4f} ms by {bound_by} ({card})"
        )
        if not (d_oracle < ORACLE_BAR and d_plain < PLAIN_BAR and d_rel < rel_bar):
            raise RuntimeError(f"K8 disagrees at kv_end={kv_end}")
        worst_plain = max(worst_plain, d_plain)
    k8 = {
        "name": "paged_prefill (K8)", "route": "cuda",
        "source": "flash_attention_tpu_torch/csrc/flash_fwd.cu",
        "replaces": f"{REFERENCE}/ops/paged.py:580",
        "max_abs_err": worst_plain, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    del cache, k_dense, v_dense

    # K10: one token row per slot into 32 layers. Slot 0 is a released slot
    # (dump-page table, frozen length 37), slot 1 is at capacity.
    num_layers = 32
    cache = _filled_cache(num_layers, num_pages=129, num_slots=8, pages_per_slot=16, kv_heads=8, head_dim=128,
                          dtype=bf16, gen=gen)
    w_table = torch.from_numpy(_shuffled_table(rng, 8, 16, 129)).to(dev)
    cache.page_table.copy_(w_table)
    w_lengths = torch.tensor([37, 2048, 5, 127, 128, 129, 1000, 2047], dtype=torch.int32, device=dev)
    cache = cache._replace(lengths=w_lengths)
    slots = torch.arange(8, device=dev)
    k_new, v_new = torch_uniform((num_layers, 8, 8, 128), bf16, gen), torch_uniform((num_layers, 8, 8, 128), bf16, gen)
    # The plain version writes into a copy of the pools.
    plain = PagedModelCache(cache.k_pool.clone(), cache.v_pool.clone(), w_table.clone(), w_lengths.clone())
    written = paged_write_tokens_multi(cache, k_new, v_new, slots)
    valid = paged_write_tokens_plain(plain, k_new, v_new, slots)
    torch.cuda.synchronize()
    same = torch.equal(cache.k_pool, plain.k_pool) and torch.equal(cache.v_pool, plain.v_pool)
    want_lengths = w_lengths + valid
    dumped = torch.equal(cache.k_pool[:, 0, :, 37], k_new[:, 0])
    if not (same and dumped and valid.tolist() == [1, 0, 1, 1, 1, 1, 1, 1]
            and torch.equal(written.lengths, want_lengths) and cache.lengths.tolist()[1] == 2048):
        raise RuntimeError("K10 disagrees with its plain version (bit-exact), or advanced lengths wrongly")
    ms = cuda_ms(lambda: paged_write_tokens_multi(cache, k_new, v_new, slots))
    plain_ms = cuda_ms(lambda: paged_write_tokens_plain(plain, k_new, v_new, slots))
    # The library yardstick: index_put_ of the valid rows into the K and the
    # V pool ([L, pages, heads, page, D] indexed by layer, page, head, row).
    ok = valid.bool()
    pos = w_lengths[ok].long()
    idx = (
        torch.arange(num_layers, device=dev)[:, None, None],
        w_table[slots[ok], pos // 128].long()[None, :, None],
        torch.arange(8, device=dev)[None, None, :],
        (pos % 128)[None, :, None],
    )
    rows_k, rows_v = k_new[:, ok], v_new[:, ok]
    lib_ms = cuda_ms(lambda: (plain.k_pool.index_put_(idx, rows_k), plain.v_pool.index_put_(idx, rows_v)))
    n_valid = int(ok.sum())
    nbytes = 2 * (2 * num_layers * n_valid * 8 * 128 * 2) + 4 * 4 * 8  # rows read + written; lengths, table, slots, valid
    bound_ms, bound_by = bound(0, nbytes)
    log(
        f"[K10] 32 layers x 8 slots x rows [8,128] bf16 into pools [32,129,8,128,128], one slot at capacity, "
        f"one on the dump page: bit-equal to plain, lengths advanced where valid {valid.tolist()}; "
        f"wrapper {ms:.4f} ms, plain {plain_ms:.4f} ms, index_put_ K and V (library) {lib_ms:.4f} ms, "
        f"bound {bound_ms:.5f} ms by {bound_by} ({nbytes / 1e6:.2f} MB) ({card})"
    )
    k10 = {
        "name": "paged_write (K9/K10)", "route": "cuda",
        "source": "flash_attention_tpu_torch/csrc/paged_write.cu",
        "replaces": f"{REFERENCE}/ops/paged.py:257",
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }

    # K9: the same kernel with one layer, writing new rows into layer 0.
    k_one, v_one = torch_uniform((8, 8, 128), bf16, gen), torch_uniform((8, 8, 128), bf16, gen)
    plain_one = PagedModelCache(plain.k_pool[:1], plain.v_pool[:1], plain.page_table, plain.lengths)
    one = paged_write_tokens(cache.layers()[0], k_one, v_one, slots)
    paged_write_tokens_plain(plain_one, k_one[None], v_one[None], slots)
    torch.cuda.synchronize()
    if not (torch.equal(cache.k_pool, plain.k_pool) and torch.equal(cache.v_pool, plain.v_pool)
            and torch.equal(cache.k_pool[0, 0, :, 37], k_one[0]) and torch.equal(one.lengths, want_lengths)):
        raise RuntimeError("K9 (one layer) disagrees with its plain version")
    ms9 = cuda_ms(lambda: paged_write_tokens(cache.layers()[0], k_one, v_one, slots))
    plain9 = cuda_ms(lambda: paged_write_tokens_plain(plain_one, k_one[None], v_one[None], slots))
    idx9 = idx[1][0], idx[2][0], idx[3][0]  # [page, head, row] of the valid rows in one layer
    rows9_k, rows9_v = k_one[ok], v_one[ok]
    lib9 = cuda_ms(lambda: (plain.k_pool[0].index_put_(idx9, rows9_k), plain.v_pool[0].index_put_(idx9, rows9_v)))
    bound9, by9 = bound(0, 2 * (2 * n_valid * 8 * 128 * 2) + 4 * 4 * 8)
    log(
        f"[K9] one layer: bit-equal to plain; wrapper {ms9:.4f} ms, plain {plain9:.4f} ms, index_put_ K and V "
        f"(library) {lib9:.4f} ms, bound {bound9:.5f} ms by {by9} ({card})"
    )
    return k7, k8, k10


def phase_paged_sweep() -> None:
    """Every (dtype, head_dim) instantiation of K7, K8 and K9/K10 at ragged
    shapes: kv lengths off the 64-row tiles, GQA groups of 1, 4 and 16,
    pages of 64 and 128 rows (64-row chunks on the 64-row pages), a
    dump-page slot and a slot at capacity."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.ops.paged import (
        PagedModelCache,
        paged_decode_attention,
        paged_decode_attention_plain,
        paged_prefill_attention,
        paged_prefill_attention_plain,
        paged_write_tokens_multi,
        paged_write_tokens_plain,
    )
    from flash_attention_tpu_torch.ops.reference import reference_attention, reference_attention_with_lse

    rng = np.random.default_rng(8)
    gen = torch.Generator(device="cuda").manual_seed(8)
    plain_bar = {torch.float32: 1e-4, torch.float16: PLAIN_BAR, torch.bfloat16: PLAIN_BAR}
    worst, worst_rel = 0.0, 0.0
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        rel_bar = REL_BAR[str(dtype).removeprefix("torch.")]
        for d in (32, 64, 128):
            for hq, hkv in ((4, 4), (4, 1), (16, 1)):
                for page in (64, 128):
                    what = f"{dtype} d={d} {hq}/{hkv} page {page}"
                    per_slot = 256 // page
                    cache = _filled_cache(2, num_pages=1 + 3 * per_slot, num_slots=3, pages_per_slot=per_slot,
                                          kv_heads=hkv, head_dim=d, dtype=dtype, gen=gen, page_size=page)
                    table = torch.from_numpy(_shuffled_table(rng, 3, per_slot, 1 + 3 * per_slot)).cuda()
                    cache.page_table.copy_(table)
                    lengths = torch.tensor([0, 37, 200], dtype=torch.int32, device="cuda")
                    c = cache._replace(lengths=lengths).layers()[0]
                    k_dense, v_dense = _dense_from_pages(c.k_pages, table), _dense_from_pages(c.v_pages, table)
                    q = torch_uniform((3, hq, d), dtype, gen)
                    out, lse = paged_decode_attention(q, c, save_residuals=True)
                    p_out, p_lse = paged_decode_attention_plain(q, c, sm_scale=d**-0.5, save_residuals=True)
                    o_out, o_lse = reference_attention_with_lse(q[:, :, None], k_dense, v_dense, kv_length=lengths)
                    d_oracle, d_plain = _max_diff(out, o_out[:, :, 0]), _max_diff(out, p_out)
                    d_rel = max(_rel_diff(out, o_out[:, :, 0]), _rel_diff(out, p_out))
                    d_lse = max(_max_diff(lse, p_lse), _max_diff(lse, o_lse[:, :, 0]))
                    if not (d_oracle < ORACLE_BAR and d_plain < plain_bar[dtype] and d_rel < rel_bar
                            and d_lse < LSE_BAR):
                        raise RuntimeError(f"K7 {what}: {d_oracle} {d_plain} {d_rel} {d_lse}")
                    worst = max(worst, d_plain / plain_bar[dtype])
                    worst_rel = max(worst_rel, d_rel / rel_bar)
                    chunk = min(page, 128)
                    qc = torch_uniform((1, hq, chunk, d), dtype, gen)
                    out = paged_prefill_attention(qc, c, 2, 200, chunk_len=chunk)
                    p_out = paged_prefill_attention_plain(qc, c, 2, 200, sm_scale=d**-0.5)
                    o_out = reference_attention(qc, k_dense[2:3, :, :200], v_dense[2:3, :, :200], causal=True)
                    d_oracle, d_plain = _max_diff(out, o_out), _max_diff(out, p_out)
                    d_rel = max(_rel_diff(out, o_out), _rel_diff(out, p_out))
                    if not (d_oracle < ORACLE_BAR and d_plain < plain_bar[dtype] and d_rel < rel_bar):
                        raise RuntimeError(f"K8 {what}: {d_oracle} {d_plain} {d_rel}")
                    worst = max(worst, d_plain / plain_bar[dtype])
                    worst_rel = max(worst_rel, d_rel / rel_bar)
                    w_lengths = torch.tensor([5, 127, 256], dtype=torch.int32, device="cuda")  # slot 2 at capacity
                    cache = cache._replace(lengths=w_lengths)
                    k_new, v_new = torch_uniform((2, 3, hkv, d), dtype, gen), torch_uniform((2, 3, hkv, d), dtype, gen)
                    copy = PagedModelCache(cache.k_pool.clone(), cache.v_pool.clone(), table, w_lengths)
                    slots = torch.tensor([2, 0, 1], device="cuda")
                    written = paged_write_tokens_multi(cache, k_new, v_new, slots)
                    valid = paged_write_tokens_plain(copy, k_new, v_new, slots)
                    if not (torch.equal(cache.k_pool, copy.k_pool) and torch.equal(cache.v_pool, copy.v_pool)
                            and valid.tolist() == [0, 1, 1] and written.lengths.tolist() == [6, 128, 256]):
                        raise RuntimeError(f"K10 {what}: not bit-equal to plain")
    torch.cuda.synchronize()
    log(
        "[paged sweep] K7, K8 and K9/K10 at fp32/fp16/bf16 x head_dim 32/64/128 x groups 1/4/16 x pages of "
        "64/128 rows, lengths {0 (dump page), 37, 200}, chunk rows [72, 200) and [136, 200): all within 0.1 of "
        f"the oracle, writes bit-equal; worst |kernel-plain| at {worst:.3f} of its bar (fp32 1e-4, fp16/bf16 "
        f"{PLAIN_BAR}), worst row-relative difference at {worst_rel:.3f} of its bar {REL_BAR}"
    )


def phase_tiny_paged(dense_tokens: dict) -> None:
    """The tiny fp32 params through PagedServingEngine on the card and on
    the CPU: tokens identical to each other and to the dense engine's on
    the card; then a shared 256-token prefix through the prefix cache."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params
    from flash_attention_tpu_torch.serving.engine import Request
    from flash_attention_tpu_torch.serving.paged_engine import PagedServingEngine

    cfg = ModelConfig(**TINY_CFG)
    params = init_model_params(torch.Generator().manual_seed(0), cfg)
    results = {}
    for device in ("cuda", "cpu"):
        eng = PagedServingEngine(_to_device(params, device), cfg, max_slots=3, num_pages=16, pages_per_slot=2, page_size=128)
        results[device] = {rid: c.tokens for rid, c in eng.run(tiny_requests()).items()}
    log(f"[tiny paged] fp32 paged engine, 5 greedy requests on 3 slots: card {results['cuda']}")
    if not results["cuda"] == results["cpu"] == dense_tokens:
        raise RuntimeError(f"paged card / paged CPU / dense card tokens differ: {results} vs {dense_tokens}")
    rng = np.random.default_rng(23)
    prefix = tuple(int(t) for t in rng.integers(0, cfg.vocab_size, 256))
    reqs = [
        Request(id=10 + i, prompt=prefix + tuple(int(t) for t in rng.integers(0, cfg.vocab_size, 40)), max_new_tokens=8)
        for i in range(3)
    ]
    on_card = _to_device(params, "cuda")
    tokens, hits = {}, {}
    for cached in (False, True):
        eng = PagedServingEngine(on_card, cfg, max_slots=2, num_pages=16, pages_per_slot=4, page_size=128,
                                 prefill_chunk=128, prefix_cache=cached)
        tokens[cached] = {r.id: eng.run([r])[r.id].tokens for r in reqs}  # one at a time: later ones hit
        hits[cached] = eng.prefix_hits
    log(f"[tiny paged] shared 256-token prefix: prefix_hits {hits[True]}; tokens with cache == without")
    if hits[True] <= 0 or tokens[True] != tokens[False]:
        raise RuntimeError(f"prefix cache: hits {hits[True]}, tokens {tokens[True]} vs {tokens[False]}")
    log("[tiny paged] paged card tokens == paged CPU tokens == dense card tokens")


def serve_full_paged(card: str, label: str, cfg, params, *, used, dense: dict, ref: dict | None = None):
    """PagedServingEngine over ``cfg`` / ``params`` at full width (phase 8;
    the dense engine and its caches are gone): a prefill-only run, then the
    main path, runs A and B, with every launch count set to 0 just before
    and read just after; it must launch the kernels in ``used`` and no
    other. ``dense``: the dense run's numbers of the same weights and cache
    type; ``ref``: the bf16 paged run's. Returns the launch counts and the
    engine's numbers."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.models.transformer import decode_step_logits_paged, prefill_chunk_paged
    from flash_attention_tpu_torch.serving.engine import Request
    from flash_attention_tpu_torch.serving.paged_engine import PagedServingEngine

    torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab_size, n)) for n in FULL_PROMPT_LENS]  # phase 5's
    eng = PagedServingEngine(params, cfg, max_slots=8, num_pages=129, pages_per_slot=16, page_size=128,
                             prefill_chunk=256, prefix_cache=True)
    pc = eng.caches
    pool_gb = _nbytes((pc.k_pool, pc.v_pool, pc.k_scales, pc.v_scales)) / 1e9

    # Prefill-only run with the prefix cache off (nothing registered):
    # measures paged prefill throughput and warms the path.
    eng.prefix_cache_enabled = False
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = eng.run([Request(id=i, prompt=p, max_new_tokens=1) for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    eng.prefix_cache_enabled = True
    if any(len(first[i].tokens) != 1 for i in range(len(prompts))):
        raise RuntimeError("paged prefill-only run: every request must give exactly one token")

    # The paged main path: counters to 0, runs A and B, read the counters.
    eng.steps, eng.decode_tokens, eng.decode_time_s = 0, 0, 0.0
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_a = eng.run([Request(id=100 + i, prompt=p, max_new_tokens=FULL_NEW_TOKENS) for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    a_s = time.perf_counter() - t0
    a_decode = (eng.decode_tokens, eng.decode_time_s)
    shared = tuple(int(t) for t in rng.integers(0, cfg.vocab_size, 1024))
    tails = [tuple(int(t) for t in rng.integers(0, cfg.vocab_size, 200)) for _ in range(9)]
    hits_before = eng.prefix_hits
    solo = eng.run([Request(id=200, prompt=shared + tails[0], max_new_tokens=FULL_NEW_TOKENS)])
    group = eng.run([Request(id=201 + i, prompt=shared + tails[1 + i], max_new_tokens=FULL_NEW_TOKENS) for i in range(8)])
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    hits_b = eng.prefix_hits - hits_before
    log(f"[{label}] runs A and B: kernel launches {launches}; decode steps {eng.steps}; prefix_hits in run B {hits_b}")
    for rid, c in {**run_a, **solo, **group}.items():
        if len(c.tokens) != FULL_NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in c.tokens):
            raise RuntimeError(f"paged request {rid}: {len(c.tokens)} tokens, want {FULL_NEW_TOKENS} in vocab")
    if any(run_a[100 + i].tokens[0] != first[i].tokens[0] for i in range(len(prompts))):
        raise RuntimeError("paged run A: first greedy token differs from the prefill-only run")
    if hits_b != 8 * 1024 // 128:
        raise RuntimeError(f"run B: prefix_hits {hits_b}, want 64 (8 requests x 8 shared pages)")
    check_launches(f"[{label}] the paged main path", launches, used)

    # The same 8 prompts without the prefix cache: the same first tokens.
    eng.prefix_cache_enabled = False
    cold = eng.run([Request(id=301 + i, prompt=shared + tails[1 + i], max_new_tokens=1) for i in range(8)])
    eng.prefix_cache_enabled = True
    if any(group[201 + i].tokens[0] != cold[301 + i].tokens[0] for i in range(8)):
        raise RuntimeError("run B: a first token through shared pages differs from the one without the cache")

    # Logits straight from the paged model functions: finite, of the
    # expected shape, and the 256-token prompt's greedy token is the engine's.
    pages = eng.alloc.acquire(2)
    row = torch.zeros(16, dtype=torch.int32, device="cuda")
    row[:2] = torch.tensor(pages, dtype=torch.int32)
    eng.caches.page_table[0] = row
    toks = torch.as_tensor(prompts[3], device="cuda")[None]  # 256 tokens: one chunk
    logits, caches = prefill_chunk_paged(params, cfg, toks, eng.caches, 0, 0, 256)
    step_logits, _ = decode_step_logits_paged(params, cfg, torch.zeros((8, 1), dtype=torch.int32, device="cuda"), caches)
    eng.caches.page_table[0] = 0
    eng.alloc.release(pages)
    if logits.shape != (1, 256, cfg.vocab_size) or step_logits.shape != (8, cfg.vocab_size):
        raise RuntimeError(f"paged logits shapes {tuple(logits.shape)} {tuple(step_logits.shape)}")
    if not (bool(torch.isfinite(logits).all()) and bool(torch.isfinite(step_logits).all())):
        raise RuntimeError("non-finite paged logits at full width")
    if int(logits[0, -1].argmax()) != first[3].tokens[0]:
        raise RuntimeError("paged prefill logits disagree with the engine's first token")

    n_prompt = sum(FULL_PROMPT_LENS)
    numbers = {"prefill_tok_s": n_prompt / prefill_s, "decode_tok_s": a_decode[0] / a_decode[1], "peak_gib": peak / 2**30,
               "cache_gb": pool_gb}

    def beside(key: str, fmt: str = ".1f") -> str:
        also = "" if ref is None else f"; bf16 paged, phase 8: {ref[key]:{fmt}}"
        return f" (bf16 dense, phase 5: {dense[key]:{fmt}}{also})"

    log(
        f"[{label}] PagedServingEngine(max_slots=8, num_pages=129, pages_per_slot=16, page_size=128, "
        f"prefill_chunk=256, prefix_cache=True), pool with its scales {pool_gb:.4f} GB{beside('cache_gb', '.4f')} ({card})"
    )
    log(
        f"[{label}] prefill: {n_prompt} prompt tokens in {prefill_s:.3f} s = {numbers['prefill_tok_s']:.1f} tok/s"
        f"{beside('prefill_tok_s')} ({card})"
    )
    log(
        f"[{label}] decode, run A: {a_decode[0]} tokens in {a_decode[1]:.3f} s of decode section = "
        f"{numbers['decode_tok_s']:.1f} tok/s{beside('decode_tok_s')}; run A whole {a_s:.3f} s ({card})"
    )
    log(
        f"[{label}] peak device memory (max_memory_allocated) over runs A and B {numbers['peak_gib']:.2f} GiB"
        f"{beside('peak_gib', '.2f')}; prefix_hits {eng.prefix_hits} ({card})"
    )
    return launches, numbers


def scaled_rows(shape, gen):
    """fp32 rows U(-0.5, 0.5), each multiplied by its own 2^U(-4, 4): the
    quantization scales of neighbouring rows differ by up to 2^8, so a kernel
    that applied another row's scale would fail any bar."""
    import torch

    x = torch.rand(shape, generator=gen, device="cuda") - 0.5
    return x * torch.exp2(torch.rand((*shape[:-1], 1), generator=gen, device="cuda") * 8 - 4)


def _hold_quant(what: str, out, plain, oracle, lse=None, p_lse=None, o_lse=None, *, dtype: str = "bfloat16"):
    """A quantized kernel's output against its plain version and the fp32
    oracle on the dequantized cache: row by row relative to the row's largest
    value (rows span 2^8 in scale, so an absolute bar says little;
    REL_BAR[dtype]), within ORACLE_BAR of the oracle, and the base-2 LSE
    within LSE_BAR of both. Returns (|out - plain|, |out - oracle|,
    row-relative, |lse|)."""
    d_plain, d_oracle = _max_diff(out, plain), _max_diff(out, oracle)
    d_rel = max(_rel_diff(out, plain), _rel_diff(out, oracle))
    d_lse = 0.0 if lse is None else max(_max_diff(lse, p_lse), _max_diff(lse, o_lse))
    if not (d_oracle < ORACLE_BAR and d_rel < REL_BAR[dtype] and d_lse < LSE_BAR):
        raise RuntimeError(f"{what} disagrees: |out-oracle| {d_oracle:.3e}, row-relative {d_rel:.3e}, |lse| {d_lse:.3e}")
    return d_plain, d_oracle, d_rel, d_lse


def _no_copy(what: str, fn, out_bytes: int, copy_bytes: int) -> int:
    """``fn`` (one kernel call) allocates its outputs and less than 1 % of a
    bf16 copy of the cache it reads (``copy_bytes``) besides: the payload is
    read in place, not dequantized into a copy. Returns the bytes ``fn``
    allocated beyond what was allocated before it, at its peak."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    if extra - out_bytes >= 0.01 * copy_bytes:
        raise RuntimeError(f"{what} allocated {extra} bytes beside {out_bytes} of output: a dequantized copy?")
    return extra


def _quant_decode_case(card: str, what: str, mode: str, q, k_x, v_x, lengths, *, no_copy: bool = False) -> dict:
    """K6q over the fp32 rows k_x, v_x [B, 8, S, 128] quantized to ``mode``."""
    import torch
    import torch.nn.functional as F

    from flash_attention_tpu_torch.ops.decode import decode_attention, decode_attention_plain
    from flash_attention_tpu_torch.ops.quant import dequantize, payload_dtype, quantize_values
    from flash_attention_tpu_torch.ops.reference import reference_attention, reference_attention_with_lse

    scale = 128**-0.5
    kq, vq = quantize_values(k_x, payload_dtype(mode)), quantize_values(v_x, payload_dtype(mode))
    out, lse = decode_attention(q, kq, vq, lengths, save_residuals=True)
    p_out, p_lse = decode_attention_plain(q, kq, vq, lengths, sm_scale=scale, save_residuals=True)
    kd, vd = dequantize(kq), dequantize(vq)
    o_out, o_lse = reference_attention_with_lse(q[:, :, None], kd, vd, kv_length=lengths)
    d_plain, d_oracle, d_rel, d_lse = _hold_quant(f"K6q {mode} {what}", out, p_out, o_out[:, :, 0], lse, p_lse, o_lse[:, :, 0])
    d_quant = _max_diff(out, reference_attention(q[:, :, None], k_x, v_x, kv_length=lengths)[:, :, 0])
    del p_out, o_out
    batch, hq, d = q.shape
    copy_bytes = 2 * kd.numel() * 2
    extra = _no_copy(f"K6q {mode} {what}", lambda: decode_attention(q, kq, vq, lengths, save_residuals=True),
                     out.numel() * out.element_size() + lse.numel() * 4, copy_bytes) if no_copy else None
    ms = cuda_ms(lambda: decode_attention(q, kq, vq, lengths, save_residuals=True))
    plain_ms = cuda_ms(lambda: decode_attention_plain(q, kq, vq, lengths, sm_scale=scale, save_residuals=True))
    # Context, not a yardstick: no single PyTorch call reads a quantized
    # cache; SDPA on a bf16 cache of the same (dequantized) values.
    kb, vb = kd.to(torch.bfloat16), vd.to(torch.bfloat16)
    del kd, vd
    mask = (torch.arange(kb.shape[2], device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kb, vb, attn_mask=mask, enable_gqa=True))
    bf16_ms = cuda_ms(lambda: decode_attention(q, kb, vb, lengths, save_residuals=True))  # K6 on the same values
    del kb, vb
    rows, hkv = int(lengths.sum()), k_x.shape[1]
    item = kq.values.element_size()
    nbytes = 2 * rows * hkv * (d * item + 4) + 2 * 2 * q.numel() + 4 * (lse.numel() + batch)
    bound_ms, bound_by = bound(4 * d * hq * rows + 2 * 2 * d * hkv * rows, nbytes)
    log(
        f"[K6q] {mode} {what}: |out-plain| {d_plain:.3e}, |out-oracle| {d_oracle:.3e} (bar {ORACLE_BAR}), "
        f"row-relative {d_rel:.3e} (bar {REL_BAR['bfloat16']}), |lse| {d_lse:.3e} (bar {LSE_BAR}); quantization "
        f"error |out - oracle on unquantized rows| {d_quant:.3e} (information)"
        + ("" if extra is None else f"; allocated {extra / 1e6:.3f} MB in the call (a bf16 copy: {copy_bytes / 1e6:.0f} MB)")
        + f"; kernel {ms:.4f} ms (K6 on a bf16 copy {bf16_ms:.4f} ms), plain {plain_ms:.4f} ms, library none (SDPA on "
        f"a bf16 copy {sdpa_ms:.4f} ms), bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB) ({card})"
    )
    return {"max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _quant_pages(mode: str, num_layers: int, num_pages: int, num_slots: int, pages_per_slot: int, gen, rng,
                 *, kv_heads: int = 8, head_dim: int = 128, dump_slot: bool = True):
    """A quantized PagedModelCache (pages of 128 rows) filled from scaled
    fp32 rows over a shuffled table; and the fp32 rows (pools [L, P,
    kv_heads, 128, head_dim]) it was quantized from."""
    import torch

    from flash_attention_tpu_torch.ops.paged import init_paged_model_cache
    from flash_attention_tpu_torch.ops.quant import bits, quantize_values

    cache = init_paged_model_cache(num_layers, num_pages=num_pages, num_slots=num_slots, pages_per_slot=pages_per_slot,
                                   kv_heads=kv_heads, page_size=128, head_dim=head_dim, kv_quant=mode, device="cuda")
    rows = []
    for pool, scales in ((cache.k_pool, cache.k_scales), (cache.v_pool, cache.v_scales)):
        x = scaled_rows(tuple(pool.shape), gen)
        qt = quantize_values(x, pool.dtype)
        bits(pool).copy_(bits(qt.values))
        scales.copy_(qt.scales[..., 0])
        rows.append(x)
    table = torch.from_numpy(_shuffled_table(rng, num_slots, pages_per_slot, num_pages, dump_slot=dump_slot)).cuda()
    cache.page_table.copy_(table)
    return cache, rows


def _dequant_pool(pages, scales):
    return pages.float() * scales[..., None]


def _quant_paged_decode_case(card: str, what: str, mode: str, layer, x_rows, q, *, no_copy: bool = False) -> dict:
    """K7q over one layer's quantized pages (PagedKVCache ``layer``, its
    lengths and table set), made from the fp32 pools ``x_rows``."""
    import torch

    from flash_attention_tpu_torch.ops.paged import paged_decode_attention, paged_decode_attention_plain
    from flash_attention_tpu_torch.ops.reference import reference_attention, reference_attention_with_lse

    scale = 128**-0.5
    table, lengths = layer.page_table, layer.lengths
    out, lse = paged_decode_attention(q, layer, save_residuals=True)
    p_out, p_lse = paged_decode_attention_plain(q, layer, sm_scale=scale, save_residuals=True)
    kd = _dense_from_pages(_dequant_pool(layer.k_pages, layer.k_scales), table)
    vd = _dense_from_pages(_dequant_pool(layer.v_pages, layer.v_scales), table)
    o_out, o_lse = reference_attention_with_lse(q[:, :, None], kd, vd, kv_length=lengths)
    del kd, vd
    d_plain, d_oracle, d_rel, d_lse = _hold_quant(f"K7q {mode} {what}", out, p_out, o_out[:, :, 0], lse, p_lse, o_lse[:, :, 0])
    del p_out, o_out
    ku, vu = (_dense_from_pages(x, table) for x in x_rows)
    d_quant = _max_diff(out, reference_attention(q[:, :, None], ku, vu, kv_length=lengths)[:, :, 0])
    del ku, vu
    if not (bool((out[lengths == 0] == 0).all()) and bool(torch.isneginf(lse[lengths == 0]).all())):
        raise RuntimeError(f"K7q {mode} {what}: a slot of length 0 must give output 0 and LSE -inf")
    slots, hq, d = q.shape
    rows = int(lengths.sum())
    copy_bytes = 2 * rows * 8 * d * 2
    extra = _no_copy(f"K7q {mode} {what}", lambda: paged_decode_attention(q, layer, save_residuals=True),
                     out.numel() * out.element_size() + lse.numel() * 4, copy_bytes) if no_copy else None
    ms = cuda_ms(lambda: paged_decode_attention(q, layer, save_residuals=True))
    plain_ms = cuda_ms(lambda: paged_decode_attention_plain(q, layer, sm_scale=scale, save_residuals=True))
    # K7 over bf16 pages of the same values, for comparison.
    bf16_pages = [_dequant_pool(layer.k_pages, layer.k_scales).to(torch.bfloat16),
                  _dequant_pool(layer.v_pages, layer.v_scales).to(torch.bfloat16)]
    as_bf16 = layer._replace(k_pages=bf16_pages[0], v_pages=bf16_pages[1], k_scales=None, v_scales=None)
    bf16_ms = cuda_ms(lambda: paged_decode_attention(q, as_bf16, save_residuals=True))
    del bf16_pages, as_bf16
    pages_read = sum(-(-n // 128) for n in lengths.tolist())
    item = layer.k_pages.element_size()
    nbytes = 2 * rows * 8 * (d * item + 4) + 2 * 2 * q.numel() + 4 * (lse.numel() + slots + pages_read)
    bound_ms, bound_by = bound(4 * d * hq * rows + 2 * 2 * d * 8 * rows, nbytes)
    log(
        f"[K7q] {mode} {what}: |out-plain| {d_plain:.3e}, |out-oracle| {d_oracle:.3e} (bar {ORACLE_BAR}), "
        f"row-relative {d_rel:.3e} (bar {REL_BAR['bfloat16']}), |lse| {d_lse:.3e} (bar {LSE_BAR}); quantization "
        f"error {d_quant:.3e} (information)"
        + ("" if extra is None else f"; allocated {extra / 1e6:.3f} MB in the call (a bf16 copy: {copy_bytes / 1e6:.0f} MB)")
        + f"; kernel {ms:.4f} ms (K7 on bf16 pages {bf16_ms:.4f} ms), plain {plain_ms:.4f} ms, library none, "
        f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB) ({card})"
    )
    return {"max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _widen_exact() -> None:
    """T1's counterpart: K6 with fp32 queries, length 1 and scale 1 over V
    rows that hold every finite code of each payload type returns the codes
    exactly (one row's softmax weight is exactly 1), which pins the widen."""
    import torch

    from flash_attention_tpu_torch.ops.decode import decode_attention
    from flash_attention_tpu_torch.ops.quant import QuantizedTensor, payload_dtype

    for mode in QUANT_MODES:
        payload = payload_dtype(mode)
        every = torch.arange(256, dtype=torch.int32).to(torch.uint8)
        codes = every[torch.isfinite(every.view(payload).float())]  # int8: all 256; fp8: not NaN or inf
        n = codes.numel()
        padded = torch.zeros(2 * 128, dtype=torch.uint8)
        padded[:n] = codes
        v = padded.view(payload).reshape(2, 1, 1, 128).cuda()
        k = torch.zeros_like(v)
        ones = torch.ones((2, 1, 1, 1), dtype=torch.float32, device="cuda")
        q = torch.ones((2, 1, 128), dtype=torch.float32, device="cuda")
        out = decode_attention(q, QuantizedTensor(k, ones), QuantizedTensor(v, ones),
                               torch.ones(2, dtype=torch.int32, device="cuda"))
        want = v.float().reshape(2, 1, 128)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            bad = (out != want).nonzero()[:4].tolist()
            raise RuntimeError(f"K6 widen of {mode}: output differs from the codes at {bad}")
        log(f"[quant] K6 widen, {mode}: all {n} finite codes returned exactly (fp32 queries, one row, scale 1)")


def phase_quant_kernels(card: str):
    """Phase 9: K6q, K7q, K8q and K9q/K10q with bf16 queries for every
    payload type, over caches whose rows are scaled one by one; queries are
    scaled by 8 so the softmax is peaked. Returns the report entries of K6q
    (int8), K7q, K8q and K10q (fp8 e4m3): the types the phase-11 paths use."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.ops.paged import (
        PagedModelCache,
        paged_prefill_attention,
        paged_prefill_attention_plain,
        paged_write_tokens,
        paged_write_tokens_multi,
        paged_write_tokens_plain,
    )
    from flash_attention_tpu_torch.ops.quant import bits
    from flash_attention_tpu_torch.ops.reference import reference_attention

    bf16 = torch.bfloat16
    rng = np.random.default_rng(9)
    gen = torch.Generator(device="cuda").manual_seed(9)
    report = {}
    _widen_exact()

    # K6q at phase 3's shape and lengths, then at 32 slots x 8192 rows.
    lengths = torch.tensor([0, 1, 255, 256, 1000, 2047, 2048, 7], dtype=torch.int32, device="cuda")
    q = (torch_uniform((8, 32, 128), torch.float32, gen) * 8).to(bf16)
    for mode in QUANT_MODES:
        k_x, v_x = scaled_rows((8, 8, 2048, 128), gen), scaled_rows((8, 8, 2048, 128), gen)
        entry = _quant_decode_case(card, "q [8,32,128] cache [8,8,2048,128], phase 3's lengths", mode, q, k_x, v_x, lengths)
        if mode == "int8":
            report["K6q"] = entry
    slots, rows = LONG["slots"], LONG["rows"]
    q = (torch_uniform((slots, 32, 128), torch.float32, gen) * 8).to(bf16)
    lengths = torch.full((slots,), rows, dtype=torch.int32, device="cuda")
    for mode in QUANT_MODES:
        k_x, v_x = scaled_rows((slots, 8, rows, 128), gen), scaled_rows((slots, 8, rows, 128), gen)
        _quant_decode_case(card, f"q [{slots},32,128] cache [{slots},8,{rows},128], every slot full", mode, q, k_x, v_x,
                           lengths, no_copy=True)
        del k_x, v_x

    # K7q at phase 6's shape and lengths (slot 0 on the dump page), then at
    # 32 slots x 64 pages of 128 rows; K8q over phase 6's cache.
    q = (torch_uniform((8, 32, 128), torch.float32, gen) * 8).to(bf16)
    for mode in QUANT_MODES:
        cache, x_rows = _quant_pages(mode, 1, 129, 8, 16, gen, rng)
        layer = cache._replace(lengths=torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device="cuda")).layers()[0]
        x_rows = [x[0] for x in x_rows]
        entry = _quant_paged_decode_case(card, f"q [8,32,128] pages [129,8,128,128], lengths {list(PAGED_LENGTHS)}",
                                         mode, layer, x_rows, q)
        if mode == "fp8_e4m3":
            report["K7q"] = entry
        kd = _dense_from_pages(_dequant_pool(layer.k_pages, layer.k_scales), layer.page_table)
        vd = _dense_from_pages(_dequant_pool(layer.v_pages, layer.v_scales), layer.page_table)
        ku, vu = (_dense_from_pages(x, layer.page_table)[7:8] for x in x_rows)
        for kv_end in (256, 1024, 2048):
            qc = (torch_uniform((1, 32, 256, 128), torch.float32, gen) * 8).to(bf16)
            out = paged_prefill_attention(qc, layer, 7, kv_end, chunk_len=256)
            p_out = paged_prefill_attention_plain(qc, layer, 7, kv_end, sm_scale=128**-0.5)
            o_out = reference_attention(qc, kd[7:8, :, :kv_end], vd[7:8, :, :kv_end], causal=True)
            d_plain, d_oracle, d_rel, _ = _hold_quant(f"K8q {mode} kv_end {kv_end}", out, p_out, o_out)
            d_quant = _max_diff(out, reference_attention(qc, ku[:, :, :kv_end], vu[:, :, :kv_end], causal=True))
            copy_bytes = 2 * kv_end * 8 * 128 * 2
            extra = _no_copy(f"K8q {mode} kv_end {kv_end}", lambda: paged_prefill_attention(qc, layer, 7, kv_end, chunk_len=256),
                             out.numel() * out.element_size(), copy_bytes)
            ms = cuda_ms(lambda: paged_prefill_attention(qc, layer, 7, kv_end, chunk_len=256))
            plain_ms = cuda_ms(lambda: paged_prefill_attention_plain(qc, layer, 7, kv_end, sm_scale=128**-0.5))
            item = layer.k_pages.element_size()
            nbytes = 2 * (2 * qc.numel()) + 2 * kv_end * 8 * (128 * item + 4) + 4 * (kv_end // 128)
            bound_ms, bound_by = bound(4 * 128 * 32 * causal_pairs(256, kv_end) + 2 * 2 * 128 * 8 * kv_end, nbytes)
            log(
                f"[K8q] {mode} q [1,32,256,128] over slot 7's pages to kv_end {kv_end}: |out-plain| {d_plain:.3e}, "
                f"|out-oracle| {d_oracle:.3e} (bar {ORACLE_BAR}), row-relative {d_rel:.3e} (bar "
                f"{REL_BAR['bfloat16']}); quantization error {d_quant:.3e} (information); allocated "
                f"{extra / 1e6:.3f} MB in the call, its output "
                f"{out.numel() * 2 / 1e6:.3f} MB; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library none, "
                f"bound {bound_ms:.4f} ms by {bound_by} ({card})"
            )
            if mode == "fp8_e4m3" and kv_end == 2048:
                report["K8q"] = {"max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                                 "bound_ms": bound_ms, "bound_by": bound_by}
        del cache, layer, x_rows, kd, vd, ku, vu
    q = (torch_uniform((slots, 32, 128), torch.float32, gen) * 8).to(bf16)
    pages_per_slot = rows // 128
    for mode in QUANT_MODES:
        cache, x_rows = _quant_pages(mode, 1, 1 + slots * pages_per_slot, slots, pages_per_slot, gen, rng, dump_slot=False)
        layer = cache._replace(lengths=torch.full((slots,), rows, dtype=torch.int32, device="cuda")).layers()[0]
        _quant_paged_decode_case(card, f"q [{slots},32,128] pages [{1 + slots * pages_per_slot},8,128,128], "
                                 f"every slot {rows} rows", mode, layer, [x[0] for x in x_rows], q, no_copy=True)
        del cache, layer, x_rows

    # K10q: one bf16 row per slot quantized into 32 layers; slot 0 is a
    # released slot (dump-page table, frozen length 37), slot 1 at capacity.
    num_layers = 32
    for mode in QUANT_MODES:
        cache, _ = _quant_pages(mode, num_layers, 129, 8, 16, gen, rng)
        w_lengths = torch.tensor([37, 2048, 5, 127, 128, 129, 1000, 2047], dtype=torch.int32, device="cuda")
        cache = cache._replace(lengths=w_lengths)
        slots8 = torch.arange(8, device="cuda")
        k_new = scaled_rows((num_layers, 8, 8, 128), gen).to(bf16)
        v_new = scaled_rows((num_layers, 8, 8, 128), gen).to(bf16)
        plain = PagedModelCache(*(t.clone() for t in cache))
        written = paged_write_tokens_multi(cache, k_new, v_new, slots8)
        valid = paged_write_tokens_plain(plain, k_new, v_new, slots8)
        torch.cuda.synchronize()

        def same() -> bool:
            return (all(torch.equal(bits(a), bits(b)) for a, b in ((cache.k_pool, plain.k_pool), (cache.v_pool, plain.v_pool)))
                    and torch.equal(cache.k_scales, plain.k_scales) and torch.equal(cache.v_scales, plain.v_scales))

        if not (same() and valid.tolist() == [1, 0, 1, 1, 1, 1, 1, 1] and torch.equal(written.lengths, w_lengths + valid)):
            raise RuntimeError(f"K10q {mode}: payload or scales not bit-equal to plain, or lengths advanced wrongly")
        ms = cuda_ms(lambda: paged_write_tokens_multi(cache, k_new, v_new, slots8))
        plain_ms = cuda_ms(lambda: paged_write_tokens_plain(plain, k_new, v_new, slots8))
        n_valid = int(valid.sum())
        item = cache.k_pool.element_size()
        nbytes = 2 * num_layers * n_valid * 8 * (128 * 2 + 128 * item + 4) + 4 * 4 * 8
        bound_ms, bound_by = bound(0, nbytes)
        # K9q: the same kernel with one layer, new rows into layer 0.
        k_one, v_one = scaled_rows((8, 8, 128), gen).to(bf16), scaled_rows((8, 8, 128), gen).to(bf16)
        plain_one = PagedModelCache(*(None if t is None else t[:1] if t.dim() > 2 else t for t in plain))
        paged_write_tokens(cache.layers()[0], k_one, v_one, slots8)
        paged_write_tokens_plain(plain_one, k_one[None], v_one[None], slots8)
        torch.cuda.synchronize()
        if not same():
            raise RuntimeError(f"K9q {mode} (one layer): not bit-equal to plain")
        ms9 = cuda_ms(lambda: paged_write_tokens(cache.layers()[0], k_one, v_one, slots8))
        plain9 = cuda_ms(lambda: paged_write_tokens_plain(plain_one, k_one[None], v_one[None], slots8))
        bound9, by9 = bound(0, 2 * n_valid * 8 * (128 * 2 + 128 * item + 4) + 4 * 4 * 8)
        log(
            f"[K10q] {mode}: 32 layers x 8 slots x bf16 rows [8,128] quantized into pools [32,129,8,128,128], one "
            f"slot at capacity, one on the dump page: payload and scales bit-equal to plain, lengths advanced where "
            f"valid {valid.tolist()}; wrapper {ms:.4f} ms, plain {plain_ms:.4f} ms, library none, bound "
            f"{bound_ms:.5f} ms by {bound_by} ({nbytes / 1e6:.2f} MB); K9q (one layer) bit-equal, wrapper "
            f"{ms9:.4f} ms, plain {plain9:.4f} ms, bound {bound9:.6f} ms by {by9} ({card})"
        )
        if mode == "fp8_e4m3":
            report["K10q"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                              "bound_ms": bound_ms, "bound_by": bound_by}
        del cache, plain, plain_one
    torch.cuda.empty_cache()
    source = "flash_attention_tpu_torch/csrc/"
    names = {
        "K6q": ("decode_quant (K6q)", "decode.cu", "ops/decode.py:56"),
        "K7q": ("paged_decode_quant (K7q)", "decode.cu", "ops/paged.py:980"),
        "K8q": ("paged_prefill_quant (K8q)", "flash_fwd.cu", "ops/paged.py:580"),
        "K10q": ("paged_write_quant (K9q/K10q)", "paged_write.cu", "ops/paged.py:257"),
    }
    return {key: {"name": names[key][0], "route": "cuda", "source": source + names[key][1],
                  "replaces": f"{REFERENCE}/{names[key][2]}", **entry} for key, entry in report.items()}


def phase_quant_sweep() -> None:
    """Every (query dtype, payload, head_dim) instantiation of K6q, K7q, K8q
    and K9q/K10q at ragged shapes: lengths off the 64-row tiles, GQA groups
    of 1 and 16, an empty slot on the dump page, a slot at capacity."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.ops.decode import decode_attention, decode_attention_plain
    from flash_attention_tpu_torch.ops.paged import (
        PagedModelCache,
        paged_decode_attention,
        paged_decode_attention_plain,
        paged_prefill_attention,
        paged_prefill_attention_plain,
        paged_write_tokens_multi,
        paged_write_tokens_plain,
    )
    from flash_attention_tpu_torch.ops.quant import bits, dequantize, payload_dtype, quantize_values
    from flash_attention_tpu_torch.ops.reference import reference_attention, reference_attention_with_lse

    rng = np.random.default_rng(10)
    gen = torch.Generator(device="cuda").manual_seed(10)
    worst = 0.0
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for d in (32, 64, 128):
            for hq, hkv in ((4, 4), (16, 1)):
                for mode in QUANT_MODES:
                    what = f"{mode} {dtype} d={d} {hq}/{hkv}"

                    def hold(kernel, *outs):
                        return _hold_quant(f"{kernel} {what}", *outs, dtype=name)[2] / REL_BAR[name]

                    # K6q over a dense [2, hkv, 130, d] cache, lengths {0, 130}.
                    kq, vq = (quantize_values(scaled_rows((2, hkv, 130, d), gen), payload_dtype(mode)) for _ in range(2))
                    q = (torch_uniform((2, hq, d), torch.float32, gen) * 8).to(dtype)
                    lengths = torch.tensor([0, 130], dtype=torch.int32, device="cuda")
                    out, lse = decode_attention(q, kq, vq, lengths, save_residuals=True)
                    p_out, p_lse = decode_attention_plain(q, kq, vq, lengths, sm_scale=d**-0.5, save_residuals=True)
                    o_out, o_lse = reference_attention_with_lse(q[:, :, None], dequantize(kq), dequantize(vq), kv_length=lengths)
                    worst = max(worst, hold("K6q", out, p_out, o_out[:, :, 0], lse, p_lse, o_lse[:, :, 0]))
                    # K7q, K8q and K10q over two layers of 3 slots x 2 pages.
                    cache, _ = _quant_pages(mode, 2, 7, 3, 2, gen, rng, kv_heads=hkv, head_dim=d)
                    layer = cache._replace(lengths=torch.tensor([0, 37, 200], dtype=torch.int32, device="cuda")).layers()[0]
                    kd = _dense_from_pages(_dequant_pool(layer.k_pages, layer.k_scales), layer.page_table)
                    vd = _dense_from_pages(_dequant_pool(layer.v_pages, layer.v_scales), layer.page_table)
                    q = (torch_uniform((3, hq, d), torch.float32, gen) * 8).to(dtype)
                    out, lse = paged_decode_attention(q, layer, save_residuals=True)
                    p_out, p_lse = paged_decode_attention_plain(q, layer, sm_scale=d**-0.5, save_residuals=True)
                    o_out, o_lse = reference_attention_with_lse(q[:, :, None], kd, vd, kv_length=layer.lengths)
                    worst = max(worst, hold("K7q", out, p_out, o_out[:, :, 0], lse, p_lse, o_lse[:, :, 0]))
                    qc = (torch_uniform((1, hq, 128, d), torch.float32, gen) * 8).to(dtype)
                    out = paged_prefill_attention(qc, layer, 2, 200, chunk_len=128)
                    p_out = paged_prefill_attention_plain(qc, layer, 2, 200, sm_scale=d**-0.5)
                    o_out = reference_attention(qc, kd[2:3, :, :200], vd[2:3, :, :200], causal=True)
                    worst = max(worst, hold("K8q", out, p_out, o_out))
                    cache = cache._replace(lengths=torch.tensor([5, 127, 256], dtype=torch.int32, device="cuda"))
                    k_new, v_new = (scaled_rows((2, 3, hkv, d), gen).to(dtype) for _ in range(2))
                    plain = PagedModelCache(*(t.clone() for t in cache))
                    slots = torch.tensor([2, 0, 1], device="cuda")
                    written = paged_write_tokens_multi(cache, k_new, v_new, slots)
                    valid = paged_write_tokens_plain(plain, k_new, v_new, slots)
                    if not (all(torch.equal(bits(a), bits(b)) for a, b in zip(cache, plain))
                            and valid.tolist() == [0, 1, 1] and written.lengths.tolist() == [6, 128, 256]):
                        raise RuntimeError(f"K10q {what}: not bit-equal to plain")
    torch.cuda.synchronize()
    log(
        "[quant sweep] K6q, K7q, K8q and K9q/K10q at fp32/fp16/bf16 queries x int8/e4m3/e5m2 payloads x head_dim "
        "32/64/128 x groups 1/16, lengths {0 (dump page), 37, 200 | 130}: all within 0.1 of the oracle on the "
        f"dequantized cache, LSE within {LSE_BAR}, writes bit-equal (payload and scales); worst row-relative "
        f"difference at {worst:.3f} of its bar {REL_BAR}"
    )


def phase_tiny_quant() -> None:
    """Phase 10: the tiny fp32 model with each kv_quant mode and with int8
    weights through both engines on the card and on the CPU."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params
    from flash_attention_tpu_torch.serving.engine import Request, ServingEngine
    from flash_attention_tpu_torch.serving.paged_engine import PagedServingEngine

    rng = np.random.default_rng(23)
    prefix = tuple(int(t) for t in rng.integers(0, TINY_CFG["vocab_size"], 256))
    shared = [Request(id=10 + i, prompt=prefix + tuple(int(t) for t in rng.integers(0, TINY_CFG["vocab_size"], 40)),
                      max_new_tokens=8) for i in range(3)]
    for variant in [{"kv_quant": m} for m in QUANT_MODES] + [{"weight_quant": "int8"}]:
        cfg = ModelConfig(**TINY_CFG, **variant)
        params = init_model_params(torch.Generator().manual_seed(0), cfg)
        tokens = {}
        for device in ("cuda", "cpu"):
            on = _to_device(params, device)
            dense = ServingEngine(on, cfg, max_slots=3, max_seq=64, prefill_chunk=16)
            paged = PagedServingEngine(on, cfg, max_slots=3, num_pages=16, pages_per_slot=2, page_size=128)
            for name, eng in (("dense", dense), ("paged", paged)):
                tokens[name, device] = {rid: c.tokens for rid, c in eng.run(tiny_requests()).items()}
        label = ", ".join(f"{k}={v}" for k, v in variant.items())
        for name in ("dense", "paged"):
            if tokens[name, "cuda"] != tokens[name, "cpu"]:
                raise RuntimeError(f"[tiny quant] {label}, {name}: card tokens {tokens[name, 'cuda']} != CPU "
                                   f"{tokens[name, 'cpu']}")
        # Over a quantized cache the paged engine merges the current token's
        # self term at full precision and the dense engine attends it as
        # stored, quantized, as in the JAX package, whose two engines diverge
        # on this model too: the engines must agree on the prefill's token
        # and the rest is information. Over an unquantized cache they agree.
        dense, paged = tokens["dense", "cuda"], tokens["paged", "cuda"]
        if ("kv_quant" not in variant and paged != dense) or any(paged[r][0] != dense[r][0] for r in dense):
            raise RuntimeError(f"[tiny quant] {label}: paged tokens {paged} vs dense {dense}")
        diverge = {rid: next((i for i, (a, b) in enumerate(zip(dense[rid], paged[rid])) if a != b), None) for rid in dense}
        on_card = _to_device(params, "cuda")
        hits, with_cache = {}, {}
        for cached in (False, True):
            eng = PagedServingEngine(on_card, cfg, max_slots=2, num_pages=16, pages_per_slot=4, page_size=128,
                                     prefill_chunk=128, prefix_cache=cached)
            with_cache[cached] = {r.id: eng.run([r])[r.id].tokens for r in shared}
            hits[cached] = eng.prefix_hits
        if hits[True] <= 0 or with_cache[True] != with_cache[False]:
            raise RuntimeError(f"[tiny quant] {label}: prefix cache hits {hits[True]}, tokens "
                               f"{with_cache[True]} vs {with_cache[False]}")
        log(
            f"[tiny quant] {label}: both engines' tokens on the card == on the CPU; paged vs dense, first "
            f"differing token per request {diverge} (None: identical); shared 256-token prefix: prefix_hits "
            f"{hits[True]}, tokens with cache == without"
        )


def phase_full_quant(card: str, params, dense: dict, paged: dict) -> dict:
    """Phase 11: phase 5's weights at full width, (a) int8 weights and an
    int8 cache through ServingEngine on phase 5's requests, (b) an fp8_e4m3
    cache through PagedServingEngine on phase 8's runs. Returns the launch
    counts of both main paths."""
    from flash_attention_tpu_torch.models.transformer import ModelConfig, quantize_model_weights

    params_w8 = quantize_model_weights(params)
    launches_a, _ = serve_full_dense(card, "full quant a", ModelConfig(kv_quant="int8", weight_quant="int8"), params_w8,
                                     used=("K1", "K6q"), ref=dense)
    del params_w8
    launches_b, _ = serve_full_paged(card, "full quant b", ModelConfig(kv_quant="fp8_e4m3"), params,
                                     used=("K7q", "K8q", "K9q/K10q"), dense=dense, ref=paged)
    return {"K6q": launches_a["K6q"], "K7q": launches_b["K7q"], "K8q": launches_b["K8q"], "K10q": launches_b["K9q/K10q"]}


def main() -> None:
    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig

    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    k1 = phase_k1(card)
    k6 = phase_k6(card)
    phase_kernel_sweep()
    dense_tiny = phase_tiny()
    launches, params, dense = phase_full(card)
    k1["launches"], k6["launches"] = launches["K1"], launches["K6"]
    k7, k8, k10 = phase_paged_kernels(card)
    phase_paged_sweep()
    phase_tiny_paged(dense_tiny)
    launches, paged = serve_full_paged(card, "full paged", ModelConfig(), params, used=("K7", "K8", "K9/K10"), dense=dense)
    k7["launches"], k8["launches"], k10["launches"] = launches["K7"], launches["K8"], launches["K9/K10"]
    quant = phase_quant_kernels(card)
    phase_quant_sweep()
    phase_tiny_quant()
    for key, n in phase_full_quant(card, params, dense, paged).items():
        quant[key]["launches"] = n
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k6, k7, k8, k10, *quant.values()]}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    if shutil.which("nvidia-smi") is None:
        raise SystemExit("chip_smoke: nvidia-smi not found; this script needs a CUDA card")
    main()
