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
        "replaces": "flash_attention_tpu/ops/flash_attention.py:57",
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
        "replaces": "flash_attention_tpu/ops/decode.py:56",
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


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    return [tree]


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


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
    """ModelConfig() at full width on 8 slots x 2048 positions. Returns the
    launch counts of the served run, the params and the engine's numbers."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.models.transformer import (
        ModelConfig,
        decode_step_logits,
        init_caches,
        init_model_params,
        prefill,
    )
    from flash_attention_tpu_torch.ops.decode import decode_attention
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention
    from flash_attention_tpu_torch.serving.engine import Request, ServingEngine

    cfg = ModelConfig()
    t0 = time.perf_counter()
    params = init_model_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[full] ModelConfig() bf16: {n_params / 1e9:.3f} B params initialised on the card in {time.perf_counter() - t0:.1f} s")
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
    flash_attention.launches = 0
    decode_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run([Request(id=100 + i, prompt=p, max_new_tokens=FULL_NEW_TOKENS) for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"K1": flash_attention.launches, "K6": decode_attention.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"[full] 10 requests on 8 slots: kernel launches {launches}; decode steps {eng.steps}")
    for i in range(len(prompts)):
        toks = done[100 + i].tokens
        if len(toks) != FULL_NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in toks):
            raise RuntimeError(f"request {100 + i}: {len(toks)} tokens, want {FULL_NEW_TOKENS} in vocab")
        if toks[0] != first[i].tokens[0]:
            raise RuntimeError(f"request {100 + i}: first greedy token differs between runs")
    if min(launches.values()) < 1:
        raise RuntimeError(f"the main path did not launch every kernel: {launches}")

    # Logits of the same model, straight from the model functions: finite
    # and of the expected shape, one-shot prefill (K1) then one decode step (K6).
    caches = init_caches(cfg, 1, 2048, device="cuda")
    toks = torch.as_tensor(prompts[5], device="cuda")[None]
    logits, caches = prefill(params, cfg, toks, caches)
    step_logits, _ = decode_step_logits(params, cfg, logits[:, -1:].argmax(-1).to(torch.int32), caches)
    if logits.shape != (1, len(prompts[5]), cfg.vocab_size) or step_logits.shape != (1, cfg.vocab_size):
        raise RuntimeError(f"logits shapes {tuple(logits.shape)} {tuple(step_logits.shape)}")
    if not (bool(torch.isfinite(logits).all()) and bool(torch.isfinite(step_logits).all())):
        raise RuntimeError("non-finite logits at full width")

    n_gen = sum(len(c.tokens) for c in done.values())
    log(
        f"[full] prefill: {n_prompt} prompt tokens in {prefill_s:.3f} s = {n_prompt / prefill_s:.1f} tok/s "
        f"(max_new_tokens=1 run, wall clock) ({card})"
    )
    log(
        f"[full] decode: {eng.decode_tokens} tokens in {eng.decode_time_s:.3f} s of decode section = "
        f"{eng.decode_tokens / eng.decode_time_s:.1f} tok/s; whole run {n_gen} tokens in {run_s:.3f} s ({card})"
    )
    log(f"[full] peak device memory (max_memory_allocated) {peak / 2**30:.2f} GiB ({card})")
    numbers = {
        "prefill_tok_s": n_prompt / prefill_s, "decode_tok_s": eng.decode_tokens / eng.decode_time_s,
        "peak_gib": peak / 2**30,
    }
    return launches, params, numbers


def _shuffled_table(rng, num_slots: int, pages_per_slot: int, num_pages: int):
    """The slots' page tables as a random permutation of pages 1..num_pages-1,
    so a kernel reading pages in order fails; slot 0's row is all dump page
    0, like a released slot's."""
    import numpy as np

    table = rng.permutation(np.arange(1, num_pages))[: num_slots * pages_per_slot]
    table = table.reshape(num_slots, pages_per_slot).astype(np.int32)
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
        "replaces": "flash_attention_tpu/ops/paged.py:980",
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
        "replaces": "flash_attention_tpu/ops/paged.py:580",
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
        "replaces": "flash_attention_tpu/ops/paged.py:257",
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


def phase_full_paged(card: str, params, dense: dict) -> dict:
    """PagedServingEngine at full width on phase 5's weights; the dense
    engine and its caches are gone. Returns the paged run's launch counts."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig, decode_step_logits_paged, prefill_chunk_paged
    from flash_attention_tpu_torch.ops.decode import decode_attention
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention
    from flash_attention_tpu_torch.ops.paged import paged_decode_attention, paged_prefill_attention, paged_write_tokens_multi
    from flash_attention_tpu_torch.serving.engine import Request
    from flash_attention_tpu_torch.serving.paged_engine import PagedServingEngine

    cfg = ModelConfig()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab_size, n)) for n in FULL_PROMPT_LENS]  # phase 5's
    eng = PagedServingEngine(params, cfg, max_slots=8, num_pages=129, pages_per_slot=16, page_size=128,
                             prefill_chunk=256, prefix_cache=True)
    pool_gb = (eng.caches.k_pool.numel() + eng.caches.v_pool.numel()) * 2 / 1e9

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
    counted = {"K1": flash_attention, "K6": decode_attention, "K7": paged_decode_attention,
               "K8": paged_prefill_attention, "K9/K10": paged_write_tokens_multi}
    for fn in counted.values():
        fn.launches = 0
    eng.steps, eng.decode_tokens, eng.decode_time_s = 0, 0, 0.0
    torch.cuda.reset_peak_memory_stats()
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
    launches = {name: fn.launches for name, fn in counted.items()}
    peak = torch.cuda.max_memory_allocated()
    hits_b = eng.prefix_hits - hits_before
    log(f"[full paged] runs A and B: kernel launches {launches}; decode steps {eng.steps}; prefix_hits in run B {hits_b}")
    for rid, c in {**run_a, **solo, **group}.items():
        if len(c.tokens) != FULL_NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in c.tokens):
            raise RuntimeError(f"paged request {rid}: {len(c.tokens)} tokens, want {FULL_NEW_TOKENS} in vocab")
    if any(run_a[100 + i].tokens[0] != first[i].tokens[0] for i in range(len(prompts))):
        raise RuntimeError("paged run A: first greedy token differs from the prefill-only run")
    if hits_b < 8:
        raise RuntimeError(f"run B: prefix_hits {hits_b} < 8")
    if min(launches[k] for k in ("K7", "K8", "K9/K10")) < 1 or launches["K1"] or launches["K6"]:
        raise RuntimeError(f"the paged path must launch K7, K8 and K10 and neither K1 nor K6: {launches}")

    # The same 8 prompts without the prefix cache: the same first tokens.
    eng.prefix_cache_enabled = False
    ref = eng.run([Request(id=301 + i, prompt=shared + tails[1 + i], max_new_tokens=1) for i in range(8)])
    eng.prefix_cache_enabled = True
    if any(group[201 + i].tokens[0] != ref[301 + i].tokens[0] for i in range(8)):
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
    log(
        f"[full paged] PagedServingEngine(max_slots=8, num_pages=129, pages_per_slot=16, page_size=128, "
        f"prefill_chunk=256, prefix_cache=True), pool {pool_gb:.2f} GB ({card})"
    )
    log(
        f"[full paged] prefill: {n_prompt} prompt tokens in {prefill_s:.3f} s = {n_prompt / prefill_s:.1f} tok/s "
        f"(dense, phase 5: {dense['prefill_tok_s']:.1f}) ({card})"
    )
    log(
        f"[full paged] decode, run A: {a_decode[0]} tokens in {a_decode[1]:.3f} s of decode section = "
        f"{a_decode[0] / a_decode[1]:.1f} tok/s (dense, phase 5: {dense['decode_tok_s']:.1f}); run A whole "
        f"{a_s:.3f} s ({card})"
    )
    log(
        f"[full paged] peak device memory (max_memory_allocated) over runs A and B {peak / 2**30:.2f} GiB "
        f"(dense, phase 5: {dense['peak_gib']:.2f}); prefix_hits {eng.prefix_hits} ({card})"
    )
    return launches


def main() -> None:
    import torch

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
    paged = phase_full_paged(card, params, dense)
    k7["launches"], k8["launches"], k10["launches"] = paged["K7"], paged["K8"], paged["K9/K10"]
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k6, k7, k8, k10]}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    if shutil.which("nvidia-smi") is None:
        raise SystemExit("chip_smoke: nvidia-smi not found; this script needs a CUDA card")
    main()
