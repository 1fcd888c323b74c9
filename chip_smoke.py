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

The last two lines of standard output are one JSON object describing the
kernels, then {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import time

ORACLE_BAR = 0.1  # the repository's pass bar against the fp32 oracle
PLAIN_BAR = 1e-2  # kernel vs plain in bf16: the same fp32 math in another order
LSE_BAR = 1e-3  # base-2 LSE, fp32, kernel vs plain and oracle
TINY_CFG = dict(
    vocab_size=128, model_dim=128, num_layers=2, num_q_heads=4,
    num_kv_heads=2, head_dim=32, mlp_dim=256, dtype="float32",
)
FULL_PROMPT_LENS = (1, 37, 255, 256, 257, 600, 1024, 1100, 1500, 1791)
FULL_NEW_TOKENS = 32


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


def phase_k1(card: str) -> dict:
    """K1 at the chunked-prefill shapes (q [1,32,256,128] against a cache
    slice of kv_len rows) and the one-shot prefill shape (Sq = Skv = 512)."""
    import torch

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
            rep = (ms, plain_ms)
    return {
        "name": "flash_fwd (K1)", "route": "cuda",
        "source": "flash_attention_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "flash_attention_tpu/ops/flash_attention.py:57",
        "max_abs_err": worst_plain, "ms": rep[0], "plain_ms": rep[1],
    }


def phase_k6(card: str) -> dict:
    """K6 at the decode shape: q [8,32,128] against a [8,8,2048,128] cache."""
    import numpy as np
    import torch

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
    log(
        f"[K6] q [8,32,128] cache [8,8,2048,128] bf16 lengths {lengths.tolist()}: "
        f"|out-oracle| {d_oracle:.3e} (bar {ORACLE_BAR}), |out-plain| {d_plain:.3e} (bar {PLAIN_BAR}); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms ({card})"
    )
    if not (d_oracle < ORACLE_BAR and d_plain < PLAIN_BAR):
        raise RuntimeError("K6 disagrees")
    return {
        "name": "decode (K6)", "route": "cuda",
        "source": "flash_attention_tpu_torch/csrc/decode.cu",
        "replaces": "flash_attention_tpu/ops/decode.py:56",
        "max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms,
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


def phase_tiny() -> None:
    """The same tiny fp32 params served on the card and on the CPU."""
    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params
    from flash_attention_tpu_torch.serving.engine import Request, ServingEngine

    cfg = ModelConfig(**TINY_CFG)
    params = init_model_params(torch.Generator().manual_seed(0), cfg)
    reqs = [
        Request(id=1, prompt=(5, 9, 2), max_new_tokens=6),
        Request(id=2, prompt=(100, 3, 44, 8, 21, 60, 7), max_new_tokens=9),
        Request(id=3, prompt=(64,), max_new_tokens=4),
        Request(id=4, prompt=(11, 12, 13, 14), max_new_tokens=5),
        Request(id=5, prompt=(90, 2), max_new_tokens=3),
    ]
    results = {}
    for device in ("cuda", "cpu"):
        eng = ServingEngine(_to_device(params, device), cfg, max_slots=3, max_seq=64, prefill_chunk=16)
        results[device] = {rid: c.tokens for rid, c in eng.run(reqs).items()}
    log(f"[tiny] fp32 engine, 5 greedy requests on 3 slots: card {results['cuda']}")
    if results["cuda"] != results["cpu"]:
        raise RuntimeError(f"card and CPU tokens differ: {results['cuda']} vs {results['cpu']}")
    log("[tiny] card tokens == CPU tokens")


def phase_full(card: str) -> dict:
    """ModelConfig() at full width on 8 slots x 2048 positions."""
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
    return launches


def main() -> None:
    import torch

    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    k1 = phase_k1(card)
    k6 = phase_k6(card)
    phase_kernel_sweep()
    phase_tiny()
    launches = phase_full(card)
    k1["launches"], k6["launches"] = launches["K1"], launches["K6"]
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k6]}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    if shutil.which("nvidia-smi") is None:
        raise SystemExit("chip_smoke: nvidia-smi not found; this script needs a CUDA card")
    main()
