#!/usr/bin/env python3
"""Drive the PyTorch port (flash_attention_tpu_torch) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

  1. device   — requires a CUDA card; prints its name and power limit and
                the torch, CUDA and nvcc versions.
  2. build    — builds the CUDA kernels and the native scheduler from the
                repository's sources, and prints the build seconds.
  3. kernels  — K1 (flash_fwd_sm90.cu: wgmma on TMA-fed tiles in bf16 /
                fp16) at the serving path's shapes and at phase 14's
                training shape, and K6 (decode.cu: the kv split over
                blocks, merged in the launch), in bf16, against their plain
                PyTorch versions and the fp32 oracle (K6 also row by row and
                its LSE), bit-identical over two calls (K6 also under a CUDA
                graph's replay), with their grids (K1: blocks, q rows a
                block, SMs; K6: kv split and blocks) and CUDA-event times of
                kernel, plain, SDPA and bound; then every dtype / head_dim
                instantiation at ragged shapes.
  4. tiny     — a tiny fp32 model served on the card (through the kernels)
                and on the CPU (through the plain versions): the greedy
                tokens must be identical.
  5. full     — ModelConfig() at full width, bf16, random weights from a
                seed; ServingEngine serves 10 greedy requests on 8 slots;
                every completion must have 32 tokens, the logits must be
                finite, and both kernels must have been launched by the run.
                Then sampling on the card: the Gumbel noise and sample_tokens'
                tokens at temperature > 0 with top-k and top-p bit-equal to
                the CPU's, with no host sync; one decode step of 8 slots
                timed greedy and sampled.
  6. paged    — K7 (decode.cu, paged), K8 (flash_fwd.cu, paged) and K9/K10
                (paged_write.cu) at the paged path's shapes in bf16 over a
                shuffled page table, against their plain versions (K9/K10
                bit-exact, the new lengths of a slot at capacity and one on
                the dump page, one launch a call) and the fp32 oracle, the
                outputs also row by row relative to the row's largest value
                (K7 with its kv split, bit-identical over two calls); then
                every dtype / head_dim instantiation at ragged shapes and
                two page sizes.
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
                code of each payload type must return the codes exactly;
                K6q and K7q print their kv split and are bit-identical over
                two calls, K9q and K10q make one launch a call. Then every
                (query dtype, payload, head_dim) instantiation of K6q, K7q,
                K8q and K9q/K10q at ragged shapes.
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
 12. backward — K3, K4, K5 and K5's split sum K5s (flash_bwd_sm90.cu:
                wgmma on TMA-fed tiles in bf16 / fp16; flash_bwd.cu's FMA
                bodies in fp32) in bf16 through
                flash_attention's autograd Function (whose card output must
                carry it): K4 + K5 at q [1,32,2048,128] over kv
                [1,8,2048,128] and at q_len 256 end-aligned, K3 at
                [1,32,2048,128] causal and not; dq, dk and dv within 0.1 of
                autograd through the fp32 oracle and row by row within
                REL_BAR of flash_attention_bwd_plain; K4 and K5, and K3's dk
                and dv, bit-identical over two calls; kernel, plain,
                SDPA-backward and bound times, TFLOP/s, share of 989 and the
                route over SDPA (K4 + K5 beside K3 at the MHA shape, for
                information); K5s alone, exactly its plain version. Then
                every (dtype, head_dim) instantiation at lengths 1, 63, 129
                and 1000, and across the 128- and 64-row tile edges
                (lengths 127-257, GQA groups 1-8, q_len < kv_len, K5 split
                and not, batch 2); then the tensor-core forward and K3
                across their tile edges in fp16 and bf16 (lengths 1-1000,
                groups 1/4/8, q_len < kv_len, batch 2, windows 1/63/65/1000,
                softcap, documents), each bit-identical over two calls.
 13. tiny train — the tiny fp32 model, GQA (K1, K4, K5) and MHA (K1, K3):
                loss and every parameter's gradient on the card equal the
                CPU's within 1e-4 of each leaf's largest gradient.
 14. full train — ModelConfig() on phase 5's weights at B=1, T=2048: three
                steps of forward + backward with finite loss and gradients
                and no all-zero weight gradient, then an SGD step along -g
                that lowers the loss; exactly K1, K4, K5 and K5s launched. Then
                ModelConfig(num_kv_heads=32, num_layers=4) one step, K1
                and K3 launched. Step ms, training tokens/s, peak memory.
 15. masked   — the masked kernels in bf16 against their plain versions
                (row-relative), the fp32 oracle with the same masks and
                their LSE: K1 with window 4096 (q 256 end-aligned over kv
                9216) and with softcap 50; K2 (window 64) beside K1 at the
                JAX band's window 128; K6 over a dense window, a ring of
                4352 rows and a ring with 4 sinks, lengths past the ring,
                K6q int8 on the ring; K7 and K8 with window 4096 and 4
                sinks over a shuffled paged ring whose rolled-out logical
                pages alias live ones (K6 and K7 with their kv split,
                bit-identical over two calls). Then every (dtype, head_dim)
                instantiation at windows 1, 63, 64, 65 and 1000; then the
                split-edge sweep: K6 / K6q / K7 / K7q for every (query
                dtype, payload, head_dim), groups 1/4/16, batch 1 and 32,
                lengths 0, 1 and the split edges +-1, over a dense window,
                a ring, a ring with 3 sinks and a paged ring of 64- and
                128-row pages, each against plain, the oracle and its LSE.
 16. tiny masked — the tiny fp32 model on the card and the CPU, identical
                tokens, through a dense window (96, and 48: K2), the rolling
                cache, rolling + 32 sinks, softcap 30, the paged ring and
                paged + sinks; rolling == dense window == paged ring, and
                paged sinks == rolling sinks.
 17. full masked — ModelConfig(mlp_dim=14336, sliding_window=4096)
                (Mistral-7B v0.1's shape, tied embedding), bf16, seed 0:
                prompts of {1, 255, 1024, 4095, 4096, 4097, 6000, 9000}
                tokens, 32 new each, through (a) the rolling ServingEngine
                (4352-row ring, K1 and K6 only), (b) the same without the
                ring at max_seq 9216 (last-chunk logits within LOGIT_BAR of
                (a)), (c) PagedServingEngine with 4 sinks (at most 37 pages a
                slot, the pool full again after; K7, K8, K10 only) and (d)
                softcap 50 on phase 5's requests.
 18. masked backward — K1d (the forward's segment ids) and the masked
                K3, K4 and K5 (K3m, K4m and K5m in flash_bwd_sm90.cu, K1d in
                flash_fwd_sm90.cu; K4m, K5m and K3m's dk and dv bit-identical
                over two calls) in bf16 through
                flash_attention's autograd Function, each call launching
                exactly its route's kernels: gradients row by row within
                REL_BAR of flash_attention_bwd_plain and within 0.1 of
                autograd through the fp32 oracle with the same masks, at
                windows 1, 63, 64 (K2's forward), 65, 1000 and 4096, softcap
                5 with q x 32 (so 1 - tanh^2 spans most of (0, 1]), packed
                documents, a (q_ids, kv_ids) pair with kv_len > q_len, a q
                id absent from kv (finite, zero gradient rows) and all three
                together, GQA and MHA; then at the training shapes (q
                [1,32,8192,128] kv [1,8,8192,128], window 4096, unpacked and
                packed as documents {5000, 1800, 900, 492}; for K3m q = kv
                [1,32,8192,128] packed, as phase 20d runs it, and
                [1,32,4096,128] at window 1024) the
                forward and backward held against plain and the oracle
                a few kv heads at a time and timed beside plain, SDPA with the
                equivalent boolean mask and the unwindowed causal K4 / K5.
                Then every (dtype, head_dim) instantiation at ragged
                shapes and windows 1-129 and 1000.
 19. tiny masked train — the tiny fp32 model with window 24 and softcap
                30, packed and not, GQA and MHA: loss and every gradient on
                the card equal the CPU's within 1e-4 of each leaf's largest.
 20. full masked train — ModelConfig(mlp_dim=14336, sliding_window=4096)
                (Mistral-7B's shape, 32 layers) at B=1, T=8192 after phase
                17's engines are released: (a) three steps and the SGD
                check, exactly K1, K4m, K5m; (b) one packed step, exactly
                K1d, K4m, K5m; (c) softcap 50, one step; (d) the MHA route
                at 4 layers, one packed step, exactly K1d and K3m. Losses,
                step ms, tokens/s, peak memory, the attention kernels' share
                of (a)'s step and (b)'s attention over (a)'s.
 21. probes   — P1-P6 (csrc/probes.cu: body T for P1, P3, P4, body S for
                P2, P5, P6) through each tool's ``run`` on a shortened
                sweep (P1 at seq 2048 over the four tile shapes and at 8192
                over one; P2, P5, P6 at 512 and 1024; P3 at 1024 over four
                tiles and 8192 over two; P4 at 8192 over one), 32 heads,
                head_dim 128: every variant within its tool's row-relative
                bar of its plain version and, where it computes attention,
                within 0.1 of the fp32 oracle, timed beside its plain
                version, bound and SDPA; each probe's run launches exactly
                its body (P5 also K1). The whole sweeps run from
                ``python3 -m flash_attention_tpu_torch.tools.<probe>``.

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
PEAK_FP32 = 67e12  # H100 SXM fp32 rate off the tensor cores


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


def _rel_diff(a, b, floor: float = 0.0) -> float:
    """max over rows (all dims but the last) of max|a - b| / max|b| in the
    row, that max taken no smaller than ``floor``; a row where b is all 0 (an
    empty slot's) must be 0 in a as well."""
    import torch

    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    err, scale = (a - b).abs().amax(1), b.abs().amax(1).clamp(min=floor)
    empty = torch.where(err > 0, torch.full_like(err, float("inf")), torch.zeros_like(err))
    rel = torch.where(scale > 0, err / scale.clamp(min=1e-30), empty)
    return float(rel.max()) if rel.numel() else 0.0


def _fwd_grid(q, k) -> str:
    """K1's grid on this card for q [B, Hq, Sq, D] (the tensor-core body in
    bf16 / fp16): blocks of ``fwd_q_tile`` rows against the SMs."""
    import torch

    from flash_attention_tpu_torch.ops.flash_attention import fwd_q_tile

    b, hq, q_len, _ = q.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tile = fwd_q_tile(b, hq, q_len, sms)
    return f"{-(-q_len // tile) * b * hq} blocks of {tile} q rows on {sms} SMs"


def phase_k1(card: str) -> dict:
    """K1 at the chunked-prefill shapes (q [1,32,256,128] against a cache
    slice of kv_len rows), the one-shot prefill shape (Sq = Skv = 512) and
    phase 14's training shape (q [1,32,2048,128] kv [1,8,2048,128]), each
    with its LSE, twice on the same inputs (bit-identical), against its
    plain version and the fp32 oracle. Returns the kernels' line entries of
    the chunk at kv 2048 ("K1") and the training shape ("K1t")."""
    import torch
    import torch.nn.functional as F

    from flash_attention_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from flash_attention_tpu_torch.ops.reference import reference_attention_with_lse
    from flash_attention_tpu_torch.utils.testing import make_qkv

    dev = torch.device("cuda")
    scale = 1.0 / 128**0.5
    worst_plain, rep = 0.0, {}
    cases = [(256, kv, True) for kv in (256, 1024, 2048)] + [(512, 512, False), (TRAIN_TOKENS, TRAIN_TOKENS, False)]
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
        _same_twice(f"K1 q_len={q_len} kv_len={kv_len}", lambda: flash_attention(q, k, v, causal=True,
                                                                                 save_residuals=True))
        p_out, p_lse = flash_attention_plain(q, k, v, causal=True, sm_scale=scale, save_residuals=True)
        o_out, o_lse = reference_attention_with_lse(q, k, v, causal=True)
        torch.cuda.synchronize()
        d_oracle, d_plain = _max_diff(out, o_out), _max_diff(out, p_out)
        d_rel = max(_rel_diff(out, p_out), _rel_diff(out, o_out))
        d_lse = max(_max_diff(lse, p_lse), _max_diff(lse, o_lse))
        del p_out, p_lse, o_out, o_lse
        ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True, save_residuals=True))
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=True, sm_scale=scale, save_residuals=True))
        # The library yardstick: one SDPA call with the end-aligned mask.
        mask = torch.arange(kv_len, device=dev)[None, :] <= torch.arange(q_len, device=dev)[:, None] + (kv_len - q_len)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True))
        flops = 4 * 128 * 32 * causal_pairs(q_len, kv_len)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse.numel()
        bound_ms, bound_by = bound(flops, nbytes)
        log(
            f"[K1] q [1,32,{q_len},128] kv [1,8,{kv_len},128] bf16 causal+lse, {_fwd_grid(q, k)}: "
            f"|out-oracle| {d_oracle:.3e} (bar {ORACLE_BAR}), |out-plain| {d_plain:.3e} (bar {PLAIN_BAR}), "
            f"row-relative vs plain and oracle {d_rel:.3e} (bar {REL_BAR['bfloat16']}), "
            f"|lse| {d_lse:.3e} (bar {LSE_BAR}), bit-identical over two calls; kernel {ms:.4f} ms ({_rates(flops, ms)}), "
            f"plain {plain_ms:.4f} ms, SDPA (library) {lib_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
            f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) ({card})"
        )
        if not (d_oracle < ORACLE_BAR and d_plain < PLAIN_BAR and d_rel < REL_BAR["bfloat16"] and d_lse < LSE_BAR):
            raise RuntimeError(f"K1 disagrees at q_len={q_len} kv_len={kv_len}")
        worst_plain = max(worst_plain, d_plain)
        if (q_len, kv_len) in ((256, 2048), (TRAIN_TOKENS, TRAIN_TOKENS)):
            rep[q_len] = {"max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by}
        del q, k, v, out, lse, mask
    rep[256]["max_abs_err"] = worst_plain
    entry = {"route": "cuda", "source": "flash_attention_tpu_torch/csrc/flash_fwd_sm90.cu",
             "replaces": f"{REFERENCE}/ops/flash_attention.py:57"}
    return {"K1": {"name": "fwd_kernel, wgmma + TMA (K1)", **entry, **rep[256]},
            "K1t": {"name": f"fwd_kernel, wgmma + TMA (K1), training shape T={TRAIN_TOKENS}", **entry,
                    **rep[TRAIN_TOKENS]}}


def phase_k6(card: str) -> dict:
    """K6 at the decode shape: q [8,32,128] against a [8,8,2048,128] cache,
    its kv split printed; output and LSE held against plain (also row by
    row) and the oracle, bit-identical over two calls and under a CUDA
    graph's replay."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from flash_attention_tpu_torch.ops.decode import decode_attention, decode_attention_plain
    from flash_attention_tpu_torch.ops.reference import reference_attention_with_lse

    dev = torch.device("cuda")
    rng = np.random.default_rng(6)

    def uniform(shape):
        return torch.from_numpy(rng.uniform(-0.5, 0.5, shape).astype(np.float32)).to(dev, torch.bfloat16)

    q = uniform((8, 32, 128))
    k_cache, v_cache = uniform((8, 8, 2048, 128)), uniform((8, 8, 2048, 128))
    lengths = torch.tensor([0, 1, 255, 256, 1000, 2047, 2048, 7], dtype=torch.int32, device=dev)
    (out, lse), grid = _twice("K6", decode_attention, lambda: decode_attention(q, k_cache, v_cache, lengths,
                                                                               save_residuals=True))
    p_out, p_lse = decode_attention_plain(q, k_cache, v_cache, lengths, sm_scale=1.0 / 128**0.5, save_residuals=True)
    o_out, o_lse = reference_attention_with_lse(q[:, :, None, :], k_cache, v_cache, kv_length=lengths)
    o_out, o_lse = o_out[:, :, 0], o_lse[:, :, 0]
    torch.cuda.synchronize()
    d_oracle, d_plain = _max_diff(out, o_out), _max_diff(out, p_out)
    d_rel = max(_rel_diff(out, p_out), _rel_diff(out, o_out))
    d_lse = max(_max_diff(lse, p_lse), _max_diff(lse, o_lse))
    if not bool((out[0] == 0).all()):
        raise RuntimeError("K6: an empty slot (length 0) must give output 0")
    same = _graph_replays(lambda: decode_attention(q, k_cache, v_cache, lengths, save_residuals=True), (out, lse))
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
        f"[K6] q [8,32,128] cache [8,8,2048,128] bf16 lengths {lengths.tolist()}, {grid}: "
        f"|out-oracle| {d_oracle:.3e} (bar {ORACLE_BAR}), |out-plain| {d_plain:.3e} (bar {PLAIN_BAR}), row-relative "
        f"vs plain and oracle {d_rel:.3e} (bar {REL_BAR['bfloat16']}), |lse| {d_lse:.3e} (bar {LSE_BAR}); "
        f"bit-identical over two calls, CUDA graph replay equal to the call: {same}; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA (library) {lib_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB) ({card})"
    )
    if not (d_oracle < ORACLE_BAR and d_plain < PLAIN_BAR and d_rel < REL_BAR["bfloat16"] and d_lse < LSE_BAR
            and same):
        raise RuntimeError("K6 disagrees")
    return {
        "name": "decode (K6)", "route": "cuda",
        "source": "flash_attention_tpu_torch/csrc/decode.cu",
        "replaces": f"{REFERENCE}/ops/decode.py:56",
        "max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms,
        "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
    }


def _twice(what: str, wrapper, call):
    """``call`` (a decode wrapper's call returning (out, lse)) run twice:
    the two results must be bit-identical (the kv split merges in a fixed
    order). Returns the first result and the split count and blocks of its
    launch (``wrapper.last_grid``) as text."""
    import torch

    first, second = call(), call()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise RuntimeError(f"{what}: two calls on the same inputs differ")
    splits, blocks = wrapper.last_grid
    return first, f"kv split {splits}, {blocks} blocks"


def _graph_replays(call, want) -> bool:
    """Whether ``call`` captured in a CUDA graph and replayed twice gives
    ``want`` (its direct result) both times: the split merge's ticket
    counters reset themselves."""
    import torch

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = call()
    same = True
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        same = same and all(torch.equal(a, b) for a, b in zip(got, want))
    return same


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
    a quantized one (the K*q instantiations) in .quant_launches; the forward
    counts K1d (segment ids) in .segment_launches, and the backward
    launchers their masked instantiations (K3m, K4m, K5m: a window, softcap
    or segment ids) in .masked_launches, and K5's split sum counts as K5s;
    the probes' bodies T and S count as PT and PS."""
    from flash_attention_tpu_torch.ops.attention_bwd import launch_dkv, launch_dkv_sum, launch_dq, launch_fused
    from flash_attention_tpu_torch.ops.decode import decode_attention
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention
    from flash_attention_tpu_torch.ops.paged import paged_decode_attention, paged_prefill_attention, paged_write_tokens_multi
    from flash_attention_tpu_torch.tools.probes import launch_single, launch_tiled

    return {
        "K1": (flash_attention, "launches"), "K2": (flash_attention, "band_launches"),
        "K1d": (flash_attention, "segment_launches"),
        "K3": (launch_fused, "launches"), "K4": (launch_dq, "launches"), "K5": (launch_dkv, "launches"),
        "K3m": (launch_fused, "masked_launches"), "K4m": (launch_dq, "masked_launches"),
        "K5m": (launch_dkv, "masked_launches"), "K5s": (launch_dkv_sum, "launches"),
        "K6": (decode_attention, "launches"), "K6q": (decode_attention, "quant_launches"),
        "K7": (paged_decode_attention, "launches"), "K7q": (paged_decode_attention, "quant_launches"),
        "K8": (paged_prefill_attention, "launches"), "K8q": (paged_prefill_attention, "quant_launches"),
        "K9/K10": (paged_write_tokens_multi, "launches"), "K9q/K10q": (paged_write_tokens_multi, "quant_launches"),
        "PT": (launch_tiled, "launches"), "PS": (launch_single, "launches"),
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


def phase_sampling(card: str, params) -> None:
    """Phase 5's sampling on the card, ModelConfig() on phase 5's weights:
    ``gumbel_noise`` for seeds and positions at the edges of their int32
    ranges, and ``sample_tokens`` at temperature > 0 with top-k and top-p on
    the logits of one decode step of 8 slots, each bit-equal to the same
    function on the CPU (which the CPU tests hold to jax.random's bits);
    the card's ``sample_tokens`` must not synchronise with the host (the
    sync debug mode raises if it does). Then that decode step timed with
    the greedy pick and with sampling, and the sampling alone."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig, decode_step_logits, init_caches
    from flash_attention_tpu_torch.serving.sampling import gumbel_noise, sample_tokens

    cfg, slots, length = ModelConfig(), 8, 1024
    seeds = torch.tensor([0, 1, 7, 12345, 2**31 - 1, -1, -2**31, 99], dtype=torch.int32)
    positions = torch.tensor([0, 1, 2, 1000, 2047, 4096, 2**31 - 1, length + 1], dtype=torch.int32)
    noise = gumbel_noise(seeds.cuda(), positions.cuda(), cfg.vocab_size)
    if not torch.equal(noise.cpu(), gumbel_noise(seeds, positions, cfg.vocab_size)):
        raise RuntimeError("[sampling] the card's Gumbel noise differs from the CPU's")
    sampling = dict(
        temperature=torch.tensor([0.7, 1.0, 1.3, 0.5, 1.0, 2.0, 0.9, 1.0]),
        top_k=torch.tensor([0, 40, 0, 5, 1000, 0, 50, 0], dtype=torch.int32),
        top_p=torch.tensor([1.0, 1.0, 0.9, 0.95, 0.8, 1.0, 0.5, 0.99]),
        seeds=seeds, positions=torch.full((slots,), length + 1, dtype=torch.int32))
    on_card = {key: t.cuda() for key, t in sampling.items()}
    caches = [c._replace(lengths=torch.full((slots,), length, dtype=torch.int32, device="cuda"))
              for c in init_caches(cfg, slots, 2048, device="cuda")]
    tok = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (slots, 1))).to("cuda", torch.int32)
    with torch.no_grad():
        logits, _ = decode_step_logits(params, cfg, tok, caches)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            card_tok = sample_tokens(logits, **on_card)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        cpu_tok = sample_tokens(logits.cpu(), **sampling)
        if not torch.equal(card_tok.cpu(), cpu_tok):
            raise RuntimeError(f"[sampling] card tokens {card_tok.tolist()} != CPU tokens {cpu_tok.tolist()}")
        greedy_ms = cuda_ms(lambda: torch.argmax(decode_step_logits(params, cfg, tok, caches)[0], dim=-1))
        sampled_ms = cuda_ms(lambda: sample_tokens(decode_step_logits(params, cfg, tok, caches)[0], **on_card))
        sample_ms = cuda_ms(lambda: sample_tokens(logits, **on_card))
        noise_ms = cuda_ms(lambda: gumbel_noise(on_card["seeds"], on_card["positions"], cfg.vocab_size))
    del caches
    torch.cuda.empty_cache()
    log(f"[sampling] Gumbel noise [8, {cfg.vocab_size}] and sample_tokens (temperature > 0, top-k, top-p) card == "
        f"CPU bit for bit, no host sync; tokens {card_tok.tolist()}")
    log(f"[sampling] ModelConfig() decode step, {slots} slots at {length} positions: greedy (argmax) {greedy_ms:.4f} ms, "
        f"sampled {sampled_ms:.4f} ms ({sampled_ms / greedy_ms:.3f}x); sample_tokens alone {sample_ms:.4f} ms, "
        f"gumbel_noise alone {noise_ms:.4f} ms ({card})")


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
    (out, lse), grid = _twice("K7", paged_decode_attention, lambda: paged_decode_attention(q, cache, save_residuals=True))
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
        f"[K7] q [8,32,128] pages [129,8,128,128] bf16, shuffled table [8,16], lengths {list(PAGED_LENGTHS)}, "
        f"{grid}, bit-identical over two calls: "
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
    launches10 = _launches_a_call(lambda: paged_write_tokens_multi(cache, k_new, v_new, slots))
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
        f"one on the dump page: bit-equal to plain, lengths advanced where valid {valid.tolist()} (new lengths "
        f"{written.lengths.tolist()}), {launches10} launch a call; "
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
    layer0 = cache.layers()[0]
    one = paged_write_tokens(layer0, k_one, v_one, slots)
    paged_write_tokens_plain(plain_one, k_one[None], v_one[None], slots)
    torch.cuda.synchronize()
    if not (torch.equal(cache.k_pool, plain.k_pool) and torch.equal(cache.v_pool, plain.v_pool)
            and torch.equal(cache.k_pool[0, 0, :, 37], k_one[0]) and torch.equal(one.lengths, want_lengths)):
        raise RuntimeError("K9 (one layer) disagrees with its plain version")
    launches9 = _launches_a_call(lambda: paged_write_tokens(layer0, k_one, v_one, slots))
    ms9 = cuda_ms(lambda: paged_write_tokens(layer0, k_one, v_one, slots))
    plain9 = cuda_ms(lambda: paged_write_tokens_plain(plain_one, k_one[None], v_one[None], slots))
    idx9 = idx[1][0], idx[2][0], idx[3][0]  # [page, head, row] of the valid rows in one layer
    rows9_k, rows9_v = k_one[ok], v_one[ok]
    lib9 = cuda_ms(lambda: (plain.k_pool[0].index_put_(idx9, rows9_k), plain.v_pool[0].index_put_(idx9, rows9_v)))
    bound9, by9 = bound(0, 2 * (2 * n_valid * 8 * 128 * 2) + 4 * 4 * 8)
    log(
        f"[K9] one layer: bit-equal to plain, new lengths {one.lengths.tolist()}, {launches9} launch a call; "
        f"wrapper {ms9:.4f} ms, plain {plain9:.4f} ms, index_put_ K and V "
        f"(library) {lib9:.4f} ms, bound {bound9:.5f} ms by {by9} ({card})"
    )
    return k7, k8, k10


# The runtime calls that put one operation on the device, as a torch.profiler
# trace records them on the host side (its device-side records can come back
# empty for a trace this short).
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def launches_a_call(call) -> int:
    """The device operations (kernels, copies, memsets) one ``call`` puts on
    the device, counted from the launch calls in a torch.profiler trace of
    one call after a warm-up."""
    import torch

    call()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return sum(e.name in LAUNCH_CALLS for e in prof.events())


def _launches_a_call(call) -> int:
    """``launches_a_call``, which must be 1: the page write is one launch."""
    n = launches_a_call(call)
    if n != 1:
        raise RuntimeError(f"the page write made {n} device operations a call, want 1")
    return n


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
    (out, lse), grid = _twice(f"K6q {mode} {what}", decode_attention,
                              lambda: decode_attention(q, kq, vq, lengths, save_residuals=True))
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
        f"[K6q] {mode} {what}, {grid}, bit-identical over two calls: |out-plain| {d_plain:.3e}, |out-oracle| "
        f"{d_oracle:.3e} (bar {ORACLE_BAR}), "
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
    (out, lse), grid = _twice(f"K7q {mode} {what}", paged_decode_attention,
                              lambda: paged_decode_attention(q, layer, save_residuals=True))
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
        f"[K7q] {mode} {what}, {grid}, bit-identical over two calls: |out-plain| {d_plain:.3e}, |out-oracle| "
        f"{d_oracle:.3e} (bar {ORACLE_BAR}), "
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
        layer0 = cache.layers()[0]
        paged_write_tokens(layer0, k_one, v_one, slots8)
        paged_write_tokens_plain(plain_one, k_one[None], v_one[None], slots8)
        torch.cuda.synchronize()
        if not same():
            raise RuntimeError(f"K9q {mode} (one layer): not bit-equal to plain")
        launches = (_launches_a_call(lambda: paged_write_tokens_multi(cache, k_new, v_new, slots8)),
                    _launches_a_call(lambda: paged_write_tokens(layer0, k_one, v_one, slots8)))
        ms9 = cuda_ms(lambda: paged_write_tokens(layer0, k_one, v_one, slots8))
        plain9 = cuda_ms(lambda: paged_write_tokens_plain(plain_one, k_one[None], v_one[None], slots8))
        bound9, by9 = bound(0, 2 * n_valid * 8 * (128 * 2 + 128 * item + 4) + 4 * 4 * 8)
        log(
            f"[K10q] {mode}: 32 layers x 8 slots x bf16 rows [8,128] quantized into pools [32,129,8,128,128], one "
            f"slot at capacity, one on the dump page: payload and scales bit-equal to plain, lengths advanced where "
            f"valid {valid.tolist()}; K10q and K9q {launches} launch a call; wrapper {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library none, bound "
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


# The backward kernels' cases at the training path's shapes: (hq, hkv,
# q_len, kv_len, causal). ModelConfig() trains through K4 + K5 (32 q over 8
# kv heads); an MHA model (LLaMA-2-7B's 32 heads over 32) through K3.
BWD_CASES = (
    (32, 8, 2048, 2048, True),
    (32, 8, 256, 2048, True),
    (32, 32, 2048, 2048, True),
    (32, 32, 2048, 2048, False),
)
# Gradients, row by row against the plain version: max|kernel - plain| in
# the row over the row's largest |plain|, as REL_BAR does for the forward.
# A row whose largest value is under GRAD_FLOOR of the largest value of the
# three gradients is held to that floor instead: its terms cancel (the first
# causal row's dq is 0 up to rounding, and with a single key dq and dk are 0
# everywhere), so it has no scale of its own.
GRAD_FLOOR = 1e-3
TRAIN_TOKENS = 2048  # the training sequence of the JAX package's benchmark (bench.py:483)
SGD_LRS = (1.0, 0.3, 0.1, 0.03)  # the SGD check's steps, largest first


def _bwd_inputs(seed: int, hq: int, hkv: int, q_len: int, kv_len: int, d: int, dtype, *, strided_do: bool = True,
                batch: int = 1):
    """U(-0.5, 0.5) q, k, v and an N(0, 1) cotangent dO. With ``strided_do``
    dO is a [B, S, H, D] buffer seen as [B, H, S, D] (unit last stride,
    strided heads and rows), as a cotangent coming back through the output
    projection's einsum may be."""
    import torch

    from flash_attention_tpu_torch.utils.testing import make_qkv

    q, k, v = make_qkv(seed, batch, hq, q_len, d, num_kv_heads=hkv, kv_seq=kv_len, dtype=dtype, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if strided_do:
        do = torch.randn((batch, q_len, hq, d), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    else:
        do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    return q, k, v, do


def _splits(batch: int, hq: int, hkv: int, kv_len: int, dtype) -> int:
    """The blocks K5 splits a kv tile's GQA group over on this card: 1 in
    fp32 (the FMA body), ``dkv_splits`` in bf16 / fp16."""
    import torch

    from flash_attention_tpu_torch.ops.attention_bwd import TENSOR_CORE_DTYPES, dkv_splits

    if dtype not in TENSOR_CORE_DTYPES:
        return 1
    return dkv_splits(batch, hkv, kv_len, hq // hkv, torch.cuda.get_device_properties(0).multi_processor_count)


def _route(hq: int, hkv: int, q_len: int, kv_len: int, window=None, softcap=None, segment_ids=None, *, dtype=None,
           batch: int = 1) -> tuple:
    """The kernels one causal-or-not call under grad launches: its forward
    (K1d with segment ids, K2 for a window of at most 64, else K1) and its
    backward (K3 for MHA self-attention, else K4 + K5; K3m, K4m, K5m, their
    masked instantiations, with any mask; and K5s, K5's split sum, where
    ``_splits`` of a bf16 / fp16 call is above 1)."""
    if segment_ids is not None:
        fwd = "K1d"
    else:
        fwd = "K2" if window is not None and window <= 64 else "K1"
    bwd = ("K3",) if hq == hkv and q_len == kv_len else ("K4", "K5")
    masked = window is not None or softcap is not None or segment_ids is not None
    split = ("K5s",) if bwd != ("K3",) and _splits(batch, hq, hkv, kv_len, dtype) > 1 else ()
    return (fwd, *(name + "m" if masked else name for name in bwd), *split)


def _hold_bwd(what: str, q, k, v, do, causal: bool = True, *, rel_bar: float, window=None, softcap=None,
              segment_ids=None):
    """The card's gradients through flash_attention's autograd Function (the
    forward with LSE, then K3 or K4 + K5), under an optional window, softcap
    and segment ids, against flash_attention_bwd_plain on the same
    residuals (row by row, ``rel_bar``) and autograd through the fp32
    oracle with the same masks (ORACLE_BAR), both ``_by_kv_head``; the call
    must launch exactly its route's kernels (``_route``). Returns (the
    grads, the residuals, |g - plain|, row-relative, |g - oracle|)."""
    import torch

    from flash_attention_tpu_torch.ops.attention_bwd import flash_attention_bwd_plain
    from flash_attention_tpu_torch.ops.common import segment_pair
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention
    from flash_attention_tpu_torch.ops.reference import reference_attention

    scale = q.shape[-1] ** -0.5
    masks = dict(sliding_window=window, logit_softcap=softcap, segment_ids=segment_ids)
    segments = segment_pair(segment_ids, q.shape[0], q.shape[2], k.shape[2])
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    zero_counts()
    out = flash_attention(*leaves, causal=causal, **masks)
    if type(out.grad_fn).__name__ != "FlashAttentionFunctionBackward":
        raise RuntimeError(f"{what}: the card's output has grad_fn {out.grad_fn}, not the port's autograd Function")
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    check_launches(what, read_counts(), _route(q.shape[1], k.shape[1], q.shape[2], k.shape[2], window, softcap,
                                               segment_ids, dtype=q.dtype, batch=q.shape[0]))
    del leaves, out
    with torch.no_grad():
        out_r, lse = flash_attention(q, k, v, causal=causal, save_residuals=True, **masks)
        plain = _by_kv_head(lambda qh, oh, lh, dh, kh, vh: flash_attention_bwd_plain(
            qh, kh, vh, oh, lh, dh, causal=causal, sm_scale=scale, window=window, softcap=softcap, segments=segments),
            (q, out_r, lse, do), (k, v))

    def oracle_grads(qh, dh, kh, vh):
        inputs = [x.detach().float().requires_grad_() for x in (qh, kh, vh)]
        return torch.autograd.grad(reference_attention(*inputs, causal=causal, **masks), inputs, dh.float())

    oracle = _by_kv_head(oracle_grads, (q, do), (k, v))
    torch.cuda.synchronize()
    d_plain = max(_max_diff(g, w) for g, w in zip(grads, plain))
    floor = GRAD_FLOOR * max(float(w.abs().max()) for w in plain if w.numel())
    d_rel = max(_rel_diff(g, w, floor) for g, w in zip(grads, plain))
    d_oracle = max(_max_diff(g, w) for g, w in zip(grads, oracle))
    if not (d_oracle < ORACLE_BAR and d_rel < rel_bar):
        raise RuntimeError(f"{what}: |grad-oracle| {d_oracle:.3e} (bar {ORACLE_BAR}), row-relative to plain "
                           f"{d_rel:.3e} (bar {rel_bar})")
    return grads, (out_r, lse), d_plain, d_rel, d_oracle


def _same_twice(what: str, fn) -> None:
    """Two calls of ``fn`` on the same inputs return bit-identical tensors."""
    import torch

    first, second = fn(), fn()
    first = first if isinstance(first, tuple) else (first,)
    second = second if isinstance(second, tuple) else (second,)
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise RuntimeError(f"{what}: two calls on the same inputs differ")


def _rates(flops: float, ms: float) -> str:
    return f"{flops / ms / 1e9:.1f} TFLOP/s, {100 * flops / ms / 1e9 / (PEAK_FLOPS / 1e12):.1f} % of 989"


def phase_bwd_kernels(card: str) -> dict:
    """Phase 12: K3, K4 and K5 in bf16 at BWD_CASES, each through the
    autograd path and against its plain version and the oracle; kernel,
    plain, SDPA-backward and bound times, each kernel's TFLOP/s and share
    of the 989 TFLOP/s peak, the route's kernels over SDPA's backward (at
    the MHA cases K4 + K5 timed beside K3 for information); K4 and K5, and
    K3's dk and dv, twice on the same inputs, bit-identical (K5 split and
    not); then K5's split sum (K5s) alone on the T=2048 case's workspace
    against its plain version. Returns the report entries."""
    import torch
    import torch.nn.functional as F

    from flash_attention_tpu_torch.ops.attention_bwd import (
        _delta,
        _guard_lse,
        bwd_route,
        dkv_split_sum_plain,
        flash_attention_bwd_plain,
        launch_dkv,
        launch_dkv_sum,
        launch_dq,
        launch_fused,
    )
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention

    bf16, d = torch.bfloat16, 128
    report = {}
    for hq, hkv, q_len, kv_len, causal in BWD_CASES:
        route = bwd_route(hq, hkv, q_len, kv_len)
        shape = f"q [1,{hq},{q_len},{d}] kv [1,{hkv},{kv_len},{d}] bf16 {'causal' if causal else 'non-causal'}"
        q, k, v, do = _bwd_inputs(12, hq, hkv, q_len, kv_len, d, bf16)
        _, (out, lse), d_plain, d_rel, d_oracle = _hold_bwd(f"backward {shape}", q, k, v, do, causal,
                                                            rel_bar=REL_BAR["bfloat16"])
        args = (q, k, v, do, _guard_lse(lse).contiguous(), _delta(out, do).contiguous())
        kw = dict(causal=causal, sm_scale=d**-0.5)
        kernels = {"K3": launch_fused} if route == "fused" else {"K4": launch_dq, "K5": launch_dkv}
        for name, fn in kernels.items():
            # K3's dq adds its tiles' partials in a run-dependent order; its dk and dv are written once.
            _same_twice(f"backward {shape} {name}", lambda fn=fn: fn(*args, **kw)[1:] if name == "K3" else fn(*args, **kw))
        times = {name: cuda_ms(lambda fn=fn: fn(*args, **kw)) for name, fn in kernels.items()}
        # K4 + K5 on the MHA inputs, for information: the route stays K3.
        beside = "" if route != "fused" else (
            f"; K4 + K5 on the same inputs {cuda_ms(lambda: (launch_dq(*args, **kw), launch_dkv(*args, **kw))):.4f} ms "
            "(not the route)")
        # The forward of the same autograd call (K1 with its LSE), for the step's breakdown.
        fwd_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal, save_residuals=True))
        plain_ms = cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, out, lse, do, **kw), warmup=2, iters=5)
        # The library yardstick: the backward of one SDPA call over the same dO.
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        if causal and q_len != kv_len:  # SDPA's is_causal aligns the mask at the top
            mask = torch.arange(kv_len, device="cuda")[None, :] <= torch.arange(q_len, device="cuda")[:, None] + (kv_len - q_len)
            lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, enable_gqa=hq != hkv)
        else:
            lib_out = F.scaled_dot_product_attention(*leaves, is_causal=causal, enable_gqa=hq != hkv)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True))
        del leaves, lib_out
        pairs = causal_pairs(q_len, kv_len) if causal else q_len * kv_len
        q_bytes, kv_bytes = 2 * q.numel(), 2 * k.numel()
        in_bytes = 2 * q_bytes + 2 * kv_bytes + 2 * 4 * hq * q_len  # q, dO, k, v, lse, delta
        products = {"K3": 5, "K4": 3, "K5": 4}
        outs = {"K3": q_bytes + 2 * kv_bytes, "K4": q_bytes, "K5": 2 * kv_bytes}
        parts = []
        for name, ms in times.items():
            flops = 2 * d * pairs * hq * products[name]
            bound_ms, bound_by = bound(flops, in_bytes + outs[name])
            parts.append(f"{name} {ms:.4f} ms ({_rates(flops, ms)}; bound {bound_ms:.4f} ms by {bound_by})")
            if (hq, hkv, q_len, kv_len, causal) in (BWD_CASES[0], BWD_CASES[2]):
                report[name] = {"max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                "bound_ms": bound_ms, "bound_by": bound_by}
        split = _splits(1, hq, hkv, kv_len, bf16)
        ratio = f"{sum(times.values()) / lib_ms:.3f}"
        log(
            f"[backward] {shape}, {route}: |grad-oracle| {d_oracle:.3e} (bar {ORACLE_BAR}), |grad-plain| "
            f"{d_plain:.3e}, row-relative to plain {d_rel:.3e} (bar {REL_BAR['bfloat16']}); "
            + ", ".join(parts) + (f" (K5 over {split} split(s), its sum included)" if route != "fused" else "")
            + f"; {' + '.join(times)} over SDPA's backward {ratio}{beside}; plain (dq, dk, dv) {plain_ms:.4f} ms, SDPA "
            f"backward (library, dq, dk, dv) {lib_ms:.4f} ms; its forward, K1 with LSE, {fwd_ms:.4f} ms ({card})"
        )
        del q, k, v, do, out, lse, args
    # K5s alone, at the T=2048 case's workspace [2, 1, 8, splits, 2048, 128].
    hq, hkv, q_len, kv_len, _ = BWD_CASES[0]
    splits = _splits(1, hq, hkv, kv_len, bf16)
    gen = torch.Generator(device="cuda").manual_seed(12)
    ws = torch.randn((2, 1, hkv, splits, kv_len, d), generator=gen, device="cuda")
    dk, dv = (torch.empty((1, hkv, kv_len, d), dtype=bf16, device="cuda") for _ in range(2))
    launch_dkv_sum(ws, dk, dv)
    plain = dkv_split_sum_plain(ws, bf16)
    err = max(_max_diff(a, b) for a, b in zip((dk, dv), plain))
    if err != 0.0:
        raise RuntimeError(f"K5s: |sum - plain| {err} (the same additions in the same order must agree exactly)")
    sum_ms = cuda_ms(lambda: launch_dkv_sum(ws, dk, dv))
    sum_plain_ms = cuda_ms(lambda: dkv_split_sum_plain(ws, bf16))
    # fp32 adds off the tensor cores (67 TFLOP/s) against the bytes.
    sum_ops_ms, sum_bytes_ms = ws.numel() / PEAK_FP32 * 1e3, (4 * ws.numel() + 2 * 2 * dk.numel()) / PEAK_BYTES * 1e3
    sum_bound, sum_by = (sum_ops_ms, "operations") if sum_ops_ms >= sum_bytes_ms else (sum_bytes_ms, "bytes")
    log(f"[backward] K5s (K5's split sum) over workspace {list(ws.shape)} fp32: {sum_ms:.4f} ms, plain {sum_plain_ms:.4f} "
        f"ms, bound {sum_bound:.4f} ms by {sum_by}; |sum - plain| {err} ({card})")
    report["K5s"] = {"max_abs_err": err, "ms": sum_ms, "plain_ms": sum_plain_ms, "library_ms": None,
                     "bound_ms": sum_bound, "bound_by": sum_by}
    del ws, dk, dv, plain
    torch.cuda.empty_cache()
    sm90 = "flash_attention_tpu_torch/csrc/flash_bwd_sm90.cu"
    names = {"K3": ("dkv_kernel<FUSED>, wgmma + TMA (K3)", 594, sm90),
             "K4": ("dq_kernel, wgmma + TMA (K4)", 65, sm90), "K5": ("dkv_kernel, wgmma + TMA (K5)", 317, sm90),
             "K5s": ("split_sum_kernel, K5's split sum (K5s)", 317, sm90)}
    return {key: {"name": names[key][0], "route": "cuda", "source": names[key][2],
                  "replaces": f"{REFERENCE}/ops/attention_bwd.py:{names[key][1]}", **report[key]} for key in names}


# Phase 12's sweep across the tensor-core bodies' tile edges (64 and 128
# rows): lengths, GQA groups and q_len < kv_len end-aligned.
EDGE_LENGTHS = (127, 128, 129, 255, 257)
EDGE_GROUPS = (1, 2, 4, 8)


def phase_bwd_sweep() -> None:
    """Every (dtype, head_dim) instantiation of K3, K4 and K5 at ragged
    lengths (1, 63, 129, 1000): MHA self-attention causal and not (K3),
    GQA group 4 self-attention and group 2 with q_len < kv_len end-aligned
    (K4 + K5), MHA cross-length (K4 + K5); a cotangent with a strided last
    dimension (copied by the wrapper) on the fp32 cases. Then across the
    tensor-core tiles' edges: lengths EDGE_LENGTHS at GQA groups 2, 4 and 8
    of 8 q heads (self-attention, K5 split over every q head) and q_len <
    kv_len end-aligned at groups EDGE_GROUPS (group 1 is K4 + K5 without a
    split); one case of 64 q over 8 kv heads at T=1100, where K5 splits the
    group of 8 over 4 blocks of 2 heads; one of batch 2. Every case within
    ORACLE_BAR of the oracle's gradients and REL_BAR of plain."""
    import torch

    worst, n = 0.0, 0
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for d in (32, 64, 128):
            for length in (1, 63, 129, 1000):
                short = min(length, 63)
                cases = [(4, 4, length, length, True), (4, 4, length, length, False), (4, 1, length, length, True),
                         (4, 2, short, length, True), (4, 4, short, length, False)]
                for hq, hkv, q_len, kv_len, causal in cases:
                    what = f"backward {name} d={d} {hq}/{hkv} q {q_len} kv {kv_len} causal={causal}"
                    q, k, v, do = _bwd_inputs(n, hq, hkv, q_len, kv_len, d, dtype, strided_do=False)
                    if dtype == torch.float32:
                        do = do.transpose(-1, -2).contiguous().transpose(-1, -2)  # last stride q_len
                    _, _, _, d_rel, _ = _hold_bwd(what, q, k, v, do, causal, rel_bar=REL_BAR[name])
                    worst = max(worst, d_rel / REL_BAR[name])
                    n += 1
    log(
        f"[backward sweep] K3, K4 and K5 at fp32/fp16/bf16 x head_dim 32/64/128 x lengths 1/63/129/1000, MHA, "
        f"GQA 4 and 2, cross-length, {n} cases: all within {ORACLE_BAR} of the oracle's gradients; worst "
        f"row-relative difference to plain at {worst:.3f} of its bar {REL_BAR}"
    )
    worst, n0 = 0.0, n
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for d in (32, 64, 128):
            for length in EDGE_LENGTHS:
                cases = [(8, 8 // g, length, length, True) for g in EDGE_GROUPS[1:]]
                cases += [(8, 8 // g, length - 66, length, True) for g in EDGE_GROUPS]
                cases.append((8, 2, length, length, False))
                for hq, hkv, q_len, kv_len, causal in cases:
                    what = f"backward edges {name} d={d} {hq}/{hkv} q {q_len} kv {kv_len} causal={causal}"
                    q, k, v, do = _bwd_inputs(n, hq, hkv, q_len, kv_len, d, dtype)
                    _, _, _, d_rel, _ = _hold_bwd(what, q, k, v, do, causal, rel_bar=REL_BAR[name])
                    worst = max(worst, d_rel / REL_BAR[name])
                    n += 1
            for hq, hkv, length, batch in ((64, 8, 1100, 1), (8, 2, 300, 2)):
                what = f"backward edges {name} d={d} batch {batch} {hq}/{hkv} T {length}"
                q, k, v, do = _bwd_inputs(n, hq, hkv, length, length, d, dtype, batch=batch)
                _, _, _, d_rel, _ = _hold_bwd(what, q, k, v, do, True, rel_bar=REL_BAR[name])
                worst = max(worst, d_rel / REL_BAR[name])
                n += 1
    log(
        f"[backward sweep] across the tile edges: lengths {list(EDGE_LENGTHS)}, groups {list(EDGE_GROUPS)}, q_len < "
        f"kv_len end-aligned, non-causal, 64/8 heads at T=1100 (K5 over {_splits(1, 64, 8, 1100, torch.bfloat16)} "
        f"splits of the group of 8), batch 2, at fp32/fp16/bf16 x head_dim 32/64/128, {n - n0} cases: all within "
        f"{ORACLE_BAR} of the oracle's gradients; worst row-relative difference to plain at {worst:.3f} of its bar"
    )


# The tensor-core forward's and K3's sweep across their 64- and 128-row tile
# edges (csrc/flash_fwd_sm90.cu, csrc/flash_bwd_sm90.cu's fused body).
TC_LENGTHS = (1, 63, 64, 65, 127, 128, 129, 255, 256, 257, 1000)
TC_MASK_LENGTHS = (129, 257, 1000)
TC_WINDOWS = (1, 63, 65, 1000)


def _three_docs(length: int, batch: int):
    """Segment ids [batch, length] of three documents a row, split
    differently in each row."""
    import torch

    a, b = length // 2, length // 3
    docs = [(a, b, length - a - b), (length - a - b, a, b)]
    return torch.cat([_packed_ids(docs[i % 2]) for i in range(batch)])


def _hold_fwd(what: str, q, k, v, *, causal: bool, window=None, softcap=None, segment_ids=None) -> float:
    """K1 (K2, K1d) with its LSE, twice on the same inputs (bit-identical),
    launching exactly its route's kernel, against flash_attention_plain and
    the fp32 oracle (``_hold``); returns its row-relative error over
    REL_BAR."""
    import torch

    from flash_attention_tpu_torch.ops.common import segment_pair
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from flash_attention_tpu_torch.ops.reference import reference_attention_with_lse

    name = str(q.dtype).removeprefix("torch.")
    kw = dict(causal=causal, sliding_window=window, logit_softcap=softcap)
    zero_counts()
    out, lse = flash_attention(q, k, v, save_residuals=True, segment_ids=segment_ids, **kw)
    torch.cuda.synchronize()
    want = "K1d" if segment_ids is not None else "K2" if window is not None and window <= 64 else "K1"
    check_launches(what, read_counts(), (want,))
    _same_twice(what, lambda: flash_attention(q, k, v, save_residuals=True, segment_ids=segment_ids, **kw))
    segments = segment_pair(segment_ids, q.shape[0], q.shape[2], k.shape[2])
    p_out, p_lse = flash_attention_plain(q, k, v, sm_scale=q.shape[-1] ** -0.5, save_residuals=True,
                                         segments=segments, **kw)
    o_out, o_lse = reference_attention_with_lse(q, k, v, segment_ids=segment_ids, **kw)
    return _hold(what, out, p_out, o_out, lse, p_lse, o_lse, dtype=name)[1] / REL_BAR[name]


def phase_tensor_core_sweep() -> None:
    """K1 / K1d and K3 / K3m's tensor-core bodies in fp16 and bf16 at
    head_dim 32, 64 and 128 across their 64- and 128-row tile edges: the
    forward (``_hold_fwd``) at lengths TC_LENGTHS, self-attention causal at
    GQA groups 1, 4 and 8 (8 q heads), q_len < kv_len end-aligned at group
    4 and non-causal at group 8; K3 through the autograd Function
    (``_hold_bwd``; its dk and dv bit-identical over two calls) at the same
    lengths, MHA causal and not; then at lengths TC_MASK_LENGTHS, batch 2,
    windows TC_WINDOWS (softcap BITE_CAP with q x BITE_Q at 65, three
    documents a row at 63 and 1000; windows 1 and 63 without ids take K2's
    forward), the forward at group 4 and K3m."""
    import torch

    from flash_attention_tpu_torch.ops.attention_bwd import _delta, _guard_lse, launch_fused
    from flash_attention_tpu_torch.utils.testing import make_qkv

    worst_f, worst_b, nf, nb = 0.0, 0.0, 0, 0
    for dtype in (torch.float16, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for d in (32, 64, 128):
            for length in TC_LENGTHS:
                short = max(1, length - 66)
                for hq, hkv, q_len, causal in ((8, 8, length, True), (8, 2, length, True), (8, 1, length, True),
                                               (8, 2, short, True), (8, 1, length, False)):
                    q, k, v = make_qkv(nf, 1, hq, q_len, d, num_kv_heads=hkv, kv_seq=length, dtype=dtype,
                                       device="cuda")
                    what = f"[tensor-core sweep] K1 {name} d={d} {hq}/{hkv} q {q_len} kv {length} causal={causal}"
                    worst_f = max(worst_f, _hold_fwd(what, q, k, v, causal=causal))
                    nf += 1
                for causal in (True, False):
                    q, k, v, do = _bwd_inputs(nb, 4, 4, length, length, d, dtype)
                    what = f"[tensor-core sweep] K3 {name} d={d} T {length} causal={causal}"
                    _, (out, lse), _, d_rel, _ = _hold_bwd(what, q, k, v, do, causal, rel_bar=REL_BAR[name])
                    args = (q, k, v, do, _guard_lse(lse).contiguous(), _delta(out, do).contiguous())
                    _same_twice(what, lambda: launch_fused(*args, causal=causal, sm_scale=d**-0.5)[1:])
                    worst_b = max(worst_b, d_rel / REL_BAR[name])
                    nb += 1
            for length in TC_MASK_LENGTHS:
                for window in TC_WINDOWS:
                    softcap = BITE_CAP if window == 65 else None
                    ids = _three_docs(length, 2) if window in (63, 1000) else None
                    masks = dict(window=window, softcap=softcap, segment_ids=ids)
                    q, k, v = make_qkv(nf, 2, 8, length, d, num_kv_heads=2, dtype=dtype, device="cuda")
                    q = (q.float() * (BITE_Q if softcap else 4)).to(dtype)
                    what = f"[tensor-core sweep] forward {name} d={d} batch 2 8/2 T {length} masks {window}, {softcap}, " \
                           f"{'3 documents' if ids is not None else 'no ids'}"
                    worst_f = max(worst_f, _hold_fwd(what, q, k, v, causal=True, window=window, softcap=softcap,
                                                     segment_ids=ids))
                    nf += 1
                    q, k, v, do = _bwd_inputs(nb, 4, 4, length, length, d, dtype, batch=2)
                    q = (q.float() * (BITE_Q if softcap else 4)).to(dtype)
                    what = what.replace("forward", "K3m").replace("8/2", "4/4")
                    _, _, _, d_rel, _ = _hold_bwd(what, q, k, v, do, rel_bar=REL_BAR[name], **masks)
                    worst_b = max(worst_b, d_rel / REL_BAR[name])
                    nb += 1
    log(f"[tensor-core sweep] fp16/bf16 x head_dim 32/64/128 across the 64- and 128-row tile edges: the forward (K1, "
        f"K1d; K2 at windows 1 and 63 without ids) over lengths {list(TC_LENGTHS)}, groups 1/4/8, q_len < kv_len, "
        f"non-causal, and batch 2 with windows {list(TC_WINDOWS)}, softcap and documents at {list(TC_MASK_LENGTHS)}: "
        f"{nf} cases, each bit-identical over two calls, worst row-relative at {worst_f:.3f} of REL_BAR; K3 / K3m "
        f"through the autograd Function, {nb} cases (dk, dv bit-identical): all within {ORACLE_BAR} of the oracle's "
        f"gradients, worst row-relative at {worst_b:.3f} of REL_BAR")


def _lm_loss(logits, targets):
    import torch.nn.functional as F

    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(), targets.reshape(-1))


def _tiny_train(label: str, seed: int, runs, **masks) -> None:
    """The tiny fp32 model (``masks``: ModelConfig fields) on the card and on
    the CPU, for each (kv heads, segment ids of tokens [2, 100] or None,
    kernels the card launches) of ``runs``: the loss and every parameter's
    gradient agree within 1e-4 of the leaf's largest gradient (fp32 sums in
    another order, and K3's atomics in a run-dependent one), and the card
    launched exactly the kernels of its route."""
    import dataclasses

    import numpy as np
    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params, train_forward

    tokens = torch.from_numpy(np.random.default_rng(seed).integers(0, TINY_CFG["vocab_size"], (2, 101)))
    for kv_heads, seg, used in runs:
        cfg = dataclasses.replace(ModelConfig(**{**TINY_CFG, "num_kv_heads": kv_heads}), **masks)
        params = init_model_params(torch.Generator().manual_seed(0), cfg)
        result = {}
        for device in ("cuda", "cpu"):
            params_d = _to_device(params, device)
            leaves = _tensors(params_d)
            for t in leaves:
                t.requires_grad_()
            toks = tokens.to(device)
            zero_counts()
            ids = None if seg is None else seg.to(device)
            loss = _lm_loss(train_forward(params_d, cfg, toks[:, :-1], segment_ids=ids), toks[:, 1:])
            grads = torch.autograd.grad(loss, leaves)
            result[device] = (float(loss.detach()), [g.cpu() for g in grads], read_counts())
        what = f"{label} {kv_heads} kv heads{', packed' if seg is not None else ''}"
        check_launches(f"{what}, on the card", result["cuda"][2], used)
        worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                    for a, b in zip(result["cuda"][1], result["cpu"][1]))
        d_loss = abs(result["cuda"][0] - result["cpu"][0])
        zero = [i for i, g in enumerate(result["cuda"][1]) if not bool(g.abs().max() > 0)]
        log(f"{what}, 2 x 100 tokens: loss card {result['cuda'][0]:.6f} CPU {result['cpu'][0]:.6f}; worst leaf |grad "
            f"card - grad CPU| / max|grad CPU| {worst:.3e} (bar 1e-4) over {len(result['cpu'][1])} leaves; kernels {used}")
        if not (d_loss < 1e-5 and worst < 1e-4) or zero:
            raise RuntimeError(f"{what}: loss diff {d_loss}, grads {worst}, all-zero leaves {zero}")


def phase_tiny_train() -> None:
    """Phase 13: the tiny fp32 model, GQA (K4 + K5) and MHA (K3), on the card
    and on the CPU (``_tiny_train``)."""
    _tiny_train("[tiny train] fp32, 4 q /", 13, ((2, None, ("K1", "K4", "K5")), (4, None, ("K1", "K3"))))


def _check_grads(what: str, params) -> None:
    """Every gradient finite, and no weight matrix's all zero."""
    import torch

    leaves = _tensors(params)
    finite = torch.stack([torch.isfinite(t.grad).all() for t in leaves])
    nonzero = torch.stack([t.grad.abs().amax() > 0 for t in leaves if t.ndim >= 2])
    if not bool(finite.all()) or not bool(nonzero.all()):
        raise RuntimeError(f"{what}: {int((~finite).sum())} leaves with non-finite gradients, "
                           f"{int((~nonzero).sum())} weight matrices with an all-zero gradient")


def _train_step(params, cfg, tokens, segment_ids=None) -> float:
    """One forward + backward of the next-token loss; returns the loss.
    With ``segment_ids`` (the ids of ``tokens[:, :-1]``) the batch is packed."""
    from flash_attention_tpu_torch.models.transformer import train_forward

    for t in _tensors(params):
        t.grad = None
    loss = _lm_loss(train_forward(params, cfg, tokens[:, :-1], segment_ids=segment_ids), tokens[:, 1:])
    loss.backward()
    return float(loss.detach())


def _sgd_check(label: str, params, cfg, tokens, loss: float, segment_ids=None) -> None:
    """SGD along -g (the gradients of the last step, on ``tokens``), in the
    script: the largest step of SGD_LRS must lower the loss, from the weights
    as they were; the weights are put back after each try."""
    import torch

    from flash_attention_tpu_torch.models.transformer import train_forward

    leaves = _tensors(params)
    g2 = float(sum((t.grad.float() ** 2).sum() for t in leaves))
    kept = [t.detach().clone() for t in leaves]
    with torch.no_grad():
        for lr in SGD_LRS:
            for t in leaves:
                t.sub_(t.grad, alpha=lr)
            after = float(_lm_loss(train_forward(params, cfg, tokens[:, :-1], segment_ids=segment_ids), tokens[:, 1:]))
            for t, w in zip(leaves, kept):
                t.copy_(w)
            log(f"{label} SGD lr {lr}: loss {loss:.4f} -> {after:.4f} (first order: -{lr * g2:.4f}; |g|^2 {g2:.4e})")
            if after < loss:
                return
    raise RuntimeError(f"{label} no SGD step along -g lowered the loss")


def _train_steps(card: str, label: str, params, cfg, batches, *, used, segment_ids=None) -> dict:
    """Forward + backward steps of ``cfg`` on ``batches`` ([1, T + 1] tokens
    each), every launch count set to 0 just before and read just after; the
    steps must launch exactly ``used``, with finite losses and gradients.
    Returns the losses, step times, launches and peak memory."""
    import numpy as np
    import torch

    for t in _tensors(params):
        t.requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times, losses = [], []
    for tokens in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(_train_step(params, cfg, tokens, segment_ids))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not np.isfinite(losses[-1]):
            raise RuntimeError(f"{label} non-finite loss {losses[-1]}")
        _check_grads(label, params)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check_launches(f"{label} steps", launches, used)
    step_s = statistics.median(times)
    n_tok = batches[0].shape[1] - 1
    log(f"{label} B=1, T={n_tok}, {len(batches)} step(s) of forward + backward: losses {[round(x, 4) for x in losses]}, "
        f"step {[round(t * 1e3, 1) for t in times]} ms, median {step_s * 1e3:.1f} ms = {n_tok / step_s:.1f} training "
        f"tokens/s; peak device memory (max_memory_allocated) {peak / 2**30:.2f} GiB; kernel launches {launches} "
        f"({card})")
    return {"losses": losses, "step_s": step_s, "launches": launches, "peak_gib": peak / 2**30}


def phase_full_train(card: str, params) -> dict:
    """Phase 14: ModelConfig() trained at full width and depth on phase 5's
    weights (the engines and caches of phases 5-11 are released): three
    steps of forward + backward at B=1, T=2048 with next-token cross
    entropy, then one SGD step in the script that must lower the loss on the
    last batch; then ModelConfig(num_kv_heads=32, num_layers=4), the MHA
    route, one step. Returns the launch counts of the GQA steps and of the
    MHA step."""
    import gc

    import numpy as np
    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params

    gc.collect()
    torch.cuda.empty_cache()
    cfg = ModelConfig()
    rng = np.random.default_rng(14)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, TRAIN_TOKENS + 1))).cuda() for _ in range(3)]
    used = _route(cfg.num_q_heads, cfg.num_kv_heads, TRAIN_TOKENS, TRAIN_TOKENS, dtype=torch.bfloat16)
    gqa = _train_steps(card, f"[full train] ModelConfig() bf16, weights {_nbytes(params) / 1e9:.3f} GB and their "
                       "gradients as much,", params, cfg, batches, used=used)
    _sgd_check("[full train]", params, cfg, batches[-1], gqa["losses"][-1])
    for t in _tensors(params):
        t.grad = None
        t.requires_grad_(False)
    gc.collect()
    torch.cuda.empty_cache()

    cfg_mha = ModelConfig(num_kv_heads=32, num_layers=4)
    p_mha = init_model_params(torch.Generator(device="cuda").manual_seed(1), cfg_mha)
    mha = _train_steps(card, "[full train] ModelConfig(num_kv_heads=32, num_layers=4) bf16, first step (warm kernels),",
                       p_mha, cfg_mha, batches[:1], used=("K1", "K3"))
    del p_mha
    torch.cuda.empty_cache()
    return {"gqa": gqa["launches"], "mha": mha["launches"]}


# Masked serving (phases 15-17). Mistral-7B v0.1's shape (config.json:
# hidden 4096, 32 layers, 32 q / 8 kv heads, head_dim 128, intermediate 14336,
# vocab 32000, rope_theta 10000, sliding_window 4096) with the repository's
# tied embedding.
MISTRAL = dict(mlp_dim=14336, sliding_window=4096)
WINDOW = 4096
SINKS = 4  # StreamingLLM's four sink tokens
RING_ROWS = 4352  # rolling_buffer_len at window 4096 and chunk 256: ceil128(4096 + 256)
DENSE_LENGTHS = (0, 1, 100, 4095, 4096, 4097, 9000, 9216)  # K6 dense window over 9216 rows; K7's logical rows
RING_LENGTHS = (0, 1, 4095, 4096, 4352, 4353, 9000, 20000)  # K6 over the ring: lengths pass its rows
MASKED_PROMPT_LENS = (1, 255, 1024, 4095, 4096, 4097, 6000, 9000)  # phase 17, run A
SWEEP_WINDOWS = (1, 63, 64, 65, 1000)
# Phase 18's sweep: also the windows either side of the tensor-core bodies' 128-row tiles.
BWD_SWEEP_WINDOWS = (1, 63, 64, 65, 127, 128, 129, 1000)


def _ring_row(p: int, rows: int, sinks: int = 0) -> int:
    """The row of a rolling cache of ``rows`` rows that holds position p, as
    the cache writes it: p % rows; with sinks, p below them and sinks_pad +
    (p - sinks) % (rows - sinks_pad) above (sinks_pad = sinks rounded up to
    128)."""
    if not sinks:
        return p % rows
    spad = -(-sinks // 128) * 128
    return p if p < sinks else spad + (p - sinks) % (rows - spad)


def _visible_positions(length: int, window: int, sinks: int = 0) -> list[int]:
    """The positions a decode query at ``length`` attends: the window's and
    the sinks'."""
    return sorted(set(range(max(0, length - window), length)) | set(range(min(sinks, length))))


def _oracle_rows(q, k, v, rows_per_seq, *, softcap=None):
    """fp32 oracle of single-token decode over the cache rows each sequence
    sees: the rows gathered, then reference_attention_with_lse with the
    count as kv_length. Returns (out [B, Hq, D], lse [B, Hq]) and the
    boolean [B, rows] mask of those rows (for the library call)."""
    import torch

    from flash_attention_tpu_torch.ops.reference import reference_attention_with_lse

    batch, hkv, rows, d = k.shape
    n = max(1, max(len(r) for r in rows_per_seq))
    idx = torch.zeros((batch, n), dtype=torch.long)
    mask = torch.zeros((batch, rows), dtype=torch.bool)
    for b, r in enumerate(rows_per_seq):
        idx[b, : len(r)] = torch.tensor(r, dtype=torch.long)
        mask[b, r] = True
    idx, mask = idx.to(k.device), mask.to(k.device)
    gather = lambda x: torch.gather(x.float(), 2, idx[:, None, :, None].expand(batch, hkv, n, d))  # noqa: E731
    counts = torch.tensor([len(r) for r in rows_per_seq], device=k.device)
    out, lse = reference_attention_with_lse(q[:, :, None].float(), gather(k), gather(v), kv_length=counts,
                                            logit_softcap=softcap)
    return out[:, :, 0], lse[:, :, 0], mask


def _oracle_mask(q, k, v, mask, *, sm_scale, softcap=None):
    """fp32 attention of q [B, Hq, Sq, D] over k, v [B, Hkv, Skv, D] under an
    explicit boolean mask [Sq, Skv]: (out, base-2 LSE), 0 and -inf where a
    row sees nothing."""
    import torch

    from flash_attention_tpu_torch.ops.common import LOG2E

    group = q.shape[1] // k.shape[1]
    kf, vf = (x.float().repeat_interleave(group, dim=1) for x in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * sm_scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s2 = torch.where(mask, s * LOG2E, -torch.inf)
    m = s2.amax(-1, keepdim=True)
    live = torch.isfinite(m)
    p = torch.exp2(s2 - torch.where(live, m, 0.0))
    l = p.sum(-1, keepdim=True)
    out = torch.where(live, torch.einsum("bhqk,bhkd->bhqd", p, vf) / torch.where(live, l, 1.0), 0.0)
    lse = torch.where(live, m + torch.log2(torch.where(live, l, 1.0)), -torch.inf)[..., 0]
    return out, lse


def _window_pairs(q_len: int, kv_len: int, window: int | None) -> int:
    """(query, key) pairs an end-aligned causal mask with a window leaves."""
    diag = kv_len - q_len
    return sum(min(kv_len, i + diag + 1) - (0 if window is None else max(0, i + diag - window + 1)) for i in range(q_len))


def _visible_pairs(q_len: int, kv_len: int, window: int | None, segments=None) -> int:
    """(query, key) pairs a batch row's causal mask leaves, with the window
    and, for segment ids (a (q_ids, kv_ids) pair of one batch row), only the
    pairs of equal ids: what this run's data needs."""
    if segments is None:
        return _window_pairs(q_len, kv_len, window)
    from flash_attention_tpu_torch.ops.common import visible_mask

    return int(visible_mask(q_len, kv_len, segments[0].device, causal=True, window=window, segments=segments).sum())


SCORES_BUDGET = 2**30  # bytes of fp32 [B, heads, Sq, Skv] scores a plain or oracle call may hold


def _by_kv_head(fn, q_like, kv_like):
    """``fn(*q_like, *kv_like)`` over as many kv heads (with their q heads) at
    a time as keep one call's fp32 scores under SCORES_BUDGET: q_like are
    tensors [B, Hq, Sq, ...], kv_like [B, Hkv, Skv, ...], and each output is
    concatenated along dimension 1 (q heads or kv heads). The same function;
    at T=8192 the plain versions' and the oracle's [Sq, Skv] intermediates
    of all 32 heads at once would not fit beside the rest."""
    import torch

    batch, hq, q_len = q_like[0].shape[:3]
    hkv, kv_len = kv_like[0].shape[1], kv_like[0].shape[2]
    group = hq // hkv
    step = max(1, SCORES_BUDGET // (4 * batch * group * q_len * kv_len))
    if step >= hkv:
        return fn(*q_like, *kv_like)
    parts = [fn(*(x[:, h * group:(h + step) * group] for x in q_like), *(x[:, h:h + step] for x in kv_like))
             for h in range(0, hkv, step)]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=1)
    return tuple(torch.cat(group_parts, dim=1) for group_parts in zip(*parts))


def _hold(what: str, out, plain, oracle, lse=None, p_lse=None, o_lse=None, *, dtype: str = "bfloat16"):
    """Row by row within REL_BAR of plain and oracle, within ORACLE_BAR of
    the oracle, the LSE within LSE_BAR of both; returns (|out - plain|,
    row-relative, |lse|)."""
    d_plain, d_oracle = _max_diff(out, plain), _max_diff(out, oracle)
    d_rel = max(_rel_diff(out, plain), _rel_diff(out, oracle))
    d_lse = 0.0 if lse is None else max(_max_diff(lse, p_lse), _max_diff(lse, o_lse))
    if not (d_oracle < ORACLE_BAR and d_rel < REL_BAR[dtype] and d_lse < LSE_BAR):
        raise RuntimeError(f"{what} disagrees: |out-oracle| {d_oracle:.3e} (bar {ORACLE_BAR}), row-relative "
                           f"{d_rel:.3e} (bar {REL_BAR[dtype]}), |lse| {d_lse:.3e} (bar {LSE_BAR})")
    return d_plain, d_rel, d_lse


def _k1_masked(card: str, what: str, q, k, v, *, window=None, softcap=None, segment_ids=None, lib_mask=None,
               want="K1") -> dict:
    """K1 (or K2, or K1d with segment ids) with a window, softcap and / or
    segment ids, causal, end-aligned, with its LSE, twice on the same
    inputs (bit-identical): against
    flash_attention_plain and the fp32 oracle with the same masks (a few kv
    heads at a time at long sequences, ``_by_kv_head``); kernel, plain,
    library and bound times."""
    import torch
    import torch.nn.functional as F

    from flash_attention_tpu_torch.ops.common import segment_pair
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from flash_attention_tpu_torch.ops.reference import reference_attention_with_lse

    scale = q.shape[-1] ** -0.5
    kw = dict(causal=True, sliding_window=window, logit_softcap=softcap, segment_ids=segment_ids)
    segments = segment_pair(segment_ids, q.shape[0], q.shape[2], k.shape[2])
    zero_counts()
    out, lse = flash_attention(q, k, v, save_residuals=True, **kw)
    torch.cuda.synchronize()
    check_launches(f"[masked] {what}", read_counts(), (want,))
    _same_twice(f"[masked] {want} {what}", lambda: flash_attention(q, k, v, save_residuals=True, **kw))

    def plain():
        return _by_kv_head(lambda qh, kh, vh: flash_attention_plain(
            qh, kh, vh, sm_scale=scale, save_residuals=True, causal=True, sliding_window=window,
            logit_softcap=softcap, segments=segments), (q,), (k, v))

    p_out, p_lse = plain()
    o_out, o_lse = _by_kv_head(lambda qh, kh, vh: reference_attention_with_lse(qh, kh, vh, **kw), (q,), (k, v))
    d_plain, d_rel, d_lse = _hold(f"{want} {what}", out, p_out, o_out, lse, p_lse, o_lse)
    del p_out, p_lse, o_out, o_lse
    ms = cuda_ms(lambda: flash_attention(q, k, v, save_residuals=True, **kw))
    plain_ms = cuda_ms(plain, warmup=2, iters=5)
    lib_ms = None
    if lib_mask is not None:
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask, enable_gqa=True))
    b, hq, q_len, d = q.shape
    hkv, kv_len = k.shape[1], k.shape[2]
    pairs = _visible_pairs(q_len, kv_len, window, segments)
    first = 0 if window is None else max(0, kv_len - q_len - window + 1)
    nbytes = 2 * 2 * q.numel() + 4 * lse.numel() + 2 * 2 * b * hkv * (kv_len - first) * d
    bound_ms, bound_by = bound(4 * d * hq * b * pairs, nbytes)
    log(
        f"[masked] {want} {what}: |out-plain| {d_plain:.3e}, row-relative vs plain and oracle {d_rel:.3e} (bar "
        f"{REL_BAR['bfloat16']}), |lse| {d_lse:.3e} (bar {LSE_BAR}), bit-identical over two calls; kernel {ms:.4f} ms "
        f"({_rates(4 * d * hq * b * pairs, ms)}), plain {plain_ms:.4f} ms, library "
        + ("none" if lib_ms is None else f"{lib_ms:.4f} ms (SDPA, boolean band mask)")
        + f", bound {bound_ms:.4f} ms by {bound_by} ({pairs} visible pairs a head) ({card})"
    )
    return {"max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _k6_masked(card: str, what: str, q, k, v, lengths, *, ring: bool, sinks: int = 0, window=WINDOW,
               softcap=None, want="K6") -> dict:
    """K6 (K6q for a QuantizedTensor cache) with a window over a dense or
    ring cache, with or without sinks: against decode_attention_plain and
    the oracle over the rows holding the visible positions."""
    import torch
    import torch.nn.functional as F

    from flash_attention_tpu_torch.ops.decode import decode_attention, decode_attention_plain
    from flash_attention_tpu_torch.ops.quant import QuantizedTensor, dequantize

    quant = isinstance(k, QuantizedTensor)
    kd, vd = (dequantize(x) if quant else x for x in (k, v))
    rows = kd.shape[2]
    kw = dict(sliding_window=window, logit_softcap=softcap, ring_buffer=ring, attention_sinks=sinks)
    zero_counts()
    (out, lse), grid = _twice(f"{want} {what}", decode_attention,
                              lambda: decode_attention(q, k, v, lengths, save_residuals=True, **kw))
    torch.cuda.synchronize()
    check_launches(f"[masked] {want} {what}", read_counts(), (want,))
    p_out, p_lse = decode_attention_plain(q, k, v, lengths, sm_scale=q.shape[-1] ** -0.5, save_residuals=True, **kw)
    row_of = (lambda p: _ring_row(p, rows, sinks)) if ring else (lambda p: p)
    seen = [[row_of(p) for p in _visible_positions(n, window, sinks)] for n in lengths.tolist()]
    o_out, o_lse, mask = _oracle_rows(q, kd, vd, seen, softcap=softcap)
    d_plain, d_rel, d_lse = _hold(f"{want} {what}", out, p_out, o_out, lse, p_lse, o_lse)
    empty = lengths == 0
    if not (bool((out[empty] == 0).all()) and bool(torch.isneginf(lse[empty]).all())):
        raise RuntimeError(f"{want} {what}: a sequence of length 0 must give output 0 and LSE -inf")
    ms = cuda_ms(lambda: decode_attention(q, k, v, lengths, save_residuals=True, **kw))
    plain_ms = cuda_ms(lambda: decode_attention_plain(q, k, v, lengths, sm_scale=q.shape[-1] ** -0.5,
                                                      save_residuals=True, **kw))
    lib_ms = None
    if not quant and softcap is None:
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kd, vd, attn_mask=mask[:, None, None],
                                                                enable_gqa=True))
    batch, hq, d = q.shape
    hkv = kd.shape[1]
    n_rows = sum(len(r) for r in seen)
    row_bytes = d * (k.values.element_size() if quant else 2) + (4 if quant else 0)
    nbytes = 2 * n_rows * hkv * row_bytes + 2 * 2 * q.numel() + 4 * (lse.numel() + batch)
    bound_ms, bound_by = bound(4 * d * hq * n_rows, nbytes)
    log(
        f"[masked] {want} {what}, lengths {lengths.tolist()}, {grid}, bit-identical over two calls: |out-plain| "
        f"{d_plain:.3e}, row-relative "
        f"{d_rel:.3e} (bar {REL_BAR['bfloat16']}), |lse| {d_lse:.3e} (bar {LSE_BAR}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library " + ("none" if lib_ms is None else f"{lib_ms:.4f} ms (SDPA, boolean mask)")
        + f", bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB) ({card})"
    )
    return {"max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _ring_table(rng, num_slots: int, pages_per_slot: int, n_ring: int, *, sinks: bool):
    """The paged ring's table over a shuffled pool: slot b owns n_ring pages
    (one more, pinned as logical page 0, with sinks) and maps logical page
    lp onto them modulo their count, as PagedServingEngine does; returns
    the table and the pool's page count (page 0 the dump page)."""
    import numpy as np

    owned = n_ring + (1 if sinks else 0)
    perm = rng.permutation(np.arange(1, 1 + num_slots * owned)).reshape(num_slots, owned)
    table = np.zeros((num_slots, pages_per_slot), np.int32)
    for b in range(num_slots):
        if sinks:
            table[b, 0] = perm[b, 0]
            table[b, 1:] = [perm[b, 1 + (lp - 1) % n_ring] for lp in range(1, pages_per_slot)]
        else:
            table[b] = [perm[b, lp % n_ring] for lp in range(pages_per_slot)]
    return table, 1 + num_slots * owned


def phase_masked_kernels(card: str) -> dict:
    """Phase 15: the masked kernels at the masked serving path's shapes in
    bf16, each against its plain version (row-relative, REL_BAR), the fp32
    oracle with the same masks (ORACLE_BAR) and its LSE (LSE_BAR). Returns
    the report entries."""
    return {**masked_k1_cases(card), **masked_k6_cases(card), **masked_paged_cases(card)}


def masked_k1_cases(card: str) -> dict:
    """K1 with window 4096 and with softcap 50; K2 beside K1 at the JAX
    band's window."""
    import torch

    from flash_attention_tpu_torch.utils.testing import make_qkv

    bf16, dev = torch.bfloat16, torch.device("cuda")
    report = {}
    # K1, window 4096: a 256-row chunk end-aligned at kv 9216.
    q, k, v = make_qkv(15, 1, 32, 256, 128, num_kv_heads=8, kv_seq=9216, dtype=bf16, device=dev)
    col, row = torch.arange(9216, device=dev)[None, :], torch.arange(256, device=dev)[:, None] + 8960
    band = (col <= row) & (col > row - WINDOW)
    report["K1w"] = _k1_masked(card, "window 4096, q [1,32,256,128] kv [1,8,9216,128]", q, k, v, window=WINDOW,
                               lib_mask=band)
    # K1, softcap 50 at phase 3's shape; q scaled up so the scores reach the cap.
    q, k, v = make_qkv(16, 1, 32, 256, 128, num_kv_heads=8, kv_seq=2048, dtype=bf16, device=dev)
    q = (q.float() * 256).to(bf16)
    report["K1c"] = _k1_masked(card, "softcap 50, q [1,32,256,128] x 256, kv [1,8,2048,128]", q, k, v, softcap=50.0)
    # K2: window 64 (the port's kv tile) against window 128 (the JAX band's block, K1).
    q, k, v = make_qkv(17, 1, 32, 2048, 128, num_kv_heads=32, dtype=bf16, device=dev)
    for window, want in ((128, "K1"), (64, "K2")):
        col, row = torch.arange(2048, device=dev)[None, :], torch.arange(2048, device=dev)[:, None]
        entry = _k1_masked(card, f"window {window}, q, kv [1,32,2048,128]", q, k, v, window=window,
                           lib_mask=(col <= row) & (col > row - window), want=want)
        if want == "K2":
            report["K2"] = entry
    return report


def masked_k6_cases(card: str) -> dict:
    """K6 over a dense window, the ring and the ring with sinks; K6q int8 on
    the ring."""
    import torch

    from flash_attention_tpu_torch.ops.quant import payload_dtype, quantize_values

    bf16, dev = torch.bfloat16, torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    report = {}
    # K6: a dense window over 9216 rows, the ring of 4352 rows and the ring
    # with 4 sinks in front (4480 rows), lengths past the ring's rows.
    q = torch_uniform((8, 32, 128), bf16, gen)
    k, v = torch_uniform((8, 8, 9216, 128), bf16, gen), torch_uniform((8, 8, 9216, 128), bf16, gen)
    lengths = torch.tensor(DENSE_LENGTHS, dtype=torch.int32, device=dev)
    _k6_masked(card, "dense window 4096, cache [8,8,9216,128]", q, k, v, lengths, ring=False)
    lengths = torch.tensor(RING_LENGTHS, dtype=torch.int32, device=dev)
    ring_k, ring_v = k[:, :, :RING_ROWS].contiguous(), v[:, :, :RING_ROWS].contiguous()
    report["K6r"] = _k6_masked(card, f"ring of {RING_ROWS} rows, window 4096", q, ring_k, ring_v, lengths, ring=True)
    rows = RING_ROWS + 128
    _k6_masked(card, f"ring of {rows} rows with {SINKS} sinks, window 4096", q, k[:, :, :rows].contiguous(),
               v[:, :, :rows].contiguous(), lengths, ring=True, sinks=SINKS)
    _k6_masked(card, f"ring of {RING_ROWS} rows, window 4096, softcap 50", q, ring_k, ring_v, lengths, ring=True,
               softcap=50.0)
    kx, vx = scaled_rows((8, 8, RING_ROWS, 128), gen), scaled_rows((8, 8, RING_ROWS, 128), gen)
    kq, vq = quantize_values(kx, payload_dtype("int8")), quantize_values(vx, payload_dtype("int8"))
    _k6_masked(card, f"int8 ring of {RING_ROWS} rows, window 4096", q, kq, vq, lengths, ring=True, want="K6q")
    return report


def masked_paged_cases(card: str) -> dict:
    """K7 and K8 with window 4096 and 4 sinks over a shuffled paged ring."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.ops.paged import (
        paged_decode_attention,
        paged_decode_attention_plain,
        paged_prefill_attention,
        paged_prefill_attention_plain,
    )

    bf16, dev = torch.bfloat16, torch.device("cuda")
    rng = np.random.default_rng(15)
    gen = torch.Generator(device=dev).manual_seed(16)
    q = torch_uniform((8, 32, 128), bf16, gen)
    report = {}
    # K7 and K8 over the paged ring with 4 sinks: 8 slots of 72 logical pages
    # over 36 + 1 physical pages each, shuffled; rolled-out logical pages
    # alias live ones.
    page, per_slot = 128, 72
    n_ring = -(-(WINDOW + 256) // page) + 2
    table, num_pages = _ring_table(rng, 8, per_slot, n_ring, sinks=True)
    cache = _filled_cache(1, num_pages=num_pages, num_slots=8, pages_per_slot=per_slot, kv_heads=8, head_dim=128,
                          dtype=bf16, gen=gen).layers()[0]
    table = torch.from_numpy(table).to(dev)
    cache.page_table.copy_(table)
    lengths = torch.tensor(DENSE_LENGTHS, dtype=torch.int32, device=dev)
    cache = cache._replace(lengths=lengths)
    k_log, v_log = _dense_from_pages(cache.k_pages, table), _dense_from_pages(cache.v_pages, table)
    kw = dict(sliding_window=WINDOW, attention_sinks=SINKS)
    zero_counts()
    (out, lse), grid = _twice("K7 paged ring", paged_decode_attention,
                              lambda: paged_decode_attention(q, cache, save_residuals=True, **kw))
    torch.cuda.synchronize()
    check_launches("[masked] K7", read_counts(), ("K7",))
    p_out, p_lse = paged_decode_attention_plain(q, cache, sm_scale=128**-0.5, save_residuals=True, **kw)
    seen = [_visible_positions(n, WINDOW, SINKS) for n in DENSE_LENGTHS]
    o_out, o_lse, _ = _oracle_rows(q, k_log, v_log, seen)
    d_plain, d_rel, d_lse = _hold("K7 paged ring, window 4096, 4 sinks", out, p_out, o_out, lse, p_lse, o_lse)
    ms = cuda_ms(lambda: paged_decode_attention(q, cache, save_residuals=True, **kw))
    plain_ms = cuda_ms(lambda: paged_decode_attention_plain(q, cache, sm_scale=128**-0.5, save_residuals=True, **kw))
    n_rows = sum(len(r) for r in seen)
    nbytes = 2 * n_rows * 8 * 128 * 2 + 2 * 2 * q.numel() + 4 * (lse.numel() + 8 + 8 * 36)
    bound_ms, bound_by = bound(4 * 128 * 32 * n_rows, nbytes)
    log(
        f"[masked] K7 q [8,32,128] over the paged ring ({n_ring} + 1 pinned pages a slot of 128 rows, table [8,{per_slot}] "
        f"shuffled), window 4096, {SINKS} sinks, lengths {list(DENSE_LENGTHS)}, {grid}, bit-identical over two "
        f"calls: |out-plain| {d_plain:.3e}, row-relative "
        f"{d_rel:.3e}, |lse| {d_lse:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library none, bound "
        f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB) ({card})"
    )
    report["K7s"] = {"max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                     "bound_ms": bound_ms, "bound_by": bound_by}
    slot, kv_end = 6, 9000
    qc = torch_uniform((1, 32, 256, 128), bf16, gen)
    zero_counts()
    out = paged_prefill_attention(qc, cache, slot, kv_end, chunk_len=256, **kw)
    torch.cuda.synchronize()
    check_launches("[masked] K8", read_counts(), ("K8",))
    p_out = paged_prefill_attention_plain(qc, cache, slot, kv_end, sm_scale=128**-0.5, **kw)
    col = torch.arange(kv_end, device=dev)[None, :]
    row = torch.arange(256, device=dev)[:, None] + kv_end - 256
    mask = (col <= row) & ((col > row - WINDOW) | (col < SINKS))
    o_out, _ = _oracle_mask(qc, k_log[slot:slot + 1, :, :kv_end], v_log[slot:slot + 1, :, :kv_end], mask,
                            sm_scale=128**-0.5)
    d_plain, d_rel, _ = _hold("K8 paged ring, window 4096, 4 sinks", out, p_out, o_out)
    ms = cuda_ms(lambda: paged_prefill_attention(qc, cache, slot, kv_end, chunk_len=256, **kw))
    plain_ms = cuda_ms(lambda: paged_prefill_attention_plain(qc, cache, slot, kv_end, sm_scale=128**-0.5, **kw),
                       warmup=2, iters=5)
    pairs = int(mask.sum())
    kv_rows = kv_end - (kv_end - 256 - WINDOW + 1) + SINKS
    nbytes = 2 * 2 * qc.numel() + 2 * 2 * kv_rows * 8 * 128 + 4 * (kv_rows // page + 2)
    bound_ms, bound_by = bound(4 * 128 * 32 * pairs, nbytes)
    log(
        f"[masked] K8 q [1,32,256,128] over slot {slot}'s paged ring to kv_end {kv_end}, window 4096, {SINKS} sinks: "
        f"|out-plain| {d_plain:.3e}, row-relative {d_rel:.3e}; kernel {ms:.4f} ms "
        f"({4 * 128 * 32 * pairs / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, library none, bound "
        f"{bound_ms:.4f} ms by {bound_by} ({card})"
    )
    report["K8s"] = {"max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                     "bound_ms": bound_ms, "bound_by": bound_by}
    del cache, k_log, v_log
    torch.cuda.empty_cache()
    return report


def phase_masked_sweep() -> None:
    """Every (dtype, head_dim) instantiation of the masked bodies at ragged
    shapes and windows 1, 63, 64, 65 and 1000: K1 / K2 (q 100 end-aligned
    over kv 1100, GQA 2; a softcap on window 65), K6 over a dense window and
    over a ring (with 3 sinks at the odd windows), K7 and K8 over a paged
    ring of 64-row pages with 3 sinks."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.ops.decode import decode_attention, decode_attention_plain
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from flash_attention_tpu_torch.ops.paged import (
        paged_decode_attention,
        paged_decode_attention_plain,
        paged_prefill_attention,
        paged_prefill_attention_plain,
    )
    from flash_attention_tpu_torch.ops.reference import reference_attention_with_lse
    from flash_attention_tpu_torch.utils.testing import make_qkv

    rng = np.random.default_rng(16)
    gen = torch.Generator(device="cuda").manual_seed(16)
    worst, n = 0.0, 0
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for d in (32, 64, 128):
            q, k, v = make_qkv(n, 2, 4, 100, d, num_kv_heads=2, kv_seq=1100, dtype=dtype, device="cuda")
            q = (q.float() * 4).to(dtype)
            qd = q[:, :, -1].contiguous()
            lengths = torch.tensor([37, 1100], dtype=torch.int32, device="cuda")
            page_rows = 64
            table, num_pages = _ring_table(rng, 2, 1152 // page_rows, 6, sinks=True)
            cache = _filled_cache(1, num_pages=num_pages, num_slots=2, pages_per_slot=1152 // page_rows, kv_heads=2,
                                  head_dim=d, dtype=dtype, gen=gen, page_size=page_rows).layers()[0]
            cache.page_table.copy_(torch.from_numpy(table).cuda())
            cache = cache._replace(lengths=lengths)
            k_log, v_log = (_dense_from_pages(x, cache.page_table) for x in (cache.k_pages, cache.v_pages))
            for window in SWEEP_WINDOWS:
                what = f"{name} d={d} window {window}"
                softcap = BITE_CAP if window == 65 else None
                kw = dict(causal=True, sliding_window=window, logit_softcap=softcap)
                out, lse = flash_attention(q, k, v, save_residuals=True, **kw)
                p_out, p_lse = flash_attention_plain(q, k, v, sm_scale=d**-0.5, save_residuals=True, **kw)
                o_out, o_lse = reference_attention_with_lse(q, k, v, **kw)
                worst = max(worst, _hold(f"K1/K2 {what}", out, p_out, o_out, lse, p_lse, o_lse, dtype=name)[1] / REL_BAR[name])
                # K6: the dense window, then a ring holding the window (256
                # rows; 128 + 256 with 3 sinks at the odd windows).
                cases = [(k, v, False, 0)]
                if window <= 256:
                    sinks = 3 if window % 2 else 0
                    rows = 256 + (128 if sinks else 0)
                    cases.append((k[:, :, :rows].contiguous(), v[:, :, :rows].contiguous(), True, sinks))
                for kc, vc, ring, sinks in cases:
                    dkw = dict(sliding_window=window, logit_softcap=softcap, ring_buffer=ring, attention_sinks=sinks)
                    out, lse = decode_attention(qd, kc, vc, lengths, save_residuals=True, **dkw)
                    p_out, p_lse = decode_attention_plain(qd, kc, vc, lengths, sm_scale=d**-0.5, save_residuals=True, **dkw)
                    row_of = (lambda p, r=kc.shape[2], s=sinks: _ring_row(p, r, s)) if ring else (lambda p: p)
                    seen = [[row_of(p) for p in _visible_positions(L, window, sinks)] for L in lengths.tolist()]
                    o_out, o_lse, _ = _oracle_rows(qd, kc, vc, seen, softcap=softcap)
                    worst = max(worst, _hold(f"K6 {what} ring={ring} sinks={sinks}", out, p_out, o_out, lse, p_lse,
                                             o_lse, dtype=name)[1] / REL_BAR[name])
                # K7 and K8 over the paged ring with 3 sinks.
                pkw = dict(sliding_window=window, logit_softcap=softcap, attention_sinks=3)
                out, lse = paged_decode_attention(qd, cache, save_residuals=True, **pkw)
                p_out, p_lse = paged_decode_attention_plain(qd, cache, sm_scale=d**-0.5, save_residuals=True, **pkw)
                seen = [_visible_positions(L, window, 3) for L in lengths.tolist()]
                o_out, o_lse, _ = _oracle_rows(qd, k_log, v_log, seen, softcap=softcap)
                worst = max(worst, _hold(f"K7 {what}", out, p_out, o_out, lse, p_lse, o_lse, dtype=name)[1] / REL_BAR[name])
                qc = q[1:, :, :64].contiguous()
                out = paged_prefill_attention(qc, cache, 1, 1000, chunk_len=64, **pkw)
                p_out = paged_prefill_attention_plain(qc, cache, 1, 1000, sm_scale=d**-0.5, **pkw)
                col, row = torch.arange(1000, device="cuda")[None, :], torch.arange(64, device="cuda")[:, None] + 936
                mask = (col <= row) & ((col > row - window) | (col < 3))
                o_out, _ = _oracle_mask(qc, k_log[1:, :, :1000], v_log[1:, :, :1000], mask, sm_scale=d**-0.5,
                                        softcap=softcap)
                worst = max(worst, _hold(f"K8 {what}", out, p_out, o_out, dtype=name)[1] / REL_BAR[name])
            n += 1
    torch.cuda.synchronize()
    log(
        f"[masked sweep] K1/K2, K6 (dense window, ring, ring + 3 sinks), K7 and K8 (paged ring, 3 sinks) at "
        f"fp32/fp16/bf16 x head_dim 32/64/128 x windows {list(SWEEP_WINDOWS)} (softcap 5 at 65), ragged lengths: all "
        f"within {ORACLE_BAR} of the masked oracle, LSE within {LSE_BAR}; worst row-relative difference at {worst:.3f} "
        f"of its bar {REL_BAR}"
    )


TINY_MASKED = {  # phase 16: (label, engine, ModelConfig fields, the kernels the card run launches)
    "dense window 96": ("dense", dict(sliding_window=96), ("K1", "K6")),
    "dense window 48": ("dense", dict(sliding_window=48), ("K2", "K6")),
    "rolling": ("dense", dict(sliding_window=96, rolling=True), ("K1", "K6")),
    "rolling + sinks 32": ("dense", dict(sliding_window=96, rolling=True, attention_sinks=32), ("K1", "K6")),
    "softcap 30": ("dense", dict(logit_softcap=30.0), ("K1", "K6")),
    "paged ring": ("paged", dict(sliding_window=96), ("K7", "K8", "K9/K10")),
    "paged + sinks 32": ("paged", dict(sliding_window=96, attention_sinks=32), ("K7", "K8", "K9/K10")),
}
# Phase 16's pairs that must give the same tokens (the JAX package's
# tests/test_rolling.py:334-444): the ring changes memory, not numbers.
TINY_MASKED_EQUAL = (("rolling", "dense window 96"), ("paged ring", "dense window 96"),
                     ("paged + sinks 32", "rolling + sinks 32"))


SPLIT_WINDOW = 1000  # the split-edge sweep's window: spans of about four 256-row splits


def _split_edges(walk_rows: int, unit: int, splits: int, lo: int = 0) -> list[int]:
    """Lengths at the edges of the kv split over live rows [lo, walk_rows):
    each split boundary and each unit edge of the first split, minus one,
    at and plus one."""
    units = -(-(walk_rows - lo) // unit)
    per = -(-units // splits)
    edges = {lo + k * per * unit for k in range(1, splits + 1)} | {lo + k * unit for k in range(1, per + 1)}
    return sorted({e + i for e in edges for i in (-1, 0, 1)})


def phase_split_sweep() -> None:
    """Phase 15, last: K6, K6q, K7 and K7q across the edges of the kv split,
    for every (query dtype, payload, head_dim): GQA groups 1, 4 and 16 (4,
    2 and 1 kv heads), batch 1 (the most splits) and 32, lengths 0, 1 and
    each split and unit edge -1 / 0 / +1, over the dense window, the ring,
    the ring with 3 sinks and the paged ring (3 sinks) of 64- and 128-row
    pages; each held against plain (row-relative, REL_BAR), the fp32 oracle
    (ORACLE_BAR) and its LSE (LSE_BAR), bit-identical over two calls."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.ops.decode import decode_attention, decode_attention_plain
    from flash_attention_tpu_torch.ops.paged import (
        PagedKVCache,
        init_paged_model_cache,
        paged_decode_attention,
        paged_decode_attention_plain,
    )
    from flash_attention_tpu_torch.ops.quant import bits, dequantize, payload_dtype, quantize_values

    t0 = time.perf_counter()
    rng = np.random.default_rng(21)
    gen = torch.Generator(device="cuda").manual_seed(21)
    w = SPLIT_WINDOW
    kinds = ("dense window", "ring", "ring + 3 sinks", "paged ring, 64-row pages", "paged ring, 128-row pages")
    groups = ((1, 4), (4, 2), (16, 1))  # (GQA group, kv heads)
    worst, n, splits_seen = 0.0, 0, set()
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for mode in (None, *QUANT_MODES):
            for d in (32, 64, 128):
                for batch in (32, 1):
                    i = n
                    n += 1
                    kind = kinds[i % len(kinds)]
                    group, hkv = groups[i % len(groups)]
                    what = f"{kind}, {name} q, {mode or name} cache, d={d}, group {group}, batch {batch}"
                    q = (torch_uniform((batch, group * hkv, d), torch.float32, gen) * 4).to(dtype)

                    def rows_of(shape):
                        x = scaled_rows(shape, gen) if mode else torch_uniform(shape, dtype, gen)
                        return quantize_values(x, payload_dtype(mode)) if mode else x

                    if kind.startswith("paged"):
                        page = 64 if "64" in kind else 128
                        per_slot, n_ring = 2048 // page, -(-(w + page) // page) + 2
                        table, num_pages = _ring_table(rng, batch, per_slot, n_ring, sinks=True)
                        pool = init_paged_model_cache(1, num_pages=num_pages, num_slots=batch, pages_per_slot=per_slot,
                                                      kv_heads=hkv, page_size=page, head_dim=d, dtype=dtype,
                                                      kv_quant=mode or "none", device="cuda")
                        for dst, scales in ((pool.k_pool, pool.k_scales), (pool.v_pool, pool.v_scales)):
                            x = rows_of(tuple(dst.shape))
                            bits(dst).copy_(bits(x.values if mode else x))
                            if mode:
                                scales.copy_(x.scales[..., 0])
                        pool.page_table.copy_(torch.from_numpy(table).cuda())
                        edges = _split_edges(per_slot * page, page, 4, 0)
                        cap = per_slot * page
                    else:
                        ring, sinks = kind != "dense window", 3 if "sinks" in kind else 0
                        rows = 1500 if not ring else 1152 + (128 if sinks else 0)
                        kc, vc = rows_of((batch, hkv, rows, d)), rows_of((batch, hkv, rows, d))
                        edges = _split_edges(rows, 64, 4, 128 if sinks else 0) + [rows + 1, w - 1, w, w + 1]
                        cap = rows if not ring else 3 * rows
                    lengths = sorted({0, 1, *(e for e in edges if 0 <= e <= cap)})
                    lengths = lengths[:batch] + [cap] * (batch - len(lengths)) if batch > 1 else [lengths[i % len(lengths)]]
                    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
                    if kind.startswith("paged"):
                        layer = pool._replace(lengths=lengths).layers()[0]
                        kw = dict(sliding_window=w, attention_sinks=3)
                        call = lambda: paged_decode_attention(q, layer, save_residuals=True, **kw)  # noqa: E731
                        (out, lse), _ = _twice(f"K7 {what}", paged_decode_attention, call)
                        grid = paged_decode_attention.last_grid
                        p_out, p_lse = paged_decode_attention_plain(q, layer, sm_scale=d**-0.5, save_residuals=True, **kw)
                        kd, vd = ((_dequant_pool(x, sc) if mode else x) for x, sc in
                                  ((layer.k_pages, layer.k_scales), (layer.v_pages, layer.v_scales)))
                        kd, vd = (_dense_from_pages(x, layer.page_table) for x in (kd, vd))
                        seen = [_visible_positions(L, w, 3) for L in lengths.tolist()]
                    else:
                        kw = dict(sliding_window=w, ring_buffer=ring, attention_sinks=sinks)
                        call = lambda: decode_attention(q, kc, vc, lengths, save_residuals=True, **kw)  # noqa: E731
                        (out, lse), _ = _twice(f"K6 {what}", decode_attention, call)
                        grid = decode_attention.last_grid
                        p_out, p_lse = decode_attention_plain(q, kc, vc, lengths, sm_scale=d**-0.5, save_residuals=True,
                                                              **kw)
                        kd, vd = (dequantize(x) if mode else x for x in (kc, vc))
                        row_of = (lambda p: _ring_row(p, rows, sinks)) if ring else (lambda p: p)  # noqa: E731
                        seen = [[row_of(p) for p in _visible_positions(L, w, sinks)] for L in lengths.tolist()]
                    o_out, o_lse, _ = _oracle_rows(q, kd, vd, seen)
                    worst = max(worst, _hold(f"split sweep {what}", out, p_out, o_out, lse, p_lse, o_lse,
                                             dtype=name)[1] / REL_BAR[name])
                    splits_seen.add(grid[0])
    torch.cuda.synchronize()
    if max(splits_seen) < 2:
        raise RuntimeError(f"split sweep: no case split the kv rows ({splits_seen})")
    log(
        f"[split sweep] K6 / K6q (dense window {w} over 1500 rows, ring of 1152, ring + 3 sinks) and K7 / K7q (paged "
        f"ring, 3 sinks, pages of 64 and 128) at fp32/fp16/bf16 queries x bf16-or-own/int8/e4m3/e5m2 caches x "
        f"head_dim 32/64/128 x batch 32 and 1, groups 1/4/16, lengths 0, 1 and the split edges +-1: {n} cases, kv "
        f"splits {sorted(splits_seen)}, each bit-identical over two calls, within {ORACLE_BAR} of the oracle, LSE "
        f"within {LSE_BAR}, worst row-relative difference at {worst:.3f} of its bar {REL_BAR}; "
        f"{time.perf_counter() - t0:.1f} s"
    )


def phase_tiny_masked() -> int:
    """Phase 16: the tiny fp32 model with each mask through its engine on
    the card and on the CPU, greedy tokens identical; prompts of 700, 150
    and 40 tokens, so windows and rings roll. Returns K2's launches in the
    window-48 run."""
    import dataclasses

    import numpy as np
    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params
    from flash_attention_tpu_torch.serving.engine import Request, ServingEngine
    from flash_attention_tpu_torch.serving.paged_engine import PagedServingEngine

    rng = np.random.default_rng(16)
    reqs = [Request(id=i, prompt=tuple(int(t) for t in rng.integers(0, TINY_CFG["vocab_size"], n)), max_new_tokens=m)
            for i, (n, m) in enumerate(((700, 24), (150, 24), (40, 16)))]
    base = ModelConfig(**TINY_CFG)
    params = init_model_params(torch.Generator().manual_seed(0), base)
    tokens, k2 = {}, 0
    for label, (kind, fields, used) in TINY_MASKED.items():
        cfg = dataclasses.replace(base, **fields)
        got = {}
        for device in ("cuda", "cpu"):
            on = _to_device(params, device)
            if kind == "dense":
                eng = ServingEngine(on, cfg, max_slots=2, max_seq=1024, prefill_chunk=64)
            else:
                eng = PagedServingEngine(on, cfg, max_slots=2, num_pages=16, pages_per_slot=8, page_size=128,
                                         prefill_chunk=128)
            zero_counts()
            got[device] = {rid: c.tokens for rid, c in eng.run(reqs).items()}
            if device == "cuda":
                launches = read_counts()
                check_launches(f"[tiny masked] {label}, on the card", launches, used)
                k2 += launches["K2"]
            if kind == "paged" and eng.alloc.free_count != 15:
                raise RuntimeError(f"[tiny masked] {label}: {eng.alloc.free_count} pages free after the run, want 15")
        if got["cuda"] != got["cpu"]:
            raise RuntimeError(f"[tiny masked] {label}: card tokens {got['cuda']} != CPU {got['cpu']}")
        if any(len(got["cuda"][r.id]) != r.max_new_tokens for r in reqs):
            raise RuntimeError(f"[tiny masked] {label}: completions of the wrong length")
        tokens[label] = got["cuda"]
        log(f"[tiny masked] {label} ({kind} engine): card tokens == CPU tokens; kernels {used}")
    for a, b in TINY_MASKED_EQUAL:
        if tokens[a] != tokens[b]:
            raise RuntimeError(f"[tiny masked] {a} tokens {tokens[a]} != {b} tokens {tokens[b]}")
    log("[tiny masked] rolling == dense window, paged ring == dense window, paged sinks == rolling sinks: "
        "tokens identical")
    return k2


LOGIT_BAR = 0.1  # phase 17: last-chunk logits, ring vs dense cache, row by row relative to the row's largest


def _serve_masked(card: str, label: str, eng, prompts, *, used, new_tokens: int = FULL_NEW_TOKENS) -> dict:
    """One served run of ``prompts`` (greedy, ``new_tokens`` each) on
    ``eng``, every launch count set to 0 just before and read just after; it
    must launch exactly ``used``. The prefill chunks are timed one by one
    (synchronised) and the logits of each request's last chunk are kept.
    Returns tokens, logits, launches and the run's numbers."""
    import torch

    from flash_attention_tpu_torch.serving.engine import Request

    chunk_s, last = [], {}
    inner = eng._prefill_chunk_step

    def step(params, tokens, caches, slot, start, kv_end):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = inner(params, tokens, caches, slot, start, kv_end)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
        st = eng._prefills[slot]
        if kv_end >= len(st.padded):
            last[st.req.id] = logits[0, : len(st.req.prompt) - start].cpu()
        return logits, caches

    eng._prefill_chunk_step = step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    done = eng.run([Request(id=i, prompt=p, max_new_tokens=new_tokens) for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = {rid: c.tokens for rid, c in done.items()}
    bad = [rid for rid, t in tokens.items() if len(t) != new_tokens]
    if bad or not all(bool(torch.isfinite(x).all()) for x in last.values()) or len(last) != len(prompts):
        raise RuntimeError(f"[{label}] requests {bad} without {new_tokens} tokens, or non-finite prefill logits")
    check_launches(f"[{label}] the main path", launches, used)
    n_prompt = sum(len(p) for p in prompts)
    numbers = {"prefill_tok_s": n_prompt / sum(chunk_s), "decode_tok_s": eng.decode_tokens / eng.decode_time_s,
               "peak_gib": peak / 2**30}
    log(
        f"[{label}] {len(prompts)} requests, {n_prompt} prompt tokens: prefill {numbers['prefill_tok_s']:.1f} tok/s "
        f"({len(chunk_s)} chunks in {sum(chunk_s):.3f} s, each synchronised), decode {eng.decode_tokens} tokens in "
        f"{eng.decode_time_s:.3f} s of decode section = {numbers['decode_tok_s']:.1f} tok/s, whole run {run_s:.3f} s; "
        f"peak device memory (max_memory_allocated) {numbers['peak_gib']:.2f} GiB; kernel launches {launches} ({card})"
    )
    return {"tokens": tokens, "last": last, "launches": launches, **numbers}


def phase_full_masked(card: str) -> dict:
    """Phase 17: ModelConfig(mlp_dim=14336, sliding_window=4096) (Mistral-7B
    v0.1's shape, tied embedding), bf16, weights from seed 0. (a) the
    rolling dense engine, (b) the same without the ring at max_seq 9216,
    (c) the paged ring with 4 sinks, each on run A's 8 requests; (d) a
    softcap of 50 on phase 5's requests. Returns each run's launches."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig, decode_step_logits, init_model_params
    from flash_attention_tpu_torch.serving.engine import ServingEngine
    from flash_attention_tpu_torch.serving.paged_engine import PagedServingEngine

    gc.collect()
    torch.cuda.empty_cache()
    cfg = ModelConfig(**MISTRAL)
    t0 = time.perf_counter()
    params = init_model_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _tensors(params))
    log(f"[full masked] ModelConfig(mlp_dim=14336, sliding_window=4096) bf16: {n_params / 1e9:.3f} B params "
        f"({_nbytes(params) / 1e9:.3f} GB) initialised on the card in {time.perf_counter() - t0:.1f} s ({card})")
    rng = np.random.default_rng(17)
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab_size, n)) for n in MASKED_PROMPT_LENS]
    runs = {}

    def cache_gb(eng) -> float:
        return _nbytes([(c.k, c.v, c.k_scales, c.v_scales) for c in eng.caches]) / 1e9

    # (a) the rolling dense engine: a ring of window + one chunk of rows.
    rolling = dataclasses.replace(cfg, rolling=True)
    eng = ServingEngine(params, rolling, max_slots=8, max_seq=16384, prefill_chunk=256)
    if eng.caches[0].k.shape[2] != RING_ROWS:
        raise RuntimeError(f"rolling cache of {eng.caches[0].k.shape[2]} rows, want {RING_ROWS}")
    log(f"[full masked a] ServingEngine(max_slots=8, max_seq=16384, prefill_chunk=256), rolling: {RING_ROWS} rows a "
        f"slot, KV cache {cache_gb(eng):.4f} GB ({card})")
    runs["a"] = _serve_masked(card, "full masked a", eng, prompts, used=("K1", "K6"))
    step_logits, _ = decode_step_logits(params, rolling, torch.zeros((8, 1), dtype=torch.int32, device="cuda"), eng.caches)
    if not bool(torch.isfinite(step_logits).all()):
        raise RuntimeError("[full masked a] non-finite decode logits over the ring")
    del eng, step_logits
    torch.cuda.empty_cache()

    # (b) the same model without the ring, at the 9216 positions run A needs.
    eng = ServingEngine(params, cfg, max_slots=8, max_seq=9216, prefill_chunk=256)
    log(f"[full masked b] ServingEngine(max_slots=8, max_seq=9216, prefill_chunk=256), no ring: KV cache "
        f"{cache_gb(eng):.4f} GB ({card})")
    runs["b"] = _serve_masked(card, "full masked b", eng, prompts, used=("K1", "K6"))
    del eng
    torch.cuda.empty_cache()
    worst = max(_rel_diff(runs["a"]["last"][i], runs["b"]["last"][i]) for i in range(len(prompts)))
    part = {len(prompts[i]): next((j for j, (x, y) in enumerate(zip(runs["a"]["tokens"][i], runs["b"]["tokens"][i]))
                                   if x != y), None) for i in range(len(prompts))}
    log(f"[full masked] ring vs no ring: last-chunk prefill logits row-relative {worst:.3e} (bar {LOGIT_BAR}); first "
        f"differing greedy token by prompt length {part} (None: all {FULL_NEW_TOKENS} equal; bf16 flips argmax ties)")
    if worst >= LOGIT_BAR:
        raise RuntimeError(f"[full masked] ring and dense logits differ by {worst:.3e} row-relative")

    # (c) the paged ring with StreamingLLM's 4 sinks.
    sinks = dataclasses.replace(cfg, attention_sinks=SINKS)
    eng = PagedServingEngine(params, sinks, max_slots=8, num_pages=297, pages_per_slot=72, page_size=128,
                             prefill_chunk=256)
    owned = []
    admit = eng._admit_one

    def admit_one(req, slot):
        ok = admit(req, slot)
        if ok:
            owned.append(len(eng.slot_pages[slot]))
        return ok

    eng._admit_one = admit_one
    pc = eng.caches
    pool_gb = _nbytes((pc.k_pool, pc.v_pool)) / 1e9
    runs["c"] = _serve_masked(card, "full masked c", eng, prompts, used=("K7", "K8", "K9/K10"))
    if max(owned) > 37 or eng.alloc.free_count != 296:
        raise RuntimeError(f"[full masked c] pages owned {owned} (at most 37), {eng.alloc.free_count} free after the run")
    log(f"[full masked c] PagedServingEngine(max_slots=8, num_pages=297, pages_per_slot=72, page_size=128, "
        f"prefill_chunk=256), attention_sinks=4: pool {pool_gb:.4f} GB, pages owned per slot {owned} (at most "
        f"37), all 296 back in the pool after the run ({card})")
    del eng, pc
    torch.cuda.empty_cache()

    # (d) a logit softcap of 50 on phase 5's requests.
    capped = dataclasses.replace(cfg, logit_softcap=50.0)
    rng5 = np.random.default_rng(0)  # phase 5's prompts
    prompts5 = [tuple(int(t) for t in rng5.integers(0, cfg.vocab_size, n)) for n in FULL_PROMPT_LENS]
    eng = ServingEngine(params, capped, max_slots=8, max_seq=2048, prefill_chunk=256)
    runs["d"] = _serve_masked(card, "full masked d", eng, prompts5, used=("K1", "K6"))
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return {key: run["launches"] for key, run in runs.items()}


# Masked training (phases 18-20): Mistral-7B's window at twice its length,
# so the window masks half the rows, and one packed row of four documents.
TRAIN_T = 8192
PACKED_DOCS = (5000, 1800, 900, 492)  # one packed 8192-token row
CAP = 50.0  # Gemma-2's attention logit cap
# A cap the kernel cases can see: make_qkv's scaled scores have a standard
# deviation of 1/12, so with q scaled x32 they reach |s| / cap of about 0.5
# and 1 - tanh^2 spans most of (0, 1]. (At cap 50 they would need scores of
# about 50, whose bf16 gradients would outgrow the oracle's absolute bar.)
BITE_CAP, BITE_Q = 5.0, 32


def _packed_ids(docs, device="cuda"):
    """Segment ids [1, sum(docs)] int32: document i's tokens carry id i."""
    import torch

    return torch.cat([torch.full((n,), i, dtype=torch.int32) for i, n in enumerate(docs)])[None].to(device)


def masked_bwd_cases() -> None:
    """Phase 18's correctness cases in bf16 at small shapes: K4m + K5m (GQA
    8/2) and K3m (MHA 4/4) at windows 1, 63, 64 (K2's forward), 65, 1000 and
    4096; a softcap that bites (BITE_CAP with q scaled by BITE_Q); packed
    documents; a (q_ids, kv_ids) pair with kv_len > q_len; a q id absent
    from kv, whose gradient rows must be finite and exactly 0; all three
    masks together."""
    import torch

    bf16, d, bar = torch.bfloat16, 128, REL_BAR["bfloat16"]
    cases = []
    for hq, hkv in ((8, 2), (4, 4)):
        for window in SWEEP_WINDOWS:
            cases.append((f"{hq}/{hkv} heads, T 1024, window {window}", hq, hkv, 1024, 1024, dict(window=window)))
        cases.append((f"{hq}/{hkv} heads, T 4608, window 4096", hq, hkv, 4608, 4608, dict(window=WINDOW)))
        cases.append((f"{hq}/{hkv} heads, T 1024, softcap {BITE_CAP}, q x {BITE_Q}", hq, hkv, 1024, 1024,
                      dict(softcap=BITE_CAP)))
        cases.append((f"{hq}/{hkv} heads, T 1024, documents (500, 300, 150, 74)", hq, hkv, 1024, 1024,
                      dict(segment_ids=_packed_ids((500, 300, 150, 74)))))
        cases.append((f"{hq}/{hkv} heads, T 1024, window 300 + softcap {BITE_CAP}, q x {BITE_Q} + documents "
                      "(500, 300, 150, 74)", hq, hkv, 1024, 1024,
                      dict(window=300, softcap=BITE_CAP, segment_ids=_packed_ids((500, 300, 150, 74)))))
    kv_ids = _packed_ids((600, 424))
    cases.append(("8/2 heads, q 256 over kv 1024, (q_ids, kv_ids) pair", 8, 2, 256, 1024,
                  dict(segment_ids=(kv_ids[:, -256:].contiguous(), kv_ids))))
    absent = kv_ids[:, -256:].clone()
    absent[:, 100:140] = 7  # no kv row has id 7
    cases.append(("8/2 heads, q 256 over kv 1024, q rows 100-139 of an id absent from kv", 8, 2, 256, 1024,
                  dict(segment_ids=(absent, kv_ids), window=700)))
    for n, (what, hq, hkv, q_len, kv_len, masks) in enumerate(cases):
        q, k, v, do = _bwd_inputs(180 + n, hq, hkv, q_len, kv_len, d, bf16)
        if masks.get("softcap"):
            q = (q.float() * BITE_Q).to(bf16)
        grads, _, d_plain, d_rel, d_oracle = _hold_bwd(f"[masked backward] {what}", q, k, v, do, **masks,
                                                       rel_bar=bar)
        if "absent" in what:
            if not (bool(torch.isfinite(grads[0]).all()) and bool((grads[0][:, :, 100:140] == 0).all())):
                raise RuntimeError(f"[masked backward] {what}: the absent id's dq rows are not finite zeros")
        route = _route(hq, hkv, q_len, kv_len, **masks, dtype=bf16)
        log(f"[masked backward] {what}: {route}; |grad-oracle| {d_oracle:.3e} (bar {ORACLE_BAR}), |grad-plain| "
            f"{d_plain:.3e}, row-relative to plain {d_rel:.3e} (bar {bar})")
        del q, k, v, do, grads
    torch.cuda.empty_cache()


def _bwd_bound(name: str, d: int, hq: int, pairs: int, q, k) -> tuple[float, str]:
    """K3's, K4's or K5's bound from the visible pairs and its bytes (q, dO,
    k, v, lse and delta read once, its outputs written once)."""
    products = {"K3m": 5, "K4m": 3, "K5m": 4}
    q_bytes, kv_bytes = 2 * q.numel(), 2 * k.numel()
    in_bytes = 2 * q_bytes + 2 * kv_bytes + 2 * 4 * q.numel() // d
    outs = {"K3m": q_bytes + 2 * kv_bytes, "K4m": q_bytes, "K5m": 2 * kv_bytes}
    return bound(2 * d * pairs * hq * products[name], in_bytes + outs[name])


def _time_bwd(card: str, label: str, q, k, v, do, *, window=None, softcap=None, segment_ids=None,
              lib_mask=None) -> dict:
    """The masked backward kernels of one call's route at the main path's
    shape: held against plain and the oracle (``_by_kv_head``), then
    timed alone on the forward's residuals, beside the plain backward and
    SDPA's backward under the equivalent boolean mask (k and v repeated to
    the q heads outside the timed call, so SDPA takes its memory-efficient
    kernel). Returns report entries by kernel."""
    import torch
    import torch.nn.functional as F

    from flash_attention_tpu_torch.ops.attention_bwd import (
        BwdMasks,
        _delta,
        _guard_lse,
        flash_attention_bwd_plain,
        launch_dkv,
        launch_dq,
        launch_fused,
    )
    from flash_attention_tpu_torch.ops.common import segment_pair

    b, hq, q_len, d = q.shape
    hkv, kv_len = k.shape[1], k.shape[2]
    scale = d**-0.5
    _, (out, lse), d_plain, d_rel, d_oracle = _hold_bwd(
        f"[masked backward] {label}", q, k, v, do, window=window, softcap=softcap, segment_ids=segment_ids,
        rel_bar=REL_BAR["bfloat16"])
    segments = segment_pair(segment_ids, b, q_len, kv_len)
    masks = BwdMasks(window, softcap, segments, q.device)
    args = (q, k, v, do, _guard_lse(lse).contiguous(), _delta(out, do).contiguous())
    kw = dict(causal=True, sm_scale=scale, masks=masks)
    fns = {"K3m": launch_fused, "K4m": launch_dq, "K5m": launch_dkv}
    route = [name for name in _route(hq, hkv, q_len, kv_len, window, softcap, segment_ids) if name in fns]
    for name in route:
        # K3 adds dq in a run-dependent order; its dk and dv are written once.
        _same_twice(f"[masked backward] {label} {name}",
                    lambda fn=fns[name]: fn(*args, **kw)[1:] if name == "K3m" else fn(*args, **kw))
    times = {name: cuda_ms(lambda fn=fns[name]: fn(*args, **kw)) for name in route}
    plain_ms = cuda_ms(lambda: _by_kv_head(lambda qh, oh, lh, dh, kh, vh: flash_attention_bwd_plain(
        qh, kh, vh, oh, lh, dh, causal=True, sm_scale=scale, window=window, softcap=softcap, segments=segments),
        (q, out, lse, do), (k, v)), warmup=1, iters=3)
    lib_ms = None
    if lib_mask is not None:
        group = hq // hkv
        leaves = [x.detach().clone().requires_grad_() for x in
                  (q, k.repeat_interleave(group, dim=1), v.repeat_interleave(group, dim=1))]
        lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=lib_mask)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True))
        del leaves, lib_out
    pairs = _visible_pairs(q_len, kv_len, window, None if segments is None else (segments[0][0:1], segments[1][0:1]))
    report, parts = {}, []
    for name, ms in times.items():
        bound_ms, bound_by = _bwd_bound(name, d, hq, pairs, q, k)
        flops = 2 * d * pairs * hq * {"K3m": 5, "K4m": 3, "K5m": 4}[name]
        parts.append(f"{name} {ms:.4f} ms ({_rates(flops, ms)}; bound {bound_ms:.4f} ms by {bound_by})")
        report[name] = {"max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by}
    ratio = "" if lib_ms is None else f", {' + '.join(times)} over it {sum(times.values()) / lib_ms:.3f}"
    log(f"[masked backward] {label}: |grad-oracle| {d_oracle:.3e}, |grad-plain| {d_plain:.3e}, row-relative "
        f"{d_rel:.3e}; " + ", ".join(parts) + f"; plain (dq, dk, dv) {plain_ms:.4f} ms, SDPA backward (library) "
        + ("none" if lib_ms is None else f"{lib_ms:.4f} ms") + ratio + f"; {pairs} visible pairs a head ({card})")
    return report


def phase_masked_bwd(card: str) -> dict:
    """Phase 18: the masked backward kernels and K1d. First the correctness
    cases (``masked_bwd_cases``); then, at the training path's shapes in
    bf16 (q [1,32,8192,128], kv [1,8,8192,128], window 4096; the same
    packed as documents PACKED_DOCS; MHA q = kv [1,32,8192,128] packed, as
    phase 20d runs it, and [1,32,4096,128] at window 1024): the forward
    (K1, K1d) and the backward (K4m + K5m, K3m) held
    against plain and the oracle, and timed beside the plain versions, SDPA
    with the equivalent boolean mask, the unwindowed causal K4 and K5 at
    T=8192, and their bounds. Returns the report entries and the times the
    step breakdown of phase 20 reads."""
    import torch

    from flash_attention_tpu_torch.ops.attention_bwd import _delta, _guard_lse, launch_dkv, launch_dq
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention

    masked_bwd_cases()
    bf16, d, dev = torch.bfloat16, 128, torch.device("cuda")
    q, k, v, do = _bwd_inputs(18, 32, 8, TRAIN_T, TRAIN_T, d, bf16)
    col, row = torch.arange(TRAIN_T, device=dev)[None, :], torch.arange(TRAIN_T, device=dev)[:, None]
    band = (col <= row) & (col > row - WINDOW)
    ids = _packed_ids(PACKED_DOCS)
    same_doc = ids[0][:, None] == ids[0][None, :]
    shape = f"q [1,32,{TRAIN_T},128] kv [1,8,{TRAIN_T},128]"
    fwd = {"window": _k1_masked(card, f"window {WINDOW}, {shape}", q, k, v, window=WINDOW, lib_mask=band),
           "packed": _k1_masked(card, f"window {WINDOW} + documents {PACKED_DOCS}, {shape}", q, k, v, window=WINDOW,
                                segment_ids=ids, lib_mask=band & same_doc, want="K1d")}
    bwd = {"window": _time_bwd(card, f"window {WINDOW}, {shape}", q, k, v, do, window=WINDOW, lib_mask=band),
           "packed": _time_bwd(card, f"window {WINDOW} + documents {PACKED_DOCS}, {shape}", q, k, v, do,
                               window=WINDOW, segment_ids=ids, lib_mask=band & same_doc)}
    # The same shape unwindowed (causal only, the unmasked K4 and K5): what
    # the window's tile skip saves.
    with torch.no_grad():
        out, lse = flash_attention(q, k, v, causal=True, save_residuals=True)
    args = (q, k, v, do, _guard_lse(lse).contiguous(), _delta(out, do).contiguous())
    causal_ms = {name: cuda_ms(lambda fn=fn: fn(*args, causal=True, sm_scale=d**-0.5))
                 for name, fn in (("K4", launch_dq), ("K5", launch_dkv))}
    log(f"[masked backward] {shape} causal, no window (K4, K5 unmasked): K4 {causal_ms['K4']:.4f} ms, K5 "
        f"{causal_ms['K5']:.4f} ms; window {WINDOW}: K4m {bwd['window']['K4m']['ms']:.4f} ms "
        f"({bwd['window']['K4m']['ms'] / causal_ms['K4']:.3f} of causal), K5m {bwd['window']['K5m']['ms']:.4f} ms "
        f"({bwd['window']['K5m']['ms'] / causal_ms['K5']:.3f}); visible pairs {_window_pairs(TRAIN_T, TRAIN_T, WINDOW)} "
        f"of {_window_pairs(TRAIN_T, TRAIN_T, None)} ({card})")
    del q, k, v, do, out, lse, args
    torch.cuda.empty_cache()
    # K3m at phase 20d's shape: MHA, q = kv [1,32,8192,128], window 4096, packed.
    q, k, v, do = _bwd_inputs(20, 32, 32, TRAIN_T, TRAIN_T, d, bf16)
    mha = _time_bwd(card, f"window {WINDOW} + documents {PACKED_DOCS}, q = kv [1,32,{TRAIN_T},128] (MHA)", q, k, v,
                    do, window=WINDOW, segment_ids=ids, lib_mask=band & same_doc)
    del q, k, v, do, band, same_doc
    torch.cuda.empty_cache()
    # K3m at T=4096, window 1024.
    q, k, v, do = _bwd_inputs(19, 32, 32, 4096, 4096, d, bf16)
    col, row = torch.arange(4096, device=dev)[None, :], torch.arange(4096, device=dev)[:, None]
    _time_bwd(card, "window 1024, q = kv [1,32,4096,128] (MHA)", q, k, v, do, window=1024,
              lib_mask=(col <= row) & (col > row - 1024))
    del q, k, v, do
    torch.cuda.empty_cache()
    report = {"K1d": fwd["packed"], "K3m": mha["K3m"], "K4m": bwd["window"]["K4m"], "K5m": bwd["window"]["K5m"]}
    step = {"window": fwd["window"]["ms"] + bwd["window"]["K4m"]["ms"] + bwd["window"]["K5m"]["ms"],
            "packed": fwd["packed"]["ms"] + bwd["packed"]["K4m"]["ms"] + bwd["packed"]["K5m"]["ms"]}
    log(f"[masked backward] attention kernels a layer at T={TRAIN_T}: window {step['window']:.4f} ms (K1 + K4m + "
        f"K5m), packed {step['packed']:.4f} ms (K1d + K4m + K5m), packed / window {step['packed'] / step['window']:.3f} "
        f"({card})")
    return report, step


def phase_masked_bwd_sweep() -> None:
    """Every (dtype, head_dim) instantiation of the masked K3, K4 and K5 (and
    K1d's forward) at ragged shapes: windows BWD_SWEEP_WINDOWS (at 65
    softcap BITE_CAP with q scaled by BITE_Q, else q x 4), MHA
    self-attention (K3m), GQA 4/2 and 8/1 self-attention and q 100
    end-aligned over kv 300 (K4m + K5m); segment ids of three documents at
    windows 63 and 1000."""
    import torch

    worst, n = 0.0, 0
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for d in (32, 64, 128):
            for window in BWD_SWEEP_WINDOWS:
                softcap = BITE_CAP if window == 65 else None
                for hq, hkv, q_len, kv_len in ((4, 4, 300, 300), (4, 2, 300, 300), (8, 1, 300, 300), (4, 2, 100, 300)):
                    ids = None
                    if window in (63, 1000):
                        kv_ids = _packed_ids((130, 101, 69))
                        ids = kv_ids if q_len == kv_len else (kv_ids[:, -q_len:].contiguous(), kv_ids)
                    what = f"[masked backward sweep] {name} d={d} {hq}/{hkv} q {q_len} kv {kv_len} window {window}"
                    q, k, v, do = _bwd_inputs(n, hq, hkv, q_len, kv_len, d, dtype, strided_do=False)
                    q = (q.float() * (BITE_Q if softcap else 4)).to(dtype)
                    _, _, _, d_rel, _ = _hold_bwd(what, q, k, v, do, window=window, softcap=softcap,
                                                  segment_ids=ids, rel_bar=REL_BAR[name])
                    worst = max(worst, d_rel / REL_BAR[name])
                    n += 1
    log(f"[masked backward sweep] K3m, K4m and K5m (forward K1, K2 or K1d) at fp32/fp16/bf16 x head_dim 32/64/128 x "
        f"windows {list(BWD_SWEEP_WINDOWS)} (softcap {BITE_CAP} with q x {BITE_Q} at 65, three documents at 63 and 1000), "
        f"MHA, GQA, cross-length, {n} cases: all within {ORACLE_BAR} of the masked oracle's gradients; worst "
        f"row-relative difference to plain at {worst:.3f} of its bar {REL_BAR}")


def phase_tiny_train_masked() -> None:
    """Phase 19: the tiny fp32 model with a window of 24 and softcap 30 on
    the card and on the CPU (``_tiny_train``): packed (three documents a
    row, then two) through K1d and K4m + K5m (GQA) or K3m (MHA), and
    unpacked through K2 and K4m + K5m."""
    import torch

    ids = torch.cat([_packed_ids((40, 35, 25), "cpu"), _packed_ids((70, 30), "cpu")])
    runs = ((2, ids, ("K1d", "K4m", "K5m")), (4, ids, ("K1d", "K3m")), (2, None, ("K2", "K4m", "K5m")))
    _tiny_train("[tiny train masked] window 24, softcap 30, 4 q /", 19, runs, sliding_window=24, logit_softcap=30.0)


def phase_full_train_masked(card: str, attn_ms: dict) -> dict:
    """Phase 20: ModelConfig(mlp_dim=14336, sliding_window=4096) (Mistral-7B
    v0.1's shape) trained at full width and depth, bf16, weights from seed
    0, B=1, T=8192 (phase 17's engines released): (a) three steps and the
    SGD check, exactly K1, K4m and K5m; (b) one step of one packed row of
    documents PACKED_DOCS on the same weights, exactly K1d, K4m and K5m;
    (c) softcap 50 added, one step; (d) the MHA route,
    ModelConfig(mlp_dim=14336, sliding_window=4096, num_kv_heads=32,
    num_layers=4), one packed step, exactly K1d and K3m. Prints the
    attention kernels' share of (a)'s step from phase 18's kernel times
    (``attn_ms``, one layer's forward + backward kernels at these shapes)
    and (b)'s attention over (a)'s. Returns each run's launches."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params

    gc.collect()
    torch.cuda.empty_cache()
    cfg = ModelConfig(**MISTRAL)
    params = init_model_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    n_params = sum(t.numel() for t in _tensors(params))
    log(f"[full train masked] ModelConfig(mlp_dim=14336, sliding_window=4096) bf16: {n_params / 1e9:.3f} B params, "
        f"{_nbytes(params) / 1e9:.3f} GB and their gradients as much ({card})")
    rng = np.random.default_rng(20)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, TRAIN_T + 1))).cuda() for _ in range(3)]
    ids = _packed_ids(PACKED_DOCS)
    runs = {}
    runs["a"] = _train_steps(card, "[full train masked a] window 4096", params, cfg, batches,
                                    used=("K1", "K4m", "K5m"))
    share = cfg.num_layers * attn_ms["window"] / (runs["a"]["step_s"] * 1e3)
    log(f"[full train masked a] attention kernels (K1 + K4m + K5m, phase 18's times at this shape) "
        f"{cfg.num_layers} x {attn_ms['window']:.2f} ms = {cfg.num_layers * attn_ms['window']:.1f} ms, "
        f"{share:.3f} of the median step ({card})")
    _sgd_check("[full train masked a]", params, cfg, batches[-1], runs["a"]["losses"][-1])
    runs["b"] = _train_steps(card, f"[full train masked b] window 4096, packed {PACKED_DOCS}", params, cfg,
                                    batches[:1], used=("K1d", "K4m", "K5m"), segment_ids=ids)
    log(f"[full train masked b] attention kernels packed / unpacked (phase 18, K1d + K4m + K5m over K1 + K4m + K5m): "
        f"{attn_ms['packed'] / attn_ms['window']:.3f}; step packed / unpacked "
        f"{runs['b']['step_s'] / runs['a']['step_s']:.3f} ({card})")
    runs["c"] = _train_steps(card, f"[full train masked c] window 4096, softcap {CAP}", params,
                                    dataclasses.replace(cfg, logit_softcap=CAP), batches[:1],
                                    used=("K1", "K4m", "K5m"))
    for t in _tensors(params):
        t.grad = None
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg_mha = ModelConfig(**MISTRAL, num_kv_heads=32, num_layers=4)
    p_mha = init_model_params(torch.Generator(device="cuda").manual_seed(1), cfg_mha)
    runs["d"] = _train_steps(card, f"[full train masked d] ModelConfig(mlp_dim=14336, sliding_window=4096, "
                                    f"num_kv_heads=32, num_layers=4), packed {PACKED_DOCS}", p_mha, cfg_mha,
                                    batches[:1], used=("K1d", "K3m"), segment_ids=ids)
    del p_mha
    gc.collect()
    torch.cuda.empty_cache()
    return {key: run["launches"] for key, run in runs.items()}

# Phase 21: each probe tool's shortened sweep, its variant that stands for it
# in the kernels' line, and the kernels its run must launch.
PROBES = (
    ("P1", "softmax_probe", "SMOKE_SWEEP", "softmax_probe.py:29", (8192, "c=1 128x64 f32"), ("PT",)),
    ("P2", "mfu_probe", "SEQS", "mfu_probe.py:36", (1024, "full"), ("PS",)),
    ("P3", "grid_probe", "SMOKE_SWEEP", "grid_probe.py:23", (8192, "128x128 par"), ("PT",)),
    ("P4", "causal_probe", "SMOKE_TILES", "causal_probe.py:28", (8192, "128x128 skip=1 mask=cond"), ("PT",)),
    ("P5", "gap_probe", "SEQS", "gap_probe.py:27", (1024, "bare S"), ("PS", "K1")),
    ("P6", "epilogue_probe", "SEQS", "epilogue_probe.py:25", (1024, "after_pv"), ("PS",)),
)


def phase_probes(card: str) -> list:
    """Phase 21: the probes P1-P6 (csrc/probes.cu, bodies T and S) through
    their tools' ``run`` on a shortened sweep: every variant's output on the
    card against its plain version, row by row within the bar its tool
    states (``tools/probes.py``: PLAIN_BAR, BF16_BAR), and, where it
    computes attention, within ORACLE_BAR of the fp32 oracle; each timed
    beside its plain version, its bound and SDPA. Each probe's run starts
    with every launch count at 0 and must launch exactly its kernels (P5's
    real rows also K1). Returns the kernels' line entries, one a probe."""
    import importlib

    import torch

    entries = []
    t0 = time.perf_counter()
    for probe, module, sweep, replaces, (seq, variant), used in PROBES:
        tool = importlib.import_module(f"flash_attention_tpu_torch.tools.{module}")
        t_probe = time.perf_counter()
        zero_counts()
        rows = tool.run(getattr(tool, sweep), quick=True, log=lambda line: log(f"[probes] {line}"))
        launches = read_counts()
        check_launches(f"[probes] {probe}", launches, used)
        timed = [r for r in rows if "ms" in r]
        rep = next(r for r in timed if r["seq"] == seq and r["variant"] == variant)
        log(f"[probes] {probe} ({module}): {len(timed)} variants within their bars, worst row-relative "
            f"{max(r['rel_plain'] / r['bar'] for r in timed):.3f} of its bar, worst |kernel - oracle| "
            f"{max((r['oracle_err'] for r in timed if r['oracle_err'] is not None), default=0.0):.3e}; "
            f"launches {launches}; {time.perf_counter() - t_probe:.1f} s ({card})")
        body = "T" if used[0] == "PT" else "S"
        entries.append({
            "name": f"probe {probe}, body {body}: {variant} at seq {seq}", "route": "cuda",
            "source": "flash_attention_tpu_torch/csrc/probes.cu", "replaces": f"tools/{replaces}",
            "launches": launches[used[0]], "max_abs_err": max(r["abs_plain"] for r in timed),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["sdpa_ms"],
        })
        del rows, timed
        torch.cuda.empty_cache()
    log(f"[probes] phase 21 took {time.perf_counter() - t0:.1f} s ({card})")
    return entries


def main() -> None:
    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig

    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    fwd = phase_k1(card)
    k1, k1t = fwd["K1"], fwd["K1t"]
    k6 = phase_k6(card)
    phase_kernel_sweep()
    dense_tiny = phase_tiny()
    launches, params, dense = phase_full(card)
    k1["launches"], k6["launches"] = launches["K1"], launches["K6"]
    phase_sampling(card, params)
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
    bwd = phase_bwd_kernels(card)
    phase_bwd_sweep()
    phase_tensor_core_sweep()
    phase_tiny_train()
    train = phase_full_train(card, params)
    bwd["K3"]["launches"] = train["mha"]["K3"]
    k1t["launches"] = train["gqa"]["K1"]
    bwd["K4"]["launches"], bwd["K5"]["launches"] = train["gqa"]["K4"], train["gqa"]["K5"]
    bwd["K5s"]["launches"] = train["gqa"]["K5s"]
    del params  # phase 17 brings its own model, and its peak memory is its own
    masked = phase_masked_kernels(card)
    phase_masked_sweep()
    phase_split_sweep()
    masked["K2"]["launches"] = phase_tiny_masked()
    full = phase_full_masked(card)
    masked["K1w"]["launches"], masked["K1c"]["launches"] = full["a"]["K1"], full["d"]["K1"]
    masked["K6r"]["launches"] = full["a"]["K6"]
    masked["K7s"]["launches"], masked["K8s"]["launches"] = full["c"]["K7"], full["c"]["K8"]
    train_masked, attn_ms = phase_masked_bwd(card)
    phase_masked_bwd_sweep()
    phase_tiny_train_masked()
    runs = phase_full_train_masked(card, attn_ms)
    for key in train_masked:
        train_masked[key]["launches"] = sum(run[key] for run in runs.values())
    source = "flash_attention_tpu_torch/csrc/"
    names = {
        "K2": ("flash_fwd_band (K2)", "flash_fwd.cu", "ops/flash_attention.py:795"),
        "K1w": ("fwd_kernel, wgmma + TMA, window 4096 (K1)", "flash_fwd_sm90.cu", "ops/flash_attention.py:57"),
        "K1c": ("fwd_kernel, wgmma + TMA, softcap 50 (K1)", "flash_fwd_sm90.cu", "ops/flash_attention.py:57"),
        "K6r": ("decode, ring of 4352 rows (K6)", "decode.cu", "ops/decode.py:56"),
        "K7s": ("paged_decode, window + sinks (K7)", "decode.cu", "ops/paged.py:980"),
        "K8s": ("paged_prefill, window + sinks (K8)", "flash_fwd.cu", "ops/paged.py:580"),
        "K1d": ("fwd_kernel, wgmma + TMA, segment ids (K1d)", "flash_fwd_sm90.cu", "ops/flash_attention.py:61"),
        "K3m": ("dkv_kernel<FUSED>, wgmma + TMA, masked (K3)", "flash_bwd_sm90.cu", "ops/attention_bwd.py:594"),
        "K4m": ("dq_kernel, wgmma + TMA, masked (K4)", "flash_bwd_sm90.cu", "ops/attention_bwd.py:65"),
        "K5m": ("dkv_kernel, wgmma + TMA, masked (K5)", "flash_bwd_sm90.cu", "ops/attention_bwd.py:317"),
    }
    masked.update(train_masked)
    masked = [{"name": names[key][0], "route": "cuda", "source": source + names[key][1],
               "replaces": f"{REFERENCE}/{names[key][2]}", **masked[key]} for key in names]
    probes = phase_probes(card)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k1t, k6, k7, k8, k10, *quant.values(), *bwd.values(), *masked, *probes]}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    if shutil.which("nvidia-smi") is None:
        raise SystemExit("chip_smoke: nvidia-smi not found; this script needs a CUDA card")
    main()
