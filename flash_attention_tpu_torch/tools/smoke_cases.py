#!/usr/bin/env python3
"""Run chosen functions of chip_smoke.py from one or more source trees on the card.

    python3 flash_attention_tpu_torch/tools/smoke_cases.py TREE[,TREE...] FUNC [FUNC ...]

Each TREE is a directory holding a checkout of the repository: the root
itself, an unpacked ``git archive`` of another commit (to compare two
commits on one card), or a copy with a deliberate fault in it (a mutation
check). First every tree's kernels are built, all trees at once, each in a
process of its own. Then, tree by tree in the order given (a tree may be
named more than once, as in ``parent,change,change,parent``), a fresh
process imports that tree's ``chip_smoke.py`` and calls each FUNC (a
function of that script, or one of this file's cases below, which run the
tree's own package), passing the card's name where the function takes an
argument. It prints

    RESULT <tree> <func>: passed            (or FAILED: <the exception>)
    TIMING <tree> <func> {"ms": ..., "plain_ms": ...}

the second for a function that returns a dict with kernel times. The exit
code is 0 when every tree built; a FAILED case is a result, not an error.
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
from pathlib import Path


def k6_split(card: str) -> dict:
    """K6 at phase 3's inputs and over phase 15's ring of 4352 rows, and K7
    over phase 15's paged ring (window 4096, 4 sinks), each timed three
    ways (``_split_times``): ``ms`` as chip_smoke.py times a wrapper call
    (host work up to the launch included, since the card idles at the start
    event), ``device_ms`` from a CUDA graph of 10 calls replayed (the kernel
    alone; the graph also shows the split merge's counters reset
    themselves: the replay must equal a direct call), and ``host_us`` the
    wrapper's host time a call. The top-level numbers are phase 3's."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from flash_attention_tpu_torch.ops.decode import decode_attention
    from flash_attention_tpu_torch.ops.paged import paged_decode_attention

    dev = torch.device("cuda")
    rng = np.random.default_rng(6)

    def uniform(shape):
        return torch.from_numpy(rng.uniform(-0.5, 0.5, shape).astype(np.float32)).to(dev, torch.bfloat16)

    q = uniform((8, 32, 128))
    k, v = uniform((8, 8, 2048, 128)), uniform((8, 8, 2048, 128))
    lengths = torch.tensor([0, 1, 255, 256, 1000, 2047, 2048, 7], dtype=torch.int32, device=dev)
    rows = {"phase 3": (decode_attention, lambda: decode_attention(q, k, v, lengths))}
    gen = torch.Generator(device=dev).manual_seed(15)
    ring_k = cs.torch_uniform((8, 8, cs.RING_ROWS, 128), torch.bfloat16, gen)
    ring_v = cs.torch_uniform((8, 8, cs.RING_ROWS, 128), torch.bfloat16, gen)
    ring_len = torch.tensor(cs.RING_LENGTHS, dtype=torch.int32, device=dev)
    rows[f"ring {cs.RING_ROWS}"] = (decode_attention, lambda: decode_attention(
        q, ring_k, ring_v, ring_len, save_residuals=True, sliding_window=cs.WINDOW, ring_buffer=True))
    page, per_slot = 128, 72
    n_ring = -(-(cs.WINDOW + 256) // page) + 2
    table, num_pages = cs._ring_table(np.random.default_rng(15), 8, per_slot, n_ring, sinks=True)
    cache = cs._filled_cache(1, num_pages=num_pages, num_slots=8, pages_per_slot=per_slot, kv_heads=8,
                             head_dim=128, dtype=torch.bfloat16, gen=gen).layers()[0]
    cache.page_table.copy_(torch.from_numpy(table).to(dev))
    cache = cache._replace(lengths=torch.tensor(cs.DENSE_LENGTHS, dtype=torch.int32, device=dev))
    rows["K7 paged ring"] = (paged_decode_attention, lambda: paged_decode_attention(
        q, cache, save_residuals=True, sliding_window=cs.WINDOW, attention_sinks=cs.SINKS))
    out = {}
    for key, (wrapper, call) in rows.items():
        direct = call()
        ms, device_ms, host_us = _split_times(call)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = call()
        graph.replay()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(_tensors(direct), _tensors(replayed)))
        grid = getattr(wrapper, "last_grid", None)
        print(f"[k6 split] {key}: wrapper {ms:.4f} ms, kernel alone {device_ms:.4f} ms (CUDA graph of 10), host "
              f"{host_us:.1f} us a call; splits and blocks {grid}; graph replay equal to a direct call: {same} "
              f"({card})", flush=True)
        if not same:
            raise RuntimeError(f"{key}: the CUDA graph's replay differs from a direct call")
        out[key] = {"ms": ms, "device_ms": device_ms, "host_us": host_us}
    return {**out["phase 3"], **{f"{key} {m}": t for key, row in out.items() for m, t in row.items()}}


def _tensors(x) -> list:
    """A wrapper's result as a list of tensors (its output, or (out, lse)).
    The cases here keep their own helpers: they also run a parent tree's
    chip_smoke.py, which may lack this tree's."""
    return list(x) if isinstance(x, tuple) else [x]


# chip_smoke.LAUNCH_CALLS, kept here too: a parent tree's script may lack it.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def write_split(card: str) -> dict:
    """K10 (32 layers) and K9 (one layer) at phase 6's shapes (8 slots, 8 kv
    heads, bf16 rows of 128, pools of 129 pages of 128 rows), each timed as
    ``_split_times`` does, beside ``index_put_`` of the same rows into K and
    V, and the launches a call makes (CUDA kernels, memsets and copies in a
    torch.profiler trace of 10 calls). ``ms`` and ``device_ms`` are K9's."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from flash_attention_tpu_torch.ops.paged import paged_write_tokens, paged_write_tokens_multi

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    cache = cs._filled_cache(32, num_pages=129, num_slots=8, pages_per_slot=16, kv_heads=8, head_dim=128,
                             dtype=torch.bfloat16, gen=gen)
    table = torch.from_numpy(cs._shuffled_table(np.random.default_rng(7), 8, 16, 129)).to(dev)
    cache.page_table.copy_(table)
    lengths = torch.tensor([37, 2047, 5, 127, 128, 129, 1000, 2046], dtype=torch.int32, device=dev)
    cache = cache._replace(lengths=lengths)
    layer = cache.layers()[0]
    slots = torch.arange(8, device=dev)  # int64, as the engine passes them
    k_new, v_new = (cs.torch_uniform((32, 8, 8, 128), torch.bfloat16, gen) for _ in range(2))
    pos = lengths.long()
    idx = (table[slots, pos // 128].long()[:, None], torch.arange(8, device=dev)[None, :], (pos % 128)[:, None])
    calls = {
        "K10": lambda: paged_write_tokens_multi(cache, k_new, v_new, slots),
        "K9": lambda: paged_write_tokens(layer, k_new[0], v_new[0], slots),
        "index_put_ K and V, one layer": lambda: (layer.k_pages.index_put_(idx, k_new[0]),
                                                  layer.v_pages.index_put_(idx, v_new[0])),
    }
    out = {}
    for key, call in calls.items():
        call()
        ms, device_ms, host_us = _split_times(call)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        launches = sum(e.name in LAUNCH_CALLS for e in prof.events()) / 10
        names = sorted({e.name[:40] for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA})
        print(f"[write split] {key}: wrapper {ms:.4f} ms, alone {device_ms:.4f} ms (CUDA graph of 10), host "
              f"{host_us:.1f} us a call, {launches} launches a call {names} ({card})", flush=True)
        out[key] = {"ms": ms, "device_ms": device_ms, "host_us": host_us, "launches": launches}
    return {**out["K9"], **{f"{key} {m}": t for key, row in out.items() for m, t in row.items()}}


def _serve_paths(card: str, quant: bool) -> dict:
    """The numbers (prefill and decode tok/s) of the serving paths, each
    with chip_smoke.py's own serving function on fresh weights from seed 0:
    phase 5 (``ServingEngine``, ``ModelConfig()``), phase 8
    (``PagedServingEngine``, the same weights and requests), with ``quant``
    phase 11a (int8 weights and an int8 cache through ``ServingEngine``) and
    11b (the paged engine over an fp8 e4m3 cache), then Mistral-7B's shape
    through phase 17's rolling engine (17a, the 4352-row ring) and its paged
    ring with 4 sinks (17c), each after ``warmup()``."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    import chip_smoke as cs
    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params, quantize_model_weights
    from flash_attention_tpu_torch.serving.engine import ServingEngine
    from flash_attention_tpu_torch.serving.paged_engine import PagedServingEngine

    cfg = ModelConfig()
    params = init_model_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    runs = {}
    _, runs["5"] = cs.serve_full_dense(card, "full", cfg, params, used=("K1", "K6", *_glue(cs)))
    if quant:
        params_w8 = quantize_model_weights(params)
        _, runs["11a"] = cs.serve_full_dense(card, "full quant a", ModelConfig(kv_quant="int8", weight_quant="int8"),
                                             params_w8, used=("K1", "K6q", *_glue(cs), *_w8(cs)), ref=runs["5"])
        del params_w8
    _, runs["8"] = cs.serve_full_paged(card, "full paged", cfg, params, used=("K7", "K8", "K9/K10", *_glue(cs)),
                                       dense=runs["5"])
    if quant:
        _, runs["11b"] = cs.serve_full_paged(card, "full quant b", ModelConfig(kv_quant="fp8_e4m3"), params,
                                             used=("K7q", "K8q", "K9q/K10q", *_glue(cs)), dense=runs["5"],
                                             ref=runs["8"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg = ModelConfig(**cs.MISTRAL)
    params = init_model_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    rng = np.random.default_rng(17)
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab_size, n)) for n in cs.MASKED_PROMPT_LENS]
    eng = ServingEngine(params, dataclasses.replace(cfg, rolling=True), max_slots=8, max_seq=16384, prefill_chunk=256)
    eng.warmup()
    runs["17a"] = cs._serve_masked(card, "full masked a", eng, prompts, used=("K1", "K6", *_glue(cs)))
    del eng
    torch.cuda.empty_cache()
    eng = PagedServingEngine(params, dataclasses.replace(cfg, attention_sinks=cs.SINKS), max_slots=8, num_pages=297,
                             pages_per_slot=72, page_size=128, prefill_chunk=256)
    eng.warmup()
    runs["17c"] = cs._serve_masked(card, "full masked c", eng, prompts, used=("K7", "K8", "K9/K10", *_glue(cs)))
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def _glue(cs) -> tuple:
    """The kernels a tree's engine runs launch beside attention: the glue and
    S1 (``SERVED``), the glue alone before csrc/sampling.cu, none before
    csrc/fused.cu."""
    return getattr(cs, "SERVED", getattr(cs, "GLUE", ()))


def _w8(cs) -> tuple:
    """The W8A16 kernels a tree's int8-weight paths launch (none before csrc/w8.cu)."""
    return ("W1", "W2") if hasattr(cs, "phase_w8") else ()


def w1_splits(card: str) -> dict:
    """W1 at 8 rows of bf16 x over ModelConfig()'s q / k / v and gate / up
    groups and wo, w_down and wk, launched with K split over clusters of 1
    to 8 blocks (``w1_plan``'s own choice marked), each alone in a CUDA
    graph with a cold L2 (distinct weight copies past 100 MB walked in
    turn): how the cluster's reduction trades against the blocks in flight.
    ``ms`` is q / k / v's at the plan's split."""
    import math

    import torch

    import chip_smoke as cs
    from flash_attention_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(7)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for name, k, ns in (("q / k / v", 4096, (4096, 1024, 1024)), ("gate / up", 4096, (11008, 11008)),
                        ("wo", 4096, (4096,)), ("w_down", 11008, (4096,)), ("wk", 4096, (1024,))):
        nbytes = k * sum(ns)
        copies = max(2, math.ceil(100e6 / nbytes))
        sets = [[(torch.randint(-127, 128, (k, n), dtype=torch.int8, device="cuda", generator=gen),
                  torch.rand(n, device="cuda", generator=gen) / 100) for n in ns] for _ in range(copies)]
        x = cs.torch_uniform((8, k), torch.bfloat16, gen)
        ref = [quant.w8_matmul(x, quant.QuantizedTensor(w, s[None])) for w, s in sets[0]]
        xt, plan_splits, _ = quant.w1_plan(8, ns, k, sms)
        ksteps = math.ceil(k / 16)
        row = []
        for want in range(1, quant.W1_MAX_SPLITS + 1):
            steps = math.ceil(math.ceil(ksteps / want) / quant.W1_BOX_STEPS) * quant.W1_BOX_STEPS
            splits = math.ceil(ksteps / steps)
            if f"{name} splits {splits}" in out:
                continue
            res = [torch.empty((8, n), dtype=torch.bfloat16, device="cuda") for n in ns]
            plan = (xt, splits, steps)
            quant._launch_w1_group(x, sets[0], res, plan)
            torch.cuda.synchronize()
            if len(ns) == 1 and splits == plan_splits and not torch.equal(res[0], ref[0]):
                raise RuntimeError(f"{name}: the plan's launch differs from w8_matmul")
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for i in range(max(10, copies)):
                    quant._launch_w1_group(x, sets[i % copies], res, plan)
            ms = cs.cuda_ms(graph.replay) / max(10, copies)
            del graph
            blocks = splits * sum(math.ceil(n / quant.W1_COLS) for n in ns)
            mark = "*" if splits == plan_splits else ""
            row.append(f"{splits}{mark} ({blocks} blocks): {ms * 1e3:.1f}")
            out[f"{name} splits {splits}"] = ms
            if name == "q / k / v" and mark:
                out["ms"] = ms
        bound_us = (nbytes + 8 * k * 2) / cs.PEAK_BYTES * 1e6
        print(f"[w1 splits] {name} N {ns}, K {k}, x [8, {k}] bf16, us alone with a cold L2 by K split (* the "
              f"plan's); bound {bound_us:.2f} us: " + ", ".join(row) + f" ({card})", flush=True)
        del sets
        torch.cuda.empty_cache()
    return out


def w1_diag(card: str) -> dict:
    """W1's group launch over an [K, N] weight whole and as a strided column
    shard, at 1 and 8 rows, at every K split: two launches compared bit for
    bit and each against the plain version; prints where two launches
    differ (output rows and columns) and fails if any do."""
    import math

    import torch

    import chip_smoke as cs
    from flash_attention_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(9)
    bad = []
    for k, n, ld in ((4096, 5504, 11008), (4096, 5504, 5504), (4096, 4096, 4096), (11008, 4096, 16384)):
        base = torch.randint(-127, 128, (k, ld), dtype=torch.int8, device="cuda", generator=gen)
        w = base[:, ld - n:]
        scales = torch.rand(n, device="cuda", generator=gen) / 100
        qt = quant.QuantizedTensor(w, scales[None])
        ksteps = math.ceil(k / 16)
        for m in (1, 8):
            x = cs.torch_uniform((m, k), torch.bfloat16, gen)
            plain = quant.w8_matmul_plain(x, qt)
            for want in range(1, quant.W1_MAX_SPLITS + 1):
                steps = math.ceil(math.ceil(ksteps / want) / quant.W1_BOX_STEPS) * quant.W1_BOX_STEPS
                splits = math.ceil(ksteps / steps)
                got = [torch.empty((m, n), dtype=torch.bfloat16, device="cuda") for _ in range(2)]
                for res in got:
                    quant._launch_w1_group(x, [(w, scales)], [res], (quant._x_tiles(m), splits, steps))
                torch.cuda.synchronize()
                rel = cs._rel_diff(got[0], plain)
                differ = (got[0] != got[1]).nonzero()
                if len(differ) or rel > cs.PLAIN_BAR:
                    cols = differ[:, 1]
                    where = (f"{len(differ)} elements differ, rows {sorted(set(differ[:, 0].tolist()))[:8]}, "
                             f"columns {int(cols.min()) if len(cols) else -1}..{int(cols.max()) if len(cols) else -1}")
                    bad.append(f"[K {k}, N {n}, ld {ld}] M={m} splits {splits} steps {steps}: {where}; "
                               f"row-relative to plain {rel:.3e}")
                    print(f"[w1 diag] {bad[-1]} ({card})", flush=True)
    print(f"[w1 diag] {len(bad)} launches differ or miss the plain bar ({card})", flush=True)
    if bad:
        raise RuntimeError(f"{len(bad)} W1 launches differ between calls or from plain")
    return {}


def w8_threshold(card: str) -> dict:
    """W1 against W2 by rows of bf16 x (8 to 64) at ModelConfig()'s wq and
    w_gate, each launched on the kernel named and timed alone in a CUDA
    graph of 10 launches: where ``ops.quant.W1_MAX_ROWS`` should sit.
    ``ms`` is wq's W1 time at 32 rows."""
    import torch

    import chip_smoke as cs
    from flash_attention_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(8)
    out = {}
    for name, k, n in (("wq", 4096, 4096), ("w_gate", 4096, 11008)):
        w = torch.randint(-127, 128, (k, n), dtype=torch.int8, device="cuda", generator=gen)
        scales = torch.rand(n, device="cuda", generator=gen) / 100
        row = []
        for m in (8, 16, 24, 32, 40, 48, 64):
            x = cs.torch_uniform((m, k), torch.bfloat16, gen)
            res = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
            times = {}
            for kernel, call in ((1, lambda: quant._launch_w1_group(x, [(w, scales)], [res])),
                                 (2, lambda: quant._launch_w2(x, w, scales, res, False))):
                call()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    for _ in range(10):
                        call()
                times[kernel] = cs.cuda_ms(graph.replay) / 10
                out[f"{name} M={m} W{kernel}"] = times[kernel]
            row.append(f"{m}: W1 {times[1] * 1e3:.1f} / W2 {times[2] * 1e3:.1f} us")
        print(f"[w8 threshold] {name} [{k}, {n}] bf16, alone in a CUDA graph: " + ", ".join(row) + f" ({card})",
              flush=True)
    out["ms"] = out["wq M=32 W1"]
    return out


def w8_ab(card: str) -> dict:
    """The W8A16 products through the public wrappers, which a parent tree
    has too, each alone in a CUDA graph with a cold L2 (distinct weight
    copies past 100 MB walked in turn): W1 at 8 rows over wq, wk, wo,
    w_gate, w_down and the unembed, the q / k / v and gate / up groups (one
    ``w8_matmul_group`` launch where the tree has it, else the single calls
    one after another), W2 at 8 to 64 rows over wq and at 256 and 1,024 rows
    over every weight; beside each, cuBLAS on the widened weight by the same
    protocol. ``ms`` is gate / up's at 8 rows."""
    import math

    import torch

    import chip_smoke as cs
    from flash_attention_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(19)
    shapes = {"wq": ((4096, 32, 128), 0), "wk": ((4096, 8, 128), 0), "wv": ((4096, 8, 128), 0),
              "wo": ((32, 128, 4096), (0, 1)), "w_gate": ((4096, 11008), 0), "w_up": ((4096, 11008), 0),
              "w_down": ((11008, 4096), 0), "unembed": ((32000, 4096), 1)}
    weights = {name: quant.quantize_weight(torch.randn(shape, generator=gen, device="cuda") / 64, contract_axes=axes)
               for name, (shape, axes) in shapes.items()}
    group = getattr(quant, "w8_matmul_group", None)

    def cold(make, nbytes, calls=10):
        copies = max(2, math.ceil(100e6 / nbytes))
        fns = [make(i) for i in range(copies)]
        for fn in fns:
            fn()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(max(calls, copies)):
                fns[i % copies]()
        return cs.cuda_ms(graph.replay) / max(calls, copies)

    def copies_of(names, nbytes):
        n = max(2, math.ceil(100e6 / nbytes))
        return [[weights[name] if i == 0 else quant.QuantizedTensor(weights[name].values.clone(),
                                                                      weights[name].scales.clone())
                 for name in names] for i in range(n)]

    out = {}

    def row(label, m, names, unembed=False):
        k = 11008 if names[0] == "w_down" else 4096
        x = cs.torch_uniform((m, k), torch.bfloat16, gen)
        nbytes = sum(weights[n].values.numel() for n in names)
        sets = copies_of(names, nbytes)
        if unembed:
            fn = lambda ws: quant.w8_matmul(x, ws[0], out_dtype=torch.float32, scale_on_output=True)  # noqa: E731
        elif len(names) > 1 and group is not None and m <= quant.W1_MAX_ROWS:
            fn = lambda ws: group(x, ws)  # noqa: E731
        else:
            fn = lambda ws: [quant.w8_matmul(x, w) for w in ws]  # noqa: E731
        t = cold(lambda i: lambda: fn(sets[i]), nbytes)
        del sets
        wides = [[(weights[n].values.to(torch.bfloat16).t() if unembed else
                   quant.w8_dequant(weights[n]).to(torch.bfloat16).reshape(k, -1)) for n in names]]
        wides += [[w.clone() for w in wides[0]] for _ in range(max(2, math.ceil(100e6 / (2 * nbytes))) - 1)]
        lib = cold(lambda i: lambda: [torch.matmul(x, w) for w in wides[i]], 2 * nbytes)
        del wides
        flops = 2.0 * m * k * nbytes / k
        bound_ms = max(flops / cs.PEAK_FLOPS, (nbytes + m * k * 2) / cs.PEAK_BYTES) * 1e3
        print(f"[w8 ab] {label} M={m}: {t * 1e3:.2f} us alone, cold L2; cuBLAS on the widened weight {lib * 1e3:.2f} "
              f"us ({t / lib:.3f}x); bound {bound_ms * 1e3:.2f} us ({bound_ms / t:.3f} of it) ({card})", flush=True)
        out[f"{label} M={m}"], out[f"{label} M={m} cuBLAS"] = t, lib
        torch.cuda.empty_cache()

    for name in ("wq", "wk", "wo", "w_gate", "w_down"):
        row(name, 8, [name])
    row("unembed", 8, ["unembed"], unembed=True)
    row("q / k / v", 8, ["wq", "wk", "wv"])
    row("gate / up", 8, ["w_gate", "w_up"])
    for m in (40, 64):
        row("wq", m, ["wq"])
    for m in (256, 1024):
        for name in ("wq", "wk", "wo", "w_gate", "w_down"):
            row(name, m, [name])
        row("unembed", m, ["unembed"], unembed=True)
    out["ms"] = out["gate / up M=8"]
    return out


def serve_w8(card: str) -> dict:
    """Phase 5 (bf16) and phase 11a (int8 weights + int8 cache) through
    chip_smoke.py's ``serve_full_dense`` on fresh weights from seed 0:
    prefill and decode tok/s and peak device memory of both, printed side by
    side. ``ms`` is 1000 over 11a's decode tok/s."""
    import torch

    import chip_smoke as cs
    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params, quantize_model_weights

    cfg = ModelConfig()
    params = init_model_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    _, bf16 = cs.serve_full_dense(card, "full", cfg, params, used=("K1", "K6", *_glue(cs)))
    params_w8 = quantize_model_weights(params)
    del params
    torch.cuda.empty_cache()
    _, w8 = cs.serve_full_dense(card, "full quant a", ModelConfig(kv_quant="int8", weight_quant="int8"), params_w8,
                                used=("K1", "K6q", *_glue(cs), *_w8(cs)), ref=bf16)
    keys = ("decode_tok_s", "prefill_tok_s", "peak_gib")
    print("[serve w8] 11a vs phase 5: " + ", ".join(f"{k} {w8[k]:.2f} vs {bf16[k]:.2f}" for k in keys) + f" ({card})",
          flush=True)
    return {"ms": 1e3 / w8["decode_tok_s"], **{f"11a {k}": w8[k] for k in keys}, **{f"5 {k}": bf16[k] for k in keys}}


def serve_decode(card: str) -> dict:
    """Decode tokens/s of the serving paths (``_serve_paths``: phases 5, 8,
    11a, 11b, 17a and 17c). ``ms`` is 1000 over phase 5's decode tok/s (a
    step's share per token)."""
    runs = _serve_paths(card, quant=True)
    tok_s = {key: run["decode_tok_s"] for key, run in runs.items()}
    print("[serve decode] decode tok/s " + ", ".join(f"phase {k} {v:.1f}" for k, v in tok_s.items()) + f" ({card})",
          flush=True)
    return {"ms": 1e3 / tok_s["5"], **{f"phase {k} decode_tok_s": v for k, v in tok_s.items()}}


def warmup_cost(card: str) -> dict:
    """What ``warmup()`` costs and buys on ``ModelConfig()`` (bf16, seed 0)
    at phase 5's engine (8 slots x 2048): its wall seconds and the device
    memory it leaves allocated (decode programs keep their token blocks
    live; their intermediates go back to the graphs' pool, reserved), then
    phase 5's 10 requests served once: decode tok/s and the run's wall.
    ``ms`` is the warmup's milliseconds."""
    import time

    import torch

    import chip_smoke as cs
    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params
    from flash_attention_tpu_torch.serving.engine import ServingEngine

    cfg = ModelConfig()
    params = init_model_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    eng = ServingEngine(params, cfg, **cs.DENSE_ENGINE)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    kept = torch.cuda.memory_allocated() - before
    t0 = time.perf_counter()
    eng.run(cs._full_requests(cfg))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    tok_s = eng.decode_tokens / eng.decode_time_s
    programs = getattr(eng, "programs", None)
    built = "no decode programs" if programs is None else f"{programs.captures} decode programs ({programs.mode})"
    print(f"[warmup cost] warmup() {warm_s:.3f} s, {kept / 2**20:.1f} MiB more allocated after it, {built}; phase 5's "
          f"requests then in {run_s:.3f} s, decode {tok_s:.1f} tok/s ({card})", flush=True)
    return {"ms": warm_s * 1e3, "kept MiB": kept / 2**20, "run s": run_s, "decode tok_s": tok_s}


def serve_prefill(card: str) -> dict:
    """Prefill tokens/s of the paths K8 and K8q run on, phases 8, 11b and
    17c, with phases 5 and 17a (K1) as controls, and the decode tok/s of
    all five (``_serve_paths``). Phase 8's and 11b's prefill is a
    prefill-only run over 10 prompts; 17a's and 17c's the sum of their
    256-row chunks, each synchronised. ``ms`` is 1000 over 17c's prefill
    tok/s."""
    runs = _serve_paths(card, quant=True)
    pre = {key: run["prefill_tok_s"] for key, run in runs.items()}
    dec = {key: run["decode_tok_s"] for key, run in runs.items()}
    print("[serve prefill] prefill tok/s " + ", ".join(f"phase {k} {v:.1f}" for k, v in pre.items())
          + "; decode tok/s " + ", ".join(f"phase {k} {v:.1f}" for k, v in dec.items()) + f" ({card})", flush=True)
    return {"ms": 1e3 / pre["17c"], **{f"phase {k} prefill_tok_s": v for k, v in pre.items()},
            **{f"phase {k} decode_tok_s": v for k, v in dec.items()}}


def prefill_check(card: str) -> None:
    """The prefill programs on the card, quickly: phases 4 (the tiny fp32
    engine, every chunk and block a replay after ``warmup()``, tokens equal
    to the CPU's), 5 and 8 (``serve_full_dense`` / ``serve_full_paged``:
    cold and warm prefill, ``hold_programs`` and ``hold_prefill_programs``)
    and 11 (int8 weights with an int8 dense cache, an fp8 paged cache), on
    fresh weights from seed 0."""
    import torch

    import chip_smoke as cs
    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params

    cs.phase_tiny()
    cfg = ModelConfig()
    params = init_model_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    _, dense = cs.serve_full_dense(card, "full", cfg, params, used=("K1", "K6", *_glue(cs)))
    _, paged = cs.serve_full_paged(card, "full paged", cfg, params, used=("K7", "K8", "K9/K10", *_glue(cs)),
                                   dense=dense)
    cs.phase_full_quant(card, params, dense, paged)


# Phase 5's, 8's, 11a's, 11b's, 17a's and 17c's engines: (label, model config fields, int8 weights, paged,
# Mistral's shape).
PREFILL_AB = (("5", {}, False, False, False), ("8", {}, False, True, False),
              ("11a", dict(kv_quant="int8", weight_quant="int8"), True, False, False),
              ("11b", dict(kv_quant="fp8_e4m3"), False, True, False),
              ("17a", dict(rolling=True), False, False, True),
              ("17c", dict(attention_sinks=4), False, True, True))
AB_LONG_NEW_TOKENS = 128  # prefill_ab's third served run: decode outlasts the prefill chunks


def prefill_ab(card: str) -> dict:
    """Cold and warm prefill and decode tokens/s of phases 5, 8, 11a, 11b,
    17a and 17c, through one harness that uses only the engines' public calls,
    so a parent tree runs it as it is: on fresh weights from seed 0 (17a, 17c:
    Mistral-7B's shape) and the phase's engine, a prefill-only run of the
    phase's prompts (one token each, wall clock, synchronised) on the fresh
    engine (cold), ``warmup()`` (its seconds), the same run again (warm; its
    first chunk timed alone, synchronised, with the launches it counted),
    then the prompts served with 32 new tokens each twice: as the engine
    runs them (the run's wall, and decode tokens over the decode section's
    seconds; a tree whose decode section does not wait for the prefill
    chunks queued ahead of a block before it starts charges their device
    time to decode), and with every chunk synchronised where it is issued,
    so that the decode section waits on decode work only on any tree (the
    eager chunks of a tree without prefill programs were all but so
    already); then served once more as the engine runs them with
    AB_LONG_NEW_TOKENS new tokens each, so that decode outlasts the
    prefill chunks it interleaves with; and the peak device memory over the
    warm run and the served ones. ``ms`` is 1000 over phase 5's warm
    prefill tok/s."""
    import dataclasses
    import gc
    import time

    import numpy as np
    import torch

    import chip_smoke as cs
    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params, quantize_model_weights
    from flash_attention_tpu_torch.serving.engine import Request, ServingEngine
    from flash_attention_tpu_torch.serving.paged_engine import PagedServingEngine

    out = {}
    params = {}
    for label, over, w8, paged, mistral in PREFILL_AB:
        base = ModelConfig(**cs.MISTRAL) if mistral else ModelConfig()
        if mistral not in params:
            params.clear()
            gc.collect()
            torch.cuda.empty_cache()
            params[mistral] = init_model_params(torch.Generator(device="cuda").manual_seed(0), base)
        weights = quantize_model_weights(params[mistral]) if w8 else params[mistral]
        cfg = dataclasses.replace(base, **over)
        lens = cs.MASKED_PROMPT_LENS if mistral else cs.FULL_PROMPT_LENS
        rng = np.random.default_rng(17 if mistral else 0)
        prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab_size, n)) for n in lens]
        if not paged:
            # 17a: the rolling ring of 4,352 rows a slot, positions up to phase 17's 16,384.
            eng = ServingEngine(weights, cfg, max_slots=8, max_seq=16384 if mistral else 2048, prefill_chunk=256)
        elif mistral:
            eng = PagedServingEngine(weights, cfg, max_slots=8, num_pages=297, pages_per_slot=72, page_size=128,
                                     prefill_chunk=256)
        else:
            eng = PagedServingEngine(weights, cfg, max_slots=8, num_pages=129, pages_per_slot=16, page_size=128,
                                     prefill_chunk=256)

        def prefill_only(base_id):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = eng.run([Request(id=base_id + i, prompt=q, max_new_tokens=1) for i, q in enumerate(prompts)])
            torch.cuda.synchronize()
            return [done[base_id + i].tokens for i in range(len(prompts))], time.perf_counter() - t0

        cold_tokens, cold_s = prefill_only(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.warmup()
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        step, first = eng._prefill_chunk_step, {}

        def first_chunk(*args):
            eng._prefill_chunk_step = step
            before = cs.read_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = step(*args)
            torch.cuda.synchronize()
            first["ms"] = (time.perf_counter() - t0) * 1e3
            first["launches"] = sum(cs.read_counts().values()) - sum(before.values())
            return result

        eng._prefill_chunk_step = first_chunk
        torch.cuda.reset_peak_memory_stats()
        warm_tokens, warm_s = prefill_only(100)
        if warm_tokens != cold_tokens:
            raise RuntimeError(f"[prefill ab] phase {label}: warm first tokens {warm_tokens} != cold {cold_tokens}")
        def served(base_id, synced: bool, new_tokens: int = cs.FULL_NEW_TOKENS):
            def chunk(*args):
                result = step(*args)
                torch.cuda.synchronize()
                return result

            eng._prefill_chunk_step = chunk if synced else step
            eng.steps, eng.decode_tokens, eng.decode_time_s = 0, 0, 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run([Request(id=base_id + i, prompt=q, max_new_tokens=new_tokens) for i, q in enumerate(prompts)])
            torch.cuda.synchronize()
            eng._prefill_chunk_step = step
            return time.perf_counter() - t0, eng.decode_tokens / eng.decode_time_s

        run_s, decode = served(200, synced=False)
        _, decode_synced = served(300, synced=True)
        _, decode_long = served(400, synced=False, new_tokens=AB_LONG_NEW_TOKENS)
        n = sum(lens)
        out[label] = {"cold": n / cold_s, "warm": n / warm_s, "decode": decode, "decode synced": decode_synced,
                      "decode long": decode_long,
                      "run s": run_s, "first chunk ms": first["ms"], "first chunk launches": first["launches"],
                      "warmup s": warmup_s, "peak GiB": torch.cuda.max_memory_allocated() / 2**30}
        print(f"[prefill ab] phase {label}: prefill {n} prompt tokens cold {out[label]['cold']:.1f} tok/s, warm "
              f"{out[label]['warm']:.1f} tok/s (warm first chunk {first['ms']:.2f} ms, {first['launches']} launches "
              f"counted); served with {cs.FULL_NEW_TOKENS} new tokens each in {run_s:.3f} s, decode {decode:.1f} "
              f"tok/s, {decode_synced:.1f} with every chunk synchronised, {decode_long:.1f} with {AB_LONG_NEW_TOKENS} new "
              f"tokens each; warmup() {warmup_s:.2f} s; peak "
              f"{out[label]['peak GiB']:.2f} GiB ({card})", flush=True)
        del eng, weights
        gc.collect()
        torch.cuda.empty_cache()
    return {"ms": 1e3 / out["5"]["warm"], **{f"{k} {m}": v for k, row in out.items() for m, v in row.items()}}


def decode_probe(card: str) -> dict:
    """Where a served run's decode time goes, on phase 5's dense and phase
    8's paged engine (fresh weights from seed 0, after ``warmup()``):
    phase 5's prompts served with AB_LONG_NEW_TOKENS new tokens each, twice,
    the engine's decode-section seconds beside the device time of its
    decode blocks (CUDA events around each ``programs.run``) and the steps
    they ran, so a change in decode tok/s shows as device time a step or as
    host time outside it. Uses only the engines' public calls, so a parent
    tree runs it as it is. ``ms`` is the dense engine's device ms a step."""
    import gc
    import time

    import numpy as np
    import torch

    import chip_smoke as cs
    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params
    from flash_attention_tpu_torch.serving.engine import Request, ServingEngine
    from flash_attention_tpu_torch.serving.paged_engine import PagedServingEngine

    cfg = ModelConfig()
    params = init_model_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab_size, n)) for n in cs.FULL_PROMPT_LENS]
    out = {}
    for what, make in (("dense", lambda: ServingEngine(params, cfg, max_slots=8, max_seq=2048, prefill_chunk=256)),
                       ("paged", lambda: PagedServingEngine(params, cfg, max_slots=8, num_pages=129,
                                                            pages_per_slot=16, page_size=128,
                                                            prefill_chunk=256))):
        eng = make()
        eng.warmup()
        inner, blocks = eng.programs.run, []

        def timed(k, greedy, inner=inner, blocks=blocks):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            toks = inner(k, greedy)
            end.record()
            blocks.append((k, start, end))
            return toks

        eng.programs.run = timed
        for rep in range(2):
            blocks.clear()
            eng.steps, eng.decode_tokens, eng.decode_time_s = 0, 0, 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run([Request(id=1000 * (rep + 1) + i, prompt=q, max_new_tokens=AB_LONG_NEW_TOKENS)
                     for i, q in enumerate(prompts)])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            steps = sum(k for k, _, _ in blocks)
            device_ms = sum(s.elapsed_time(e) for _, s, e in blocks)
            key = f"{what} {rep}"
            out[f"{key} decode tok/s"] = eng.decode_tokens / eng.decode_time_s
            out[f"{key} device ms a step"] = device_ms / steps
            out[f"{key} host ms a step"] = (eng.decode_time_s * 1e3 - device_ms) / steps
            print(f"[decode probe] {what} run {rep}: {eng.decode_tokens} tokens in {eng.decode_time_s:.4f} s of decode "
                  f"section = {out[f'{key} decode tok/s']:.1f} tok/s; {len(blocks)} blocks, {steps} steps, device "
                  f"{device_ms:.2f} ms = {device_ms / steps:.4f} ms a step; the section less the blocks' device time "
                  f"{out[f'{key} host ms a step']:.4f} ms a step; run {run_s:.3f} s ({card})", flush=True)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return {"ms": out["dense 1 device ms a step"], **out}


# A replayed chunk's device operations by group: the first group with a pattern in an operation's name (a
# tuple of strings matches where all of them are). "cache gathers and dequant": the dense chunk's reads of its
# cache as plain PyTorch, which the kernels now make in place: the ring's rows gathered by an advanced index
# (2-byte or 1-byte elements), a quantized slice by index_select, and the broadcast fp32 multiply by the scales
# (the payload's widen to fp32 and the round to bf16 around it are counted with the copies: their names are
# those of the cache writes' copies and of every cast). "strided bf16 copies": ``einsum``'s permute of ``wo``
# [H, D, M] (32 MB a layer) and of o, and the reshape of o's [B, T, H, D] transpose (2 MB a layer). The
# attention group's pattern also matches chunk_fwd_kernel (K1q, K1r). CHUNK_WRITE: the chunk's RoPE and cache write,
# F2c's one launch a layer, or a tree's F2 rotation and the write as plain PyTorch after it (the positions' arange
# and add, the quantizer's fills / abs / amax / divide / round / clamp, the ring's row arithmetic, the index
# assignments, the lengths' clone (memcpy32_post) and index_fill_; the casts to fp32 and to the payload are counted
# with the copies, whose names other operations share), so the two read as one line.
CHUNK_WRITE = "RoPE and the cache write (F2c; or F2 and the write's index, quantizer and length operations)"
WRITE_OPS = ("elementwise_kernel_with_index", "index_put", "index_fill", "AbsFunctor", "abs_kernel", "round_kernel")
CHUNK_GROUPS = (("K1 / K1q / K1r / K8 (fwd_kernel, chunk_fwd_kernel)", ("fwd_kernel",)), ("W2", ("w8_gemm_kernel",)),
                (CHUNK_WRITE, ("rope_kernel", "rope_chunk_kernel", *WRITE_OPS, "MaxOps", "MaxNanFunctor", "clamp",
                               "remainder", "where_kernel", "DivFunctor", "div_true", "CompareEqFunctor",
                               "CUDAFunctorOnSelf_add<long>", "FillFunctor<float>", "memcpy32_post")),
                ("F1, F3", ("add_rms_norm_kernel", "swiglu_act_kernel")),
                ("cuBLAS GEMMs", ("gemm", "nvjet", "xmma", "cutlass")),
                ("cache gathers and dequant", ("index_kernel_impl<at::native::OpaqueType<1>",
                                               "index_kernel_impl<at::native::OpaqueType<2>", "indexSelect",
                                               ("BinaryFunctor<float, float, float", "MulFunctor"))),
                ("strided bf16 copies", (("direct_copy_kernel", "elementwise_kernel<128, 4", "BFloat16"),)),
                ("copies", ("copy", "Memcpy", "Memset")), ("other elementwise and indexing", ("",)))


def chunk_group(name: str) -> str:
    """The CHUNK_GROUPS group of a device operation's name."""
    def hit(pat) -> bool:
        return all(pt in name for pt in ((pat,) if isinstance(pat, str) else pat))

    return next(group for group, pats in CHUNK_GROUPS if any(hit(pat) for pat in pats))


# prefill_profile's cells: (label, Mistral-7B's shape, the chunk's kv_end).
PROFILE_CELLS = (("5", False, 2048), ("11a", False, 2048), ("17a", True, 9216), ("17c", True, 9216))


def prefill_profile(card: str) -> dict:
    """Where a replayed prefill chunk's time goes: phase 5's (bf16), 11a's
    (int8 weights + int8 cache), 17a's (Mistral-7B's shape, the rolling
    dense ring of 4,352 rows) and 17c's (the same shape, the paged ring
    with 4 sinks) engines on fresh weights from seed 0, after ``warmup()``,
    each replaying its 256-token chunk program on slot 0 at kv_end 2048
    (5, 11a: the last chunk position) or 9216 (17a: the ring has wrapped;
    17c: the last) under ``utils/profiling.profile_op`` (device operations
    by name, busy share) and ``time_fn`` untraced. Prints the device time
    by group (``CHUNK_GROUPS``) beside the GEMMs' bound (2 x the layers'
    weights x 256 tokens over 989 TFLOP/s, the unembed included), and
    writes every operation's name, count and device ms to
    ``chiprun_out/prefill_profile_<tree>.json``. ``ms`` is phase 5's
    untraced replay."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    import chip_smoke as cs
    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params, quantize_model_weights
    from flash_attention_tpu_torch.serving.engine import ServingEngine
    from flash_attention_tpu_torch.serving.paged_engine import PagedServingEngine
    from flash_attention_tpu_torch.utils.benchmarking import time_fn
    from flash_attention_tpu_torch.utils.profiling import profile_op

    out, ops = {}, {}
    for label, mistral, kv_end in PROFILE_CELLS:
        base = ModelConfig(**cs.MISTRAL) if mistral else ModelConfig()
        params = init_model_params(torch.Generator(device="cuda").manual_seed(0), base)
        if label == "11a":
            params = quantize_model_weights(params)
            eng = ServingEngine(params, dataclasses.replace(base, kv_quant="int8", weight_quant="int8"), max_slots=8,
                                max_seq=2048, prefill_chunk=256)
        elif label == "17a":
            eng = ServingEngine(params, dataclasses.replace(base, rolling=True), max_slots=8, max_seq=16384,
                                prefill_chunk=256)
        elif mistral:
            eng = PagedServingEngine(params, dataclasses.replace(base, attention_sinks=cs.SINKS), max_slots=8,
                                     num_pages=297, pages_per_slot=72, page_size=128, prefill_chunk=256)
        else:
            eng = ServingEngine(params, base, max_slots=8, max_seq=2048, prefill_chunk=256)
        eng.warmup()
        tokens = np.random.default_rng(24).integers(0, base.vocab_size, (1, 256)).astype(np.int32)
        progs = eng.prefill_programs

        def replay():
            return progs.run(tokens, 0, kv_end)

        replays = progs.replays
        prof = profile_op(replay)
        untraced = min(time_fn(replay, warmup=3, iters=20, runs=3))
        if progs.replays == replays:
            raise RuntimeError(f"[prefill profile] phase {label}: the chunk did not replay")
        groups = dict.fromkeys((name for name, _ in CHUNK_GROUPS), 0.0)
        for op in prof["device_ops"]:
            groups[chunk_group(op["name"])] += op["device_s_per_call"] * 1e3
        ops[label] = [{"group": chunk_group(op["name"]), "name": op["name"], "count": op["count"],
                       "ms": op["device_s_per_call"] * 1e3} for op in prof["device_ops"]]
        per_layer = sum(t.numel() for t in cs._tensors(params["layers"][0]))
        flops = 2 * 256 * (base.num_layers * per_layer + base.vocab_size * base.model_dim)
        device_ms = sum(groups.values())
        top = "; ".join(f"{op['name'][:60]} x{op['count']:g} {op['device_s_per_call'] * 1e3:.3f}"
                        for op in prof["device_ops"][:8])
        print(f"[prefill profile] phase {label}: the (256, {kv_end}) chunk replayed, {untraced * 1e3:.3f} ms untraced, "
              f"{prof['wall_s_per_call'] * 1e3:.3f} ms traced, busy {prof['device_busy_share']:.4f}, device "
              f"{device_ms:.3f} ms in {sum(op['count'] for op in prof['device_ops']):g} operations: "
              + ", ".join(f"{k} {v:.3f}" for k, v in groups.items())
              + f"; the GEMMs' bound {flops / cs.PEAK_FLOPS * 1e3:.3f} ms ({flops / 1e12:.2f} TFLOP); top: {top} "
              f"({card})", flush=True)
        out[label] = {"ms": untraced * 1e3, "device ms": device_ms, "busy": prof["device_busy_share"],
                      **{f"ms {k}": v for k, v in groups.items()}}
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()
    dump = Path(__file__).resolve().parents[2] / "chiprun_out" / f"prefill_profile_{Path.cwd().name}.json"
    dump.parent.mkdir(exist_ok=True)
    dump.write_text(json.dumps({"card": card, "ops": ops}, indent=1))
    return {"ms": out["5"]["ms"], **{f"{k} {m}": v for k, row in out.items() for m, v in row.items()}}


SM90_SOURCES = ("flash_bwd_sm90.cu", "flash_fwd_sm90.cu", "chunk_fwd_sm90.cu")


def _kernel_label(line: str) -> str:
    """A kernel's name and template arguments from ptxas's mangled name:
    e.g. "dkv_kernel bf16 128 masked=0 fused=1", "fwd_kernel fp16 64 masked=1
    wgs=2", "tiled_kernel 128 bn=64 arith=0 skip=1 mask=2 grid=0" (bm first),
    "single_kernel 2 epi=1 mask=0 hb=1" (the stage first)."""
    import re

    m = re.search(r"(dq_kernel|dkv_kernel|split_sum_kernel|chunk_fwd_kernel|fwd_kernel|tiled_kernel|single_kernel)I"
                  r"(\w+?)EEv", line)
    if m is None:
        m = re.search(r"'_Z\w*?(decode_kernel|paged_write_kernel|paged_write_quant_kernel|sample_kernel)(I\w+?E)?",
                      line)
        return " ".join(filter(None, m.groups())) if m else line.strip()
    name, args = m.group(1), m.group(2).replace("13__nv_bfloat16", "bf16 ").replace("6__half", "fp16 ")
    flags = {"dq_kernel": ("masked",), "dkv_kernel": ("masked", "fused"), "fwd_kernel": ("masked", "wgs"),
             "chunk_fwd_kernel": ("masked",),
             "tiled_kernel": ("bn", "arith", "skip", "mask", "grid"), "single_kernel": ("epi", "mask", "hb")}.get(name, ())
    values = re.findall(r"L[ib](\d+)E", args)
    dims, rest = values[:1], values[1:]
    return " ".join(filter(None, [name, args.split()[0] if args.split() and not args.startswith("L") else "", *dims,
                                  *(f"{k}={v}" for k, v in zip(flags, rest))]))


def ptxas_sm90(card: str) -> None:
    """Compiles each tensor-core source (SM90_SOURCES, those the tree has)
    alone with the build's flags and ``-Xptxas -v``, all at once: prints the
    seconds each took and, for each kernel, its registers, spills, stack
    frame (local memory) and whether ptxas serialised its wgmma (C7515)."""
    _ptxas(card, SM90_SOURCES, "ptxas sm90")


def ptxas_probes(card: str) -> None:
    """``ptxas_sm90`` for the probes' bodies (csrc/probes.cu)."""
    _ptxas(card, ("probes.cu",), "ptxas probes")


def ptxas_decode(card: str) -> None:
    """``ptxas_sm90`` for the decode and page-write sources (K6, K7, K9, K10):
    every instantiation's registers and spills."""
    _ptxas(card, ("decode.cu", "paged_write.cu"), "ptxas decode")


def ptxas_w8(card: str) -> None:
    """``ptxas_sm90`` for the W8A16 products (csrc/w8.cu: W1, W2)."""
    _ptxas(card, ("w8.cu",), "ptxas w8")


def ptxas_sampling(card: str) -> None:
    """``ptxas_sm90`` for the sampler (csrc/sampling.cu: S1)."""
    _ptxas(card, ("sampling.cu",), "ptxas sampling")


def unchanged_rope(card: str) -> dict:
    """F2's decode form, which the chunk form must leave as it was, on
    seeded bf16 inputs: q [8,32,1,128] and k [8,8,1,128] at phase 25's
    decode positions with the row write into a dense [8,8,2048,128] cache,
    an int8 one and the 4352-row ring with 4 sinks (q, k, every cache
    tensor and the lengths), and the rotation alone over a 256-row chunk
    from position 70000. Prints a hash of each one's output bytes and its
    time, so two trees in one call can be held to the same bits; ``ms`` is
    the dense write's call."""
    import torch

    import chip_smoke as cs
    from flash_attention_tpu_torch.ops.fused import rope

    gen = torch.Generator(device="cuda").manual_seed(24)
    positions = torch.tensor(cs.FUSED_POSITIONS, dtype=torch.int32, device="cuda")[:, None, None]
    q = cs.torch_uniform((8, 1, 32, 128), torch.bfloat16, gen).transpose(1, 2)
    k, v = (cs.torch_uniform((8, 1, 8, 128), torch.bfloat16, gen).transpose(1, 2) for _ in range(2))
    out, times = {}, {}
    for kind in ("dense", "int8", "rolling + sinks"):
        cache, ring, sinks = cs._rope_cache(kind, torch.bfloat16, gen)
        pos = positions.clamp(max=cache.k.shape[2] - 1) if not ring else positions
        work = cs._clone_cache(cache)
        got = rope(q, k, pos, cache=work, v=v, ring=ring, sinks=sinks)
        out[kind] = _digest(got[0], got[1], *(t for t in got[2] if t is not None))
        # Again into the written copy: the same rows, and fresh lengths each call.
        times[kind] = cs.cuda_ms(lambda work=work, pos=pos, ring=ring, sinks=sinks: rope(
            q, k, pos, cache=work, v=v, ring=ring, sinks=sinks))
    qc, kc = (cs.torch_uniform((1, h, 256, 128), torch.bfloat16, gen) for h in (32, 8))
    chunk_pos = 70000 + torch.arange(256, device="cuda")[None, None, :]
    out["chunk rotation"] = _digest(*rope(qc, kc, chunk_pos))
    times["chunk rotation"] = cs.cuda_ms(lambda: rope(qc, kc, chunk_pos))
    print(f"[unchanged rope] F2's decode form, output hashes {out}; ms "
          + ", ".join(f"{key} {t:.4f}" for key, t in times.items()) + f" ({card})", flush=True)
    return {"ms": times["dense"], **times}


def ptxas_fused(card: str) -> None:
    """``ptxas_sm90`` for the glue (csrc/fused.cu: F1, F2, F2c, F3)."""
    _ptxas(card, ("fused.cu",), "ptxas fused")


def chunk_rope(card: str) -> dict:
    """Phase 25's F2c part alone (``chip_smoke._fused_rope_chunk``): F2's
    chunk form against its plain version over every cache form, then timed
    at phase 5's, 11a's, 17a's and 17c's forms. ``ms`` is the call at phase
    5's chunk."""
    import torch

    import chip_smoke as cs

    row = cs._fused_rope_chunk(card, torch.Generator(device="cuda").manual_seed(25))["F2c"]
    return {k: row[k] for k in ("ms", "plain_ms", "bound_ms")}


def _ptxas(card: str, names, tag: str) -> None:
    import re
    import tempfile
    import time

    from flash_attention_tpu_torch.ops import _build

    sources = [_build.CSRC_DIR / name for name in names if (_build.CSRC_DIR / name).exists()]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o",
                                   os.path.join(tmp, src.stem + ".o")], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for src in sources]
        outs = [(src, *proc.communicate(), time.perf_counter() - t0, proc.returncode) for src, proc in zip(sources, procs)]
    for src, stdout, _, secs, rc in outs:
        if rc:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{stdout}")
        lines, kernel, rows, spill, stack, serial = stdout.splitlines(), None, [], "0", "0", []
        for line in lines:
            if "Compiling entry function" in line:
                kernel = _kernel_label(line)
            elif "bytes spill stores" in line and kernel:
                spill = re.search(r"(\d+) bytes spill stores", line).group(1)
                stack = re.search(r"(\d+) bytes stack frame", line).group(1)
            elif "Used" in line and "registers" in line and kernel:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                rows.append(f"{kernel}: {regs} registers, {spill} B spilled, {stack} B stack")
            if "C7515" in line:
                serial.append(kernel)
        print(f"[{tag}] {src.name} compiled alone in {secs:.1f} s; {len(rows)} kernels; wgmma serialised in "
              f"{len(serial)} {serial}; " + "; ".join(rows) + f" ({card})", flush=True)


def _model(cfg):
    import torch

    from flash_attention_tpu_torch.models.transformer import init_model_params

    return init_model_params(torch.Generator(device="cuda").manual_seed(0), cfg)


def full_train(card: str) -> dict:
    """Phase 14 (ModelConfig() trained at B=1, T=2048, then the 4-layer MHA
    step) on fresh weights from seed 0."""
    import chip_smoke as cs
    from flash_attention_tpu_torch.models.transformer import ModelConfig

    return cs.phase_full_train(card, _model(ModelConfig()))


def sampling(card: str):
    """Phase 5's sampling check and decode-step times on fresh ModelConfig()
    weights from seed 0 (S1's times since csrc/sampling.cu)."""
    import chip_smoke as cs
    from flash_attention_tpu_torch.models.transformer import ModelConfig

    return cs.phase_sampling(card, _model(ModelConfig()))


def s1_split(card: str) -> dict:
    """S1 at phase 5's 8 x 32,000 by what its rows ask for, each timed as
    chip_smoke.py's ``_three_times`` does (a call, alone in a CUDA graph of
    10 calls, host us): every row greedy (the max alone), top_k 40 (the
    selects, few elements drawn), top_k 0 and top_p 1 (the selects, every
    element drawn), phase 5's rows, and those in the detail mode; then
    phase 5's rows at 1 and 32 rows and at vocab 128,256 and 256,000. ``ms``
    is phase 5's rows alone."""
    import torch

    import chip_smoke as cs
    from flash_attention_tpu_torch.serving.sampling import sample_tokens, sample_tokens_detail

    gen = torch.Generator(device="cuda").manual_seed(5)
    base = {key: t.cuda() for key, t in cs._sampling_inputs(1025).items()}

    def rows(batch, **fixed):
        out = {key: t.repeat((batch + 7) // 8)[:batch] for key, t in base.items()}
        out.update({key: torch.full((batch,), v, dtype=out[key].dtype, device="cuda") for key, v in fixed.items()})
        return out

    cases = {
        "greedy": (8, 32000, rows(8, temperature=0.0), sample_tokens),
        "top_k 40": (8, 32000, rows(8, top_k=40, top_p=1.0, temperature=1.0), sample_tokens),
        "every element drawn": (8, 32000, rows(8, top_k=0, top_p=1.0, temperature=1.0), sample_tokens),
        "phase 5": (8, 32000, rows(8), sample_tokens),
        "phase 5 detail": (8, 32000, rows(8), sample_tokens_detail),
        "phase 5 at 1 row": (1, 32000, rows(1), sample_tokens),
        "phase 5 at 32 rows": (32, 32000, rows(32), sample_tokens),
        "phase 5 at vocab 128256": (8, 128256, rows(8), sample_tokens),
        "phase 5 at vocab 256000": (8, 256000, rows(8), sample_tokens),
    }
    out = {}
    for key, (batch, vocab, r, fn) in cases.items():
        logits = torch.randn((batch, vocab), generator=gen, device="cuda") * 3
        ms, alone, host_us = cs._three_times(lambda: fn(logits, **r))
        print(f"[s1 split] {key} [{batch}, {vocab}]: call {ms:.4f} ms, alone {alone:.4f} ms, host {host_us:.1f} us "
              f"({card})", flush=True)
        out[f"{key} alone"] = alone
    return {"ms": out["phase 5 alone"], **out}


def mistral_steps(card: str) -> dict:
    """Two steps of phase 20a (Mistral-7B's shape, window 4096, B=1, T=8192)
    on fresh weights from seed 0: step times and peak memory."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from flash_attention_tpu_torch.models.transformer import ModelConfig

    cfg = ModelConfig(**cs.MISTRAL)
    rng = np.random.default_rng(20)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, cs.TRAIN_T + 1))).cuda() for _ in range(2)]
    return cs._train_steps(card, "[mistral steps] window 4096", _model(cfg), cfg, batches, used=("K1", "K4m", "K5m"))


def _bwd_args(q, k, v, do, **masks):
    """The backward launchers' arguments from the forward's residuals."""
    import torch

    from flash_attention_tpu_torch.ops.attention_bwd import _delta, _guard_lse
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention

    with torch.no_grad():
        out, lse = flash_attention(q, k, v, causal=True, save_residuals=True, **masks)
    return (q, k, v, do, _guard_lse(lse).contiguous(), _delta(out, do).contiguous())


def mistral_bwd(card: str) -> dict:
    """K4m + K5m at phase 20a's attention shape (q [1,32,8192,128], kv
    [1,8,8192,128], window 4096, bf16) and the unmasked causal K4 + K5 at the
    same shape, each timed alone on the forward's residuals; ``ms`` is K4m +
    K5m."""
    import chip_smoke as cs
    import torch

    from flash_attention_tpu_torch.ops.attention_bwd import BwdMasks, launch_dkv, launch_dq

    q, k, v, do = cs._bwd_inputs(18, 32, 8, cs.TRAIN_T, cs.TRAIN_T, 128, torch.bfloat16)
    args = _bwd_args(q, k, v, do, sliding_window=cs.WINDOW)
    kw = dict(causal=True, sm_scale=128**-0.5, masks=BwdMasks(cs.WINDOW, None, None, q.device))
    t = {"K4m": cs.cuda_ms(lambda: launch_dq(*args, **kw)), "K5m": cs.cuda_ms(lambda: launch_dkv(*args, **kw))}
    args = _bwd_args(q, k, v, do)
    kw = dict(causal=True, sm_scale=128**-0.5)
    t["K4"], t["K5"] = cs.cuda_ms(lambda: launch_dq(*args, **kw)), cs.cuda_ms(lambda: launch_dkv(*args, **kw))
    print(f"[mistral bwd] q [1,32,{cs.TRAIN_T},128] kv [1,8,{cs.TRAIN_T},128] bf16: window {cs.WINDOW} K4m "
          f"{t['K4m']:.4f} ms + K5m {t['K5m']:.4f} ms = {t['K4m'] + t['K5m']:.4f} ms; causal K4 {t['K4']:.4f} + K5 "
          f"{t['K5']:.4f} = {t['K4'] + t['K5']:.4f} ms ({card})", flush=True)
    return {"ms": t["K4m"] + t["K5m"], **t}


def mistral_attn(card: str) -> dict:
    """K1 and K3m at phase 20's attention shapes, bf16: K1 with LSE at window
    4096 over q [1,32,8192,128] kv [1,8,8192,128] (20a), K1d there packed as
    documents PACKED_DOCS (20b), and K3m at 20d's shape (q = kv
    [1,32,8192,128], window 4096, packed) alone on the plain forward's
    residuals; ``ms`` is K1's at window 4096."""
    import chip_smoke as cs
    import torch

    from flash_attention_tpu_torch.ops.attention_bwd import BwdMasks, _delta, _guard_lse, launch_fused
    from flash_attention_tpu_torch.ops.common import segment_pair
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    t = {}
    ids = cs._packed_ids(cs.PACKED_DOCS)
    q, k, v, _ = cs._bwd_inputs(18, 32, 8, cs.TRAIN_T, cs.TRAIN_T, 128, torch.bfloat16)
    kw = dict(causal=True, sliding_window=cs.WINDOW, save_residuals=True)
    with torch.no_grad():
        t["K1 window"] = cs.cuda_ms(lambda: flash_attention(q, k, v, **kw))
        t["K1d packed"] = cs.cuda_ms(lambda: flash_attention(q, k, v, segment_ids=ids, **kw))
    del q, k, v
    q, k, v, do = cs._bwd_inputs(20, 32, 32, cs.TRAIN_T, cs.TRAIN_T, 128, torch.bfloat16)
    segments = segment_pair(ids, 1, cs.TRAIN_T, cs.TRAIN_T)
    outs, lses = [], []
    with torch.no_grad():
        for h in range(0, 32, 4):  # the plain forward's fp32 scores a few heads at a time
            o, l = flash_attention_plain(q[:, h:h + 4], k[:, h:h + 4], v[:, h:h + 4], causal=True, sm_scale=128**-0.5,
                                         save_residuals=True, sliding_window=cs.WINDOW, segments=segments)
            outs.append(o.to(q.dtype))
            lses.append(l)
    out, lse = torch.cat(outs, 1), torch.cat(lses, 1)
    args = (q, k, v, do, _guard_lse(lse).contiguous(), _delta(out, do).contiguous())
    masks = BwdMasks(cs.WINDOW, None, segments, q.device)
    t["K3m"] = cs.cuda_ms(lambda: launch_fused(*args, causal=True, sm_scale=128**-0.5, masks=masks))
    print(f"[mistral attn] bf16, T={cs.TRAIN_T}, window {cs.WINDOW}: K1 + LSE (32/8 heads) {t['K1 window']:.4f} ms, "
          f"K1d packed {cs.PACKED_DOCS} {t['K1d packed']:.4f} ms; K3m (q = kv 32 heads, packed) {t['K3m']:.4f} ms "
          f"({card})", flush=True)
    return {"ms": t["K1 window"], **t}


def bwd_split(card: str) -> dict:
    """K4 and K5 at phase 12's shape (q [1,32,2048,128] kv [1,8,2048,128],
    causal, bf16) and K4m and K5m at phase 20a's (q [1,32,8192,128] kv
    [1,8,8192,128], window 4096), each timed three ways, as ``k6_split``
    times K6: ``ms`` as chip_smoke.py times a wrapper call, the kernel alone
    from a CUDA graph of 10 calls replayed, and the wrapper's host time a
    call (200 calls enqueued without a synchronisation). ``ms`` is K4 + K5's
    wrapper time, ``device_ms`` their graph time."""
    import chip_smoke as cs
    import torch

    from flash_attention_tpu_torch.ops.attention_bwd import BwdMasks, launch_dkv, launch_dq

    rows = {}
    for label, seq, window in (("causal T=2048", 2048, None), (f"window {cs.WINDOW} T={cs.TRAIN_T}", cs.TRAIN_T, cs.WINDOW)):
        q, k, v, do = cs._bwd_inputs(12, 32, 8, seq, seq, 128, torch.bfloat16)
        args = _bwd_args(q, k, v, do, sliding_window=window)
        kw = dict(causal=True, sm_scale=128**-0.5)
        if window is not None:
            kw["masks"] = BwdMasks(window, None, None, q.device)
        for name, fn in (("K4", launch_dq), ("K5", launch_dkv)):
            rows[f"{name} {label}"] = _split_times(lambda fn=fn: fn(*args, **kw))
    print("[bwd split] " + "; ".join(f"{key}: wrapper {ms:.4f} ms, kernel alone {dev:.4f} ms (CUDA graph of 10), host "
                                     f"{host:.1f} us a call" for key, (ms, dev, host) in rows.items()) + f" ({card})",
          flush=True)
    pair = [rows["K4 causal T=2048"], rows["K5 causal T=2048"]]
    return {"ms": pair[0][0] + pair[1][0], "device_ms": pair[0][1] + pair[1][1]}


def _digest(*tensors) -> str:
    """A hash of the tensors' bytes."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def _plain_args(q, k, v, do):
    """The backward launchers' arguments from the plain forward's residuals
    (causal), so a backward's inputs do not depend on the forward kernel
    under test."""
    import torch

    from flash_attention_tpu_torch.ops.attention_bwd import _delta, _guard_lse
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention_plain

    with torch.no_grad():
        out, lse = flash_attention_plain(q, k, v, causal=True, sm_scale=q.shape[-1] ** -0.5, save_residuals=True)
    return (q, k, v, do, _guard_lse(lse).contiguous(), _delta(out.to(q.dtype), do).contiguous())


def unchanged_bwd(card: str) -> dict:
    """The backward kernels K1 and K3's redesign leaves as they were, on
    seeded inputs and the plain forward's residuals: K4 and K5 in bf16 (q
    [1,32,2048,128] kv [1,8,2048,128], causal, K5 split with its sum K5s),
    the fp32 K3 (dk and dv of q = kv [1,8,1024,64]; its dq sums with atomics
    in a run-dependent order) and the fp32 K4 and K5 (q [1,8,1024,64] kv
    [1,2,1024,64]). Prints each one's time and a hash of its output bytes,
    so two trees in one call can be held to the same results and times;
    ``ms`` is K4 + K5's."""
    import chip_smoke as cs
    import torch

    from flash_attention_tpu_torch.ops.attention_bwd import launch_dkv, launch_dq, launch_fused

    out, times = {}, {}
    q, k, v, do = cs._bwd_inputs(12, 32, 8, 2048, 2048, 128, torch.bfloat16)
    args, kw = _plain_args(q, k, v, do), dict(causal=True, sm_scale=128**-0.5)
    out["K4"], out["K5"] = _digest(launch_dq(*args, **kw)), _digest(*launch_dkv(*args, **kw))
    times["K4"] = cs.cuda_ms(lambda: launch_dq(*args, **kw))
    times["K5"] = cs.cuda_ms(lambda: launch_dkv(*args, **kw))
    q, k, v, do = cs._bwd_inputs(13, 8, 8, 1024, 1024, 64, torch.float32)
    args, kw = _plain_args(q, k, v, do), dict(causal=True, sm_scale=64**-0.5)
    out["fp32 K3 dk, dv"] = _digest(*launch_fused(*args, **kw)[1:])
    times["fp32 K3"] = cs.cuda_ms(lambda: launch_fused(*args, **kw))
    q, k, v, do = cs._bwd_inputs(13, 8, 2, 1024, 1024, 64, torch.float32)
    args = _plain_args(q, k, v, do)
    out["fp32 K4"], out["fp32 K5"] = _digest(launch_dq(*args, **kw)), _digest(*launch_dkv(*args, **kw))
    times["fp32 K4"] = cs.cuda_ms(lambda: launch_dq(*args, **kw))
    times["fp32 K5"] = cs.cuda_ms(lambda: launch_dkv(*args, **kw))
    print(f"[unchanged bwd] output hashes {out}; ms " + ", ".join(f"{k} {t:.4f}" for k, t in times.items())
          + f" ({card})", flush=True)
    return {"ms": times["K4"] + times["K5"], **times}


def unchanged_fwd(card: str) -> dict:
    """The forward kernels the K2 / K8 redesign must leave bit-identical, on
    seeded inputs: the fp32 K1 (causal with LSE, q [1,8,1024,64] kv
    [1,2,1024,64]), K2 (window 64, q = kv [1,8,1024,64], with LSE) and K8
    (q [1,8,256,64] over slot 1's shuffled pages [33,2,128,64] to kv_end
    2048) on the FMA body, and the bf16 K1 and K1d (documents {900, 700,
    448}) with LSE at phase 12's training shape, q [1,32,2048,128] kv
    [1,8,2048,128]. Prints each one's time and a hash of its output bytes;
    ``ms`` is the bf16 K1's."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention
    from flash_attention_tpu_torch.ops.paged import paged_prefill_attention
    from flash_attention_tpu_torch.utils.testing import make_qkv

    f32, out, times = torch.float32, {}, {}
    gen, rng = torch.Generator(device="cuda").manual_seed(9), np.random.default_rng(9)
    calls = {}
    q, k, v = make_qkv(13, 1, 8, 1024, 64, num_kv_heads=2, dtype=f32, device="cuda")
    calls["fp32 K1"] = lambda q=q, k=k, v=v: flash_attention(q, k, v, causal=True, save_residuals=True)
    q2, k2, v2 = make_qkv(14, 1, 8, 1024, 64, dtype=f32, device="cuda")
    calls["fp32 K2"] = lambda: flash_attention(q2, k2, v2, causal=True, sliding_window=64, save_residuals=True)
    cache = cs._filled_cache(1, num_pages=33, num_slots=2, pages_per_slot=16, kv_heads=2, head_dim=64, dtype=f32,
                             gen=gen).layers()[0]
    cache.page_table.copy_(torch.from_numpy(cs._shuffled_table(rng, 2, 16, 33)).cuda())
    qc = cs.torch_uniform((1, 8, 256, 64), f32, gen)
    calls["fp32 K8"] = lambda: paged_prefill_attention(qc, cache, 1, 2048, chunk_len=256)
    qb, kb, vb = make_qkv(12, 1, 32, 2048, 128, num_kv_heads=8, dtype=torch.bfloat16, device="cuda")
    ids = torch.tensor([0] * 900 + [1] * 700 + [2] * 448, dtype=torch.int32, device="cuda")[None]
    calls["bf16 K1"] = lambda: flash_attention(qb, kb, vb, causal=True, save_residuals=True)
    calls["bf16 K1d"] = lambda: flash_attention(qb, kb, vb, causal=True, segment_ids=ids, save_residuals=True)
    with torch.no_grad():
        for key, call in calls.items():
            got = call()
            out[key] = _digest(*_tensors(got))
            times[key] = cs.cuda_ms(call)
    print(f"[unchanged fwd] output hashes {out}; ms " + ", ".join(f"{k} {t:.4f}" for k, t in times.items())
          + f" ({card})", flush=True)
    return {"ms": times["bf16 K1"], **times}


def probe_split(card: str) -> dict:
    """The six probes' stand-in variants (PERF.md section 6), 32 heads,
    head_dim 128, bf16: P1 (body T, causal 128x64, fp32 softmax, q scaled)
    and P3 (128x128 head-major, unmasked) and P4 (128x128 skip + cond) at
    seq 8192; P2 (body S, full), P5 (body S after_pv launched bare into a
    preallocated output) and P6 (after_pv) at seq 1024. Each is timed by the
    probes' own timer (``probes.graphed_s``: CUDA-graph replay, the kernel
    alone), and as ``_split_times`` does (the wrapper call, a CUDA graph of
    10 calls, the wrapper's host µs), beside SDPA on the same inputs
    (graphed) and the bound. K1 at P3's shape (``gap_probe.bare_k1``:
    non-causal, scale2 1, which is P3's function) is timed the same ways.
    ``ms`` and ``device_ms`` are P3's call and graph times."""
    import math

    import torch

    from flash_attention_tpu_torch.ops.common import LOG2E
    from flash_attention_tpu_torch.tools import gap_probe, probes

    heads, d = 32, probes.HEAD_DIM
    sm_scale = 1.0 / math.sqrt(d)
    scale2 = sm_scale * LOG2E
    rows = {}

    def row(name, call, seq, causal, sdpa_scale, pairs, q, k, v):
        ms, device_ms, host_us = _split_times(call)
        graph_ms = probes.graphed_s(call) * 1e3
        sdpa_ms = probes.graphed_s(lambda: probes.sdpa(q, k, v, causal=causal, sm_scale=sdpa_scale)) * 1e3
        bound, by = probes.bound_ms(pairs, heads, seq)
        rows[name] = {"graph_ms": graph_ms, "ms": ms, "device_ms": device_ms, "host_us": host_us, "sdpa_ms": sdpa_ms,
                      "bound_ms": bound}
        print(f"[probe split] {name}: graphed {graph_ms:.4f} ms ({4 * pairs * heads * d / graph_ms / 1e9:.1f} TFLOP/s), "
              f"call {ms:.4f} ms, graph of 10 {device_ms:.4f} ms, host {host_us:.1f} us; SDPA {sdpa_ms:.4f} ms "
              f"(x{graph_ms / sdpa_ms:.2f}); bound {bound:.4f} ms ({by}) ({card})", flush=True)

    seq = 8192
    q, k, v = probes.make_inputs(heads, seq)
    qs = (q.float() * scale2).to(q.dtype)
    causal_pairs, full_pairs = seq * (seq + 1) // 2, seq * seq
    row("P1 c=1 128x64 f32", lambda: probes.probe_tiled(qs, k, v, bm=128, bn=64, skip=True, mask="always"), seq, True,
        sm_scale, causal_pairs, q, k, v)
    row("P3 128x128 par", lambda: probes.probe_tiled(q, k, v, bm=128, bn=128), seq, False, math.log(2), full_pairs,
        q, k, v)
    row("P4 128x128 skip=1 mask=cond", lambda: probes.probe_tiled(q, k, v, bm=128, bn=128, skip=True, mask="cond"), seq,
        True, math.log(2), causal_pairs, q, k, v)
    q4, k4, v4, out4 = q[None], k[None], v[None], torch.empty_like(q[None])
    row("K1 at P3's shape", lambda: gap_probe.bare_k1(q4, k4, v4, out4, 1.0), seq, False, math.log(2), full_pairs,
        q, k, v)
    del q, k, v, qs, q4, k4, v4, out4
    seq = 1024
    q, k, v = probes.make_inputs(heads, seq)
    out = torch.empty_like(q)
    full_pairs = seq * seq

    def bare_s():
        probes.launch_single(q, k, v, out, scale2, stage="softmax", epilogue="after_pv", mask=False, hb=1)
        return out

    row("P2 full", lambda: probes.probe_single(q, k, v, scale2), seq, False, sm_scale, full_pairs, q, k, v)
    row("P5 bare S", bare_s, seq, False, sm_scale, full_pairs, q, k, v)
    row("P6 after_pv", lambda: probes.probe_single(q, k, v, scale2, epilogue="after_pv"), seq, False, sm_scale,
        full_pairs, q, k, v)
    p3 = rows["P3 128x128 par"]
    return {"ms": p3["ms"], "device_ms": p3["graph_ms"],
            **{f"{name} {key}": t for name, r in rows.items() for key, t in r.items()}}


def _split_times(call, calls: int = 10) -> tuple[float, float, float]:
    """``call`` timed as chip_smoke.py times a wrapper call, alone in a CUDA
    graph of ``calls`` calls replayed, and as the wrapper's host time a call
    (200 calls enqueued without a synchronisation): (ms, device_ms,
    host_us)."""
    import time

    import chip_smoke as cs
    import torch

    ms = cs.cuda_ms(call, iters=50)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            call()
    device_ms = cs.cuda_ms(graph.replay) / calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        call()
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    return ms, device_ms, host_us


def fwd_split(card: str) -> dict:
    """K1 with its LSE, bf16, at phase 3's chunk shape (q [1,32,256,128]
    over kv 2048 of slot 3 of a [8,8,2048,128] cache, a strided view) and at
    phase 14's training shape (q [1,32,2048,128] kv [1,8,2048,128]), each
    timed three ways (``_split_times``): the wrapper, the kernel alone in a
    CUDA graph, the wrapper's host time a call. ``ms`` and ``device_ms`` are
    the chunk's."""
    import torch

    from flash_attention_tpu_torch.ops.flash_attention import flash_attention
    from flash_attention_tpu_torch.utils.testing import make_qkv

    rows = {}
    q, k, v = make_qkv(1, 1, 32, 256, 128, num_kv_heads=8, kv_seq=2048, dtype=torch.bfloat16, device="cuda")
    k_cache = torch.zeros((8, 8, 2048, 128), dtype=torch.bfloat16, device="cuda")
    v_cache = torch.zeros_like(k_cache)
    k_cache[3], v_cache[3] = k[0], v[0]
    k, v = k_cache[3:4], v_cache[3:4]
    with torch.no_grad():
        rows["chunk q 256 over kv 2048"] = _split_times(lambda: flash_attention(q, k, v, causal=True,
                                                                                 save_residuals=True))
        q, k, v = make_qkv(12, 1, 32, 2048, 128, num_kv_heads=8, dtype=torch.bfloat16, device="cuda")
        rows["T=2048"] = _split_times(lambda: flash_attention(q, k, v, causal=True, save_residuals=True))
    print("[fwd split] K1 + LSE " + "; ".join(f"{key}: wrapper {ms:.4f} ms, kernel alone {dev:.4f} ms (CUDA graph of "
                                              f"10), host {host:.1f} us a call" for key, (ms, dev, host) in rows.items())
          + f" ({card})", flush=True)
    ms, device_ms, host_us = rows["chunk q 256 over kv 2048"]
    return {"ms": ms, "device_ms": device_ms, "host_us": host_us}


def prefill_split(card: str) -> dict:
    """K8, K8q and K2 at their chip_smoke.py shapes, bf16, each timed three
    ways (``_split_times``: the wrapper call, the kernel alone in a CUDA
    graph of 10 calls, the wrapper's host time a call): K8 q [1,32,256,128]
    over slot 7's shuffled pages [129,8,128,128] to kv_end 2048 (phase 6),
    K8 with window 4096 and 4 sinks over phase 15's paged ring to kv_end
    9000, K8q e4m3 to kv_end 2048 (phase 9), K2 at window 64 over q = kv
    [1,32,2048,128] with its LSE (phase 15). ``ms`` and ``device_ms`` are
    K8's at kv_end 2048."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention
    from flash_attention_tpu_torch.ops.paged import paged_prefill_attention
    from flash_attention_tpu_torch.utils.testing import make_qkv

    bf16, dev, rows = torch.bfloat16, torch.device("cuda"), {}
    gen, rng = torch.Generator(device=dev).manual_seed(7), np.random.default_rng(7)
    cache = cs._filled_cache(1, num_pages=129, num_slots=8, pages_per_slot=16, kv_heads=8, head_dim=128, dtype=bf16,
                             gen=gen).layers()[0]
    cache.page_table.copy_(torch.from_numpy(cs._shuffled_table(rng, 8, 16, 129)).to(dev))
    qc = cs.torch_uniform((1, 32, 256, 128), bf16, gen)
    rows["K8 kv_end 2048"] = _split_times(lambda: paged_prefill_attention(qc, cache, 7, 2048, chunk_len=256))
    layer = cs._quant_pages("fp8_e4m3", 1, 129, 8, 16, gen, rng)[0].layers()[0]
    rows["K8q e4m3 kv_end 2048"] = _split_times(lambda: paged_prefill_attention(qc, layer, 7, 2048, chunk_len=256))
    del cache, layer
    page, per_slot = 128, 72
    n_ring = -(-(cs.WINDOW + 256) // page) + 2
    table, num_pages = cs._ring_table(np.random.default_rng(15), 8, per_slot, n_ring, sinks=True)
    ring = cs._filled_cache(1, num_pages=num_pages, num_slots=8, pages_per_slot=per_slot, kv_heads=8, head_dim=128,
                            dtype=bf16, gen=gen).layers()[0]
    ring.page_table.copy_(torch.from_numpy(table).to(dev))
    kw = dict(sliding_window=cs.WINDOW, attention_sinks=cs.SINKS)
    rows["K8 window 4096 + 4 sinks, kv_end 9000"] = _split_times(
        lambda: paged_prefill_attention(qc, ring, 6, 9000, chunk_len=256, **kw))
    del ring
    q, k, v = make_qkv(17, 1, 32, 2048, 128, num_kv_heads=32, dtype=bf16, device=dev)
    with torch.no_grad():
        rows["K2 window 64"] = _split_times(
            lambda: flash_attention(q, k, v, causal=True, sliding_window=64, save_residuals=True))
    print("[prefill split] " + "; ".join(f"{key}: wrapper {ms:.4f} ms, kernel alone {d:.4f} ms (CUDA graph of 10), "
                                         f"host {host:.1f} us a call" for key, (ms, d, host) in rows.items())
          + f" ({card})", flush=True)
    ms, device_ms, host_us = rows["K8 kv_end 2048"]
    return {"ms": ms, "device_ms": device_ms, "host_us": host_us,
            **{f"{key} {m}": t for key, row in rows.items() for m, t in zip(("ms", "device_ms", "host_us"), row)}}


def cache_split(card: str) -> dict:
    """A prefill chunk's attention over its slot of a dense cache, on any
    tree, q [1,32,256,128] bf16 at slot 7: K1 over the slot of an [8, 8,
    2048, 128] bf16 cache by ``kv_batch`` (kv_end 2048); the same cache
    quantized to int8 (11a) at kv_end 2048; 17a's ring of 4352 rows (4480
    with 4 sinks) at kv_end 9000, window 4096. Over the int8 cache and the
    ring, the chain the parent's chunk prefill ran (the slot's rows copied
    out by index_select or an advanced index in position order, int8 widened
    and scaled and rounded to bf16, then K1; with sinks past the window the
    band and sink passes merged by ``merge_two``) and, on a tree that has
    it, ``cache_attention`` (K1q, K1r). Each timed by ``_split_times``: the
    call, alone in a CUDA graph of 10 calls, host us a call. ``ms`` and
    ``device_ms`` are the int8 slot's on this tree's path."""
    import torch

    import chip_smoke as cs
    from flash_attention_tpu_torch.ops import flash_attention as fa
    from flash_attention_tpu_torch.ops.merge import merge_two
    from flash_attention_tpu_torch.ops.quant import quantize_values

    dev, bf16, rows = torch.device("cuda"), torch.bfloat16, {}
    gen = torch.Generator(device=dev).manual_seed(9)
    q = cs.torch_uniform((1, 32, 256, 128), bf16, gen)
    slot = torch.tensor([7], dtype=torch.int32, device=dev)
    new = hasattr(fa, "cache_attention")
    k, v = (cs.torch_uniform((8, 8, 2048, 128), bf16, gen) for _ in range(2))
    rows["K1 bf16 slot, kv_end 2048"] = _split_times(
        lambda: fa.flash_attention(q, k[:, :, :2048], v[:, :, :2048], causal=True, kv_batch=slot))
    (kp, ks), (vp, vs) = (quantize_values(x.float(), torch.int8) for x in (k, v))
    del k, v

    def deq(x, sc):
        return (x.float() * sc).to(bf16)

    def chain_quant():
        kq, vq = (deq(x[:, :, :2048].index_select(0, slot), sc[:, :, :2048].index_select(0, slot))
                  for x, sc in ((kp, ks), (vp, vs)))
        return fa.flash_attention(q, kq, vq, causal=True)

    rows["int8 slot, kv_end 2048: copy + dequant + K1"] = _split_times(chain_quant)
    if new:
        rows["int8 slot, kv_end 2048: K1q"] = _split_times(
            lambda: fa.cache_attention(q, kp, vp, slot, 2048, k_scales=ks, v_scales=vs))
    del kp, ks, vp, vs
    heads = torch.arange(8, device=dev)
    for sinks in (0, cs.SINKS):
        n = cs.RING_ROWS + (128 if sinks else 0)
        k, v = (cs.torch_uniform((8, 8, n, 128), bf16, gen) for _ in range(2))

        # The rows of the positions each pass reads, made before the timed calls (a graph captures no copy
        # from the host).
        window, kv_end = cs.WINDOW, 9000
        g = min(window + 256, kv_end - sinks)
        band, sink = (torch.tensor([cs._ring_row(p, n, sinks) for p in range(lo, hi)], dtype=torch.long,
                                   device=dev)
                      for lo, hi in ((kv_end - g, kv_end), (0, sinks)))

        def gather(idx, k=k, v=v):
            return tuple(x[slot[:, None, None], heads[None, :, None], idx[None, None, :]] for x in (k, v))

        def chain_ring(sinks=sinks, band=band, sink=sink):
            if not sinks:
                return fa.flash_attention(q, *gather(band), causal=True, sliding_window=window)
            o_b, l_b = fa.flash_attention(q, *gather(band), causal=True, sliding_window=window, save_residuals=True)
            o_s, l_s = fa.flash_attention(q, *gather(sink), save_residuals=True)
            return merge_two(o_b, l_b, o_s, l_s)[0]

        label = f"ring of {n} rows{f', {sinks} sinks' if sinks else ''}, kv_end 9000"
        rows[f"{label}: gather + K1{' x2 + merge' if sinks else ''}"] = _split_times(chain_ring)
        if new:
            rows[f"{label}: K1r"] = _split_times(lambda sinks=sinks, k=k, v=v: fa.cache_attention(
                q, k, v, slot, kv_end, ring=True, sinks=sinks, sliding_window=window))
        del k, v
    print("[cache split] " + "; ".join(f"{key}: call {ms:.4f} ms, alone {d:.4f} ms (CUDA graph of 10), host "
                                       f"{host:.1f} us" for key, (ms, d, host) in rows.items()) + f" ({card})",
          flush=True)
    ms, device_ms, host_us = rows["int8 slot, kv_end 2048: K1q" if new else
                                  "int8 slot, kv_end 2048: copy + dequant + K1"]
    return {"ms": ms, "device_ms": device_ms, "host_us": host_us,
            **{f"{key} {m}": t for key, row in rows.items() for m, t in zip(("ms", "device_ms", "host_us"), row)}}


def chunk_split_sweep(card: str) -> dict:
    """csrc/chunk_fwd_sm90.cu alone in a CUDA graph of 10 calls at every
    cluster size 1-8, through its C entry (which takes the cluster size
    that ``cache_attention`` picks by ``chunk_splits``), at cache_split's
    shapes: q [1,32,256,128] bf16 over slot 7 of an int8 [8,8,2048,128]
    cache at kv_end 2048 (K1q), of the same cache in bf16 (K1's function,
    which ``cache_attention`` sends to K1: the body's 16-bit dense
    instantiation, for comparison) and of 17a's 4352-row bf16 ring at
    kv_end 9000 (K1r), each held to the split the wrapper picks, bit for bit
    when the split is the same and within the plain version's row-relative
    bar otherwise; then K1q and K1r at kv_end 256 (walks of 1-4 tiles: the
    body's fixed cost) at the wrapper's split. ``ms`` is K1q's at the
    wrapper's split."""
    import torch

    import chip_smoke as cs
    from flash_attention_tpu_torch.ops import _build
    from flash_attention_tpu_torch.ops import flash_attention as fa
    from flash_attention_tpu_torch.ops.common import LOG2E, ring_layout, sm_count
    from flash_attention_tpu_torch.ops.quant import quantize_values

    dev, bf16, rows = torch.device("cuda"), torch.bfloat16, {}
    gen = torch.Generator(device=dev).manual_seed(9)
    q = cs.torch_uniform((1, 32, 256, 128), bf16, gen)
    slot = torch.tensor([7], dtype=torch.int32, device=dev)
    picked = fa.chunk_splits(8, 256, 4, sm_count(dev))
    k16, v16 = (cs.torch_uniform((8, 8, 2048, 128), bf16, gen) for _ in range(2))
    (kp, ks), (vp, vs) = (quantize_values(x.float(), torch.int8) for x in (k16, v16))
    ring_k, ring_v = (cs.torch_uniform((8, 8, cs.RING_ROWS, 128), bf16, gen) for _ in range(2))
    out = torch.empty_like(q)
    for label, k, v, scales, kv_end, ring in (
            ("K1q int8 kv_end 2048", kp, vp, (ks, vs), 2048, False),
            ("bf16 dense kv_end 2048", k16, v16, (None, None), 2048, False),
            ("K1r ring 4352 rows kv_end 9000", ring_k, ring_v, (None, None), 9000, True),
            ("K1q int8 kv_end 256", kp, vp, (ks, vs), 256, False),
            ("K1r ring 4352 rows kv_end 256", ring_k, ring_v, (None, None), 256, True)):
        sc = [None if x is None else x.reshape(x.shape[:3]) for x in scales]
        strides = [0] * 6 if sc[0] is None else [*sc[0].stride(), *sc[1].stride()]
        ring_mod, ring_base = ring_layout(k.shape[2], 0) if ring else (0, 0)
        payload = _build.PAYLOAD_CODES.get(k.dtype, _build.DTYPE_CODES[bf16])

        def call(splits, k=k, v=v, sc=sc, strides=strides, kv_end=kv_end, ring_mod=ring_mod, ring_base=ring_base,
                 payload=payload, ring=ring):
            err = _build.kernels().fat_chunk_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), *(None if x is None else x.data_ptr() for x in sc),
                out.data_ptr(), None, slot.data_ptr(), 8, 32, 8, 256, kv_end, k.shape[2], 128, q.stride(1),
                q.stride(2), *k.stride()[:3], *v.stride()[:3], _build.int64_tuple_array(tuple(strides)),
                128 ** -0.5 * LOG2E, cs.WINDOW if ring else 0, 0, ring_mod, ring_base, 0.0, _build.DTYPE_CODES[bf16],
                payload, _build.current_stream(q.device), splits)
            _build.check(err, f"chunk body at {splits} splits")
            return out

        want = call(picked).clone()
        for splits in range(1, fa.CHUNK_MAX_SPLITS + 1) if kv_end > 256 else (picked,):
            got = call(splits).clone()
            if splits == picked and not torch.equal(got, want):
                raise RuntimeError(f"[chunk split sweep] {label}: two calls at {splits} splits differ")
            if cs._rel_diff(got, want) >= cs.REL_BAR["bfloat16"]:
                raise RuntimeError(f"[chunk split sweep] {label}: {splits} splits against {picked}")
            rows[f"{label} splits {splits}"] = _split_times(lambda splits=splits: call(splits))[1]
    print("[chunk split sweep] alone in a CUDA graph of 10 (the wrapper picks " + f"{picked}): "
          + "; ".join(f"{key} {ms:.4f} ms" for key, ms in rows.items()) + f" ({card})", flush=True)
    return {"ms": rows[f"K1q int8 kv_end 2048 splits {picked}"], **rows}


def mha_bwd(card: str) -> dict:
    """K3 (the MHA route) at phase 14's MHA shape, q = kv [1,32,2048,128]
    causal bf16, beside K4 + K5 (the GQA route's kernels) on the same
    inputs, each timed alone on the plain forward's residuals; ``ms`` is
    K3's. K4 + K5 are timed for information: the MHA route stays K3."""
    import chip_smoke as cs
    import torch

    from flash_attention_tpu_torch.ops.attention_bwd import launch_dkv, launch_dq, launch_fused

    q, k, v, do = cs._bwd_inputs(12, 32, 32, 2048, 2048, 128, torch.bfloat16)
    args, kw = _plain_args(q, k, v, do), dict(causal=True, sm_scale=128**-0.5)
    t = {"K3": cs.cuda_ms(lambda: launch_fused(*args, **kw)),
         "K4 + K5": cs.cuda_ms(lambda: (launch_dq(*args, **kw), launch_dkv(*args, **kw)))}
    print(f"[mha bwd] q = kv [1,32,2048,128] causal bf16: K3 {t['K3']:.4f} ms, K4 + K5 {t['K4 + K5']:.4f} ms "
          f"({card})", flush=True)
    return {"ms": t["K3"], **t}


def _gloo_cuda_rank() -> dict:
    """One of two gloo ranks on cuda:0: which collectives of this torch's
    gloo take CUDA tensors as they are. Each is tried once and its outcome
    printed as it comes (a transport that aborts the process leaves the
    earlier lines): this answers a question, and the parallel layer never
    keys on it (it stages CUDA tensors through host buffers over gloo)."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    rank, peer = dist.get_rank(), 1 - dist.get_rank()
    out = {}

    def attempt(name, fn):
        print(f"[gloo cuda] rank {rank}: {name} of a CUDA tensor ...", flush=True)
        try:
            out[name] = f"carried: {fn()}"
        except Exception as e:  # the answer sought
            out[name] = f"refused: {type(e).__name__}: {str(e).splitlines()[0][:160]}"
        print(f"[gloo cuda] rank {rank}: {name}: {out[name]}", flush=True)

    def all_reduce():
        x = torch.full((4,), rank + 1.0, device="cuda")
        dist.all_reduce(x)
        return x.tolist()

    def all_gather():
        parts = [torch.empty(2, device="cuda") for _ in range(2)]
        dist.all_gather(parts, torch.full((2,), float(rank), device="cuda"))
        return [p.tolist() for p in parts]

    def isend_irecv():
        recv = torch.empty(3, device="cuda")
        works = dist.batch_isend_irecv([dist.P2POp(dist.isend, torch.full((3,), float(rank), device="cuda"), peer),
                                        dist.P2POp(dist.irecv, recv, peer)])
        for w in works:
            w.wait()
        return recv.tolist()

    for name, fn in (("all_reduce", all_reduce), ("all_gather", all_gather), ("isend/irecv", isend_irecv)):
        attempt(name, fn)
        dist.barrier()
    return out


def gloo_cuda(card: str) -> None:
    """Whether this torch's gloo carries CUDA tensors through all_reduce,
    all_gather and isend / irecv (two ranks on the card)."""
    import torch

    from flash_attention_tpu_torch.utils.distributed import spawn_ranks

    for rank, res in enumerate(spawn_ranks(_gloo_cuda_rank, 2, backend="gloo", timeout_s=180)):
        print(f"[gloo cuda] torch {torch.__version__}, rank {rank}: {res} ({card})", flush=True)


def sharded_serving(card: str) -> None:
    """Phase 23 alone: phases 5's and 8's main paths on fresh weights from
    seed 0 give the tokens it holds the sharded engines to, then
    ``phase_sharded_serving``, whose kernels' entries are printed."""
    import torch

    import chip_smoke as cs
    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params

    cfg = ModelConfig()
    params = init_model_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    _, dense = cs.serve_full_dense(card, "full", cfg, params, used=("K1", "K6", *_glue(cs)))
    _, paged = cs.serve_full_paged(card, "full paged", cfg, params, used=("K7", "K8", "K9/K10", *_glue(cs)),
                                   dense=dense)
    del params
    print(json.dumps({"kernels": cs.phase_sharded_serving(card, dense["tokens"], paged["tokens"])}), flush=True)


def warmup_profiles(card: str) -> None:
    """Phase 24 alone: phases 5's and 8's main paths on fresh weights from
    seed 0 give the tokens it holds the first runs and the paged warmup to,
    then ``phase_warmup_profiles``."""
    import torch

    import chip_smoke as cs
    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params

    cfg = ModelConfig()
    params = init_model_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    _, dense = cs.serve_full_dense(card, "full", cfg, params, used=("K1", "K6", *_glue(cs)))
    _, paged = cs.serve_full_paged(card, "full paged", cfg, params, used=("K7", "K8", "K9/K10", *_glue(cs)),
                                   dense=dense)
    del params
    cs.phase_warmup_profiles(card, dense["tokens"], paged["tokens"])


def _emulated_tp(params, cfg, ranks: int, run):
    """``run(params, cfg, group, rank)`` on each of ``ranks`` model shards
    of ``params`` at once in one process: a thread a rank on the one
    device, the model's all-reduce a barrier at which every thread adds the
    partials in rank order. The tensor-parallel numerics without a process
    group; returns each rank's result."""
    import threading

    import flash_attention_tpu_torch.models.attention as attention
    import flash_attention_tpu_torch.models.transformer as transformer
    from flash_attention_tpu_torch.parallel.sharding import shard_model_params

    class _Mesh:  # the one-axis mesh shard_model_params reads
        mesh_dim_names, shape = ("data", "model", "context"), (1, ranks, 1)

        def __init__(self, rank):
            self.rank = rank

        def get_coordinate(self):
            return [0, self.rank, 0]

    shards = [shard_model_params(params, cfg, _Mesh(r)) for r in range(ranks)]
    parts, barrier, me = [None] * ranks, threading.Barrier(ranks), threading.local()

    def all_reduce_(t, op, group):
        parts[me.rank] = t
        barrier.wait()
        total = parts[0].clone()
        for p in parts[1:]:
            total += p
        barrier.wait()
        return t.copy_(total)

    saved = attention.all_reduce_, attention.tensor_parallel, transformer.tensor_parallel
    attention.all_reduce_ = all_reduce_
    attention.tensor_parallel = transformer.tensor_parallel = lambda group: group is not None
    out = [None] * ranks

    def rank_main(r):
        me.rank = r
        out[r] = run(*shards[r], "emulated", r)

    try:
        threads = [threading.Thread(target=rank_main, args=(r,)) for r in range(ranks)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        attention.all_reduce_, attention.tensor_parallel, transformer.tensor_parallel = saved
    return out


def tp_emulation(card: str) -> None:
    """How far a tensor-parallel ModelConfig() (model 4) parts from the
    single-process model when only the order of the row-parallel sums
    differs (``_emulated_tp``): chip_smoke's phase-23 logits
    (``_serve_logits``) at 1, 2, 4, 8 and 32 layers, and at 32 layers each
    layer's attention and MLP outputs on the single-process model's own
    inputs (``_layer_outputs``); beside them the single-process model
    against itself, run again and with its prefill in 256-row chunks."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_caches, init_model_params, prefill_chunk

    ranks = 4
    for layers in (1, 2, 4, 8, 32):
        cfg = ModelConfig(num_layers=layers)
        params = init_model_params(torch.Generator(device="cuda").manual_seed(0), cfg)
        want = cs._serve_logits(params, cfg, "dense")
        got = _emulated_tp(params, cfg, ranks, lambda p, c, group, r: cs._serve_logits(p, c, "dense", group))
        if not all(torch.equal(got[0], g) for g in got):
            raise RuntimeError("[tp emulation] the ranks' logits differ")
        print(f"[tp emulation] {layers} layers, model {ranks}: logits row-relative {cs._rel_diff(got[0], want):.3e} "
              f"(the first 16 prompt rows {cs._rel_diff(got[0][:16], want[:16]):.3e}); largest |logit| "
              f"{float(want.abs().max()):.3f} ({card})", flush=True)
    ins, outs = cs._layer_outputs(params, cfg)
    tp = _emulated_tp(params, cfg, ranks, lambda p, c, group, r: cs._layer_outputs(p, c, group, inputs=ins)[1])[0]
    errs = [max(cs._rel_diff(a, ra), cs._rel_diff(m, rm)) for (a, m), (ra, rm) in zip(tp, outs)]
    print(f"[tp emulation] 32 layers, each layer's attention and MLP outputs on the single-process model's inputs: "
          f"row-relative {min(errs):.3e}-{max(errs):.3e} ({card})", flush=True)
    toks = np.random.default_rng(cs.TP_SEED).integers(0, cfg.vocab_size, (1, cs.TP_PREFILL))
    toks = torch.from_numpy(toks).to("cuda", torch.int32)
    caches, rows = init_caches(cfg, 1, 2048, device="cuda"), []
    with torch.no_grad():
        for lo in range(0, cs.TP_PREFILL, 256):
            chunk, caches = prefill_chunk(params, cfg, toks[:, lo:lo + 256], caches, 0, lo, lo + 256)
            rows.append(chunk[0])
    again = cs._serve_logits(params, cfg, "dense")
    print(f"[tp emulation] single process against itself: run again {cs._rel_diff(again, want):.3e}, prefill in 256-row "
          f"chunks {cs._rel_diff(torch.cat(rows), want[:cs.TP_PREFILL]):.3e} ({card})", flush=True)


def _kernel_short(name: str) -> str:
    """A device record's name without its template arguments' bulk."""
    for key in ("direct_copy", "nvjet", "gemv", "gemm", "elementwise_kernel", "reduce_kernel", "index", "sort"):
        if key in name:
            return f"{key}: {name[:90]}"
    return name[:110]


def glue_trace(card: str) -> dict:
    """``_glue_trace`` of ModelConfig() in bf16."""
    from flash_attention_tpu_torch.models.transformer import ModelConfig

    return _glue_trace(card, ModelConfig(), "")


def glue_trace_w8(card: str) -> dict:
    """``_glue_trace`` of phase 11a's configuration (int8 weights, int8 cache)."""
    from flash_attention_tpu_torch.models.transformer import ModelConfig

    return _glue_trace(card, ModelConfig(kv_quant="int8", weight_quant="int8"), " w8")


def _glue_trace(card: str, cfg, tag: str) -> dict:
    """Which source line issues each device operation of one decode step:
    phase 24(c)'s dense and paged step plus the sampler (``cfg`` on fresh
    weights from seed 0, quantized where it says, 8 slots x PROFILE_ROWS rows, paged
    over 129 pages of 128 rows), issued eagerly (a replayed block runs the
    same kernels) under torch.profiler with shapes. Prints the step's
    device operations by kernel and, by (kernel, the aten operator that
    launched it, its input shapes), the rows that take the most device time
    and every ``direct_copy`` row. ``ms`` is the dense step's device ms."""
    import dataclasses
    from collections import defaultdict

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from flash_attention_tpu_torch.models.transformer import (
        decode_step_logits,
        decode_step_logits_paged,
        init_caches,
        init_model_params,
        init_paged_caches,
        quantize_model_weights,
    )
    from flash_attention_tpu_torch.serving.sampling import sample_tokens

    params = init_model_params(torch.Generator(device="cuda").manual_seed(0), dataclasses.replace(cfg, weight_quant="none"))
    if cfg.weight_quant == "int8":
        params = quantize_model_weights(params)
    slots, rows = 8, cs.PROFILE_ROWS
    sampling = {key: t.cuda() for key, t in cs._sampling_inputs(rows + 1).items()}
    tok = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (slots, 1))).to("cuda", torch.int32)
    lengths = torch.full((slots,), rows, dtype=torch.int32, device="cuda")
    caches = [c._replace(lengths=lengths) for c in init_caches(cfg, slots, 2048, device="cuda")]
    paged = init_paged_caches(cfg, num_pages=129, num_slots=slots, pages_per_slot=16, page_size=128)
    paged.page_table.copy_(1 + torch.arange(slots * 16, dtype=torch.int32, device="cuda").view(slots, 16))
    paged = paged._replace(lengths=lengths)
    out = {}
    for what, decode, cache in (("dense", decode_step_logits, caches), ("paged", decode_step_logits_paged, paged)):
        def step():
            with torch.no_grad():
                return sample_tokens(decode(params, cfg, tok, cache)[0], **sampling)

        for _ in range(2):
            step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
            step()
            torch.cuda.synchronize()
        events = prof.events()
        device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        by_kernel = defaultdict(lambda: [0, 0.0])
        for e in device:
            row = by_kernel[_kernel_short(e.name)]
            row[0] += 1
            row[1] += e.time_range.end - e.time_range.start
        by_op = defaultdict(lambda: [0, 0.0])
        attributed = 0
        for e in events:
            if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
                continue
            shapes = str([list(s) for s in e.input_shapes if s])[:70]
            for k in e.kernels:
                row = by_op[(_kernel_short(k.name)[:60], e.name, shapes)]
                row[0] += 1
                row[1] += k.duration
                attributed += 1
        device_ms = sum(us for _, us in by_kernel.values()) / 1e3
        print(f"[glue trace{tag}] {what} step + sampler: {len(device)} device operations, {device_ms:.3f} ms of device "
              f"time; {attributed} attributed to an aten operator (the rest: the port's own ctypes launches) "
              f"({card})", flush=True)
        for name, (n, us) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1]):
            print(f"[glue trace{tag}] {what} by kernel: x{n} {us / 1e3:.4f} ms  {name}", flush=True)
        ranked = sorted(by_op.items(), key=lambda kv: -kv[1][1])
        shown = ranked[:40] + [kv for kv in ranked[40:] if "direct_copy" in kv[0][0]]
        for (kname, op, shapes), (n, us) in shown:
            print(f"[glue trace{tag}] {what} by operator: x{n} {us / 1e3:.4f} ms  {kname} | {op} {shapes}", flush=True)
        out[f"{what} device_ops"] = len(device)
        out[f"{what} device_ms"] = device_ms
        out[f"{what} direct_copy"] = sum(n for name, (n, _) in by_kernel.items() if "direct_copy" in name)
    return {"ms": out["dense device_ms"], **out}


def block_step(card: str) -> dict:
    """``_block_step`` of ModelConfig() in bf16."""
    from flash_attention_tpu_torch.models.transformer import ModelConfig

    return _block_step(card, ModelConfig(), "")


def block_step_w8(card: str) -> dict:
    """``_block_step`` of phase 11a's configuration (int8 weights, int8 cache)."""
    from flash_attention_tpu_torch.models.transformer import ModelConfig

    return _block_step(card, ModelConfig(kv_quant="int8", weight_quant="int8"), " w8")


def _block_step(card: str, cfg, tag: str) -> dict:
    """Phase 24(c)'s replayed decode blocks on fresh ``cfg`` weights
    (seed 0, quantized where it says): the dense and the paged engine's k = 16 program, sampled and
    greedy, every slot active at 8 slots x PROFILE_ROWS rows (reset before
    each block), the paged table the straight one. Each block's least
    untraced wall of 2 runs of 3 (``time_fn``) as ms a step, and from one
    traced block (``profile_op``) its device busy share, device operations
    and ``direct_copy`` kernels a step. ``ms`` is the dense sampled step's."""
    import dataclasses

    import numpy as np
    import torch

    import chip_smoke as cs
    from flash_attention_tpu_torch.models.transformer import init_model_params, quantize_model_weights
    from flash_attention_tpu_torch.serving.engine import ServingEngine
    from flash_attention_tpu_torch.serving.paged_engine import PagedServingEngine
    from flash_attention_tpu_torch.utils.benchmarking import time_fn
    from flash_attention_tpu_torch.utils.profiling import profile_op

    params = init_model_params(torch.Generator(device="cuda").manual_seed(0), dataclasses.replace(cfg, weight_quant="none"))
    if cfg.weight_quant == "int8":
        params = quantize_model_weights(params)
    slots, k = 8, cs.DENSE_ENGINE_BLOCK
    rows = {key: t.numpy() for key, t in cs._sampling_inputs(0).items()}
    tok = np.random.default_rng(5).integers(0, cfg.vocab_size, slots).astype(np.int32)
    out = {}
    for what, make in (("dense", lambda: ServingEngine(params, cfg, max_slots=slots, max_seq=2048)),
                       ("paged", lambda: PagedServingEngine(params, cfg, max_slots=slots, num_pages=129,
                                                            pages_per_slot=16, page_size=128))):
        eng = make()
        if what == "paged":
            eng.caches.page_table.copy_(1 + torch.arange(slots * 16, dtype=torch.int32, device="cuda").view(slots, 16))
        lengths = eng._lengths_of(eng.caches)
        eng.programs.upload(tok, np.ones(slots, bool), rows["temperature"], rows["top_k"], rows["top_p"],
                            rows["seeds"])
        for greedy in (False, True):
            def block(eng=eng, lengths=lengths, greedy=greedy):
                lengths.fill_(cs.PROFILE_ROWS)
                return eng.programs.run(k, greedy)

            prof = profile_op(block, warmup=2, iters=1)
            wall = min(time_fn(block, warmup=1, iters=3, runs=2))
            ops = sum(op["count"] for op in prof["device_ops"]) / k
            copies = sum(op["count"] for op in prof["device_ops"] if "direct_copy" in op["name"]) / k
            key = f"{what} {'greedy' if greedy else 'sampled'}"
            print(f"[block step{tag}] {key} k={k} block replayed, {slots} slots x {cs.PROFILE_ROWS} rows: "
                  f"{wall * 1e3 / k:.3f} ms a step untraced, busy {prof['device_busy_share']:.4f} of the traced "
                  f"block, {ops:g} device operations and {copies:g} direct_copy a step ({card})", flush=True)
            out[f"{key} ms_step"], out[f"{key} busy"] = wall * 1e3 / k, prof["device_busy_share"]
            out[f"{key} ops_step"], out[f"{key} copies_step"] = ops, copies
        del eng, lengths
        torch.cuda.empty_cache()
    return {"ms": out["dense sampled ms_step"], **out}


def _one(funcs: list[str]) -> None:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    card = cs.phase_device()
    cs.phase_build()
    tree = os.path.basename(os.getcwd())
    for name in funcs:
        try:
            fn = getattr(cs, name) if hasattr(cs, name) else globals()[name]
            out = fn(card) if inspect.signature(fn).parameters else fn()
        except Exception as e:  # a failing case is what a mutation check looks for
            print(f"RESULT {tree} {name}: FAILED: {e}", flush=True)
            continue
        print(f"RESULT {tree} {name}: passed", flush=True)
        if isinstance(out, dict) and "ms" in out:
            keys = ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms", "host_us")
            times = {k: v for k, v in out.items() if k in keys or " " in k}
            print(f"TIMING {tree} {name} {json.dumps(times)}", flush=True)


def _build() -> None:
    sys.path.insert(0, os.getcwd())
    from flash_attention_tpu_torch.ops import _build as build

    build.kernels()


def main() -> int:
    if len(sys.argv) >= 2 and sys.argv[1] == "--one":
        _one(sys.argv[2:])
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--build":
        _build()
        return 0
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    trees, funcs = sys.argv[1].split(","), sys.argv[2:]
    me = os.path.abspath(__file__)
    builds = {t: subprocess.Popen([sys.executable, me, "--build"], cwd=t) for t in dict.fromkeys(trees)}
    if any(p.wait() != 0 for p in builds.values()):
        return 1
    for t in trees:
        subprocess.run([sys.executable, me, "--one", *funcs], cwd=t, check=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
