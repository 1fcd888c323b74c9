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


def serve_decode(card: str) -> dict:
    """Decode tokens/s of the serving paths K6, K7 and K10 run on, on fresh
    weights from seed 0: phase 5 (``ServingEngine``, ``ModelConfig()``),
    phase 8 (``PagedServingEngine``, the same weights and requests), then
    Mistral-7B's shape through phase 17's rolling engine (17a, the 4352-row
    ring) and its paged ring with 4 sinks (17c), each with chip_smoke.py's
    own serving function. ``ms`` is 1000 over phase 5's decode tok/s (a
    step's share per token)."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    import chip_smoke as cs
    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params
    from flash_attention_tpu_torch.serving.engine import ServingEngine
    from flash_attention_tpu_torch.serving.paged_engine import PagedServingEngine

    cfg = ModelConfig()
    params = init_model_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    _, dense = cs.serve_full_dense(card, "full", cfg, params, used=("K1", "K6"))
    _, paged = cs.serve_full_paged(card, "full paged", cfg, params, used=("K7", "K8", "K9/K10"), dense=dense)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg = ModelConfig(**cs.MISTRAL)
    params = init_model_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    rng = np.random.default_rng(17)
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab_size, n)) for n in cs.MASKED_PROMPT_LENS]
    eng = ServingEngine(params, dataclasses.replace(cfg, rolling=True), max_slots=8, max_seq=16384, prefill_chunk=256)
    ring = cs._serve_masked(card, "full masked a", eng, prompts, used=("K1", "K6"))
    del eng
    torch.cuda.empty_cache()
    eng = PagedServingEngine(params, dataclasses.replace(cfg, attention_sinks=cs.SINKS), max_slots=8, num_pages=297,
                             pages_per_slot=72, page_size=128, prefill_chunk=256)
    paged_ring = cs._serve_masked(card, "full masked c", eng, prompts, used=("K7", "K8", "K9/K10"))
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    tok_s = {"5": dense["decode_tok_s"], "8": paged["decode_tok_s"], "17a": ring["decode_tok_s"],
             "17c": paged_ring["decode_tok_s"]}
    print("[serve decode] decode tok/s " + ", ".join(f"phase {k} {v:.1f}" for k, v in tok_s.items()) + f" ({card})",
          flush=True)
    return {"ms": 1e3 / tok_s["5"], **{f"phase {k} decode_tok_s": v for k, v in tok_s.items()}}


SM90_SOURCES = ("flash_bwd_sm90.cu", "flash_fwd_sm90.cu")


def _kernel_label(line: str) -> str:
    """A kernel's name and template arguments from ptxas's mangled name:
    e.g. "dkv_kernel bf16 128 masked=0 fused=1", "fwd_kernel fp16 64 masked=1
    wgs=2"."""
    import re

    m = re.search(r"(dq_kernel|dkv_kernel|split_sum_kernel|fwd_kernel)I(\w+?)EEv", line)
    if m is None:
        m = re.search(r"'_Z\w*?(decode_kernel|paged_write_kernel|paged_write_quant_kernel)(I\w+?E)?", line)
        return " ".join(filter(None, m.groups())) if m else line.strip()
    name, args = m.group(1), m.group(2).replace("13__nv_bfloat16", "bf16 ").replace("6__half", "fp16 ")
    flags = {"dq_kernel": ("masked",), "dkv_kernel": ("masked", "fused"), "fwd_kernel": ("masked", "wgs")}.get(name, ())
    values = re.findall(r"L[ib](\d+)E", args)
    dims, rest = values[:1], values[1:]
    return " ".join([name, args.split()[0] if args.split() else "", *dims,
                     *(f"{k}={v}" for k, v in zip(flags, rest))]).strip()


def ptxas_sm90(card: str) -> None:
    """Compiles each tensor-core source (SM90_SOURCES, those the tree has)
    alone with the build's flags and ``-Xptxas -v``, all at once: prints the
    seconds each took and, for each kernel, its registers, spills and
    whether ptxas serialised its wgmma (C7515)."""
    _ptxas(card, SM90_SOURCES, "ptxas sm90")


def ptxas_decode(card: str) -> None:
    """``ptxas_sm90`` for the decode and page-write sources (K6, K7, K9, K10):
    every instantiation's registers and spills."""
    _ptxas(card, ("decode.cu", "paged_write.cu"), "ptxas decode")


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
        lines, kernel, rows, spill, serial = stdout.splitlines(), None, [], "0", []
        for line in lines:
            if "Compiling entry function" in line:
                kernel = _kernel_label(line)
            elif "bytes spill stores" in line and kernel:
                spill = re.search(r"(\d+) bytes spill stores", line).group(1)
            elif "Used" in line and "registers" in line and kernel:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                rows.append(f"{kernel}: {regs} registers, {spill} B spilled")
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


def sampling(card: str) -> None:
    """Phase 5's sampling check and decode-step times on fresh ModelConfig()
    weights from seed 0."""
    import chip_smoke as cs
    from flash_attention_tpu_torch.models.transformer import ModelConfig

    cs.phase_sampling(card, _model(ModelConfig()))


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
    """The forward kernels K1's redesign leaves as they were, on seeded
    inputs: K2 (window 64, q = kv [1,32,2048,128], bf16), K8 and K8q (fp8
    e4m3) over a shuffled pool [129,8,128,128] (q [1,32,256,128] to kv_end
    2048 of slot 7) and the fp32 K1 (causal with LSE, q [1,8,1024,64] kv
    [1,2,1024,64]). Prints each one's time and a hash of its output bytes;
    ``ms`` is K2's."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention
    from flash_attention_tpu_torch.ops.paged import paged_prefill_attention
    from flash_attention_tpu_torch.utils.testing import make_qkv

    bf16, out, times = torch.bfloat16, {}, {}
    gen, rng = torch.Generator(device="cuda").manual_seed(9), np.random.default_rng(9)
    q, k, v = make_qkv(17, 1, 32, 2048, 128, num_kv_heads=32, dtype=bf16, device="cuda")
    kw = dict(causal=True, sliding_window=64, save_residuals=True)
    out["K2"] = _digest(*flash_attention(q, k, v, **kw))
    times["K2"] = cs.cuda_ms(lambda: flash_attention(q, k, v, **kw))
    cache = cs._filled_cache(1, num_pages=129, num_slots=8, pages_per_slot=16, kv_heads=8, head_dim=128, dtype=bf16,
                             gen=gen).layers()[0]
    cache.page_table.copy_(torch.from_numpy(cs._shuffled_table(rng, 8, 16, 129)).cuda())
    qc = cs.torch_uniform((1, 32, 256, 128), bf16, gen)
    out["K8"] = _digest(paged_prefill_attention(qc, cache, 7, 2048, chunk_len=256))
    times["K8"] = cs.cuda_ms(lambda: paged_prefill_attention(qc, cache, 7, 2048, chunk_len=256))
    layer = cs._quant_pages("fp8_e4m3", 1, 129, 8, 16, gen, rng)[0].layers()[0]
    out["K8q"] = _digest(paged_prefill_attention(qc, layer, 7, 2048, chunk_len=256))
    times["K8q"] = cs.cuda_ms(lambda: paged_prefill_attention(qc, layer, 7, 2048, chunk_len=256))
    q, k, v = make_qkv(13, 1, 8, 1024, 64, num_kv_heads=2, dtype=torch.float32, device="cuda")
    out["fp32 K1"] = _digest(*flash_attention(q, k, v, causal=True, save_residuals=True))
    times["fp32 K1"] = cs.cuda_ms(lambda: flash_attention(q, k, v, causal=True, save_residuals=True))
    print(f"[unchanged fwd] output hashes {out}; ms " + ", ".join(f"{k} {t:.4f}" for k, t in times.items())
          + f" ({card})", flush=True)
    return {"ms": times["K2"], **times}


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
