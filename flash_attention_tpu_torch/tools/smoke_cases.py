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
    """K6 at phase 3's inputs, its time split in two: ``ms`` as chip_smoke.py
    times a wrapper call (host work up to the launch included, since the
    card idles at the start event), ``device_ms`` from a CUDA graph of 20
    calls replayed (the kernel alone), and ``host_us`` the wrapper's host
    time a call, 200 calls enqueued without a synchronisation."""
    import time

    import numpy as np
    import torch

    from chip_smoke import cuda_ms
    from flash_attention_tpu_torch.ops.decode import decode_attention

    dev = torch.device("cuda")
    rng = np.random.default_rng(6)

    def uniform(shape):
        return torch.from_numpy(rng.uniform(-0.5, 0.5, shape).astype(np.float32)).to(dev, torch.bfloat16)

    q = uniform((8, 32, 128))
    k, v = uniform((8, 8, 2048, 128)), uniform((8, 8, 2048, 128))
    lengths = torch.tensor([0, 1, 255, 256, 1000, 2047, 2048, 7], dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: decode_attention(q, k, v, lengths))
    graph, calls = torch.cuda.CUDAGraph(), 20
    with torch.cuda.graph(graph):
        for _ in range(calls):
            decode_attention(q, k, v, lengths)
    device_ms = cuda_ms(graph.replay) / calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        decode_attention(q, k, v, lengths)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    print(f"[k6 split] wrapper {ms:.4f} ms, kernel alone {device_ms:.4f} ms (CUDA graph of {calls}), "
          f"host {host_us:.1f} us a call ({card})", flush=True)
    return {"ms": ms, "device_ms": device_ms, "host_us": host_us}


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
            times = {k: out[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms", "host_us") if k in out}
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
