"""P5: how much the Python wrapper adds over a bare launch.

Counterpart of the repository's tools/gap_probe.py, which split the gap
between the real flash_attention and a bare pallas_call of the same
single-step body. At its shapes (32 heads, seq 512 and 1024, head_dim 128,
non-causal) the rows here are

  bare S     body S (csrc/probes.cu) with K1's single-step epilogue
             (after_pv), launched into a preallocated output through
             ``probes.launch_single``: its C entry and a launch count
  bare K1    K1 (in bf16 csrc/flash_fwd_sm90.cu's tensor-core body) through
             its C entry ``fat_flash_fwd`` with a preallocated output, no
             wrapper
  real       flash_attention(q, k, v, causal=False) under torch.no_grad
  real+lse   the same with save_residuals=True
  real grad  the forward of FlashAttentionFunction (inputs that require grad)

each timed twice: by ``scan_timer`` (CUDA-graph replay: the kernel alone)
and by ``time_fn`` (a loop of calls: the host included). The JAX probe's
suspects (grid3, scratch, cost) were Mosaic's; the wrapper's parts take
their place and are timed on the host by ``time_fn`` with the card idle:
the input checks, ``segment_pair``, an output allocation, the
``torch.cuda.device`` context and ``_build.kernels()``.

    python3 -m flash_attention_tpu_torch.tools.gap_probe
"""

from __future__ import annotations

import functools
import math

import torch

from flash_attention_tpu_torch.ops import _build
from flash_attention_tpu_torch.ops import flash_attention as fa
from flash_attention_tpu_torch.ops.common import LOG2E, segment_pair, sm_count
from flash_attention_tpu_torch.tools import probes
from flash_attention_tpu_torch.utils.benchmarking import attention_flops, card_description, time_fn

SEQS = (512, 1024)


def bare_k1(q4, k4, v4, out, scale2: float) -> None:
    """K1, non-causal, unmasked, no LSE, through its C entry into ``out``."""
    b, h, s, d = q4.shape
    err = _build.kernels().fat_flash_fwd(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(), None, None, None, None, None,
        b, h, h, s, s, d, *q4.stride()[:3], *k4.stride()[:3], *v4.stride()[:3],
        scale2, 0, 0, 0.0, 0, _build.DTYPE_CODES[q4.dtype], torch.cuda.current_stream(q4.device).cuda_stream,
        fa.fwd_q_tile(b, h, s, sm_count(q4.device)),
    )
    _build.check(err, "gap_probe bare K1")


def _device_context(device) -> None:
    with torch.cuda.device(device):
        pass


def run(seqs=SEQS, *, heads: int = 32, quick: bool = False, log=print) -> list[dict]:
    """Every row and wrapper part at each seq of ``seqs``; returns the rows,
    logging each. ``quick`` shortens the graph replays to ~20 ms
    (chip_smoke.py's phase 21)."""
    rows = []
    timer = functools.partial(probes.graphed_s, quick=quick)
    sm_scale = 1.0 / math.sqrt(probes.HEAD_DIM)
    scale2 = sm_scale * LOG2E
    for seq in seqs:
        q, k, v = probes.make_inputs(heads, seq)
        q4, k4, v4 = q[None], k[None], v[None]
        qg, kg, vg = (x.detach().requires_grad_() for x in (q4, k4, v4))
        flops = attention_flops(1, heads, seq, probes.HEAD_DIM, causal=False)
        want = probes.oracle_out(q, k, v, causal=False, sm_scale=sm_scale)
        sdpa_ms = probes.graphed_s(lambda: probes.sdpa(q, k, v, causal=False, sm_scale=sm_scale), quick=quick) * 1e3
        out = torch.empty_like(q)
        out4 = torch.empty_like(q4)

        def no_grad(fn):
            def call():
                with torch.no_grad():
                    return fn()
            return call

        def bare_s():
            probes.launch_single(q, k, v, out, scale2, stage="softmax", epilogue="after_pv", mask=False, hb=1)
            return out

        def bare():
            bare_k1(q4, k4, v4, out4, scale2)
            return out4[0]

        variants = {
            "bare S": (bare_s, lambda: probes.single_plain(q, k, v, scale2, epilogue="after_pv")),
            "bare K1": (bare, None),
            "real": (no_grad(lambda: fa.flash_attention(q4, k4, v4, causal=False)[0]), None),
            "real+lse": (no_grad(lambda: fa.flash_attention(q4, k4, v4, causal=False, save_residuals=True)[0][0]),
                         None),
            "real grad": (lambda: fa.flash_attention(qg, kg, vg, causal=False)[0], None),
        }
        k1_plain = no_grad(lambda: fa.flash_attention_plain(q4, k4, v4, causal=False, sm_scale=sm_scale,
                                                            save_residuals=False)[0])
        for name, (kernel, plain) in variants.items():
            row = probes.measure(
                "P5", name, heads=heads, seq=seq, kernel=kernel, plain=plain or k1_plain, bar=probes.PLAIN_BAR,
                pairs=seq * seq, flops=flops, timer=timer, want=want, sdpa_ms=sdpa_ms,
            )
            row["host_ms"] = probes.looped_s(kernel) * 1e3
            log(f"{probes.format_row(row)}  graph {row['ms'] * 1e3:8.2f} us, loop {row['host_ms'] * 1e3:8.2f} us")
            rows.append(row)
        parts = {
            "validate": lambda: fa._validate(q4, k4, v4, False, None, None),
            "segment_pair": lambda: segment_pair(None, 1, seq, seq),
            "empty": lambda: torch.empty(q4.shape, dtype=q4.dtype, device=q4.device),
            "device ctx": lambda: _device_context(q.device),
            "kernels()": _build.kernels,
        }
        for name, fn in parts.items():
            us = min(time_fn(fn, warmup=20, iters=200, runs=3)) * 1e6
            log(f"P5 seq={seq} wrapper part {name:<14s} {us:8.2f} us host")
            rows.append(dict(probe="P5", variant=f"part {name}", seq=seq, heads=heads, host_us=us))
    return rows


def main() -> None:
    print(card_description(), flush=True)
    run(log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
