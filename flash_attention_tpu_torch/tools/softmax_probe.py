"""P1: fp32 against bf16 softmax arithmetic in body T, on the card.

Counterpart of the repository's tools/softmax_probe.py. On the TPU the
forward was bound by its vector unit, and the probe asked what running the
softmax passes in bf16 saves and what it costs in accuracy. Here body T
(csrc/probes.cu) runs both arithmetics at the JAX probe's shapes (32 heads,
head_dim 128, seq 8192 and 2048, causal and not), over the four Hopper tile
shapes that stand for its 256-1024-row blocks; q is pre-scaled by
sm_scale·log2(e), as there. Each row: the kernel's time (``time_fn``: 5
warm-up, 20 timed calls, 2 runs, the fastest), TFLOP/s, its error against
the plain version and the fp32 oracle, the plain version's time, the bound
and SDPA at the same shape as the yardstick.

    python3 -m flash_attention_tpu_torch.tools.softmax_probe
"""

from __future__ import annotations

import math

import torch

from flash_attention_tpu_torch.ops.common import LOG2E
from flash_attention_tpu_torch.tools import probes
from flash_attention_tpu_torch.utils.benchmarking import attention_flops, card_description

SWEEP = ((8192, probes.TILES), (2048, probes.TILES))
SMOKE_SWEEP = ((2048, probes.TILES), (8192, ((128, 64),)))


def run(sweep=SWEEP, *, heads: int = 32, quick: bool = False, log=print) -> list[dict]:
    """Every (seq, tiles) of ``sweep``, causal and not, fp32 and bf16 softmax;
    returns the rows, logging each. ``quick`` is taken for the tools' common
    interface: ``time_fn``'s 45 calls are short either way."""
    rows = []
    sm_scale = 1.0 / math.sqrt(probes.HEAD_DIM)
    for seq, tiles in sweep:
        q, k, v = probes.make_inputs(heads, seq)
        qs = (q.float() * (sm_scale * LOG2E)).to(q.dtype)
        for causal in (False, True):
            want = probes.oracle_out(q, k, v, causal=causal, sm_scale=sm_scale)
            sdpa_ms = probes.looped_s(lambda: probes.sdpa(q, k, v, causal=causal, sm_scale=sm_scale)) * 1e3
            flops = attention_flops(1, heads, seq, probes.HEAD_DIM, causal=causal)
            for bm, bn in tiles:
                kw = dict(bm=bm, bn=bn, skip=causal, mask="always" if causal else "none")
                for arith in ("f32", "bf16"):
                    row = probes.measure(
                        "P1", f"c={int(causal)} {bm}x{bn} {arith}", heads=heads, seq=seq,
                        kernel=lambda: probes.probe_tiled(qs, k, v, arith=arith, **kw),
                        plain=lambda: probes.tiled_plain(qs, k, v, arith=arith, **kw),
                        bar=probes.BF16_BAR if arith == "bf16" else probes.PLAIN_BAR,
                        pairs=probes.tiled_pairs(seq, bm=bm, bn=bn, skip=kw["skip"], mask=kw["mask"]),
                        flops=flops, timer=probes.looped_s, want=want, sdpa_ms=sdpa_ms,
                    )
                    log(probes.format_row(row))
                    rows.append(row)
            del want
    return rows


def main() -> None:
    print(card_description(), flush=True)
    run(log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
