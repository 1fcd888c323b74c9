"""P6: where the 1/l normalise should go.

Counterpart of the repository's tools/epilogue_probe.py. Body S
(csrc/probes.cu) at the JAX probe's shapes (32 heads, seq 512 and 1024,
head_dim 128, non-causal, scale2 = log2(e)/sqrt(128) inside) with five
epilogues:

  none              no normalise: the floor (wrong by design)
  before_pv         p·(1/l) before PV, over the seq-wide score rows
                    (mfu_probe's full)
  after_pv          PV·(1/l) with the l == 0 guard, over head_dim columns
                    (the shipped K1, gap_probe's single step)
  after_pv_noguard  PV / l
  after_pv_bf16     bf16(PV)·bf16(1/l), the product in bf16

Times are from ``scan_timer`` (CUDA-graph replay, the kernel alone; inputs
L2-warm), each beside its error against the plain version (within
``probes.BF16_BAR`` for the bf16 epilogue, ``PLAIN_BAR`` for the others)
and (all but none) the fp32 oracle, the plain version's time, the bound and SDPA.

    python3 -m flash_attention_tpu_torch.tools.epilogue_probe
"""

from __future__ import annotations

import functools
import math

from flash_attention_tpu_torch.ops.common import LOG2E
from flash_attention_tpu_torch.tools import probes
from flash_attention_tpu_torch.utils.benchmarking import attention_flops, card_description

SEQS = (512, 1024)
EPILOGUES = ("none", "before_pv", "after_pv", "after_pv_noguard", "after_pv_bf16")


def run(seqs=SEQS, *, heads: int = 32, quick: bool = False, log=print) -> list[dict]:
    """Every epilogue at each seq of ``seqs``; returns the rows, logging each.
    ``quick`` shortens the graph replays to ~20 ms (chip_smoke.py's phase
    21)."""
    rows = []
    timer = functools.partial(probes.graphed_s, quick=quick)
    sm_scale = 1.0 / math.sqrt(probes.HEAD_DIM)
    scale2 = sm_scale * LOG2E
    for seq in seqs:
        q, k, v = probes.make_inputs(heads, seq)
        flops = attention_flops(1, heads, seq, probes.HEAD_DIM, causal=False)
        want = probes.oracle_out(q, k, v, causal=False, sm_scale=sm_scale)
        sdpa_ms = probes.graphed_s(lambda: probes.sdpa(q, k, v, causal=False, sm_scale=sm_scale), quick=quick) * 1e3
        for epilogue in EPILOGUES:
            row = probes.measure(
                "P6", epilogue, heads=heads, seq=seq,
                kernel=lambda: probes.probe_single(q, k, v, scale2, epilogue=epilogue),
                plain=lambda: probes.single_plain(q, k, v, scale2, epilogue=epilogue),
                bar=probes.BF16_BAR if epilogue == "after_pv_bf16" else probes.PLAIN_BAR, pairs=seq * seq,
                flops=flops, timer=timer, want=None if epilogue == "none" else want, sdpa_ms=sdpa_ms,
            )
            log(f"{probes.format_row(row)}  {row['ms'] * 1e3:8.2f} us")
            rows.append(row)
    return rows


def main() -> None:
    print(card_description(), flush=True)
    run(log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
