"""P2: where the time goes as stages are added to the bare products.

Counterpart of the repository's tools/mfu_probe.py. Body S (csrc/probes.cu)
at the JAX probe's shapes (32 heads, seq 512 and 1024, head_dim 128,
non-causal, q scaled inside by scale2 = log2(e)/sqrt(128)), one stage at a
time:

  mma      p = bf16(s): the two products and the score tile's trip through
           shared memory, nothing else
  max      + the row max pass, p = bf16(s - m)
  exp2     + p = exp2(s·scale2 - m), in place (no normalise)
  full     + the row sum, p·(1/l) before PV
  mask     full + the causal iota mask, applied to the score fragments
  perhead  full with two heads' tiles interleaved in one block (16 rows of
           each) against one head a block: the Hopper form of the JAX
           probe's per-head unrolled dots

mma, max and exp2 are wrong by design; full, mask and perhead compute
attention and are also held against the fp32 oracle. Times are from
``scan_timer`` (CUDA-graph replay: the kernel alone), as the JAX probe's
in-graph scan; with q, k, v and the output under 50 MB they stay in L2
across replays, as the TPU's stayed in VMEM. Each row gives µs and TFLOP/s
(non-causal FLOPs, as the JAX probe), the share of the 989 TFLOP/s peak,
the plain version's time, the bound and SDPA's time.

    python3 -m flash_attention_tpu_torch.tools.mfu_probe
"""

from __future__ import annotations

import functools
import math

from flash_attention_tpu_torch.ops.common import LOG2E
from flash_attention_tpu_torch.tools import probes
from flash_attention_tpu_torch.utils.benchmarking import TENSOR_PEAK_TFLOPS, attention_flops, card_description

SEQS = (512, 1024)
# stage name -> (body S's stage, epilogue, mask, hb)
STAGES = {
    "mma": ("mma", "none", False, 1),
    "max": ("max", "none", False, 1),
    "exp2": ("softmax", "none", False, 1),
    "full": ("softmax", "before_pv", False, 1),
    "mask": ("softmax", "before_pv", True, 1),
    "perhead": ("softmax", "before_pv", False, 2),
}
ATTENTION = {"full": False, "mask": True, "perhead": False}  # stage -> causal, for the oracle


def run(seqs=SEQS, *, heads: int = 32, quick: bool = False, log=print) -> list[dict]:
    """Every stage at each seq of ``seqs``; returns the rows, logging each.
    ``quick`` shortens the graph replays to ~20 ms (chip_smoke.py's phase
    21)."""
    rows = []
    timer = functools.partial(probes.graphed_s, quick=quick)
    sm_scale = 1.0 / math.sqrt(probes.HEAD_DIM)
    scale2 = sm_scale * LOG2E
    for seq in seqs:
        q, k, v = probes.make_inputs(heads, seq)
        flops = attention_flops(1, heads, seq, probes.HEAD_DIM, causal=False)
        wants = {c: probes.oracle_out(q, k, v, causal=c, sm_scale=sm_scale) for c in (False, True)}
        sdpa_ms = {c: probes.graphed_s(lambda: probes.sdpa(q, k, v, causal=c, sm_scale=sm_scale), quick=quick) * 1e3
                   for c in (False, True)}
        for name, (stage, epilogue, mask, hb) in STAGES.items():
            causal = ATTENTION.get(name)
            row = probes.measure(
                "P2", name, heads=heads, seq=seq,
                kernel=lambda: probes.probe_single(q, k, v, scale2, stage=stage, epilogue=epilogue, mask=mask, hb=hb),
                plain=lambda: probes.single_plain(q, k, v, scale2, stage=stage, epilogue=epilogue, mask=mask),
                bar=probes.PLAIN_BAR, pairs=seq * (seq + 1) // 2 if mask else seq * seq, flops=flops,
                timer=timer, want=None if causal is None else wants[causal],
                sdpa_ms=None if causal is None else sdpa_ms[causal],
            )
            row["peak_share"] = flops / (row["ms"] * 1e-3) / (TENSOR_PEAK_TFLOPS["H100"] * 1e12)
            log(f"{probes.format_row(row)}  {row['ms'] * 1e3:8.2f} us  ({row['peak_share'] * 100:5.1f}% of peak)")
            rows.append(row)
    return rows


def main() -> None:
    print(card_description(), flush=True)
    run(log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
