"""P3: what the tile shape and the block order cost, on the card.

Counterpart of the repository's tools/grid_probe.py, which timed the
unmasked fp32 online-softmax body under three grid shapes and dimension
semantics. On Hopper the three columns become three block orders of body T
(csrc/probes.cu), all over the same unmasked fp32 body with unscaled q and no
scale, as the JAX probe's main ran it:

  par   head-major 2-D: q tile on blockIdx.x, head on blockIdx.y, so blocks
        in flight share a head's K/V in L2;
  arb   q-tile-major 2-D: the two swapped, so blocks in flight are different
        heads (Mosaic's sequential order has no counterpart on the card);
  2d    one collapsed 1-D grid whose block derives head and q tile by a
        division, as the JAX probe's collapsed index maps did.

Each is timed at seq 512-8192 (32 heads, head_dim 128) for the four tile
shapes by ``scan_timer`` (CUDA-graph replay, the kernel alone; the JAX probe
timed an in-graph scan of 8 calls), beside its error against the plain
version and the fp32 oracle (softmax scale ln 2: exp2 of the raw scores),
the plain version's time, the bound and SDPA.

    python3 -m flash_attention_tpu_torch.tools.grid_probe
"""

from __future__ import annotations

import functools
import math

from flash_attention_tpu_torch.tools import probes
from flash_attention_tpu_torch.utils.benchmarking import attention_flops, card_description

SWEEP = tuple((seq, probes.TILES) for seq in (512, 1024, 2048, 8192))
SMOKE_SWEEP = ((1024, probes.TILES), (8192, ((128, 64), (128, 128))))
COLUMNS = (("par", "head"), ("arb", "qtile"), ("2d", "flat"))


def run(sweep=SWEEP, *, heads: int = 32, quick: bool = False, log=print) -> list[dict]:
    """Every (seq, tiles) of ``sweep`` under the three block orders; returns
    the rows, logging each. ``quick`` shortens the graph replays to ~20 ms
    (chip_smoke.py's phase 21)."""
    rows = []
    timer = functools.partial(probes.graphed_s, quick=quick)
    for seq, tiles in sweep:
        q, k, v = probes.make_inputs(heads, seq)
        want = probes.oracle_out(q, k, v, causal=False, sm_scale=math.log(2))
        sdpa_ms = probes.graphed_s(lambda: probes.sdpa(q, k, v, causal=False, sm_scale=math.log(2)), quick=quick) * 1e3
        flops = attention_flops(1, heads, seq, probes.HEAD_DIM, causal=False)
        for bm, bn in tiles:
            for name, grid in COLUMNS:
                row = probes.measure(
                    "P3", f"{bm}x{bn} {name}", heads=heads, seq=seq,
                    kernel=lambda: probes.probe_tiled(q, k, v, bm=bm, bn=bn, grid=grid),
                    plain=lambda: probes.tiled_plain(q, k, v, bm=bm, bn=bn),
                    bar=probes.PLAIN_BAR, pairs=seq * seq, flops=flops, timer=timer, want=want,
                    sdpa_ms=sdpa_ms,
                )
                log(probes.format_row(row))
                rows.append(row)
    return rows


def main() -> None:
    print(card_description(), flush=True)
    run(log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
