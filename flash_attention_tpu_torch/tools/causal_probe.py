"""P4: whether causal tile skipping pays, and how the mask should be gated.

Counterpart of the repository's tools/causal_probe.py: body T
(csrc/probes.cu) in fp32 at its causal shape (32 heads, seq 8192, head_dim
128, unscaled q and no scale, as the JAX probe's main ran it), toggling

  skip   the kv loop stops at the tile holding the q tile's last row, or
         walks every tile;
  mask   none (numerically wrong without the skip: a perf probe only, as in
         the JAX probe), always (every tile takes the causal iota mask), or
         cond (only the tiles crossing the diagonal, by a branch uniform
         over the block: the counterpart of its lax.cond).

over three tile shapes standing for its (512, 1024), (1024, 1024) and (512,
512) blocks. Each row: the kernel's time (``time_fn``, 5 + 20 calls, 2 runs,
the fastest) in ms and causal TFLOP/s, its error against the plain version
and, for the masked variants, the fp32 causal oracle (softmax scale ln 2),
the plain version's time, the bound (causal pairs when masked; the tiles
walked otherwise) and causal SDPA.

    python3 -m flash_attention_tpu_torch.tools.causal_probe
"""

from __future__ import annotations

import math

from flash_attention_tpu_torch.tools import probes
from flash_attention_tpu_torch.utils.benchmarking import attention_flops, card_description

SEQ = 8192
TILES = ((64, 128), (128, 128), (64, 64))
SMOKE_TILES = ((128, 128),)
VARIANTS = tuple((skip, mask) for skip in (False, True) for mask in ("none", "always", "cond"))


def run(tiles=TILES, *, seq: int = SEQ, heads: int = 32, quick: bool = False, log=print) -> list[dict]:
    """Every (skip, mask) over each tile shape of ``tiles``; returns the rows,
    logging each. ``quick`` is taken for the tools' common interface:
    ``time_fn``'s 45 calls are short either way."""
    rows = []
    q, k, v = probes.make_inputs(heads, seq)
    want = probes.oracle_out(q, k, v, causal=True, sm_scale=math.log(2))
    sdpa_ms = probes.looped_s(lambda: probes.sdpa(q, k, v, causal=True, sm_scale=math.log(2))) * 1e3
    flops = attention_flops(1, heads, seq, probes.HEAD_DIM, causal=True)
    for bm, bn in tiles:
        for skip, mask in VARIANTS:
            kw = dict(bm=bm, bn=bn, skip=skip, mask=mask)
            row = probes.measure(
                "P4", f"{bm}x{bn} skip={int(skip)} mask={mask}", heads=heads, seq=seq,
                kernel=lambda: probes.probe_tiled(q, k, v, **kw),
                plain=lambda: probes.tiled_plain(q, k, v, **kw),
                bar=probes.PLAIN_BAR, pairs=probes.tiled_pairs(seq, **kw), flops=flops, timer=probes.looped_s,
                want=None if mask == "none" else want, sdpa_ms=sdpa_ms,
            )
            log(probes.format_row(row))
            rows.append(row)
    return rows


def main() -> None:
    print(card_description(), flush=True)
    run(log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
