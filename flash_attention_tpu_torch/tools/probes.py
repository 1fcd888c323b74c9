"""The probes' two CUDA bodies (csrc/probes.cu), their plain versions, and
what the six probe tools share.

Body T (``probe_tiled``; P1 ``softmax_probe``, P3 ``grid_probe``, P4
``causal_probe``) is a tiled attention forward with an online softmax over
q, k, v [heads, seq, 128] bf16, taking q as given (no scale: P1 passes it
scaled by sm_scale·log2(e), P3 and P4 unscaled, as the TPU probes' mains
do). On the card it is warp-specialised: a producer warpgroup fills a ring
of K / V tiles by TMA, and one or two consumer warpgroups run both
products on wgmma, taking turns at 128-row tiles. Body S (``probe_single``;
P2 ``mfu_probe``, P5 ``gap_probe``, P6 ``epilogue_probe``) is a single
pass over the whole row at seq <= 1024, scaling inside by ``scale2``, built
up by stage and epilogue; on the card each row's columns are split over a
cluster of 2 (hb 1) or 4 (hb 2) blocks, whose row maxima, sums and partial
outputs meet through distributed shared memory. What each variant
computes, which TPU probe it stands for and how the bodies are built is
written at the top of csrc/probes.cu.

Each wrapper checks device, dtype, shape and contiguity, takes the plain
version for CPU tensors, and for CUDA tensors allocates the output and
launches the kernel, or raises. ``launch_tiled`` and ``launch_single``
launch into a given output with no checks (P5's bare launch) and count
their launches in ``.launches``; the plain versions count nothing.

The plain versions compute each variant's function in fp32 PyTorch, the
deliberately wrong ones included (stages mma, max and exp2; mask none
without the tile skip), so every variant is held against something. The
tiled one walks the same kv tiles with the same online rescale, so it
rounds p to bf16 where the kernel does. ``single_split_plain`` mirrors
body S's split: per-part maxima, l and P V, added in the kernel's order.
``tiled_walk``, ``tiled_smem`` and ``single_smem`` mirror, from the shapes
alone, the blocks body T launches and the tiles each walks, and the shared
memory each instantiation asks for.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from flash_attention_tpu_torch.ops import _build
from flash_attention_tpu_torch.ops.common import LOG2E, M_FLOOR, MASK_VALUE
from flash_attention_tpu_torch.ops.counters import counter
from flash_attention_tpu_torch.ops.reference import reference_attention
from flash_attention_tpu_torch.utils import benchmarking

HEAD_DIM = 128
# -0.7 * bfloat16 max, the bf16 softmax's mask value (tools/softmax_probe.py).
MASK_VALUE_BF16 = -0.7 * 3.3895313892515355e38
TILES = ((64, 64), (128, 64), (64, 128), (128, 128))
SINGLE_STAGE_ROWS = 128  # body S's seq step: seq must be a multiple of it
SINGLE_MAX_SEQ = 1024  # body S holds 64 rows' fp32 scores over seq / parts columns a block
MAX_SMEM = 232448  # the shared memory an H100 block may use

ARITHS = {"f32": 0, "bf16": 1}
MASKS = {"none": 0, "always": 1, "cond": 2}
# Block orders, each standing for a column of tools/grid_probe.py: head-major
# 2-D ("par"), q-tile-major 2-D ("arb"), one collapsed 1-D grid ("2d").
GRIDS = {"head": 0, "qtile": 1, "flat": 2}
STAGES = {"mma": 0, "max": 1, "softmax": 2}
EPILOGUES = {"none": 0, "before_pv": 1, "after_pv": 2, "after_pv_noguard": 3, "after_pv_bf16": 4}

# Row-relative bars, kernel against plain on the card and plain against the
# JAX probe on the CPU: max|a - b| / max|b| in each (head, row).
# fp32 softmax: both sides round the same fp32 values to bf16 (p before PV,
# the output at the end); two roundings of nearly equal values differ by at
# most one bf16 ulp, 2^-7 of the element, so 2^-7 of the row's largest, plus
# the rare p whose rounding flips. 1e-2 is the repository's bf16 bar.
PLAIN_BAR = 1e-2
# The variants with bf16 arithmetic past the products. The bf16 softmax:
# exp2 in bf16 is within one bf16 ulp (2^-7 relative) of the rounded fp32
# exp2 on either side, so each p may move by 2^-7; the output, a p-weighted
# mean of v normalised by the same p's sum, moves by at most 2^-7 of max|v|
# in a row and is rounded once more. The bf16 epilogue (bf16(PV) ·
# bf16(1/l), rounded again): each of the two roundings may land one ulp
# apart on the two sides, 2 · 2^-7 of the element (1.036e-2 measured on the
# H100 against 1e-2).
BF16_BAR = 3e-2
# The repository's bar against the fp32 oracle.
ORACLE_BAR = 0.1
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s (NVIDIA's data sheet)
L2_BYTES = 50 * 2**20


def _check_inputs(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 3 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"{what}: q must be [heads, seq, {HEAD_DIM}], got {tuple(q.shape)}")
    for t in (k, v):
        if t.shape != q.shape:
            raise ValueError(f"{what}: q, k, v shapes differ: {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
        if t.device != q.device:
            raise ValueError(f"{what}: operands on {q.device} and {t.device}")
    for t in (q, k, v):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{what}: the probes take bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: runs on cpu or cuda tensors, got {q.device}")


# ---------------------------------------------------------------- body T


def check_tiled(seq: int, *, bm: int, bn: int, arith: str, skip: bool, mask: str, grid: str) -> None:
    """Raise on a body-T variant csrc/probes.cu does not instantiate."""
    if (bm, bn) not in TILES:
        raise ValueError(f"probe_tiled: tile {(bm, bn)} not in {TILES}")
    if seq % bm or seq % bn:
        raise ValueError(f"probe_tiled: seq {seq} is not a multiple of the tile {(bm, bn)}")
    if arith not in ARITHS or mask not in MASKS or grid not in GRIDS:
        raise ValueError(f"probe_tiled: unknown variant {arith!r}, {mask!r}, {grid!r}")
    if grid != "head" and (arith != "f32" or skip or mask != "none"):
        raise ValueError("probe_tiled: the qtile and flat grids run the unmasked fp32 body only")
    if arith == "bf16" and (skip, mask) not in ((False, "none"), (True, "always")):
        raise ValueError("probe_tiled: the bf16 softmax runs non-causal or causal with skip and mask 'always'")


def tiled_plain(q, k, v, *, bm: int, bn: int, arith: str = "f32", skip: bool = False, mask: str = "none"):
    """Body T's function in plain PyTorch: the same kv tiles in the same
    order, the online softmax in fp32 (or in bf16 as the bf16 variant), p
    rounded to bf16 before each PV product, the output normalised by l (0
    where l is 0)."""
    heads, seq, d = q.shape
    dev = q.device
    qf = q.float()
    rows = torch.arange(seq, device=dev)
    iq = rows // bm
    m = torch.full((heads, seq, 1), -math.inf, device=dev)
    l = torch.zeros((heads, seq, 1), device=dev)
    acc = torch.zeros((heads, seq, d), device=dev)
    bf16 = arith == "bf16"
    mask_value = torch.tensor(MASK_VALUE_BF16, dtype=torch.bfloat16).item() if bf16 else MASK_VALUE
    for j in range(seq // bn):
        cols = torch.arange(j * bn, (j + 1) * bn, device=dev)
        s = torch.einsum("hqd,hkd->hqk", qf, k[:, j * bn:(j + 1) * bn].float())
        if bf16:
            s = s.bfloat16().float()
        if mask != "none":
            above = cols[None, :] > rows[:, None]
            if mask == "cond":
                above = above & ((j + 1) * bn - 1 > iq * bm)[:, None]
            s = torch.where(above, mask_value, s)
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_next)
        if bf16:
            p = torch.exp2(s.bfloat16() - m_next.bfloat16())
            l_cur = p.float().sum(dim=-1, keepdim=True)
        else:
            p = torch.exp2(s - m_next)
            l_cur = p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("hqk,hkd->hqd", p.bfloat16().float(), v[:, j * bn:(j + 1) * bn].float())
        run = (j * bn <= (iq + 1) * bm - 1)[:, None] if skip else torch.ones_like(rows, dtype=torch.bool)[:, None]
        l = torch.where(run, alpha * l + l_cur, l)
        acc = torch.where(run, acc * alpha + pv, acc)
        m = torch.where(run, m_next, m)
    inv = torch.where(l == 0, 0.0, 1.0 / l)
    return (acc * inv).to(q.dtype)


def launch_tiled(q, k, v, out, *, bm: int, bn: int, arith: str, skip: bool, mask: str, grid: str) -> None:
    """Body T into ``out`` on the current stream, with no checks."""
    lib = _build.kernels()
    err = lib.fat_probe_tiled(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), q.shape[0], q.shape[1],
        bm, bn, ARITHS[arith], int(skip), MASKS[mask], GRIDS[grid],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "probe_tiled")
    launch_tiled.launches += 1


counter(launch_tiled, "launches", "PT", "tiled_kernel")


def probe_tiled(q, k, v, *, bm: int = 64, bn: int = 64, arith: str = "f32", skip: bool = False,
                mask: str = "none", grid: str = "head"):
    """Body T over q, k, v [heads, seq, 128] bf16: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check_inputs("probe_tiled", q, k, v)
    check_tiled(q.shape[1], bm=bm, bn=bn, arith=arith, skip=skip, mask=mask, grid=grid)
    if q.device.type == "cpu":
        return tiled_plain(q, k, v, bm=bm, bn=bn, arith=arith, skip=skip, mask=mask)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        launch_tiled(q, k, v, out, bm=bm, bn=bn, arith=arith, skip=skip, mask=mask, grid=grid)
    return out


def tiled_pairs(seq: int, *, bm: int, bn: int, skip: bool, mask: str) -> int:
    """(row, column) pairs a head of body T's function reads: causal with a
    mask; the tiles up to each q tile's last row with the skip alone; all
    without either."""
    if mask != "none":
        return seq * (seq + 1) // 2
    if skip:
        return sum(bm * min(seq, (((i + 1) * bm - 1) // bn + 1) * bn) for i in range(seq // bm))
    return seq * seq


def tiled_walk(heads: int, seq: int, *, bm: int, bn: int, skip: bool, mask: str, grid: str) -> list[tuple]:
    """Body T's blocks in launch order (blockIdx.x fastest, then y), each as
    (head, q tile, the kv tiles it walks, those that take the mask), from
    the shapes alone as csrc/probes.cu's tiled_kernel derives them: grid
    head puts the q tile on x and the head on y, qtile the two swapped, flat
    one x of head · (seq / bm) + q tile."""
    nq = seq // bm
    if grid == "head":
        order = [(h, i) for h in range(heads) for i in range(nq)]
    elif grid == "qtile":
        order = [(h, i) for i in range(nq) for h in range(heads)]
    else:
        order = [divmod(x, nq) for x in range(heads * nq)]
    walk = []
    for head, iq in order:
        tiles = tuple(range(((iq + 1) * bm - 1) // bn + 1 if skip else seq // bn))
        masked = tuple(j for j in tiles if mask == "always" or (mask == "cond" and (j + 1) * bn - 1 > iq * bm))
        walk.append((head, iq, tiles, masked))
    return walk


def tiled_smem(bm: int, bn: int) -> int:
    """Shared memory body T asks for at a tile shape (csrc/probes.cu
    TPlan::SMEM): 1024 bytes of alignment slack, the Q tile, the K / V ring
    and the mbarriers (Q; full and empty a stage)."""
    stages = 3
    return 1024 + bm * HEAD_DIM * 2 + 2 * stages * bn * HEAD_DIM * 2 + 8 * (1 + 2 * stages)


# ---------------------------------------------------------------- body S


def check_single(heads: int, seq: int, *, stage: str, epilogue: str, mask: bool, hb: int) -> None:
    """Raise on a body-S variant csrc/probes.cu does not instantiate."""
    if seq % SINGLE_STAGE_ROWS or not SINGLE_STAGE_ROWS <= seq <= SINGLE_MAX_SEQ:
        raise ValueError(
            f"probe_single: seq must be a multiple of {SINGLE_STAGE_ROWS} up to {SINGLE_MAX_SEQ}, got {seq}")
    if stage not in STAGES or epilogue not in EPILOGUES:
        raise ValueError(f"probe_single: unknown stage {stage!r} or epilogue {epilogue!r}")
    if stage != "softmax" and epilogue != "none":
        raise ValueError("probe_single: stages mma and max take epilogue 'none'")
    if (mask or hb != 1) and (stage, epilogue) != ("softmax", "before_pv"):
        raise ValueError("probe_single: the mask and hb 2 run the full stage (softmax, before_pv) only")
    if mask and hb != 1:
        raise ValueError("probe_single: the mask runs at hb 1")
    if hb not in (1, 2) or heads % hb:
        raise ValueError(f"probe_single: hb must be 1 or 2 and divide heads ({heads}), got {hb}")


def single_parts(hb: int) -> int:
    """Blocks of body S's cluster, over which each row's columns split."""
    return 2 * hb


def single_smem(seq: int, hb: int) -> int:
    """Shared memory body S asks for (csrc/probes.cu SPlan::bytes): 1024
    bytes of alignment slack; a warpgroup a head's Q tile, K / V ring
    (three stages of 64 rows at hb 1, of 32 at hb 2), fp32 score array (64
    rows × seq / parts) and the 32 KB of partial outputs it receives (apart
    at hb 1, in the score array's place at hb 2); the exchanged row maxima
    and sums; the mbarriers."""
    parts, tn, stages, recv = single_parts(hb), 64 if hb == 1 else 32, 3, 64 * HEAD_DIM * 4
    scores = 64 * (seq // parts) * 4
    region = 64 * HEAD_DIM * 2 + stages * tn * HEAD_DIM * 2 + (scores + recv if hb == 1 else max(scores, recv))
    return 1024 + hb * region + 2 * hb * parts * 64 * 4 + 8 * hb * (1 + stages)


def single_terms(q, k, v, scale2: float, *, stage: str = "softmax", epilogue: str = "before_pv",
                 mask: bool = False, parts: int = 1):
    """Body S's function up to its epilogue, in fp32, as tools/mfu_probe.py
    and tools/epilogue_probe.py compute it, with each row's columns split
    into ``parts`` equal parts as body S's cluster splits them: s = q kᵀ, the
    optional causal mask, each part's row max combined into m =
    max(rowmax(s)·scale2, M_FLOOR), then by stage p = bf16(s), bf16(s − m)
    or exp2(s·scale2 − m); each part's l and P V (p rounded to bf16, times
    1/l first for before_pv), added in part order. Returns (pv, l), l None
    where the stage takes none; parts=1 is the unsplit function."""
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float())
    seq = s.shape[-1]
    if mask:
        rows = torch.arange(seq, device=s.device)
        s = torch.where(rows[None, :] <= rows[:, None], s, MASK_VALUE)
    cols = seq // parts
    s_parts, v_parts = s.split(cols, dim=-1), v.float().split(cols, dim=-2)

    def pv_of(p_parts):
        pv = None
        for p_part, v_part in zip(p_parts, v_parts):
            term = torch.einsum("hqk,hkd->hqd", p_part.bfloat16().float(), v_part)
            pv = term if pv is None else pv + term
        return pv

    if stage == "mma":
        return pv_of(s_parts), None
    mx = s_parts[0].amax(dim=-1, keepdim=True)
    for s_part in s_parts[1:]:
        mx = torch.maximum(mx, s_part.amax(dim=-1, keepdim=True))
    m = (mx * scale2).clamp_min(M_FLOOR)
    if stage == "max":
        return pv_of([s_part - m for s_part in s_parts]), None
    p_parts = [torch.exp2(s_part * scale2 - m) for s_part in s_parts]
    l = p_parts[0].sum(dim=-1, keepdim=True)
    for p_part in p_parts[1:]:
        l = l + p_part.sum(dim=-1, keepdim=True)
    if epilogue == "before_pv":
        inv = torch.where(l == 0, 0.0, 1.0 / l)
        p_parts = [p_part * inv for p_part in p_parts]
    return pv_of(p_parts), l


def _single_epilogue(pv, l, epilogue: str, dtype):
    if l is None or epilogue in ("none", "before_pv"):
        return pv.to(dtype)
    inv = torch.where(l == 0, 0.0, 1.0 / l)
    if epilogue == "after_pv":
        return (pv * inv).to(dtype)
    if epilogue == "after_pv_noguard":
        return (pv / l).to(dtype)
    return pv.to(dtype) * inv.to(dtype)  # after_pv_bf16: the product in bf16


def single_plain(q, k, v, scale2: float, *, stage: str = "softmax", epilogue: str = "before_pv", mask: bool = False):
    """Body S's function in plain PyTorch, as tools/mfu_probe.py:probe_kernel
    and tools/epilogue_probe.py:kernel compute it (``single_terms`` unsplit),
    with the epilogue putting 1/l where it says."""
    terms = single_terms(q, k, v, scale2, stage=stage, epilogue=epilogue, mask=mask)
    return _single_epilogue(*terms, epilogue, q.dtype)


def single_split_plain(q, k, v, scale2: float, *, stage: str = "softmax", epilogue: str = "before_pv",
                       mask: bool = False, parts: int = 2):
    """``single_plain`` with the columns split into ``parts`` (2 or 4) as body
    S's cluster splits them: the same function, its l and P V summed by part
    in rank order, as the kernel sums them."""
    terms = single_terms(q, k, v, scale2, stage=stage, epilogue=epilogue, mask=mask, parts=parts)
    return _single_epilogue(*terms, epilogue, q.dtype)


def launch_single(q, k, v, out, scale2: float, *, stage: str, epilogue: str, mask: bool, hb: int) -> None:
    """Body S into ``out`` on the current stream, with no checks."""
    lib = _build.kernels()
    err = lib.fat_probe_single(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), q.shape[0], q.shape[1], scale2,
        STAGES[stage], EPILOGUES[epilogue], int(mask), hb, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "probe_single")
    launch_single.launches += 1


counter(launch_single, "launches", "PS", "single_kernel")


def probe_single(q, k, v, scale2: float | None = None, *, stage: str = "softmax", epilogue: str = "before_pv",
                 mask: bool = False, hb: int = 1):
    """Body S over q, k, v [heads, seq, 128] bf16, seq a multiple of 128 up
    to 1024; ``scale2`` defaults to log2(e) / sqrt(128). The kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check_inputs("probe_single", q, k, v)
    check_single(q.shape[0], q.shape[1], stage=stage, epilogue=epilogue, mask=mask, hb=hb)
    if scale2 is None:
        scale2 = LOG2E / math.sqrt(HEAD_DIM)
    if q.device.type == "cpu":
        return single_plain(q, k, v, scale2, stage=stage, epilogue=epilogue, mask=mask)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        launch_single(q, k, v, out, scale2, stage=stage, epilogue=epilogue, mask=mask, hb=hb)
    return out


# ---------------------------------------------------------------- what the tools share


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over (head, row) of max|got − want| / max|want| in the row; a row
    where want is all 0 must be 0 in got as well."""
    a, b = got.float().flatten(0, -2), want.float().flatten(0, -2).to(got.device)
    err, scale = (a - b).abs().amax(1), b.abs().amax(1)
    rel = torch.where(scale > 0, err / scale.clamp(min=1e-30), torch.where(err > 0, math.inf, 0.0))
    return float(rel.max()) if rel.numel() else 0.0


def max_abs(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float().to(got.device)).abs().max())


def oracle_out(q, k, v, *, causal: bool, sm_scale: float, heads_at_once: int = 4) -> torch.Tensor:
    """The fp32 oracle's output over [heads, seq, D] inputs, a few heads at
    a time (the oracle materialises [h, seq, seq] scores)."""
    return torch.cat([
        reference_attention(q[None, h:h + heads_at_once], k[None, h:h + heads_at_once], v[None, h:h + heads_at_once],
                            causal=causal, sm_scale=sm_scale, out_dtype=torch.float32)[0]
        for h in range(0, q.shape[0], heads_at_once)
    ])


def bound_ms(pairs_per_head: int, heads: int, seq: int) -> tuple[float, str]:
    """The least time the card could take (ms) and what bounds it: the
    products' FLOPs (4 · pairs · 128 a head) over the dense bf16 peak
    against q, k, v and the output read or written once over HBM's rate."""
    t_ops = 4.0 * pairs_per_head * heads * HEAD_DIM / (benchmarking.TENSOR_PEAK_TFLOPS["H100"] * 1e12) * 1e3
    t_bytes = 4 * heads * seq * HEAD_DIM * 2 / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def residency(heads: int, seq: int) -> str:
    """Where repeated launches find q, k, v and the output: in the 50 MB L2
    when the four fit, else in HBM."""
    return "L2-warm" if 4 * heads * seq * HEAD_DIM * 2 <= L2_BYTES else "HBM"


def sdpa(q, k, v, *, causal: bool, sm_scale: float):
    """The yardstick: one scaled_dot_product_attention call on [1, heads,
    seq, D] views of the same inputs. Timed beside the probes only; no path
    of the port calls it."""
    return F.scaled_dot_product_attention(q[None], k[None], v[None], is_causal=causal, scale=sm_scale)[0]


def make_inputs(heads: int, seq: int, *, seed: int = 0, device: str = "cuda"):
    """q, k, v [heads, seq, 128] bf16 from ``make_qkv``'s numpy seed, the
    JAX probes' shapes with the port's inputs."""
    from flash_attention_tpu_torch.utils.testing import make_qkv

    q, k, v = make_qkv(seed, 1, heads, seq, HEAD_DIM, dtype=torch.bfloat16, device=device)
    return q[0].contiguous(), k[0].contiguous(), v[0].contiguous()


def format_row(row: dict) -> str:
    fl = row["flops"] / row["ms"] / 1e9
    parts = [
        f"{row['probe']} seq={row['seq']} {row['variant']:<28s} {row['ms']:8.4f} ms {fl:7.1f} TF",
        f"plain {row['plain_ms']:9.4f} ms",
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})",
        f"SDPA {row['sdpa_ms']:.4f} ms" if row.get("sdpa_ms") is not None else "SDPA —",
        f"rel {row['rel_plain']:.2e} (bar {row['bar']})",
        f"oracle {row['oracle_err']:.2e}" if row.get("oracle_err") is not None else "oracle —",
        row["residency"],
    ]
    return "  ".join(parts)


def graphed_s(fn, *, quick: bool = False) -> float:
    """Seconds a call from ``scan_timer`` (CUDA-graph replay: the kernel
    alone), as the TPU probes timed by in-graph scan; ``quick`` for a short
    sweep's replays of ~20 ms."""
    kw = dict(target_hi_s=0.02, iters=2, runs=2) if quick else {}
    return benchmarking.scan_timer(fn, (), **kw)


def looped_s(fn) -> float:
    """Seconds a call from ``time_fn`` with the TPU probes' own counts (5
    warm-up, 20 timed, 2 runs; the host included), the fastest run."""
    return min(benchmarking.time_fn(fn, warmup=5, iters=20, runs=2))


def measure(probe: str, variant: str, *, heads: int, seq: int, kernel, plain, bar: float, pairs: int,
            flops: float, timer, want=None, sdpa_ms: float | None = None) -> dict:
    """One row: the kernel's output held against its plain version (row by
    row, within ``bar``) and, given ``want`` (the fp32 oracle's output), the
    oracle (within ORACLE_BAR), raising past either; then the kernel
    timed by ``timer`` (seconds a call of a function), the plain version by a short ``time_fn`` run, the
    bound from ``pairs`` a head, and ``sdpa_ms`` beside them."""
    row = dict(probe=probe, variant=variant, seq=seq, heads=heads, flops=flops, bar=bar)
    got, ref = kernel().detach(), plain()
    row["rel_plain"], row["abs_plain"] = rel_err(got, ref), max_abs(got, ref)
    row["oracle_err"] = None if want is None else max_abs(got, want)
    del got, ref
    where = f"{probe} {variant} seq {seq}"
    if not row["rel_plain"] < bar:
        raise RuntimeError(f"{where}: kernel vs plain {row['rel_plain']:.3e} row-relative, bar {bar}")
    if want is not None and not row["oracle_err"] < ORACLE_BAR:
        raise RuntimeError(f"{where}: |kernel - oracle| {row['oracle_err']:.3e}, bar {ORACLE_BAR}")
    row["ms"] = timer(kernel) * 1e3
    row["plain_ms"] = min(benchmarking.time_fn(plain, warmup=1, iters=2, runs=1)) * 1e3
    row["bound_ms"], row["bound_by"] = bound_ms(pairs, heads, seq)
    row["sdpa_ms"] = sdpa_ms
    row["residency"] = residency(heads, seq)
    return row
