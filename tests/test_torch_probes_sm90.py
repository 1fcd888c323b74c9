"""The pure parts of the probes' Hopper bodies (csrc/probes.cu), on the CPU.

The kernels run only on the card (chip_smoke.py phase 21); what they decide
from the shapes alone is mirrored in ``flash_attention_tpu_torch/tools/probes.py``
and held here:

* body S's split: each row's columns over a cluster of ``single_parts(hb)``
  blocks, whose maxima, sums and partial outputs meet in rank order.
  ``single_split_plain`` / ``single_terms(parts=...)`` against the unsplit
  function for every variant ``check_single`` accepts, in fp32 within 1e-6
  (the split moves only the order of l's sum and of the partial outputs'
  sum; an fp32 sum of at most 1024 terms in either order differs by a few
  ulps of its largest term), but for P V under before_pv, where 1/l's last
  bits can flip a bf16 rounding of p (see the test); the bf16 outputs
  within the probes' bars; and against the JAX probes' kernels in interpret
  mode, as tests/test_torch_probes.py runs them;
* body T's walk: which (head, q tile) each block takes in launch order for
  the three block orders, the kv tiles it walks and those that take the
  mask, against ``tiled_pairs`` and against the function's own reads;
* the shared memory each instantiation asks for, within the 232,448 bytes
  an H100 block may use.
"""

from __future__ import annotations

import functools
import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from flash_attention_tpu_torch.ops.common import LOG2E
from flash_attention_tpu_torch.tools import probes

ROOT = pathlib.Path(__file__).resolve().parents[1]
D = probes.HEAD_DIM
SCALE2 = LOG2E / math.sqrt(D)
SPLIT_BAR = 1e-6

# Every (stage, epilogue, mask, hb) check_single accepts.
SINGLE_VARIANTS = [("mma", "none", False, 1), ("max", "none", False, 1)]
SINGLE_VARIANTS += [("softmax", e, False, 1) for e in probes.EPILOGUES]
SINGLE_VARIANTS += [("softmax", "before_pv", True, 1), ("softmax", "before_pv", False, 2)]


def _inputs(heads: int, seq: int, seed: int):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.uniform(-0.5, 0.5, (heads, seq, D)).astype(np.float32)).to(torch.bfloat16)
            for _ in range(3)]


def _row_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return probes.rel_err(got, want)


# ---------------------------------------------------------------- body S's split


def test_every_variant_check_single_accepts_is_listed():
    stages, epilogues = list(probes.STAGES), list(probes.EPILOGUES)
    accepted = []
    for stage in stages:
        for epilogue in epilogues:
            for mask in (False, True):
                for hb in (1, 2):
                    try:
                        probes.check_single(4, 256, stage=stage, epilogue=epilogue, mask=mask, hb=hb)
                    except ValueError:
                        continue
                    accepted.append((stage, epilogue, mask, hb))
    assert sorted(accepted) == sorted(SINGLE_VARIANTS)


@pytest.mark.parametrize("seq", [128, 384])
@pytest.mark.parametrize("variant", SINGLE_VARIANTS, ids=lambda v: "-".join(map(str, v)))
def test_split_terms_match_the_unsplit_function(variant, seq):
    """The kernel's split (parts = single_parts(hb)) gives the unsplit
    function's l, and so p · (1/l) before its rounding, in fp32 within
    SPLIT_BAR relative, and its P V within SPLIT_BAR of each row's largest
    wherever p does not depend on l. Where it does (before_pv), a p · (1/l)
    within a few fp32 ulps of a bf16 rounding boundary rounds the other
    way, one bf16 ulp of that p (~2e-4 of the row measured): P V is then
    held to the probes' bar."""
    stage, epilogue, mask, hb = variant
    q, k, v = _inputs(2 * hb, seq, seed=seq + hb)
    kw = dict(stage=stage, epilogue=epilogue, mask=mask)
    pv, l = probes.single_terms(q, k, v, SCALE2, **kw)
    pv_s, l_s = probes.single_terms(q, k, v, SCALE2, parts=probes.single_parts(hb), **kw)
    assert (l is None) == (l_s is None)
    if l is not None:
        assert float(((l_s - l).abs() / l.abs()).max()) < SPLIT_BAR
    assert _row_rel(pv_s, pv) < (probes.PLAIN_BAR if epilogue == "before_pv" else SPLIT_BAR)


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("variant", SINGLE_VARIANTS, ids=lambda v: "-".join(map(str, v)))
def test_split_outputs_within_the_probes_bars(variant, parts):
    """single_split_plain's bf16 outputs against single_plain's within the
    bar the probes hold the kernel to (a rounding may land one ulp apart)."""
    stage, epilogue, mask, _ = variant
    q, k, v = _inputs(2, 256, seed=parts)
    kw = dict(stage=stage, epilogue=epilogue, mask=mask)
    got = probes.single_split_plain(q, k, v, SCALE2, parts=parts, **kw)
    want = probes.single_plain(q, k, v, SCALE2, **kw)
    assert got.dtype == want.dtype == torch.bfloat16
    bar = probes.BF16_BAR if epilogue == "after_pv_bf16" else probes.PLAIN_BAR
    assert _row_rel(got, want) < bar


def test_unsplit_terms_are_single_plain():
    q, k, v = _inputs(2, 256, seed=21)
    for stage, epilogue, mask, _ in SINGLE_VARIANTS:
        kw = dict(stage=stage, epilogue=epilogue, mask=mask)
        assert torch.equal(probes.single_split_plain(q, k, v, SCALE2, parts=1, **kw),
                           probes.single_plain(q, k, v, SCALE2, **kw))


def test_split_adds_the_parts_in_rank_order():
    """The partial outputs are summed ((o0 + o1) + o2) + o3, as the kernel's
    owner block adds what it receives: the mirror does the same sums."""
    q, k, v = _inputs(1, 256, seed=22)
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float())
    m = (s.amax(-1, keepdim=True) * SCALE2).clamp_min(probes.M_FLOOR)
    p = torch.exp2(s * SCALE2 - m)
    terms = [torch.einsum("hqk,hkd->hqd", p[..., i * 64:(i + 1) * 64].bfloat16().float(),
                          v[:, i * 64:(i + 1) * 64].float()) for i in range(4)]
    pv, _ = probes.single_terms(q, k, v, SCALE2, epilogue="none", parts=4)
    assert torch.equal(pv, ((terms[0] + terms[1]) + terms[2]) + terms[3])


def _jax_probe(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _jax_single(kernel, q, k, v, hb: int):
    """The JAX probes' single-pass pallas_call (mfu_probe.py:run_probe,
    epilogue_probe.py:run) without its timer."""
    bh, seq, d = q.shape
    spec = pl.BlockSpec((hb, seq, d), lambda i: (i, 0, 0))
    return pl.pallas_call(
        kernel, grid=(bh // hb,), in_specs=[spec, spec, spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((bh, seq, d), q.dtype),
        compiler_params=pltpu.CompilerParams(dimension_semantics=("parallel",)),
    )(q, k, v)


@pytest.mark.parametrize("hb", [1, 2])
@pytest.mark.parametrize("probe", ["mfu_full", "epilogue_after_pv"])
def test_split_against_the_jax_probes(interpret, probe, hb):
    """The kernel's split at hb 1 and 2 against mfu_probe.py's full stage and
    epilogue_probe.py's after_pv epilogue, run in interpret mode."""
    q, k, v = _inputs(4, 256, seed=23 + hb)
    qj, kj, vj = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, k, v))
    if probe == "mfu_full":
        kernel, epilogue = functools.partial(_jax_probe("mfu_probe").probe_kernel, stage="full", scale2=SCALE2), "before_pv"
    else:
        kernel = functools.partial(_jax_probe("epilogue_probe").kernel, scale2=SCALE2, variant="after_pv")
        epilogue = "after_pv"
    want = torch.from_numpy(np.array(_jax_single(kernel, qj, kj, vj, 2).astype(jnp.float32)))
    got = probes.single_split_plain(q, k, v, SCALE2, epilogue=epilogue, parts=probes.single_parts(hb))
    assert _row_rel(got, want) < probes.PLAIN_BAR
    oracle = probes.oracle_out(q, k, v, causal=False, sm_scale=1 / math.sqrt(D))
    assert probes.max_abs(got, oracle) < probes.ORACLE_BAR


# ---------------------------------------------------------------- body T's walk

TILED_VARIANTS = [("f32", skip, mask, "head") for skip in (False, True) for mask in ("none", "always", "cond")]
TILED_VARIANTS += [("bf16", False, "none", "head"), ("bf16", True, "always", "head"),
                   ("f32", False, "none", "qtile"), ("f32", False, "none", "flat")]


@pytest.mark.parametrize("grid", ["head", "qtile", "flat"])
def test_walk_orders_are_the_documented_ones(grid):
    """head: q tile on x, head on y (one head's q tiles in a row); qtile: the
    two swapped (one q tile of every head in a row); flat: one x of head ·
    nq + q tile, the head-major order."""
    heads, seq, bm = 3, 512, 128
    nq = seq // bm
    order = [(h, i) for h, i, _, _ in probes.tiled_walk(heads, seq, bm=bm, bn=64, skip=False, mask="none", grid=grid)]
    assert sorted(order) == [(h, i) for h in range(heads) for i in range(nq)]
    if grid == "qtile":
        assert order == [(h, i) for i in range(nq) for h in range(heads)]
    else:
        assert order == [(h, i) for h in range(heads) for i in range(nq)]


@pytest.mark.parametrize("tile", probes.TILES)
@pytest.mark.parametrize("variant", TILED_VARIANTS, ids=lambda v: "-".join(map(str, v)))
def test_walk_reads_the_pairs_tiled_pairs_counts(variant, tile):
    """Every variant the kernel instantiates: the pairs the walk's tiles
    hold (causal pairs where a tile takes the mask) are tiled_pairs' count;
    the skip ends at the tile holding the block's last row; cond masks
    exactly the tiles crossing the block's first row."""
    arith, skip, mask, grid = variant
    bm, bn = tile
    heads, seq = 2, 512
    probes.check_tiled(seq, bm=bm, bn=bn, arith=arith, skip=skip, mask=mask, grid=grid)
    walk = probes.tiled_walk(heads, seq, bm=bm, bn=bn, skip=skip, mask=mask, grid=grid)
    pairs = 0
    for _, iq, tiles, masked in walk:
        rows = np.arange(iq * bm, (iq + 1) * bm)[:, None]
        assert tiles == tuple(range(len(tiles)))
        if skip:
            assert tiles[-1] * bn <= (iq + 1) * bm - 1 < (tiles[-1] + 1) * bn
        else:
            assert len(tiles) == seq // bn
        if mask == "cond":
            assert masked == tuple(j for j in tiles if (j + 1) * bn - 1 > iq * bm)
        for j in tiles:
            cols = np.arange(j * bn, (j + 1) * bn)[None, :]
            pairs += int((cols <= rows).sum()) if j in masked else bm * bn
    want = probes.tiled_pairs(seq, bm=bm, bn=bn, skip=skip, mask=mask) * heads
    assert pairs == want


@pytest.mark.parametrize("tile", probes.TILES)
def test_walk_one_tile_short_loses_pairs(tile):
    """A skip that ends one tile early (the mutation phase 21 must catch)
    drops visible pairs of every q tile whose last row's tile it cuts."""
    bm, bn = tile
    seq = 512
    walk = probes.tiled_walk(1, seq, bm=bm, bn=bn, skip=True, mask="always", grid="head")
    short = sum(int((np.arange(j * bn, (j + 1) * bn)[None, :] <= np.arange(iq * bm, (iq + 1) * bm)[:, None]).sum())
                for _, iq, tiles, _ in walk for j in tiles[:-1])
    assert short < probes.tiled_pairs(seq, bm=bm, bn=bn, skip=True, mask="always")


def test_tiled_plain_reads_only_the_walked_tiles():
    """Keys past a block's walk do not move its rows (the walk is the
    function's), for the skip at 64x128, where the last tile is half past
    the diagonal."""
    q, k, v = _inputs(1, 256, seed=24)
    base = probes.tiled_plain(q, k, v, bm=64, bn=128, skip=True, mask="none")
    k2 = k.clone()
    k2[:, 128:] = 3.0
    got = probes.tiled_plain(q, k2, v, bm=64, bn=128, skip=True, mask="none")
    assert torch.equal(got[:, :128], base[:, :128])
    assert not torch.equal(got[:, 128:], base[:, 128:])


# ---------------------------------------------------------------- shared memory


@pytest.mark.parametrize("tile", probes.TILES)
def test_body_t_fits_a_block(tile):
    assert probes.tiled_smem(*tile) <= probes.MAX_SMEM


def test_body_t_budget_by_parts():
    """Alignment slack, the Q tile, three K / V stages, seven mbarriers."""
    assert probes.tiled_smem(128, 128) == 1024 + 128 * 256 + 3 * 2 * 128 * 256 + 8 * 7 == 230456
    assert probes.tiled_smem(64, 64) == 1024 + 64 * 256 + 3 * 2 * 64 * 256 + 8 * 7


@pytest.mark.parametrize("hb", [1, 2])
@pytest.mark.parametrize("seq", range(probes.SINGLE_STAGE_ROWS, probes.SINGLE_MAX_SEQ + 1, probes.SINGLE_STAGE_ROWS))
def test_body_s_fits_a_block(seq, hb):
    assert probes.single_smem(seq, hb) <= probes.MAX_SMEM
    cols = seq // probes.single_parts(hb)
    assert cols % (64 if hb == 1 else 32) == 0  # whole ring stages a block


def test_body_s_budget_at_the_largest_seq():
    """64 rows × 512 fp32 scores (128 KB) with the Q tile, three 64-row
    stages and the 32 KB the partial outputs land in at hb 1; two heads'
    64 × 256 scores, Q tiles and 32-row rings at hb 2."""
    assert probes.single_smem(1024, 1) == 1024 + 16384 + 3 * 16384 + 131072 + 32768 + 2 * 2 * 64 * 4 + 8 * 4 == 231456
    assert probes.single_smem(1024, 2) == 1024 + 2 * (16384 + 3 * 8192 + 65536) + 2 * 2 * 4 * 64 * 4 + 8 * 2 * 4
    assert probes.single_smem(1024, 2) <= probes.MAX_SMEM
