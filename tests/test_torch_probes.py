"""The probes P1-P6 of the PyTorch port against the JAX probes.

Each plain version of ``flash_attention_tpu_torch/tools/probes.py`` (the
function its CUDA body computes on the card) is held against the TPU probe
it ports (``tools/*_probe.py``) on the same numpy inputs, at seq 256, 2-4
heads and head_dim 128. The JAX probes run unchanged, in Pallas's interpret
mode: the ``interpret`` fixture swaps ``pl.pallas_call`` for a partial with
``interpret=True``, which the probes look up when they are called.

Bars, row-relative (max|port - JAX| / max|JAX| in each head and row):
``probes.PLAIN_BAR`` (1e-2) where the softmax runs in fp32, since both sides
round the same fp32 values to bf16 and two such roundings differ by at most
one ulp (2^-7 of the element); ``probes.BF16_BAR`` (3e-2) where it or the
epilogue runs in bf16, since exp2 in bf16 may differ by one ulp per p on
either side, and a bf16 epilogue rounds twice. The
variants that compute attention are also held within 0.1 (the repository's
bar) of the port's fp32 oracle.
"""

from __future__ import annotations

import functools
import importlib.util
import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from flash_attention_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from flash_attention_tpu_torch.ops.common import LOG2E
from flash_attention_tpu_torch.ops.flash_attention import flash_attention
from flash_attention_tpu_torch.ops.reference import reference_attention
from flash_attention_tpu_torch.tools import probes

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEQ = 256
D = 128
SM_SCALE = 1.0 / math.sqrt(D)
SCALE2 = SM_SCALE * LOG2E


def _jax_probe(name: str):
    """The repository's tools/<name>.py, imported from its path."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _inputs(heads: int, seed: int = 0):
    """Seeded U(-0.5, 0.5) q, k, v [heads, SEQ, D] as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(-0.5, 0.5, (heads, SEQ, D)).astype(np.float32) for _ in range(3)]


def _jax(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def _torch(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _to_torch(y):
    return torch.from_numpy(np.array(y.astype(jnp.float32)))


def _oracle(q, k, v, *, causal: bool, sm_scale: float):
    return reference_attention(q[None], k[None], v[None], causal=causal, sm_scale=sm_scale,
                               out_dtype=torch.float32)[0]


def _hold(port, jax_out, bar, *, oracle=None):
    rel = probes.rel_err(port, _to_torch(jax_out))
    assert rel < bar, f"port vs JAX probe {rel:.3e} row-relative, bar {bar}"
    if oracle is not None:
        err = probes.max_abs(port, oracle)
        assert err < probes.ORACLE_BAR, f"|port - oracle| {err:.3e}"


# ---------------------------------------------------------------- body T: P1, P3, P4


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("arith", ["f32", "bf16"])
def test_p1_softmax_arithmetic(interpret, arith, causal):
    mod = _jax_probe("softmax_probe")
    qn, kn, vn = _inputs(2)
    qs = (qn * np.float32(SM_SCALE * LOG2E))
    want = mod.make_fn(SEQ, 128, 128, 2, causal=causal, variant=arith)(_jax(qs), _jax(kn), _jax(vn))
    got = probes.tiled_plain(_torch(qs), _torch(kn), _torch(vn), bm=128, bn=128, arith=arith, skip=causal,
                             mask="always" if causal else "none")
    bar = probes.BF16_BAR if arith == "bf16" else probes.PLAIN_BAR
    _hold(got, want, bar, oracle=_oracle(_torch(qn), _torch(kn), _torch(vn), causal=causal, sm_scale=SM_SCALE))


@pytest.mark.parametrize("column", [("par", False), ("arb", False), ("2d", True)])
def test_p3_grid_orders(interpret, column):
    name, collapse = column
    semantics = {"par": ("parallel", "parallel", "arbitrary"), "arb": ("arbitrary",) * 3,
                 "2d": ("parallel", "arbitrary")}[name]
    mod = _jax_probe("grid_probe")
    qn, kn, vn = _inputs(2, seed=3)
    fn, _ = mod.make_call(SEQ, 128, 128, 2, semantics=semantics, collapse_bh_q=collapse)
    want = fn(_jax(qn), _jax(kn), _jax(vn))
    q, k, v = _torch(qn), _torch(kn), _torch(vn)
    grid = {"par": "head", "arb": "qtile", "2d": "flat"}[name]
    got = probes.probe_tiled(q, k, v, bm=128, bn=128, grid=grid)
    _hold(got, want, probes.PLAIN_BAR, oracle=_oracle(q, k, v, causal=False, sm_scale=math.log(2)))


@pytest.mark.parametrize("mask", ["none", "always", "cond"])
@pytest.mark.parametrize("skip", [False, True])
def test_p4_causal_skip_and_mask(interpret, skip, mask):
    mod = _jax_probe("causal_probe")
    qn, kn, vn = _inputs(2, seed=4)
    want = mod.make_fn(SEQ, 64, 128, 2, skip=skip, mask=mask)(_jax(qn), _jax(kn), _jax(vn))
    q, k, v = _torch(qn), _torch(kn), _torch(vn)
    got = probes.tiled_plain(q, k, v, bm=64, bn=128, skip=skip, mask=mask)
    oracle = None if mask == "none" else _oracle(q, k, v, causal=True, sm_scale=math.log(2))
    _hold(got, want, probes.PLAIN_BAR, oracle=oracle)


def test_tiled_causal_variants_agree_bit_for_bit():
    """Skipping a tile above the diagonal and masking it give the same bits
    (m unchanged, alpha 1, p 0), and cond masks only tiles that need it."""
    q, k, v = (_torch(x) for x in _inputs(3, seed=5))
    outs = [probes.tiled_plain(q, k, v, bm=64, bn=64, skip=skip, mask=mask)
            for skip in (False, True) for mask in ("always", "cond")]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("tile", probes.TILES)
@pytest.mark.parametrize("variant", [(False, "none"), (True, "none"), (True, "always")])
def test_tiled_pairs_count_the_function(tile, variant):
    """The pairs behind the bound are the pairs the plain version reads:
    perturbing an unread key moves nothing."""
    bm, bn = tile
    skip, mask = variant
    seq = 256
    rows, cols = np.arange(seq)[:, None], np.arange(seq)[None, :]
    if mask != "none":
        read = cols <= rows
    elif skip:
        read = cols < ((rows // bm + 1) * bm - 1) // bn * bn + bn
    else:
        read = np.ones((seq, seq), bool)
    assert probes.tiled_pairs(seq, bm=bm, bn=bn, skip=skip, mask=mask) == int(read.sum())
    q, k, v = (_torch(x)[:1] for x in _inputs(1, seed=6))
    base = probes.tiled_plain(q, k, v, bm=bm, bn=bn, skip=skip, mask=mask)
    unread_cols = np.flatnonzero(~read.any(axis=0))
    if unread_cols.size:
        k2 = k.clone()
        k2[:, unread_cols] = 7.0
        assert torch.equal(base, probes.tiled_plain(q, k2, v, bm=bm, bn=bn, skip=skip, mask=mask))


# ---------------------------------------------------------------- body S: P2, P5, P6


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


@pytest.mark.parametrize("stage", ["mma", "max", "exp2", "full", "mask", "perhead"])
def test_p2_stages(interpret, stage):
    mod = _jax_probe("mfu_probe")
    from flash_attention_tpu_torch.tools.mfu_probe import ATTENTION, STAGES

    qn, kn, vn = _inputs(4, seed=2)
    hb = 2
    if stage == "perhead":
        kernel = functools.partial(mod.perhead_kernel, scale2=SCALE2, hb=hb)
    else:
        kernel = functools.partial(mod.probe_kernel, stage=stage, scale2=SCALE2)
    want = _jax_single(kernel, _jax(qn), _jax(kn), _jax(vn), hb)
    body_stage, epilogue, mask, _ = STAGES[stage]
    q, k, v = _torch(qn), _torch(kn), _torch(vn)
    got = probes.single_plain(q, k, v, SCALE2, stage=body_stage, epilogue=epilogue, mask=mask)
    causal = ATTENTION.get(stage)
    oracle = None if causal is None else _oracle(q, k, v, causal=causal, sm_scale=SM_SCALE)
    _hold(got, want, probes.PLAIN_BAR, oracle=oracle)


@pytest.mark.parametrize("flags", [{}, {"grid3": True}, {"scratch": True}, {"cost": True},
                                   {"grid3": True, "scratch": True, "cost": True}])
def test_p5_bare_single_step(interpret, flags):
    mod = _jax_probe("gap_probe")
    qn, kn, vn = _inputs(4, seed=7)
    want = mod.bare(_jax(qn), _jax(kn), _jax(vn), 2, **flags)
    q, k, v = _torch(qn), _torch(kn), _torch(vn)
    got = probes.single_plain(q, k, v, SCALE2, epilogue="after_pv")
    _hold(got, want, probes.PLAIN_BAR, oracle=_oracle(q, k, v, causal=False, sm_scale=SM_SCALE))


def test_p5_real_flash_attention(interpret):
    qn, kn, vn = _inputs(2, seed=8)
    want = jax_flash_attention(_jax(qn)[None], _jax(kn)[None], _jax(vn)[None], causal=False)[0]
    q, k, v = _torch(qn), _torch(kn), _torch(vn)
    got = flash_attention(q[None], k[None], v[None], causal=False)[0]
    _hold(got, want, probes.PLAIN_BAR, oracle=_oracle(q, k, v, causal=False, sm_scale=SM_SCALE))


@pytest.mark.parametrize("epilogue", ["none", "before_pv", "after_pv", "after_pv_noguard", "after_pv_bf16"])
def test_p6_epilogues(interpret, epilogue):
    mod = _jax_probe("epilogue_probe")
    qn, kn, vn = _inputs(4, seed=9)
    want = _jax_single(functools.partial(mod.kernel, scale2=SCALE2, variant=epilogue), _jax(qn), _jax(kn),
                       _jax(vn), 2)
    q, k, v = _torch(qn), _torch(kn), _torch(vn)
    got = probes.single_plain(q, k, v, SCALE2, epilogue=epilogue)
    oracle = None if epilogue == "none" else _oracle(q, k, v, causal=False, sm_scale=SM_SCALE)
    _hold(got, want, probes.BF16_BAR if epilogue == "after_pv_bf16" else probes.PLAIN_BAR, oracle=oracle)


# ---------------------------------------------------------------- the wrappers


def test_wrappers_take_the_plain_version_on_cpu_without_a_launch():
    q, k, v = (_torch(x) for x in _inputs(2, seed=10))
    tiled, single = probes.launch_tiled.launches, probes.launch_single.launches
    got = probes.probe_tiled(q, k, v, bm=64, bn=128, skip=True, mask="cond")
    assert torch.equal(got, probes.tiled_plain(q, k, v, bm=64, bn=128, skip=True, mask="cond"))
    got = probes.probe_single(q, k, v, epilogue="after_pv")
    assert torch.equal(got, probes.single_plain(q, k, v, SCALE2, epilogue="after_pv"))
    assert (probes.launch_tiled.launches, probes.launch_single.launches) == (tiled, single)


@pytest.mark.parametrize("case", [
    ("tiled", dict(bm=32, bn=64), "tile"),
    ("tiled", dict(bm=64, bn=64, grid="flat", skip=True), "unmasked fp32"),
    ("tiled", dict(bm=64, bn=64, arith="bf16", mask="cond"), "bf16 softmax"),
    ("single", dict(stage="mma", epilogue="after_pv"), "epilogue 'none'"),
    ("single", dict(stage="softmax", epilogue="after_pv", mask=True), "full stage"),
    ("single", dict(hb=3), "hb must be"),
])
def test_wrappers_refuse_what_no_instantiation_takes(case):
    body, kw, message = case
    q, k, v = (_torch(x) for x in _inputs(2, seed=11))
    fn = probes.probe_tiled if body == "tiled" else probes.probe_single
    with pytest.raises(ValueError, match=message):
        fn(q, k, v, **kw)


def test_wrappers_check_their_operands():
    q, k, v = (_torch(x) for x in _inputs(2, seed=12))
    with pytest.raises(ValueError, match="bfloat16"):
        probes.probe_tiled(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="contiguous"):
        probes.probe_single(q.transpose(0, 1).contiguous().transpose(0, 1), k, v)
    with pytest.raises(ValueError, match="multiple of 128"):
        probes.probe_single(*(torch.zeros(2, 2048, D, dtype=torch.bfloat16),) * 3)
    with pytest.raises(ValueError, match=r"\[heads, seq, 128\]"):
        probes.probe_tiled(q[..., :64].contiguous(), k[..., :64].contiguous(), v[..., :64].contiguous())


# ---------------------------------------------------------------- what the port reads

PORT = ROOT / "flash_attention_tpu_torch"


def test_port_and_its_probe_tools_import_neither_jax_nor_the_repos_tools():
    """No source of the port (its probe tools included) nor chip_smoke.py
    imports jax or a module of the repository's tools/, or loads a module
    from a file path to do so."""
    imports = re.compile(r"^\s*(?:import|from)\s+(?:jax|tools)\b|spec_from_file_location")
    files = [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]
    assert {"softmax_probe.py", "mfu_probe.py", "grid_probe.py", "causal_probe.py", "gap_probe.py",
            "epilogue_probe.py", "probes.py"} <= {p.name for p in files}
    hits = [f"{p.name}:{i}" for p in files for i, line in enumerate(p.read_text().splitlines(), 1)
            if imports.search(line)]
    assert not hits, hits
    assert imports.search("from tools.softmax_probe import make_fn") and imports.search("import jax.numpy as jnp")
    assert not imports.search("from flash_attention_tpu_torch.tools import probes")
