"""S1's wrapper and the plain version S1 is held to, on the CPU.

``sample_tokens`` runs the plain version for CPU tensors and S1
(csrc/sampling.cu) for CUDA ones; S1 itself runs only on the card, where
chip_smoke.py's phase 5 holds it against the plain version. Here:

  * the wrapper's dispatch: CPU tensors take the plain version and launch
    nothing, any other non-CUDA device raises;
  * the assumption S1's noise rests on: the plain ``_fma`` rounds a * b + c
    twice (to float64, then float32), S1's ``__fmaf_rn`` once, and the two
    agree unless the float64 sum is an inexact float32 midpoint. Every
    multiply-add of ``gumbel_noise``'s two logs at phase 5's edge seeds and
    positions is checked with TwoSum in float64: none is such a midpoint,
    and ``_fma`` equals the one-rounding fma on all of them;
  * the plain version's per-row kth and thresh against the same quantities
    computed with jnp as the JAX package's ``sample_tokens`` computes them
    (its lines 82-106), on rows that include a top_p == 1 row whose fp32
    cumsum reaches 1.0 before its end and rows with tied logits at the
    thresholds. kth is exact; thresh is exact or, where the two fp32 cumsums
    round across top_p at different entries, the exact mass rule holds at
    each version's boundary to within V * 2^-24, the error bound of an fp32
    cumsum of V probabilities (jnp.cumsum adds fp32 partial sums in a tree;
    torch's CPU cumsum accumulates in float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.serving.sampling import sample_tokens as jax_sample_tokens
from flash_attention_tpu_torch.serving import sampling
from flash_attention_tpu_torch.serving.sampling import (
    _plain_parts,
    _threefry2x32,
    gumbel_noise,
    sample_tokens,
    sample_tokens_detail,
    sample_tokens_plain,
)

# Phase 5's sampling seeds and its edge positions (chip_smoke.py: _sampling_inputs, phase_sampling).
EDGE_SEEDS = (0, 1, 7, 12345, 2**31 - 1, -1, -2**31, 99)
EDGE_POSITIONS = (0, 1, 2, 1000, 2047, 4096, 2**31 - 1, 1025)
VOCAB = 32000


def _rows(batch: int, rng):
    return dict(
        temperature=torch.from_numpy(rng.choice(np.array([0.0, 0.5, 0.7, 1.0, 1.3], np.float32), batch)),
        top_k=torch.from_numpy(rng.choice(np.array([0, 1, 5, 40, 300], np.int32), batch)),
        top_p=torch.from_numpy(rng.choice(np.array([1.0, 0.99, 0.9, 0.5], np.float32), batch)),
        seeds=torch.from_numpy(rng.integers(-2**31, 2**31, batch, dtype=np.int64).astype(np.int32)),
        positions=torch.from_numpy(rng.integers(0, 2**31, batch, dtype=np.int64).astype(np.int32)))


# ---- dispatch ----

def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    rng = np.random.default_rng(0)
    logits, rows = torch.from_numpy(rng.normal(size=(6, 300)).astype(np.float32) * 3), _rows(6, rng)
    launches = sample_tokens.launches
    got = sample_tokens(logits, **rows)
    assert got.dtype == torch.int32 and got.shape == (6,)
    assert torch.equal(got, sample_tokens_plain(logits, **rows))
    assert sample_tokens.launches == launches


def test_the_detail_mode_on_cpu_is_the_plain_versions_parts():
    rng = np.random.default_rng(1)
    logits, rows = torch.from_numpy(rng.normal(size=(5, 200)).astype(np.float32)), _rows(5, rng)
    got = sample_tokens_detail(logits, **rows)
    assert set(got) == {"tokens", "noise", "greedy", "kth", "thresh"}
    assert torch.equal(got["tokens"], sample_tokens_plain(logits, **rows))
    assert torch.equal(got["noise"], gumbel_noise(rows["seeds"], rows["positions"], 200))
    assert torch.equal(got["greedy"], torch.argmax(logits, dim=-1).to(torch.int32))
    assert got["kth"].shape == got["thresh"].shape == (5,)


@pytest.mark.parametrize("call", [sample_tokens, sample_tokens_detail])
def test_other_devices_raise(call):
    meta = [torch.zeros((2, 5), device="meta")] + [torch.zeros((2,), device="meta")] * 5
    with pytest.raises(ValueError, match="cpu or cuda"):
        call(*meta)


def test_s1_is_registered_as_a_counted_kernel():
    from flash_attention_tpu_torch.ops import counters

    fn, attr, functions = counters.KERNELS["S1"]
    assert fn is sample_tokens and attr == "launches" and functions == ("sample_kernel",)


# ---- the single rounding S1's noise rests on ----

def _uniforms(seed: int, positions, vocab: int) -> torch.Tensor:
    """``gumbel_noise``'s u for one seed at each position: its lines up to
    the two logs."""
    seed_t = torch.full((len(positions),), seed, dtype=torch.int64) & 0xFFFFFFFF
    pos = torch.tensor(positions, dtype=torch.int64) & 0xFFFFFFFF
    zero = torch.zeros_like(seed_t)
    k1, k2 = _threefry2x32(zero, seed_t, zero, pos)
    count = torch.arange(vocab, dtype=torch.int64)[None, :]
    b1, b2 = _threefry2x32(k1[:, None], k2[:, None], torch.zeros_like(count), count)
    mantissa = (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    tiny = torch.finfo(torch.float32).tiny
    return (mantissa * (1.0 - tiny) + tiny).clamp_min(tiny)


def _fma_once(a, b, c):
    """a * b + c (float32 arrays or scalars) rounded once to float32, and
    where the float64 sum is an inexact float32 midpoint. The product of two
    float32 values is exact in float64; TwoSum gives the float64 sum s and
    its error exactly, s + err == a * b + c, and rounding s to float32
    differs from rounding s + err only where s is a midpoint and err != 0."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.astype(np.float32)
    other = np.nextafter(r, np.where(s > r, np.float32(np.inf), np.float32(-np.inf)))
    midpoint = (s != r) & (s == (r.astype(np.float64) + other.astype(np.float64)) / 2) & (err != 0)
    once = np.where(midpoint, np.where(err > 0, np.maximum(r, other), np.minimum(r, other)), r)
    return once.astype(np.float32), midpoint


def _log_mirror(x: np.ndarray, fma) -> np.ndarray:
    """``sampling._log`` step by step in numpy float32, its multiply-adds
    through ``fma``."""
    f = np.float32
    x = np.maximum(x.astype(f), f(torch.finfo(torch.float32).tiny))
    bits = x.view(np.int32)
    m = ((bits & ~0x7F800000) | 0x3F000000).astype(np.int32).view(f)
    e = (((bits >> 23) & 0xFF) - 126).astype(f)
    low = m < f(sampling._SQRT_HALF)
    e = e - low.astype(f)
    m = (m - f(1.0)) + np.where(low, m, f(0.0))
    x2 = m * m
    x3 = x2 * m
    p = [f(c) for c in sampling._LOG_POLY]
    y0 = fma(fma(p[0], m, p[1]), m, p[2])
    y1 = fma(fma(p[3], m, p[4]), m, p[5])
    y2 = fma(fma(p[6], m, p[7]), m, p[8])
    y0 = fma(fma(y0, x3, y1), x3, y2)
    y = fma(y0, x3, e * f(sampling._LN2_LO))
    m = fma(f(-0.5), x2, m) + y
    return fma(f(sampling._LN2_HI), e, m)


@pytest.mark.parametrize("seed", EDGE_SEEDS)
def test_fma_rounds_once_over_gumbel_noise_inputs(seed):
    u = _uniforms(seed, EDGE_POSITIONS, VOCAB)
    assert torch.equal(-sampling._log(-sampling._log(u)),
                       gumbel_noise(torch.full((8,), seed, dtype=torch.int32), torch.tensor(EDGE_POSITIONS), VOCAB))
    tally = {"sums": 0, "midpoints": 0, "parted": 0}

    def fma(a, b, c):
        once, midpoint = _fma_once(a, b, c)
        as_arg = [float(v) if np.ndim(v) == 0 else torch.from_numpy(np.ascontiguousarray(v)) for v in (a, b, c)]
        plain = sampling._fma(*as_arg).numpy()
        tally["sums"] += once.size
        tally["midpoints"] += int(midpoint.sum())
        tally["parted"] += int((plain.view(np.int32) != once.view(np.int32)).sum())
        return once

    inner = _log_mirror(u.numpy(), fma)
    assert np.array_equal(inner.view(np.int32), sampling._log(u).numpy().view(np.int32))
    outer = _log_mirror(-inner, fma)
    assert np.array_equal((-outer).view(np.int32), (-sampling._log(torch.from_numpy(-inner))).numpy().view(np.int32))
    assert tally["sums"] == 2 * 11 * u.numel()
    assert tally["midpoints"] == 0 and tally["parted"] == 0, tally


def test_a_double_rounding_midpoint_is_found():
    """The check above can fail: (1 + 2^-23) * (1 - 2^-23) 2^-24 + (1 + 2^-23)
    is 1 + 3 * 2^-24 - 2^-70, whose float64 rounding is the float32 midpoint
    1 + 3 * 2^-24; rounded once it is 1 + 2^-23, rounded twice 1 + 2^-22."""
    a, b, c = np.float32(1 + 2.0**-23), np.float32((1 - 2.0**-23) * 2.0**-24), np.float32(1 + 2.0**-23)
    once, midpoint = _fma_once(a, b, c)
    assert bool(midpoint) and once == np.float32(1 + 2.0**-23)
    assert float(sampling._fma(float(a), float(b), torch.tensor([c]))[0]) == 1 + 2.0**-22


# ---- kth and thresh against the JAX package's rule ----

def _jax_kth_thresh(logits, temperature, top_k, top_p):
    """kth and thresh as the JAX package's sample_tokens computes them
    (serving/sampling.py:82-106), in jnp."""
    batch, vocab = logits.shape
    logits = jnp.asarray(logits, jnp.float32)
    sorted_logits = jnp.sort(logits, axis=-1)[:, ::-1]
    k = jnp.clip(jnp.asarray(top_k).astype(jnp.int32), 0, vocab)
    k_idx = jnp.where(k > 0, k - 1, vocab - 1)
    kth = jnp.take_along_axis(sorted_logits, k_idx[:, None], axis=-1)
    temp_safe = jnp.where(jnp.asarray(temperature) > 0, jnp.asarray(temperature), 1.0)[:, None]
    z = sorted_logits / temp_safe
    z = z - z[:, :1]
    probs = jax.nn.softmax(z, axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    sorted_keep = jnp.concatenate([jnp.ones((batch, 1), bool), cum[:, :-1] < jnp.asarray(top_p)[:, None]], axis=-1)
    thresh = jnp.min(jnp.where(sorted_keep, sorted_logits, jnp.inf), axis=-1, keepdims=True)
    return np.asarray(kth[:, 0]), np.asarray(thresh[:, 0])


def _boundary_gap(row: np.ndarray, temperature: float, top_p: float, thresh: float) -> float:
    """How far top_p lies outside [the exact mass above thresh, the mass at
    or above it] of softmax((row - max) / T) (T's fp32 division as both
    versions take it): 0 where thresh is the exact rule's boundary."""
    t = np.float32(temperature if temperature > 0 else 1.0)
    z = (row / t).astype(np.float32)
    e = np.exp((z - z.max()).astype(np.float64))
    probs = e / e.sum()
    above, at_or_above = probs[row > thresh].sum(), probs[row >= thresh].sum()
    return max(0.0, above - top_p, top_p - at_or_above)


def _edge_rows(vocab: int = 512):
    """A top_p == 1 row whose fp32 cumsum reaches 1.0 before its end (one
    logit 0, the rest below -17 and distinct), and rows with tied logits at
    kth and at thresh."""
    peak = (-17.0 - 1e-3 * np.arange(vocab)).astype(np.float32)
    peak[7] = 0.0
    ties = np.repeat(np.array([6.0, 4.0, 4.0, 4.0, 2.0, 2.0], np.float32), -(-vocab // 6))[:vocab]
    ties_p = np.full(vocab, -5.0, np.float32)
    ties_p[:9] = (3.0, 1.0, 1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 0.0)
    logits = np.stack([peak, ties, ties, ties_p, ties_p])
    rows = dict(temperature=np.array([1.0, 1.0, 0.8, 1.0, 1.0], np.float32),
                top_k=np.array([0, 2, vocab // 3, 0, 4], np.int32),
                top_p=np.array([1.0, 1.0, 0.6, 0.6, 0.85], np.float32))
    return logits, rows


def _random_rows(seed: int, vocab: int = 1000):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(8, vocab)) * rng.choice([0.5, 3.0, 8.0], (8, 1))).astype(np.float32)
    rows = dict(temperature=rng.choice(np.array([0.0, 0.5, 1.0, 2.0], np.float32), 8),
                top_k=rng.choice(np.array([0, 1, 10, 100, vocab, vocab + 3], np.int32), 8),
                top_p=rng.choice(np.array([1.0, 0.99, 0.9, 0.5, 0.1], np.float32), 8))
    return logits, rows


@pytest.mark.parametrize("case", ["edges", "random 0", "random 1", "random 2"])
def test_plain_kth_and_thresh_are_the_jax_rules(case):
    logits, rows = _edge_rows() if case == "edges" else _random_rows(int(case.split()[1]))
    batch = logits.shape[0]
    if case == "edges":
        sorted_row = torch.sort(torch.from_numpy(logits[:1]), descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_row - sorted_row[:, :1], dim=-1), dim=-1)
        assert bool((cum[0, :-1] >= 1.0).any())  # the top_p == 1 row's mass reaches 1.0 before its end
    parts = _plain_parts(torch.from_numpy(logits), torch.from_numpy(rows["temperature"]),
                         torch.from_numpy(rows["top_k"]), torch.from_numpy(rows["top_p"]),
                         torch.zeros(batch, dtype=torch.int32), torch.arange(batch, dtype=torch.int32))
    kth, thresh = _jax_kth_thresh(logits, rows["temperature"], rows["top_k"], rows["top_p"])
    assert np.array_equal(parts["kth"].numpy(), kth)
    got = parts["thresh"].numpy()
    bar = logits.shape[1] * 2.0**-24
    for r in np.flatnonzero(got != thresh):
        for value in (got[r], thresh[r]):
            gap = _boundary_gap(logits[r], float(rows["temperature"][r]), float(rows["top_p"][r]), float(value))
            assert gap <= bar, (case, r, got[r], thresh[r], gap)
    same = got == thresh
    seeds, positions = np.arange(batch, dtype=np.int32), np.arange(batch, dtype=np.int32) * 7
    want = np.asarray(jax_sample_tokens(jnp.asarray(logits), jnp.asarray(rows["temperature"]),
                                        jnp.asarray(rows["top_k"]), jnp.asarray(rows["top_p"]),
                                        jnp.asarray(seeds), jnp.asarray(positions)))
    tokens = sample_tokens(torch.from_numpy(logits), *(torch.from_numpy(rows[k]) for k in ("temperature", "top_k",
                                                                                           "top_p")),
                           torch.from_numpy(seeds), torch.from_numpy(positions)).numpy()
    assert np.array_equal(tokens[same], want[same])
