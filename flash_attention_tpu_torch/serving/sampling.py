"""Per-request token sampling for the serving engine.

Counterpart of the JAX package's ``serving/sampling.py``: temperature,
top-k and top-p (nucleus), vectorised over the slot batch with per-slot
parameters.

  * temperature == 0 -> greedy argmax for that slot (exact),
  * top_k == 0 -> no k-truncation; top_p == 1 -> no nucleus truncation,
  * sampling uses the Gumbel-max trick (argmax(logits/T + G)),
  * randomness is stateless: a slot's noise depends only on (seed,
    position), so completions are reproducible across runs and devices.

The keep masks, the greedy picks and the Gumbel noise match the JAX
package's bit for bit: ``gumbel_noise`` draws what ``jax.random.gumbel(
jax.random.fold_in(jax.random.key(seed), position), (vocab,))`` draws
(threefry2x32, partitionable random bits), on the logits' device, with no
host sync, so sampled tokens are the JAX package's too.

``sample_tokens`` is S1's wrapper (csrc/sampling.cu, registered in
``ops/counters.py``): one launch a call on the card, the plain version
(``sample_tokens_plain``, with ``gumbel_noise`` and ``_log`` the plain
noise) on the CPU.
"""

from __future__ import annotations

import dataclasses
import struct

import torch

from flash_attention_tpu_torch.ops import _build
from flash_attention_tpu_torch.ops.counters import counter


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    temperature: 0.0 = greedy; > 0 scales logits by 1/T before sampling.
    top_k: keep only the k highest-probability tokens (0 = disabled).
    top_p: keep the smallest prefix of the sorted distribution with
      cumulative probability >= top_p (1.0 = disabled).
    seed: per-request RNG seed (stateless; combined with token position).
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


GREEDY = SamplingParams()


_U32 = 0xFFFFFFFF
# threefry2x32's rotations, alternating by group of four rounds, and its key
# schedule's parity constant (jax/_src/prng.py, Salmon et al. 2011).
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _threefry2x32(k1, k2, x1, x2):
    """threefry2x32's 20 rounds on uint32 words carried in int64 tensors
    (PyTorch has no full uint32 arithmetic): every sum is masked back to 32
    bits. The inputs broadcast; returns the two output words."""

    def rotl(x, d):
        return ((x << d) | (x >> (32 - d))) & _U32

    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & _U32
    x2 = (x2 + ks[1]) & _U32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _U32
            x2 = rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _U32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _U32
    return x1, x2


def _f32(value: float) -> float:
    """``value`` rounded to the nearest float32, as a Python float: as a
    scalar operand it is exact in float32 and float64 arithmetic alike."""
    return struct.unpack("f", struct.pack("f", value))[0]


# _log's constants in float32, as XLA holds them: Python scalars, so a call
# copies nothing to the device.
_SQRT_HALF = _f32(0.707106781186547524)
_LOG_POLY = tuple(_f32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
    -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LN2_LO, _LN2_HI = _f32(-2.12194440e-4), _f32(0.693359375)


def _fma(a, b, c):
    """a * b + c rounded once to float32 (each a float32 tensor or a float32
    value as a Python float): the product of two float32 values is exact in
    float64, so only the sum rounds (twice, which differs from one rounding
    only for a sum that lands exactly between two float32 neighbours after
    the first)."""

    def wide(x):
        return x.double() if isinstance(x, torch.Tensor) else x

    return (wide(a) * wide(b) + wide(c)).float()


def _log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log of positive x as XLA's CPU backend computes it
    (Cephes' logf polynomial with the multiply-adds it fuses), which is not
    always the correctly rounded log that ``torch.log`` gives: the Gumbel
    noise then matches jax.random's bit for bit. Inputs below the smallest
    normal float32 are raised to it, as XLA does."""
    x = x.float().clamp_min(torch.finfo(torch.float32).tiny)
    bits = x.view(torch.int32)
    # frexp: mantissa in [0.5, 1) and exponent; then centre on sqrt(1/2).
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    e = (((bits >> 23) & 0xFF) - 126).float()
    low = m < _SQRT_HALF
    e = e - low.float()
    m = (m - 1.0) + torch.where(low, m, 0.0)
    x2 = m * m
    x3 = x2 * m
    p = _LOG_POLY
    y0 = _fma(_fma(p[0], m, p[1]), m, p[2])
    y1 = _fma(_fma(p[3], m, p[4]), m, p[5])
    y2 = _fma(_fma(p[6], m, p[7]), m, p[8])
    y0 = _fma(_fma(y0, x3, y1), x3, y2)
    y = _fma(y0, x3, e * _LN2_LO)
    m = _fma(-0.5, x2, m) + y
    return _fma(_LN2_HI, e, m)


def gumbel_noise(seeds: torch.Tensor, positions: torch.Tensor, vocab: int) -> torch.Tensor:
    """Standard Gumbel noise [batch, vocab] fp32 on the seeds' device, row i
    from (seeds[i], positions[i]) alone, bit-equal to the JAX package's
    ``jax.random.gumbel(fold_in(key(seed), position), (vocab,))`` under
    threefry2x32 with partitionable bits:

      key = (0, seed);  key' = threefry(key, (0, position))     fold_in
      bits[j] = xor of threefry(key', (0, j))                   random_bits
      u = max(tiny, (bits >> 9 | 1.0's bits) as float - 1 + tiny)  uniform
      g = -log(-log(u))

    All rows at once in integer tensor ops: no host sync, no loop over rows.
    """
    seed = seeds.to(torch.int64) & _U32
    pos = positions.to(device=seed.device, dtype=torch.int64) & _U32
    zero = torch.zeros_like(seed)
    k1, k2 = _threefry2x32(zero, seed, zero, pos)
    count = torch.arange(vocab, dtype=torch.int64, device=seed.device)[None, :]
    b1, b2 = _threefry2x32(k1[:, None], k2[:, None], torch.zeros_like(count), count)
    mantissa = (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    tiny = torch.finfo(torch.float32).tiny
    u = (mantissa * (1.0 - tiny) + tiny).clamp_min(tiny)
    return -_log(-_log(u))


def _plain_parts(logits, temperature, top_k, top_p, seeds, positions) -> dict:
    """The plain version's tokens and what S1's detail mode writes: the noise,
    each row's greedy pick, kth (the k-th largest logit) and thresh (the
    smallest kept sorted logit of the top-p rule)."""
    batch, vocab = logits.shape
    logits = logits.float()
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values

    # top-k: keep logits >= the k-th largest. k=0 keeps all.
    k = top_k.to(torch.int64).clamp(0, vocab)
    k_idx = torch.where(k > 0, k - 1, vocab - 1)
    kth = torch.gather(sorted_logits, 1, k_idx[:, None])
    keep_k = logits >= kth

    # top-p over the softmax of the temperature-scaled distribution.
    temp_safe = torch.where(temperature > 0, temperature, 1.0)[:, None]
    z = sorted_logits / temp_safe
    probs = torch.softmax(z - z[:, :1], dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # Keep entries whose PRECEDING mass is < top_p (always keeps the first).
    sorted_keep = torch.cat(
        [torch.ones((batch, 1), dtype=torch.bool, device=logits.device), cum[:, :-1] < top_p[:, None]],
        dim=-1,
    )
    thresh = torch.where(sorted_keep, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
    keep_p = logits >= thresh

    masked = torch.where(keep_k & keep_p, logits, -torch.inf)
    g = gumbel_noise(seeds.to(logits.device), positions, vocab)
    sampled_tok = torch.argmax(masked / temp_safe + g, dim=-1).to(torch.int32)
    return dict(tokens=torch.where(temperature > 0, sampled_tok, greedy_tok), noise=g, greedy=greedy_tok,
                kth=kth[:, 0], thresh=thresh[:, 0])


def sample_tokens_plain(
    logits: torch.Tensor,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
    seeds: torch.Tensor,
    positions: torch.Tensor,
) -> torch.Tensor:
    """The function S1 computes, in plain PyTorch: ``sample_tokens``' tokens."""
    return _plain_parts(logits, temperature, top_k, top_p, seeds, positions)["tokens"]


def _on_card(logits: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA one."""
    if logits.device.type == "cpu":
        return False
    if logits.device.type != "cuda":
        raise ValueError(f"sample_tokens runs on cpu or cuda tensors, got {logits.device}")
    return True


def _launch(logits, temperature, top_k, top_p, seeds, positions, detail: bool) -> dict:
    """One launch of S1 (csrc/sampling.cu) on the logits' card: the tokens,
    and with ``detail`` what ``_plain_parts`` returns beside them."""
    if logits.ndim != 2 or logits.shape[1] == 0:
        raise ValueError(f"sample_tokens: logits [batch, vocab] with vocab >= 1, got {tuple(logits.shape)}")
    batch, vocab = logits.shape
    device = logits.device
    logits = _build.unit_last_stride(logits.float())
    rows = [temperature.to(device=device, dtype=torch.float32).contiguous(), _build.as_int32(top_k.to(device)),
            top_p.to(device=device, dtype=torch.float32).contiguous(), _build.as_int32(seeds.to(device)),
            _build.as_int32(positions.to(device))]
    if any(t.shape != (batch,) for t in rows):
        raise ValueError(f"sample_tokens: temperature, top_k, top_p, seeds and positions [{batch}], got "
                         f"{[tuple(t.shape) for t in rows]}")
    out = dict(tokens=torch.empty((batch,), dtype=torch.int32, device=device))
    if detail:
        out.update(noise=torch.empty((batch, vocab), dtype=torch.float32, device=device),
                   greedy=torch.empty((batch,), dtype=torch.int32, device=device),
                   kth=torch.empty((batch,), dtype=torch.float32, device=device),
                   thresh=torch.empty((batch,), dtype=torch.float32, device=device))
    if batch:
        extra = [out[key].data_ptr() if detail else None for key in ("noise", "greedy", "kth", "thresh")]
        with _build.on_device(device):
            err = _build.kernels().fat_sample(
                logits.data_ptr(), logits.stride(0), *(t.data_ptr() for t in rows), out["tokens"].data_ptr(),
                *extra, batch, vocab, _build.current_stream(device))
        _build.check(err, "sample_tokens (S1)")
        sample_tokens.launches += 1
    return out


def sample_tokens(
    logits: torch.Tensor,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
    seeds: torch.Tensor,
    positions: torch.Tensor,
) -> torch.Tensor:
    """Sample one token per row of ``logits``.

    Args:
      logits: [batch, vocab].
      temperature: [batch] fp32 (0 = greedy for that row).
      top_k: [batch] int (0 = disabled).
      top_p: [batch] fp32 (1 = disabled).
      seeds: [batch] int per-slot seeds.
      positions: [batch] int — the position the sampled token will occupy.

    Returns:
      [batch] int32 token ids, on logits' device.

    On CPU tensors the plain version (``sample_tokens_plain``); on CUDA
    tensors one launch of S1 (csrc/sampling.cu), counted in ``.launches``,
    with outputs from ``torch.empty`` and no host sync, so it runs inside the
    decode programs' CUDA graphs; any other device raises.
    """
    if not _on_card(logits):
        return sample_tokens_plain(logits, temperature, top_k, top_p, seeds, positions)
    return _launch(logits, temperature, top_k, top_p, seeds, positions, detail=False)["tokens"]


counter(sample_tokens, "launches", "S1", "sample_kernel")


def sample_tokens_detail(logits, temperature, top_k, top_p, seeds, positions) -> dict:
    """``sample_tokens`` with what it decided on the way: a dict of the
    tokens, the Gumbel noise [batch, vocab], each row's greedy pick, kth and
    thresh. On CUDA tensors S1's detail mode (every row computed in full and
    the noise of every element written), on CPU tensors the plain version's;
    for holding the kernel against the plain version."""
    if not _on_card(logits):
        return _plain_parts(logits, temperature, top_k, top_p, seeds, positions)
    return _launch(logits, temperature, top_k, top_p, seeds, positions, detail=True)
