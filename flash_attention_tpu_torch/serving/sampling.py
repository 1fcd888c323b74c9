"""Per-request token sampling for the serving engine.

Counterpart of the JAX package's ``serving/sampling.py``: temperature,
top-k and top-p (nucleus), vectorised over the slot batch with per-slot
parameters.

  * temperature == 0 -> greedy argmax for that slot (exact),
  * top_k == 0 -> no k-truncation; top_p == 1 -> no nucleus truncation,
  * sampling uses the Gumbel-max trick (argmax(logits/T + G)),
  * randomness is stateless: a slot's noise depends only on (seed,
    position), so completions are reproducible across runs and devices.

The keep masks and greedy picks match the JAX package exactly; the Gumbel
noise does not (see ``gumbel_noise``).
"""

from __future__ import annotations

import dataclasses

import torch


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


_MASK64 = (1 << 64) - 1


def _generator_seed(seed: int, pos: int) -> int:
    """A 32-bit seed that depends on all bits of (seed, position): the CPU
    generator (mt19937) keeps only the low 32 bits of what it is given, so
    the pair goes through splitmix64's finaliser first."""
    z = ((((seed & 0xFFFFFFFF) << 32) | (pos & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & 0xFFFFFFFF


def gumbel_noise(seeds: torch.Tensor, positions: torch.Tensor, vocab: int) -> torch.Tensor:
    """Standard Gumbel noise [batch, vocab] on the CPU, one row per (seed,
    position) pair, from a CPU ``torch.Generator`` seeded with both.

    The same pair gives the same row on every run and device. It does NOT
    reproduce the JAX package's bits (jax.random's threefry keys), so sampled
    (temperature > 0) tokens differ between the packages; greedy tokens do
    not. Reading the seeds and positions waits for the device.
    """
    rows = []
    for seed, pos in zip(seeds.tolist(), positions.tolist()):
        gen = torch.Generator().manual_seed(_generator_seed(seed, pos))
        u = torch.rand(vocab, generator=gen).clamp_min(torch.finfo(torch.float32).tiny)
        rows.append(-torch.log(-torch.log(u)))
    return torch.stack(rows)


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
    """
    batch, vocab = logits.shape
    logits = logits.float()
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values

    # top-k: keep logits >= the k-th largest. k=0 keeps all.
    k = top_k.to(torch.int64).clamp(0, vocab)
    k_idx = torch.where(k > 0, k - 1, vocab - 1)
    keep_k = logits >= torch.gather(sorted_logits, 1, k_idx[:, None])

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
    g = gumbel_noise(seeds, positions, vocab).to(logits.device)
    sampled_tok = torch.argmax(masked / temp_safe + g, dim=-1).to(torch.int32)
    return torch.where(temperature > 0, sampled_tok, greedy_tok)
