"""Continuous-batching serving engine.

Counterpart of the JAX package's ``serving/engine.py``: a fixed-slot batch
of sequences advances one decode block per iteration while finished slots
are refilled from the queue. The C++ scheduler (the port's copy of the JAX
package's) owns the request lifecycle; this module owns the device work:

  * CHUNKED prefill: prompts are split into fixed-size chunks; each engine
    iteration advances every pending prefill by ONE chunk and then runs ONE
    decode block for all active slots, so a long prompt does not stall the
    decode batch;
  * decode: one batched step for all slots; inactive slots compute but
    their cache lengths stay frozen;
  * sampling: per-request temperature / top-k / top-p (serving/sampling.py);
    temperature 0 is exact greedy.

The KV cache lives on the device the params live on and is updated in place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flash_attention_tpu_torch.models.transformer import (
    ModelConfig,
    decode_step_logits,
    init_caches,
    prefill_chunk,
)
from flash_attention_tpu_torch.serving.decode_loop import (
    advance_prefill,
    make_decode_multi,
    retire_decode_block,
    run_decode_block,
    start_prefill,
)
from flash_attention_tpu_torch.serving.sampling import GREEDY, SamplingParams, sample_tokens
from flash_attention_tpu_torch.serving.scheduler import ContinuousBatchScheduler

# Sharded caches need a tensor-parallel model (column- and row-parallel
# projections, an all-reduce after the output projection), which the port
# does not have yet.
SHARD_ITEM = "ROADMAP.md queue 1 item 8b (a tensor-parallel model behind shard_caches)"


@dataclasses.dataclass(frozen=True)
class Request:
    id: int
    prompt: tuple[int, ...]
    max_new_tokens: int
    sampling: SamplingParams = GREEDY


@dataclasses.dataclass
class Completion:
    id: int
    tokens: list[int]
    finished_by_eos: bool


@dataclasses.dataclass
class _PrefillState:
    req: Request
    padded: np.ndarray  # [n_chunks * chunk] int32 prompt, right-padded
    next_chunk: int = 0


class ServingEngine:
    """Continuous-batching engine over the transformer stack.

    Args:
      params: model params dict (init_model_params or params_from_jax); the
        engine runs on their device.
      cfg: ModelConfig.
      max_slots: concurrent sequences (the decode batch size).
      max_seq: the logical context per slot; admission requires
        prompt_len + max_new_tokens <= max_seq. A rolling cache
        (``cfg.rolling``) holds only window + one chunk of its rows.
      eos_id: optional end-of-sequence token id.
      prefill_chunk: tokens per prefill chunk; with attention sinks at most
        sliding_window - attention_sinks, so every chunk past the window
        starts after the sinks.
      shard_caches: the JAX engine's hook that places the fresh caches on a
        device mesh; not ported (``SHARD_ITEM``), must be None.
      decode_block_steps: most decode steps per block (one readback each).
      pipeline_decode: dispatch block i+1 before reading block i's tokens.
    """

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        *,
        max_slots: int,
        max_seq: int,
        eos_id: int | None = None,
        prefill_chunk: int = 256,
        shard_caches=None,
        decode_block_steps: int = 16,
        pipeline_decode: bool = True,
    ):
        if shard_caches is not None:
            raise NotImplementedError(f"shard_caches is not ported yet: {SHARD_ITEM}")
        chunk = min(prefill_chunk, max_seq)
        if cfg.attention_sinks:
            chunk = min(chunk, cfg.sliding_window - cfg.attention_sinks)
        self._init_host_loop(params, cfg, max_slots, max_seq, eos_id, chunk, decode_block_steps, pipeline_decode)
        self.caches = init_caches(cfg, max_slots, max_seq, device=self.device, prefill_chunk=chunk)
        self._decode_multi = make_decode_multi(cfg, decode_step_logits, self._lengths_of, self._with_lengths)

    def _init_host_loop(self, params, cfg, max_slots, max_seq, eos_id, chunk, decode_block_steps, pipeline_decode):
        """The host state the shared loop (serving/decode_loop.py) reads and
        writes, common to the dense and the paged engine."""
        self.params = params
        self.cfg = cfg
        self.device = params["embed"].device
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.chunk = chunk
        self.sched = ContinuousBatchScheduler(max_slots, max_seq)
        self.last_token = np.zeros((max_slots,), np.int32)
        # Per-slot sampling parameters (set at admission).
        self._temps = np.zeros((max_slots,), np.float32)
        self._topk = np.zeros((max_slots,), np.int32)
        self._topp = np.ones((max_slots,), np.float32)
        self._seeds = np.zeros((max_slots,), np.int32)
        self._prefills: dict[int, _PrefillState] = {}
        self.decode_block_steps = max(1, decode_block_steps)
        self.pipeline_decode = pipeline_decode
        self._pending_block = None
        self._dev = None
        self._dev_dirty = True
        self._dev_greedy = False
        self._remaining = np.zeros((max_slots,), np.int64)
        self._cur_len = np.zeros((max_slots,), np.int64)
        self.steps = 0
        self.decode_tokens = 0
        # Wall-clock in the decode section (block dispatch + readback wait +
        # host token bookkeeping) — denominator of engine-level tokens/s.
        self.decode_time_s = 0.0
        self.events: list[tuple] = []  # ("chunk", slot) / ("decode", n_appended)

    # Hooks of the shared host loop (serving/decode_loop.py).
    def _prefill_chunk_step(self, params, tokens, caches, slot: int, start: int, kv_end: int):
        return prefill_chunk(params, self.cfg, tokens, caches, slot, start, kv_end)

    def _set_slot_length_fn(self, caches, slot: int, true_len: int):
        """Every layer's cache with ``lengths[slot] = true_len``."""
        lengths = self._lengths_of(caches).clone()
        lengths[slot] = true_len
        return self._with_lengths(caches, lengths)

    @staticmethod
    def _lengths_of(caches) -> torch.Tensor:
        return caches[0].lengths  # every layer holds the same lengths

    @staticmethod
    def _with_lengths(caches, lengths: torch.Tensor):
        return [c._replace(lengths=lengths) for c in caches]

    def _on_slot_finished(self, slot: int) -> None:
        self._dev_dirty = True

    def _sample_first(self, logits: torch.Tensor, slot: int, position: int) -> torch.Tensor:
        """The first token of ``slot`` from its prompt's last logits [1, vocab]."""

        def one(values, dtype):
            return torch.tensor([values[slot]], dtype=dtype, device=self.device)

        return sample_tokens(
            logits,
            one(self._temps, torch.float32), one(self._topk, torch.int32),
            one(self._topp, torch.float32), one(self._seeds, torch.int32),
            torch.tensor([position], dtype=torch.int32, device=self.device),
        )[0]

    def submit(self, req: Request) -> bool:
        return self.sched.submit(req.id, len(req.prompt), req.max_new_tokens)

    def run(self, requests: list[Request]) -> dict[int, Completion]:
        """Serve a batch of requests to completion; returns {id: Completion}."""
        by_id = {r.id: r for r in requests}
        out: dict[int, Completion] = {}
        for r in requests:
            if not self.submit(r):
                out[r.id] = Completion(r.id, [], finished_by_eos=False)

        while True:
            # Admit newly-scheduled requests into prefill states.
            for req_id, slot in self.sched.admit():
                start_prefill(self, by_id[req_id], slot)

            # Advance every pending prefill by ONE chunk (interleaved with
            # the decode block below — no head-of-line blocking).
            for slot in sorted(self._prefills):
                advance_prefill(self, slot, out)

            active = self.sched.active_slots()
            if not active:
                # An in-flight block may still exist (its slots finished at
                # the previous retirement): drain it before the exit check.
                retire_decode_block(self, out)
                if self._prefills:
                    continue
                st = self.sched.stats()
                if st.queued == 0 and st.prefilling == 0 and st.decoding == 0:
                    break
                continue

            run_decode_block(self, active, out)

        return out
