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

The KV cache lives on the device the params live on and is updated in place,
its lengths too: every layer of the dense caches shares one lengths tensor,
which the prefill programs and the decode programs (``serving/decode_loop.
py``: on the card a CUDA graph a (chunk length, kv_end) key and a graph a
(k, greedy) key) both write in place. ``warmup()`` builds every program a
served run can reach, so a run after it captures none. Assigning
``engine.caches`` (a restored checkpoint) copies into those buffers.

Tensor-parallel serving (JAX's ``shard_caches`` over a mesh): given the
callable of ``parallel.sharding.make_cache_sharding``, the engine makes only
this rank's block of the caches, runs the model on its share of the params
(``shard_model_params``) with an all-reduce over the mesh's model axis, and
over its data axis owns a contiguous range of slots. Every rank of the mesh
runs the same engine on the same requests, so the scheduler, the host loop
and (paged) the page allocator step alike on each; the device work of a
slot runs on its owners only, and the tokens reach every rank
(``serving/decode_loop.py``), so ``run`` returns the same tokens on each.
The sharded caches carry their sharding (``parallel.sharding.with_sharding``),
so ``utils/checkpoint``'s ``save_kv_cache(path, engine.caches)`` writes the
global caches and ``load_kv_cache`` gives each rank its block.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from flash_attention_tpu_torch.models.transformer import (
    ModelConfig,
    decode_step_logits,
    init_caches,
    prefill_chunk,
)
from flash_attention_tpu_torch.parallel.mesh import all_gather, axis_index, axis_size
from flash_attention_tpu_torch.parallel.sharding import shard_model_params, with_sharding
from flash_attention_tpu_torch.serving.decode_loop import (
    DecodePrograms,
    PrefillPrograms,
    advance_prefill,
    make_decode_multi,
    retire_decode_block,
    run_decode_block,
    start_prefill,
    warmup_engine,
)
from flash_attention_tpu_torch.serving.sampling import GREEDY, SamplingParams, sample_tokens
from flash_attention_tpu_torch.serving.scheduler import ContinuousBatchScheduler
from flash_attention_tpu_torch.utils.checkpoint import _leaves


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

    Each prefill chunk and each decode block runs as one program
    (``prefill_programs``, ``programs``: on the card a CUDA graph a key,
    captured at the key's first use); ``warmup()`` builds every program a
    run can reach, so no run after it captures one.

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
      shard_caches: a callable applied once to the freshly made global
        caches. One from ``parallel.sharding.make_cache_sharding`` carries
        its mesh, and then the engine makes only this rank's block of the
        caches (the one the callable keeps of the global caches, so no rank
        allocates the global ones), shards ``params`` (the global ones) over
        the mesh's model axis and runs the tensor-parallel model, and this
        rank serves the slots of its data coordinate (every rank of the mesh
        runs the engine on the same requests). Any other callable is a
        placement only: it must return the caches with their shapes, dtypes
        and device, and the model runs unsharded.
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
        chunk = min(prefill_chunk, max_seq)
        if cfg.attention_sinks:
            chunk = min(chunk, cfg.sliding_window - cfg.attention_sinks)
        self._init_host_loop(params, cfg, max_slots, max_seq, eos_id, chunk, decode_block_steps, pipeline_decode)
        caches = self._place_caches(
            lambda c, slots: init_caches(c, slots, max_seq, device=self.device, prefill_chunk=chunk), shard_caches,
            data_sharded=True,
        )
        self._caches = with_sharding(self._with_lengths(caches, self._lengths_of(caches)), shard_caches)
        decode = functools.partial(decode_step_logits, tp_group=self.tp_group)
        self._decode_multi = make_decode_multi(self.model_cfg, decode, self._lengths_of, self._with_lengths)
        self._init_programs()

    def _init_programs(self) -> None:
        """The engine's decode and prefill programs, each kind over a memory
        pool of its own."""
        self.programs = DecodePrograms(self)
        self.prefill_programs = PrefillPrograms(self)

    def _init_host_loop(self, params, cfg, max_slots, max_seq, eos_id, chunk, decode_block_steps, pipeline_decode):
        """The host state the shared loop (serving/decode_loop.py) reads and
        writes, common to the dense and the paged engine."""
        self.params = params
        self.cfg = cfg
        # The config and process group the model runs under, and the slots
        # [_slot_lo, _slot_hi) whose device work this rank runs (tensor
        # parallel: set by _place_caches).
        self.model_cfg = cfg
        self.tp_group = None
        self._data_group = None
        self._slot_lo, self._slot_hi = 0, max_slots
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
        self._dev_dirty = True
        self._dev_greedy = False
        self._remaining = np.zeros((max_slots,), np.int64)
        self._cur_len = np.zeros((max_slots,), np.int64)
        self.steps = 0
        self.decode_tokens = 0
        # Wall-clock in the decode section (block dispatch + readback wait +
        # host token bookkeeping) — denominator of engine-level tokens/s. It
        # starts once the prefill chunks queued ahead of the block have run
        # (``_prefill_queued``, the last chunk's CUDA event), so a replayed
        # chunk's device time is not charged to decode.
        self.decode_time_s = 0.0
        self._prefill_queued = None
        self.events: list[tuple] = []  # ("chunk", slot) / ("decode", n_appended)

    def _place_caches(self, make, shard_caches, *, data_sharded: bool):
        """The engine's fresh caches, ``make(cfg, slots)``, placed by
        ``shard_caches`` (see the class's Args). With a mesh, this rank's
        block made directly, and this rank's params, model config and model
        group, and with ``data_sharded`` its slots and data group."""
        if shard_caches is None:
            return make(self.cfg, self.max_slots)
        mesh = getattr(shard_caches, "mesh", None)
        if mesh is None:
            caches = make(self.cfg, self.max_slots)
            placed = shard_caches(caches)
            if _layout(placed) != _layout(caches):
                raise ValueError("shard_caches without a mesh is a placement only and must return the caches with "
                                 "their shapes, dtypes and device; for tensor-parallel serving pass "
                                 "parallel.sharding.make_cache_sharding(mesh)")
            return placed
        model_axis, data_axis = shard_caches.model_axis, shard_caches.data_axis
        self.params, self.model_cfg = shard_model_params(self.params, self.cfg, mesh, model_axis=model_axis)
        self.tp_group = mesh.get_group(model_axis)
        n_data = axis_size(mesh, data_axis)
        if data_sharded and n_data > 1:
            if self.max_slots % n_data:
                raise ValueError(f"max_slots ({self.max_slots}) must split over the {n_data} ranks of {data_axis!r}")
            per = self.max_slots // n_data
            self._slot_lo = axis_index(mesh, data_axis) * per
            self._slot_hi = self._slot_lo + per
            self._data_group = mesh.get_group(data_axis)
        # Fresh caches are uniform (zeros, scales of ones), so the rank's
        # block is the caches of its heads and slots.
        return make(self.model_cfg, self._slot_hi - self._slot_lo)

    @property
    def caches(self):
        """The engine's KV caches (under tensor parallelism this rank's
        block, carrying its sharding). The decode programs hold their
        addresses, so assigning a cache of the same layout (``engine.caches
        = load_kv_cache(path, engine.caches)``) copies it into them."""
        return self._caches

    @caches.setter
    def caches(self, value) -> None:
        dst, src = _leaves(self._caches), _leaves(value)
        if [(t.shape, t.dtype) for t in src] != [(t.shape, t.dtype) for t in dst]:
            raise ValueError("the engine's caches take a cache of their own layout (shapes and dtypes)")
        for d, s in zip(dst, src):
            if d is not s:
                d.copy_(s)

    # Hooks of the shared host loop (serving/decode_loop.py). Slots are the
    # scheduler's; the caches hold this rank's [_slot_lo, _slot_hi).
    def _owns(self, slot: int) -> bool:
        """Whether this rank runs ``slot``'s device work."""
        return self._slot_lo <= slot < self._slot_hi

    def _prefill_chunk_step(self, tokens, slot: int, start: int, kv_end: int) -> torch.Tensor:
        """One prefill chunk, JAX's jitted step: ``tokens`` [1, T] (host
        integers) at positions [start, kv_end) of ``slot``, through the
        prefill program of key (T, kv_end) (``self.prefill_programs``),
        which writes K / V and the lengths into the engine's caches in
        place. Returns the logits [1, T, vocab] fp32, valid until the next
        chunk of length T."""
        if start + np.shape(tokens)[-1] != kv_end:
            raise ValueError(f"a chunk of {np.shape(tokens)[-1]} tokens from {start} must end at kv_end, got {kv_end}")
        return self.prefill_programs.run(tokens, slot - self._slot_lo, kv_end)

    def _prefill_logits(self, tokens: torch.Tensor, slot: torch.Tensor, start: int, kv_end: int):
        """The body of a prefill program: the model over one chunk of this
        rank's ``slot`` (a device scalar), (logits, caches)."""
        return prefill_chunk(self.params, self.model_cfg, tokens, self._caches, slot, start, kv_end,
                             tp_group=self.tp_group)

    def _keep_lengths(self, caches) -> None:
        """Take the lengths of ``caches``, a model call's result over the
        engine's caches (whose K/V it wrote in place), into the engine's one
        lengths tensor, in place."""
        dst, src = self._lengths_of(self._caches), self._lengths_of(caches)
        if src is not dst:
            dst.copy_(src)

    def _set_slot_length(self, slot: int, true_len: int) -> None:
        """``lengths[slot] = true_len``, in place (a fill on the device: no
        copy from the host)."""
        self._lengths_of(self._caches)[slot - self._slot_lo] = true_len

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

    def _share_first(self, first: torch.Tensor | None, slot: int) -> int:
        """``slot``'s first token on every rank: sampled on its owners
        (``first``; None elsewhere) and, over a data axis, broadcast from
        the owner to the other data coordinates."""
        if self._data_group is None:
            return int(first)
        group = self._data_group
        t = torch.tensor([0 if first is None else int(first)], dtype=torch.int32)
        if dist.get_backend(group) != "gloo":
            t = t.to(self.device)
        src = dist.get_process_group_ranks(group)[slot // (self._slot_hi - self._slot_lo)]
        dist.broadcast(t, src=src, group=group)
        return int(t)

    def _gather_tokens(self, toks: torch.Tensor) -> torch.Tensor:
        """A decode block's tokens [k, local slots] as [k, max_slots]: over a
        data axis, every data coordinate's slots (on the device)."""
        return toks if self._data_group is None else all_gather(toks, 1, self._data_group)

    def warmup(self, *, prompt_len: int | None = None) -> None:
        """Run every prefill chunk position and decode block length once,
        greedy and sampled, building every prefill and decode program (see
        decode_loop.warmup_engine), and reset the perf counters."""
        warmup_engine(self, prompt_len=prompt_len)

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


def _layout(caches) -> list:
    """(shape, dtype, device) of each tensor of the caches."""
    return [(t.shape, t.dtype, t.device) for t in _leaves(caches)]
