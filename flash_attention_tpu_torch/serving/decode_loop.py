"""Host loop of the serving engine: chunked prefill and blocked decode.

Counterpart of the JAX package's ``serving/decode_loop.py``. A decode
BLOCK is up to ``decode_block_steps`` model steps on the device with ONE
device-to-host token readback per block. Blocks are pipelined: block i+1 is
dispatched before block i's tokens are read, and the readback is an
asynchronous copy into pinned memory with an event, so the host waits on
block i's tokens only, not on block i+1's work.

A block is one PROGRAM (``DecodePrograms``), as JAX's ``make_decode_multi``
is one jitted ``lax.scan`` a (k, greedy) key: on the card a CUDA graph of
the k steps and the sampler, captured once its key's block has run eagerly
and replayed from then on, so a block costs one launch of host time instead
of ~3,600. The graph reads and writes fixed addresses: the engine's caches
(K/V written in place, and ONE lengths tensor that the prefill path writes
in place too) and the engine's static input buffers (last tokens, active
mask, sampling rows), which a membership change overwrites in place.

Under tensor parallelism over a data axis (``ServingEngine``'s
``shard_caches``) a rank runs the device work of its own slots only: the
prefill chunks of the slots it owns and the decode block over them. The
host state stays the same on every rank: a prefill's first token goes from
its owner to every rank (``_share_first``), and a block's tokens are
all-gathered over the data axis on the device as it is dispatched
(``_gather_tokens``), before the readback, so a pipelined block still
overlaps the previous one's readback. Every rank runs the same
collectives in the same order, since its host loop is every other's.

``warmup_engine`` is the counterpart of JAX's: throwaway requests that
walk every prefill chunk position and every power-of-two decode block
length, greedy and sampled, so the first served run builds no program.
"""

from __future__ import annotations

import gc
import time
import weakref

import numpy as np
import torch

from flash_attention_tpu_torch.models.attention import tensor_parallel
from flash_attention_tpu_torch.ops import counters
from flash_attention_tpu_torch.serving.sampling import SamplingParams, sample_tokens


def start_prefill(eng, req, slot: int) -> None:
    """Admit one request into a prefill state.

    The prompt is right-padded to the engine's chunk grid, CLAMPED to the
    slot capacity: the grid need not divide max_seq, so the final chunk may
    be shorter.
    """
    from flash_attention_tpu_torch.serving.engine import _PrefillState

    n_chunks = max(1, -(-len(req.prompt) // eng.chunk))
    padded_len = min(n_chunks * eng.chunk, eng.max_seq)
    padded = np.zeros((padded_len,), np.int32)
    padded[: len(req.prompt)] = req.prompt
    eng._prefills[slot] = _PrefillState(req=req, padded=padded)
    eng._dev_dirty = True
    sp = req.sampling
    eng._temps[slot] = sp.temperature
    eng._topk[slot] = sp.top_k
    eng._topp[slot] = sp.top_p
    eng._seeds[slot] = sp.seed


def advance_prefill(eng, slot: int, out) -> None:
    """Run ONE chunk of the pending prefill on ``slot``; after the last
    chunk, fix the slot's true length and sample its first token.

    The engine-specific pieces are hooks on ``eng``, as in the JAX loop:
    ``_prefill_chunk_step`` (dense or paged chunk), ``_keep_lengths`` and
    ``_set_slot_length`` (the engine's one lengths tensor, written in place)
    and ``_on_slot_finished`` (the paged engine releases the slot's pages).
    A rank that does not own the slot (``_owns``) runs no chunk and takes
    the first token from its owner (``_share_first``).
    """
    from flash_attention_tpu_torch.serving.engine import Completion

    st = eng._prefills[slot]
    c = st.next_chunk
    lo = c * eng.chunk
    hi = min((c + 1) * eng.chunk, len(st.padded))
    owned = eng._owns(slot)
    if owned:
        toks = torch.as_tensor(st.padded[None, lo:hi], device=eng.device)
        logits, caches = eng._prefill_chunk_step(eng.params, toks, eng.caches, slot, lo, hi)
        eng._keep_lengths(caches)
    st.next_chunk += 1
    eng.events.append(("chunk", slot))
    if st.next_chunk * eng.chunk < len(st.padded):
        return
    req = st.req
    true_len = len(req.prompt)
    first = None
    if owned:
        eng._set_slot_length(slot, true_len)
        local_idx = (true_len - 1) - (st.next_chunk - 1) * eng.chunk
        first = eng._sample_first(logits[:, local_idx], slot, true_len)
    first = eng._share_first(first, slot)
    del eng._prefills[slot]
    eng.sched.prefill_done(slot)
    eng._dev_dirty = True
    eng._cur_len[slot] = true_len
    eng._remaining[slot] = req.max_new_tokens - 1
    out.setdefault(req.id, Completion(req.id, [], False))
    out[req.id].tokens.append(first)
    eng.last_token[slot] = first
    is_eos = eng.eos_id is not None and first == eng.eos_id
    if is_eos:
        out[req.id].finished_by_eos = True
    if eng.sched.record_token(slot, is_eos):
        eng._on_slot_finished(slot)


def warmup_engine(eng, *, prompt_len: int | None = None) -> None:
    """Run everything a serving run can reach once, then zero the counters.

    Eager PyTorch compiles nothing per shape, but a first run still pays
    once: the kernels' nvcc build (``ops/_build.py``) or the load of the
    built library, each kernel function's load at its first launch, cuBLAS's
    handle and workspace at the first GEMM, the caching allocator's growth
    to the run's peak, and on the card each decode program's capture
    (``DecodePrograms``). Two throwaway requests walk both surfaces:

      * prefill: a full-length greedy prompt visits every chunk position
        (K1 on the dense engine, K8 on the paged one);
      * decode: ``max_new = 2 * decode_block_steps`` makes the remaining
        budget after the prefill-sampled first token ``2B - 1``, so blocks
        run at k = B, B/2, ..., 2, 1 (K6, or K7 with K10). With ``max_new =
        2B - 1`` k = 1 would be skipped. The greedy request builds the
        greedy program of each k; a second, sampled request of a one-token
        prompt builds the sampled ones.

    ``prompt_len`` is clamped to [1, max_seq - 2B]. The prefix cache is
    suspended for the run, so the synthetic prompts register no pages, and
    so is ``eos_id``, so that no block length goes unwalked.
    Safe to call more than once. Counters (steps, decode_tokens,
    decode_time_s, events) are reset, so a following measured run reports
    steady state only. Under tensor parallelism every rank calls it: the
    ranks then run ``run``'s collectives in the same order.
    """
    from flash_attention_tpu_torch.serving.engine import Request

    max_new = 2 * eng.decode_block_steps
    cap = eng.max_seq - max_new
    if cap < 1:
        raise ValueError(
            f"max_seq={eng.max_seq} leaves no room for a warmup prompt "
            f"(needs >= {max_new + 1})"
        )
    plen = max(1, cap if prompt_len is None else min(prompt_len, cap))
    had_prefix = getattr(eng, "prefix_cache_enabled", False)
    if had_prefix:
        eng.prefix_cache_enabled = False
    eos_id, eng.eos_id = eng.eos_id, None
    try:
        # Large positive ids: the C++ scheduler reserves negatives as its
        # empty-slot sentinel.
        eng.run([Request(id=(1 << 62) + 41, prompt=(7,) * plen, max_new_tokens=max_new)])
        eng.run([Request(id=(1 << 62) + 42, prompt=(7,), max_new_tokens=max_new,
                         sampling=SamplingParams(temperature=1.0))])
    finally:
        eng.eos_id = eos_id
        if had_prefix:
            eng.prefix_cache_enabled = True
    eng.steps = 0
    eng.decode_tokens = 0
    eng.decode_time_s = 0.0
    eng.events.clear()


def make_decode_multi(model_cfg, decode_logits_fn, lengths_of, with_lengths):
    """Build the k-step decode block for one engine: the body of its
    programs (``DecodePrograms``).

    Returns a function (params, last_tok, caches, active, temps, topk, topp,
    seeds, k, greedy) -> ([k, slots] token block, final last-token row,
    caches): k decode steps issued back to back on the device. Inactive
    slots keep their lengths and tokens each step (their lanes ride along in
    the batched kernels). ``lengths_of(caches)`` reads the slots' [S]
    lengths and ``with_lengths(caches, lengths)`` sets them: the dense
    engine's layers each hold the same lengths, the paged cache holds one.
    """

    def _decode_multi(params, last_tok, caches, active, temps, topk, topp, seeds, k, greedy=False):
        tok = last_tok
        block = []
        for _ in range(k):
            old_lengths = lengths_of(caches)
            logits, caches = decode_logits_fn(params, model_cfg, tok[:, None], caches)
            if greedy:
                # Every active slot is temperature 0: skip the sampling sorts.
                nt = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                # The position the sampled token will OCCUPY (old length + 1):
                # the first token already used position == prompt length.
                nt = sample_tokens(logits, temps, topk, topp, seeds, old_lengths + 1)
            tok = torch.where(active, nt, tok)
            caches = with_lengths(caches, torch.where(active, lengths_of(caches), old_lengths))
            block.append(tok)
        return torch.stack(block), tok, caches

    return _decode_multi


class DecodePrograms:
    """An engine's decode blocks as programs, one a (k, greedy) key: JAX's
    jitted ``make_decode_multi`` (one XLA program a static (k, greedy)).

    A block reads the engine's static input buffers (``upload``) and its
    caches, runs ``make_decode_multi``'s k steps and the sampler, and
    writes the last tokens back into their buffer and the final lengths into
    the engine's one lengths tensor, so the next block, eager or replayed,
    starts where this one ended. ``mode`` is how a block runs:

      * "graph" (an engine on the card): a key's first block runs eagerly
        (the block the run needed, which also brings up whatever its first
        use allocates: the kernels' split counters, cuBLAS's handle); right
        after it the key is captured as a ``torch.cuda.CUDAGraph`` in the
        default error mode, which refuses any host sync, and every later
        block of the key is one replay. Capturing runs nothing, so no block
        is thrown away over the live caches. All of an engine's graphs share
        one memory pool: they never run concurrently, and each holds its own
        token block;
      * "issued" (an engine on the card whose model axis spans more than one
        rank, ``models.attention.tensor_parallel``): every block runs
        eagerly. Over gloo the model's all-reduces move CUDA tensors through
        host memory (``parallel.mesh.host_staged``), which no graph can hold;
        over NCCL they could be captured, but no multi-card run has yet held
        a captured block against its eager body, so they are issued too;
      * "eager" (the CPU): every block runs eagerly through the same static
        buffers, and a key's first block builds its program as the card
        captures it, so the bookkeeping the card replays is what the CPU
        tests exercise.

    ``captures`` counts programs built (captured on the card) and
    ``replays`` blocks run from a built program, as the kernel wrappers
    count their launches. A replay launches the kernels its capture
    recorded but runs no wrapper, so it adds to the wrappers' counts what
    the capture's calls counted, and the capture itself, which launches
    nothing, adds nothing: every count of ``ops.counters``' registry, where
    each wrapper registers its counters as it creates them. ``chip_smoke.py``
    holds what a replay adds against the kernel records of its device trace.
    """

    def __init__(self, eng):
        # A proxy: the engine holds its programs, and a cycle between the two
        # would leave a dropped engine's graphs to the cyclic collector.
        self.eng = weakref.proxy(eng)
        slots = eng._slot_hi - eng._slot_lo
        self.last, self.active, self.temps, self.topk, self.topp, self.seeds = (
            torch.zeros((slots,), dtype=dtype, device=eng.device)
            for dtype in (torch.int32, torch.bool, torch.float32, torch.int32, torch.float32, torch.int32)
        )
        if eng.device.type != "cuda":
            self.mode = "eager"
        elif tensor_parallel(eng.tp_group):
            self.mode = "issued"
        else:
            self.mode = "graph"
        self._pool = torch.cuda.graph_pool_handle() if self.mode == "graph" else None
        self._programs: dict = {}  # (k, greedy) -> (graph or None, token block, launch counts a replay)
        self.captures = 0
        self.replays = 0
        self.capture_s: dict = {}  # (k, greedy) -> seconds its capture took (the card's)

    def built(self) -> frozenset:
        """The (k, greedy) keys whose program is built."""
        return frozenset(self._programs)

    def upload(self, last_token, active, temps, topk, topp, seeds) -> None:
        """Write this rank's rows of the host arrays into the static input
        buffers, in place. Called between blocks only: the previous block's
        readback has been waited on (``retire_decode_block``)."""
        own = slice(self.eng._slot_lo, self.eng._slot_hi)
        for buf, host in zip((self.last, self.active, self.temps, self.topk, self.topp, self.seeds),
                             (last_token, active, temps, topk, topp, seeds)):
            buf.copy_(torch.from_numpy(np.ascontiguousarray(host[own])))

    def block(self, k: int, greedy: bool) -> torch.Tensor:
        """The k-step block on the static buffers, eagerly: its [k, slots]
        tokens. The body every program holds."""
        eng = self.eng
        toks, last, caches = eng._decode_multi(eng.params, self.last, eng.caches, self.active, self.temps,
                                               self.topk, self.topp, self.seeds, k, greedy)
        self.last.copy_(last)
        eng._keep_lengths(caches)
        return toks

    def run(self, k: int, greedy: bool) -> torch.Tensor:
        """One block of key (k, greedy): its [k, slots] tokens, valid until
        the next block of the same key runs (stream order puts that block
        after this one's readback)."""
        key = (k, bool(greedy))
        program = self._programs.get(key)
        if program is not None:
            graph, toks, counts = program
            self.replays += 1
            if graph is None:
                return self.block(k, greedy)
            graph.replay()
            counters.add(counts)
            return toks
        toks = self.block(k, greedy)
        if self.mode == "issued":
            return toks
        if self.mode == "graph":
            self._programs[key] = self._capture(k, greedy)
        else:
            self._programs[key] = (None, None, {})
        self.captures += 1
        return toks

    def _capture(self, k: int, greedy: bool):
        t0 = time.perf_counter()
        before = counters.snapshot()
        graph = torch.cuda.CUDAGraph()
        # No cyclic collection while capturing: freeing another object's CUDA
        # graph, event or pinned buffer is a host call that invalidates a
        # capture in the default error mode.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                toks = self.block(k, greedy)
        finally:
            if collecting:
                gc.enable()
        counts = {key: n - before.get(key, 0) for key, n in counters.snapshot().items() if n != before.get(key, 0)}
        counters.add(counts, -1)
        self.capture_s[k, bool(greedy)] = time.perf_counter() - t0
        return graph, toks, counts


def _start_readback(toks: torch.Tensor):
    """Start the block's one device-to-host copy; returns (host, event)."""
    if toks.device.type != "cuda":
        return toks, None
    host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
    host.copy_(toks, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def retire_decode_block(eng, out) -> None:
    """Read back the in-flight decode block (if any) and do its host-side
    bookkeeping: append tokens, detect EOS / budget completion, finish slots.

    Tokens of a slot whose request ended BEFORE this block was dispatched
    (the pipelined overrun block) are dropped: the dispatch-time slot ->
    request snapshot no longer matches the scheduler's. Tokens past a
    completion found WITHIN this block are dropped by the ``finished`` set.
    """
    pend = eng._pending_block
    if pend is None:
        return
    t0 = time.perf_counter()
    eng._pending_block = None
    (host, done), block_active, slot_req = pend
    if done is not None:
        done.synchronize()
    toks_np = host.numpy()  # [k_run, max_slots]
    finished: set[int] = set()
    appended = 0
    for j in range(toks_np.shape[0]):
        for slot in block_active:
            if slot in finished:
                continue
            req_id = slot_req[slot]
            if eng.sched.slot_request(slot) != req_id:
                continue  # finished before this block was dispatched
            tok = int(toks_np[j, slot])
            out[req_id].tokens.append(tok)
            eng.last_token[slot] = tok
            appended += 1
            is_eos = eng.eos_id is not None and tok == eng.eos_id
            if is_eos:
                out[req_id].finished_by_eos = True
            if eng.sched.record_token(slot, is_eos):
                eng._on_slot_finished(slot)
                finished.add(slot)
    eng.decode_tokens += appended
    eng.events.append(("decode", appended))
    eng.decode_time_s += time.perf_counter() - t0


def run_decode_block(eng, active, out) -> None:
    """Advance every active slot by one decode BLOCK (host side).

    Pipelined (``eng.pipeline_decode``): the next block is dispatched before
    the previous block's tokens are read back. Budgets and capacity are
    decremented at dispatch, so the next block's length bound never
    overshoots the cache; a membership change (prefill done, EOS, slot
    released) forces the in-flight block's retirement before the sampling
    state is re-uploaded from ``last_token``.
    """
    if eng._dev_dirty:
        retire_decode_block(eng, out)
        active = eng.sched.active_slots()
        if not active:
            return
    t0 = time.perf_counter()
    if eng._dev_dirty:
        active_mask = np.zeros((eng.max_slots,), bool)
        active_mask[active] = True
        eng.programs.upload(eng.last_token, active_mask, eng._temps, eng._topk, eng._topp, eng._seeds)
        # Exact fast path: every ACTIVE slot greedy (temperature 0).
        eng._dev_greedy = bool((eng._temps[active] == 0).all())
        eng._dev_dirty = False
    # Block length: bounded by every active slot's scheduled token budget
    # and cache headroom, then rounded DOWN to a power of two (as the JAX
    # engine does to bound its compiles; here its programs).
    k_run = int(
        min(
            eng.decode_block_steps,
            min(eng._remaining[s] for s in active),
            min(eng.max_seq - eng._cur_len[s] for s in active),
        )
    )
    k_run = max(1, k_run)
    k_run = 1 << (k_run.bit_length() - 1)
    toks_dev = eng.programs.run(k_run, eng._dev_greedy)
    for s in active:
        eng._cur_len[s] += k_run
        eng._remaining[s] -= k_run
    eng.steps += k_run
    eng.decode_time_s += time.perf_counter() - t0
    # The readback is queued on the stream behind this block, so the next
    # block of the same key, queued after it, rewrites the program's token
    # buffer only once the copy has read it.
    next_pending = (
        _start_readback(eng._gather_tokens(toks_dev)),
        list(active),
        {s: eng.sched.slot_request(s) for s in active},
    )
    if eng.pipeline_decode:
        # Retire the PREVIOUS block now that this one is in flight.
        retire_decode_block(eng, out)
        eng._pending_block = next_pending
    else:
        eng._pending_block = next_pending
        retire_decode_block(eng, out)
