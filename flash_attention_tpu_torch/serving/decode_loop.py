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

A prefill chunk is one program too (``PrefillPrograms``), as JAX jits its
``_prefill_chunk_step`` with ``kv_end`` static: a CUDA graph a (chunk
length, kv_end) key, whose start follows from the two. The slot is the one
dynamic input: the chunk's kernels and index operations read it from a
device scalar that the host fills before each replay, so one program serves
every slot. The chunk's tokens go to a static buffer of its length, its
logits to another.

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
length, greedy and sampled, so the first served run builds no program,
prefill or decode.
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
    ``_prefill_chunk_step`` (one prefill program, ``PrefillPrograms``, over
    the dense or paged model; its logits), ``_set_slot_length`` (the engine's one
    lengths tensor, written in place) and ``_on_slot_finished`` (the paged
    engine releases the slot's pages).
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
        # One program of key (hi - lo, hi): the caches and the lengths are
        # written in place, the logits are the programs' buffer.
        logits = eng._prefill_chunk_step(st.padded[None, lo:hi], slot, lo, hi)
        if logits.device.type == "cuda":
            # A replayed chunk returns before its work is done: the decode
            # section (``run_decode_block``) starts once it has run.
            eng._prefill_queued = torch.cuda.Event()
            eng._prefill_queued.record()
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
    to the run's peak, and on the card each program's capture
    (``PrefillPrograms``, ``DecodePrograms``). Two throwaway requests walk
    both surfaces:

      * prefill: a full-length greedy prompt visits every chunk position
        (K1 on the dense engine, K8 on the paged one), building the prefill
        program of each (T, kv_end) key. The chunk positions past that
        prompt's, which only a prompt of more than max_seq - 2B tokens
        reaches (the clamped last chunk among them), are then run once on
        the first slot of this rank, whose rows no request holds, and the
        engine's lengths are restored, so a served run builds none;
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
        progs = eng.prefill_programs
        rest = [key for key in prefill_keys(eng) if key not in progs.built()]
        if rest and progs.mode != "issued":
            lengths = eng._lengths_of(eng.caches)
            kept = lengths.clone()
            for t, kv_end in rest:
                progs.run(np.full((1, t), 7, np.int32), 0, kv_end)
            lengths.copy_(kept)
    finally:
        eng.eos_id = eos_id
        if had_prefix:
            eng.prefix_cache_enabled = True
    eng.steps = 0
    eng.decode_tokens = 0
    eng.decode_time_s = 0.0
    eng.events.clear()


def prefill_keys(eng) -> list[tuple[int, int]]:
    """Every (T, kv_end) key of a prefill chunk the engine can run: the
    chunk positions of a prompt of max_seq - 1 tokens (``start_prefill``'s
    grid, clamped at max_seq). A shorter prompt's chunks are among them,
    and a longer one leaves no room for a new token."""
    padded = min(-(-(eng.max_seq - 1) // eng.chunk) * eng.chunk, eng.max_seq)
    return [(min(lo + eng.chunk, padded) - lo, min(lo + eng.chunk, padded)) for lo in range(0, padded, eng.chunk)]


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


class _Programs:
    """What an engine's decode and prefill programs share: how a key's
    program is built, run and counted. ``mode`` is how a key runs:

      * "graph" (an engine on the card): a key's first run is eager (the
        work the caller needed, which also brings up whatever its first use
        allocates: the kernels' split counters, cuBLAS's handle, the
        program's static buffers); right after it the key is captured as a
        ``torch.cuda.CUDAGraph`` in the default error mode, which refuses
        any host sync, and every later run of the key is one replay.
        Capturing runs nothing, so no work is thrown away over the live
        caches;
      * "issued" (an engine on the card whose model axis spans more than one
        rank, ``models.attention.tensor_parallel``): every run is eager.
        Over gloo the model's all-reduces move CUDA tensors through host
        memory (``parallel.mesh.host_staged``), which no graph can hold;
        over NCCL they could be captured, but no multi-card run has yet
        held a captured program against its eager body, so they are issued
        too;
      * "eager" (the CPU): every run is eager, through the same static
        buffers, and a key's first run builds its program as the card
        captures it, so the bookkeeping the card replays is what the CPU
        tests exercise.

    ``captures`` counts programs built (captured on the card), ``replays``
    runs from a built program and ``capture_s`` each key's capture seconds
    (the card's). A replay launches the kernels its capture recorded but
    runs no wrapper, so it adds to the wrappers' counts what the capture's
    calls counted, and the capture itself, which launches nothing, adds
    nothing: every count of ``ops.counters``' registry, where each wrapper
    registers its counters as it creates them. ``chip_smoke.py`` holds what
    a replay adds against the kernel records of its device trace.

    The decode programs share one memory pool and the prefill programs
    another: within a pool the programs run in one stream, one after
    another, and each holds its own output, so no capture of the other
    kind can place its scratch on a decode program's token block.
    """

    def __init__(self, eng):
        # A proxy: the engine holds its programs, and a cycle between the two
        # would leave a dropped engine's graphs to the cyclic collector.
        self.eng = weakref.proxy(eng)
        if eng.device.type != "cuda":
            self.mode = "eager"
        elif tensor_parallel(eng.tp_group):
            self.mode = "issued"
        else:
            self.mode = "graph"
        self.pool = torch.cuda.graph_pool_handle() if self.mode == "graph" else None
        self._programs: dict = {}  # key -> (graph or None, its output, launch counts a replay)
        self.captures = 0
        self.replays = 0
        self.capture_s: dict = {}  # key -> seconds its capture took (the card's)

    def built(self) -> frozenset:
        """The keys whose program is built."""
        return frozenset(self._programs)

    def _run(self, key, body):
        """``body()`` of ``key``: replayed where its program is built, else
        run eagerly and, but in mode "issued", its program built."""
        program = self._programs.get(key)
        if program is not None:
            graph, out, counts = program
            self.replays += 1
            if graph is None:
                return body()
            graph.replay()
            counters.add(counts)
            return out
        out = body()
        if self.mode == "issued":
            return out
        if self.mode == "graph":
            self._programs[key] = self._capture(key, body)
        else:
            self._programs[key] = (None, None, {})
        self.captures += 1
        return out

    def _capture(self, key, body):
        t0 = time.perf_counter()
        before = counters.snapshot()
        graph = torch.cuda.CUDAGraph()
        # No cyclic collection while capturing: freeing another object's CUDA
        # graph, event or pinned buffer is a host call that invalidates a
        # capture in the default error mode.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                out = body()
        finally:
            if collecting:
                gc.enable()
        counts = {c: n - before.get(c, 0) for c, n in counters.snapshot().items() if n != before.get(c, 0)}
        counters.add(counts, -1)
        self.capture_s[key] = time.perf_counter() - t0
        return graph, out, counts


class DecodePrograms(_Programs):
    """An engine's decode blocks as programs, one a (k, greedy) key: JAX's
    jitted ``make_decode_multi`` (one XLA program a static (k, greedy)).

    A block reads the engine's static input buffers (``upload``) and its
    caches, runs ``make_decode_multi``'s k steps and the sampler, and
    writes the last tokens back into their buffer and the final lengths into
    the engine's one lengths tensor, so the next block, eager or replayed,
    starts where this one ended. Each program holds its own token block.
    Modes, counts and the memory pool: ``_Programs``.
    """

    def __init__(self, eng):
        super().__init__(eng)
        slots = eng._slot_hi - eng._slot_lo
        self.last, self.active, self.temps, self.topk, self.topp, self.seeds = (
            torch.zeros((slots,), dtype=dtype, device=eng.device)
            for dtype in (torch.int32, torch.bool, torch.float32, torch.int32, torch.float32, torch.int32)
        )

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
        the next block of the same key."""
        return self._run((k, bool(greedy)), lambda: self.block(k, greedy))


class PrefillPrograms(_Programs):
    """An engine's prefill chunks as programs, one a (T, kv_end) key: JAX's
    jitted ``_prefill_chunk_step``, one XLA program a static ``kv_end`` and
    token shape [1, T], with ``start`` (= kv_end - T) and the slot traced.

    A chunk reads its tokens from a static [1, T] int32 buffer of its
    length and the slot from ``slot``, a device int32 scalar, both filled
    in place before each run without a host sync (the tokens through pinned
    memory, the slot by a fill); runs the engine's model over the chunk
    (``_prefill_logits``), whose kernels and index operations take the slot
    from device memory, so one program serves every slot; writes K / V and
    the lengths into the engine's caches in place; and copies its [1, T,
    vocab] fp32 logits into a buffer of its length. One buffer a length,
    not a key: at a 1,024-token chunk over a 32,000-token vocabulary one is
    131 MB. Modes, counts and the memory pool: ``_Programs``.
    """

    def __init__(self, eng):
        super().__init__(eng)
        self.slot = torch.zeros((1,), dtype=torch.int32, device=eng.device)
        self._tokens: dict = {}  # T -> [1, T] int32 tokens
        self._logits: dict = {}  # T -> [1, T, vocab] fp32 logits

    def chunk(self, t: int, kv_end: int) -> torch.Tensor:
        """The chunk of key (t, kv_end) on the static buffers, eagerly: its
        logits buffer. The body every program holds."""
        eng = self.eng
        logits, caches = eng._prefill_logits(self._tokens[t], self.slot, kv_end - t, kv_end)
        out = self._logits[t]
        out.copy_(logits)
        eng._keep_lengths(caches)
        return out

    def run(self, tokens, slot: int, kv_end: int) -> torch.Tensor:
        """One chunk: ``tokens`` [1, T] (host integers) at positions [kv_end
        - T, kv_end) of this rank's ``slot``. Returns its [1, T, vocab] fp32
        logits, valid until the next chunk of length T runs."""
        tokens = np.ascontiguousarray(tokens, dtype=np.int32)
        t = tokens.shape[-1]
        if t not in self._tokens:
            self._tokens[t] = torch.zeros((1, t), dtype=torch.int32, device=self.eng.device)
            self._logits[t] = torch.empty((1, t, self.eng.cfg.vocab_size), dtype=torch.float32,
                                          device=self.eng.device)
        host = torch.from_numpy(tokens.reshape(1, t))
        if self.eng.device.type == "cuda":
            # Pinned, so the copy is queued without a host sync; the pinned
            # allocator keeps the block until the copy has read it.
            host = host.pin_memory()
        self._tokens[t].copy_(host, non_blocking=True)
        self.slot.fill_(slot)
        return self._run((t, kv_end), lambda: self.chunk(t, kv_end))


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
    if eng._prefill_queued is not None:
        # The decode section's wall excludes the prefill chunks queued ahead.
        eng._prefill_queued.synchronize()
        eng._prefill_queued = None
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
