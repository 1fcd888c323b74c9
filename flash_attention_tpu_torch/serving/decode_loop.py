"""Host loop of the serving engine: chunked prefill and blocked decode.

Counterpart of the JAX package's ``serving/decode_loop.py``. A decode
BLOCK is up to ``decode_block_steps`` model steps issued back to back on the
device (``lax.scan`` there, a Python loop of k steps here), with ONE
device-to-host token readback per block. Blocks are pipelined: block i+1 is
dispatched before block i's tokens are read, and the readback is an
asynchronous copy into pinned memory with an event, so the host waits on
block i's tokens only, not on block i+1's work.

Under tensor parallelism over a data axis (``ServingEngine``'s
``shard_caches``) a rank runs the device work of its own slots only: the
prefill chunks of the slots it owns and the decode block over them. The
host state stays the same on every rank: a prefill's first token goes from
its owner to every rank (``_share_first``), and a block's tokens are
all-gathered over the data axis on the device as it is dispatched
(``_gather_tokens``), before the readback, so a pipelined block still
overlaps the previous one's readback. Every rank runs the same
collectives in the same order, since its host loop is every other's.

``warmup_engine`` is the counterpart of JAX's: one throwaway request that
walks every prefill chunk position and every power-of-two decode block
length, so the first served run pays none of the first-use costs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from flash_attention_tpu_torch.serving.sampling import sample_tokens


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
    ``_prefill_chunk_step`` (dense or paged chunk), ``_set_slot_length_fn``
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
        logits, eng.caches = eng._prefill_chunk_step(eng.params, toks, eng.caches, slot, lo, hi)
    st.next_chunk += 1
    eng.events.append(("chunk", slot))
    if st.next_chunk * eng.chunk < len(st.padded):
        return
    req = st.req
    true_len = len(req.prompt)
    first = None
    if owned:
        eng.caches = eng._set_slot_length_fn(eng.caches, slot, true_len)
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

    Eager PyTorch compiles no programs per shape, but a first run still
    pays once: the kernels' nvcc build (``ops/_build.py``) or the load of
    the built library, each kernel function's load at its first launch,
    cuBLAS's handle and workspace at the first GEMM, and the caching
    allocator's growth to the run's peak. One throwaway request walks both
    surfaces:

      * prefill: a full-length prompt visits every chunk position (K1 on
        the dense engine, K8 on the paged one);
      * decode: ``max_new = 2 * decode_block_steps`` makes the remaining
        budget after the prefill-sampled first token ``2B - 1``, so blocks
        run at k = B, B/2, ..., 2, 1 (K6, or K7 with K10). With ``max_new =
        2B - 1`` k = 1 would be skipped.

    ``prompt_len`` is clamped to [1, max_seq - 2B]. The prefix cache is
    suspended for the run, so the synthetic prompt registers no pages.
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
    try:
        # Large positive id: the C++ scheduler reserves negatives as its
        # empty-slot sentinel.
        eng.run([Request(id=(1 << 62) + 41, prompt=(7,) * plen, max_new_tokens=max_new)])
    finally:
        if had_prefix:
            eng.prefix_cache_enabled = True
    eng.steps = 0
    eng.decode_tokens = 0
    eng.decode_time_s = 0.0
    eng.events.clear()


def make_decode_multi(model_cfg, decode_logits_fn, lengths_of, with_lengths):
    """Build the k-step decode block for one engine.

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
        own = slice(eng._slot_lo, eng._slot_hi)  # this rank's slots: all of them unless data-sharded
        eng._dev = tuple(
            torch.as_tensor(a[own], device=eng.device)
            for a in (eng.last_token, active_mask, eng._temps, eng._topk, eng._topp, eng._seeds)
        )
        # Exact fast path: every ACTIVE slot greedy (temperature 0).
        eng._dev_greedy = bool((eng._temps[active] == 0).all())
        eng._dev_dirty = False
    d_last, d_active, d_t, d_k, d_p, d_s = eng._dev
    # Block length: bounded by every active slot's scheduled token budget
    # and cache headroom, then rounded DOWN to a power of two (as the JAX
    # engine does to bound its compiles; kept so both engines step alike).
    k_run = int(
        min(
            eng.decode_block_steps,
            min(eng._remaining[s] for s in active),
            min(eng.max_seq - eng._cur_len[s] for s in active),
        )
    )
    k_run = max(1, k_run)
    k_run = 1 << (k_run.bit_length() - 1)
    toks_dev, d_last, eng.caches = eng._decode_multi(
        eng.params, d_last, eng.caches, d_active, d_t, d_k, d_p, d_s, k_run, eng._dev_greedy,
    )
    eng._dev = (d_last, d_active, d_t, d_k, d_p, d_s)
    for s in active:
        eng._cur_len[s] += k_run
        eng._remaining[s] -= k_run
    eng.steps += k_run
    eng.decode_time_s += time.perf_counter() - t0
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
