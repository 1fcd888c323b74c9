"""Continuous-batching serving engine over a PAGED KV cache.

Counterpart of the JAX package's ``serving/paged_engine.py``, the JAX
package's production memory model: instead of reserving max_seq rows per
slot (the dense engine, serving/engine.py), KV lives in fixed-size pages
owned by the native free-list allocator. A request's page budget,
ceil((prompt + max_new) / page_size) pages, is acquired at admission and
released at completion, so cache memory scales with actual use.

Page-table discipline:
  * ``self.caches`` is one PagedModelCache (ops/paged.py): all layers share
    its page table and lengths tensor on the device, and each layer has its
    own pages in its pools (physical page i of layer l is storage of its
    own);
  * physical page 0 is the DUMP page: never allocated; a released slot
    points its whole table at it, so the decode step's writes for inactive
    lanes (they ride along in the batched kernels) land there harmlessly.

The table row of a slot is written in place into the shared table tensor,
and so are the lengths (``ServingEngine``'s discipline: the decode programs
read both at fixed addresses).
With ``cfg.kv_quant`` the pages are quantized (payload and scale pools,
``ops/paged.py``); the scales are indexed by physical page, so shared
prefix pages carry theirs. A sliding-window model gets the PAGED RING: a
slot owns ceil((window + chunk) / page) + 2 physical pages (one more, pinned
as logical page 0, with attention sinks) and its table maps its whole
logical range onto them modulo their count, so its KV memory is O(window)
however long the context. Tensor-parallel serving (``shard_caches`` from
``parallel.sharding.make_cache_sharding``) shards the pools over kv heads
and the model over the mesh's model axis, and keeps the page table, the
lengths, the allocator and the prefix cache whole on every rank, as JAX's
paged engine does; over a data axis the ranks are replicas. ``warmup()``
(inherited, ``decode_loop.warmup_engine``) runs two throwaway requests with
the prefix cache suspended: their pages go back to the pool and the prefix
table is left as it was. Its prefill programs are the dense engine's
(``decode_loop.PrefillPrograms``): a key serves every slot, since K8 and
the page write find the slot's table row on the device, and a prompt whose
leading chunks the prefix cache skips runs the keys of the chunks left.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from flash_attention_tpu_torch.models.transformer import (
    ModelConfig,
    decode_step_logits_paged,
    init_paged_caches,
    prefill_chunk_paged,
)
from flash_attention_tpu_torch.parallel.sharding import with_sharding
from flash_attention_tpu_torch.serving.allocator import PageAllocator
from flash_attention_tpu_torch.serving.decode_loop import (
    advance_prefill,
    make_decode_multi,
    retire_decode_block,
    run_decode_block,
    start_prefill,
)
from flash_attention_tpu_torch.serving.engine import Completion, Request, ServingEngine


class PagedServingEngine(ServingEngine):
    """Continuous batching over paged KV memory (chunked prefill, sampling,
    optional prefix cache). The host loop, sampling state and counters are
    the dense engine's; the caches, admission and the loop's hooks differ.

    Args:
      params, cfg: the model (init_model_params or params_from_jax;
        ModelConfig); the engine runs on the params' device.
      max_slots: concurrent sequences (the decode batch size).
      num_pages: physical pages per layer (page 0 is reserved).
      pages_per_slot: page-table width = ceil(max supported seq / page_size).
      page_size: tokens per page (on the card a multiple of 64, the
        rows K7 and K8 read from one page at a time).
      eos_id: optional end-of-sequence token.
      prefill_chunk: tokens per prefill chunk (rounded up to a page multiple).
      decode_block_steps, pipeline_decode: as in ServingEngine.
      shard_caches: a callable applied once to the fresh PagedModelCache.
        One from ``parallel.sharding.make_cache_sharding`` carries its mesh:
        the engine makes only this rank's kv heads of the pools (table and
        lengths whole), shards ``params`` (the global ones) over the mesh's
        model axis and runs the tensor-parallel model; every rank of the
        mesh runs the engine on the same requests, and the ranks of a data
        axis are replicas. Any other callable is a placement only, as in
        ServingEngine.
      prefix_cache: share identical prompt-prefix pages across requests.
        Full prompt pages register by chained content hash when their
        prefill completes; a later request with a matching prefix points its
        table at the shared pages and skips the covered prefill chunks.
        Shared pages are refcounted and go back to the pool only when evicted
        under pool pressure. Decode writes land past the last full prompt
        page, so shared pages never change. Not with a sliding window,
        whose paged ring rewrites prompt pages in place.
    """

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        *,
        max_slots: int,
        num_pages: int,
        pages_per_slot: int,
        page_size: int = 128,
        eos_id: int | None = None,
        prefill_chunk: int = 256,
        decode_block_steps: int = 16,
        pipeline_decode: bool = True,
        shard_caches=None,
        prefix_cache: bool = False,
    ):
        if cfg.attention_sinks:
            if cfg.sliding_window is None:
                raise ValueError("attention_sinks requires sliding_window")
            if cfg.attention_sinks >= page_size:
                raise ValueError(f"attention_sinks ({cfg.attention_sinks}) must fit the pinned first page ({page_size} rows)")
        if prefix_cache and cfg.sliding_window is not None:
            raise ValueError("prefix_cache is incompatible with sliding-window configs (the paged ring recycles "
                             "prompt pages in place)")
        max_seq = pages_per_slot * page_size
        chunk = max(page_size, -(-prefill_chunk // page_size) * page_size)
        self._init_host_loop(params, cfg, max_slots, max_seq, eos_id, min(chunk, max_seq),
                             decode_block_steps, pipeline_decode)
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot
        # Page 0 is the dump page: burn it out of the pool by acquiring once.
        self.alloc = PageAllocator(num_pages)
        dump = self.alloc.acquire(1)
        if dump != [0]:
            raise RuntimeError(f"expected dump page 0, got {dump}")
        self._caches = with_sharding(self._place_caches(
            lambda c, slots: init_paged_caches(c, num_pages=num_pages, num_slots=slots, pages_per_slot=pages_per_slot,
                                               page_size=page_size, device=self.device),
            shard_caches, data_sharded=False,
        ), shard_caches)
        self.prefix_cache_enabled = prefix_cache
        # key (chained prompt-prefix digest) -> [phys_page, refcount]
        self._prefix: dict[bytes, list[int]] = {}
        self._slot_shared: dict[int, list[bytes]] = {}  # slot -> matched keys
        self._share_skip: dict[int, int] = {}  # slot -> prefill rows skipped
        self.prefix_hits = 0  # shared pages reused
        self.slot_pages: dict[int, list[int]] = {}
        decode = functools.partial(decode_step_logits_paged, tp_group=self.tp_group)
        self._decode_multi = make_decode_multi(self.model_cfg, decode, self._lengths_of, self._with_lengths)
        self._init_programs()

    # Hooks of the shared host loop (serving/decode_loop.py); a chunk runs
    # through ServingEngine._prefill_chunk_step's programs.
    def _prefill_logits(self, tokens: torch.Tensor, slot: torch.Tensor, start: int, kv_end: int):
        return prefill_chunk_paged(self.params, self.model_cfg, tokens, self._caches, slot, start, kv_end,
                                   tp_group=self.tp_group)

    @staticmethod
    def _lengths_of(cache) -> torch.Tensor:
        return cache.lengths

    @staticmethod
    def _with_lengths(cache, lengths: torch.Tensor):
        return cache._replace(lengths=lengths)

    def _on_slot_finished(self, slot: int) -> None:
        self._release(slot)  # sets _dev_dirty

    def _set_slot_table(self, row: np.ndarray, slot: int) -> None:
        """Write ``slot``'s row of the page table every layer shares, in place."""
        self.caches.page_table[slot] = torch.as_tensor(row, device=self.device)

    # ------------------------------------------------------------------
    def _admit_one(self, req: Request, slot: int) -> bool:
        """Acquire the slot's page budget; False if the pool is exhausted.

        A sliding-window model gets the paged ring: n = ceil((window +
        chunk) / page) + 2 physical pages, and logical page lp maps to
        pages[lp % n] over the request's whole logical range (with sinks,
        logical page 0 is pinned to one more page and the rest cycle over
        the other n). The kernels mask by position, so a rolled-out logical
        page aliasing a newer one is never scored, and the live span
        (window + one chunk + a page straddle) always fits the ring.
        """
        n_logical = min(-(-(len(req.prompt) + req.max_new_tokens) // self.page_size), self.pages_per_slot)
        window = self.cfg.sliding_window
        if window is not None:
            ring = -(-(window + self.chunk) // self.page_size) + 2
            sinks = self.cfg.attention_sinks
            n_phys = min(n_logical, ring + (1 if sinks else 0))
            pages = self.alloc.acquire(n_phys)
            if pages is None:
                return False
            self.slot_pages[slot] = pages
            row = np.zeros((self.pages_per_slot,), np.int32)  # the rest -> dump page
            if sinks and n_phys > 1:
                row[0] = pages[0]
                row[1:n_logical] = [pages[1 + (lp - 1) % (n_phys - 1)] for lp in range(1, n_logical)]
            else:
                row[:n_logical] = [pages[lp % n_phys] for lp in range(n_logical)]
            self._set_slot_table(row, slot)
            return True
        shared_keys: list[bytes] = []
        shared_phys: list[int] = []
        if self.prefix_cache_enabled:
            shared_keys, shared_phys = self._match_prefix(req)
        # Take the matched pages' references BEFORE any eviction, so the
        # eviction below cannot free a page this request is about to share.
        for key in shared_keys:
            self._prefix[key][1] += 1
        n_phys = n_logical - len(shared_phys)
        pages = self.alloc.acquire(n_phys)
        if pages is None and self._evict_prefix_pages():
            pages = self.alloc.acquire(n_phys)
        if pages is None:
            for key in shared_keys:
                self._prefix[key][1] -= 1
            return False
        self.slot_pages[slot] = pages
        row = np.zeros((self.pages_per_slot,), np.int32)  # the rest -> dump page
        row[: len(shared_phys)] = shared_phys
        row[len(shared_phys) : n_logical] = pages
        self._slot_shared[slot] = shared_keys
        self._share_skip[slot] = len(shared_phys) * self.page_size
        self.prefix_hits += len(shared_phys)
        self._set_slot_table(row, slot)
        return True

    def _match_prefix(self, req: Request) -> tuple[list[bytes], list[int]]:
        """Longest run of registered pages covering this prompt's prefix.

        Keys chain over the WHOLE prefix (page i's key hashes
        prompt[:(i+1)*page]), so a page matches only when everything before
        it matched too. Capped so the final prefill chunk always runs (its
        logits sample the first token), and floored to whole chunks: a
        partly covered chunk would rewrite rows of shared pages."""
        n_chunks = max(1, -(-len(req.prompt) // self.chunk))
        cap_rows = (n_chunks - 1) * self.chunk
        max_pages = min(len(req.prompt) // self.page_size, cap_rows // self.page_size)
        keys, phys = [], []
        for i in range(max_pages):
            key = self._prefix_key(req.prompt, i)
            ent = self._prefix.get(key)
            if ent is None:
                break
            keys.append(key)
            phys.append(ent[0])
        cpp = self.chunk // self.page_size
        n = (len(keys) // cpp) * cpp
        return keys[:n], phys[:n]

    def _prefix_key(self, prompt, i: int) -> bytes:
        """Content key of prompt page i: a blake2b digest of the int64 bytes
        of the WHOLE prefix through that page (a collision would share wrong
        KV silently, so Python's hash() is not enough). Equal to the JAX
        package's keys."""
        data = np.asarray(prompt[: (i + 1) * self.page_size], np.int64).tobytes()
        return hashlib.blake2b(data, digest_size=16).digest()

    def _register_prefix(self, slot: int, req: Request) -> None:
        """Move the slot's full prompt pages into the prefix cache (called
        when its prefill completes, so their contents are final)."""
        n_full = len(req.prompt) // self.page_size
        already = len(self._slot_shared.get(slot, []))
        owned = self.slot_pages.get(slot, [])
        shared_count = self._share_skip.get(slot, 0) // self.page_size
        new_keys = self._slot_shared.setdefault(slot, [])
        for i in range(already, n_full):
            owned_idx = i - shared_count
            if owned_idx >= len(owned):
                break
            key = self._prefix_key(req.prompt, i)
            if key in self._prefix:
                # Registered meanwhile by another slot: stop, so the moved
                # pages stay a contiguous prefix of ``owned``.
                break
            # The page now belongs to the prefix cache (refcount 1, this
            # slot); the slot's release decrements it instead of freeing it.
            self._prefix[key] = [owned[owned_idx], 1]
            new_keys.append(key)
        moved = len(new_keys) - already
        if moved:
            self.slot_pages[slot] = owned[moved:]

    def _evict_prefix_pages(self) -> bool:
        """Free every zero-ref prefix-cache page back to the pool."""
        dead = [k for k, ent in self._prefix.items() if ent[1] <= 0]
        for k in dead:
            self.alloc.release([self._prefix.pop(k)[0]])
        return bool(dead)

    def _release(self, slot: int) -> None:
        self._dev_dirty = True
        self.alloc.release(self.slot_pages.pop(slot, []))
        for key in self._slot_shared.pop(slot, []):
            ent = self._prefix.get(key)
            if ent is not None:
                ent[1] -= 1  # zero-ref pages stay cached until pool pressure
        self._share_skip.pop(slot, None)
        self._set_slot_table(np.zeros((self.pages_per_slot,), np.int32), slot)  # all -> dump page

    def _start_prefill(self, req: Request, slot: int) -> None:
        start_prefill(self, req, slot)
        skip = self._share_skip.get(slot, 0)
        if skip:
            # Shared pages already hold these rows' K/V: skip their chunks
            # (_match_prefix leaves the final chunk to run).
            self._prefills[slot].next_chunk = skip // self.chunk

    def _advance_prefill(self, slot: int, out: dict[int, Completion]) -> None:
        req = self._prefills[slot].req
        advance_prefill(self, slot, out)
        if self.prefix_cache_enabled and slot not in self._prefills:
            self._register_prefix(slot, req)

    def run(self, requests: list[Request]) -> dict[int, Completion]:
        """Serve requests to completion; returns {id: Completion}. Raises
        RuntimeError when the pool can never hold a deferred request."""
        by_id = {r.id: r for r in requests}
        out: dict[int, Completion] = {}
        deferred: list[tuple[int, int]] = []  # admitted, but no pages yet
        for r in requests:
            if not self.submit(r):
                out[r.id] = Completion(r.id, [], finished_by_eos=False)

        while True:
            for req_id, slot in deferred + self.sched.admit():
                req = by_id[req_id]
                if not self._admit_one(req, slot):
                    # Pool exhausted: hold the slot until pages come free.
                    if (req_id, slot) not in deferred:
                        deferred.append((req_id, slot))
                    continue
                if (req_id, slot) in deferred:
                    deferred.remove((req_id, slot))
                self._start_prefill(req, slot)

            # Advance every pending prefill by ONE chunk, then decode.
            for slot in sorted(self._prefills):
                self._advance_prefill(slot, out)

            active = self.sched.active_slots()
            if not active:
                retire_decode_block(self, out)
                if self._prefills:
                    continue
                st = self.sched.stats()
                if deferred and st.decoding == 0:
                    # Nothing in flight can ever release pages.
                    raise RuntimeError(f"page pool too small: deferred requests can never be admitted ({deferred})")
                if st.queued == 0 and st.prefilling == 0 and st.decoding == 0:
                    break
                continue

            run_decode_block(self, active, out)

        return out
