"""Each prefill chunk as one program (``serving/decode_loop.PrefillPrograms``)
on the paged engine, on the CPU, against the JAX package's paged engine;
and the device-slot forms of K8's plain version and of the page write
against their host-slot forms.

On ``ModelConfig.tiny()`` in fp32 with the same weights on both sides
through ``params_from_jax``: pages of 16 rows, 5 a slot (max_seq 80) and
chunks of two pages, so a long prompt's last chunk is clamped to one page;
two slots serve five requests with the prefix cache on, one of them
skipping its first chunk over pages another registered. Every chunk runs
through the prefill programs (mode "eager" here): the tokens, the final
lengths and the prefix hits equal JAX's, one key serves both slots, the
programs built are the distinct keys and the other chunks replays, and
``warmup()`` builds every key, after which a run builds none (one JAX paged
run costs ~15 s, so the JAX side runs once).

The slot reaches K8 and the page write as a device scalar (JAX's traced
slot): ``paged_prefill_attention``'s plain version and
``paged_write_prefill`` give bit for bit what the host-int slot gives, at
every slot, over bf16 and int8 pages, with a window and with a window and
sinks over a table that aliases pages as the paged ring does.
"""

import jax
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import transformer as jt
from flash_attention_tpu.serving import engine as jax_engine
from flash_attention_tpu.serving import paged_engine as jax_paged
from flash_attention_tpu_torch.models import transformer as tt
from flash_attention_tpu_torch.models.convert import params_from_jax
from flash_attention_tpu_torch.ops.paged import init_paged_cache, paged_prefill_attention, paged_write_prefill
from flash_attention_tpu_torch.serving import decode_loop
from flash_attention_tpu_torch.serving import engine as torch_engine
from flash_attention_tpu_torch.serving import paged_engine as torch_paged

TINY = dict(dtype="float32")
POOL = dict(max_slots=2, num_pages=16, pages_per_slot=5, page_size=16, prefill_chunk=32, decode_block_steps=8,
            prefix_cache=True)
SHARED = tuple(range(3, 35))  # one chunk: two full pages
REQS = [
    (SHARED + tuple(range(60, 68)), 6),  # 40 tokens: registers the two shared pages when its prefill ends
    ((5, 9, 2), 7),
    (tuple(range(90, 160)), 8),  # 70 tokens: keys (32, 32), (32, 64) and the clamped (16, 80)
    (SHARED + tuple(range(200, 230)), 8),  # 62 tokens: its first chunk is skipped over the shared pages
    ((64, 7), 4),
]
KEYS = [(32, 32), (32, 64), (16, 80)]
SLOTS = 3  # the device-slot checks' slots


@pytest.fixture(scope="module")
def model():
    jcfg = jt.ModelConfig.tiny(**TINY)
    jparams = jt.init_model_params(jax.random.key(0), jcfg)
    return jcfg, jparams, tt.ModelConfig.tiny(**TINY), params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _requests(mod, first_id=0):
    return [mod.Request(id=first_id + i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(REQS)]


def _tokens(out, first_id=0):
    return {i - first_id: c.tokens for i, c in out.items()}


@pytest.fixture(scope="module")
def jax_run(model):
    jcfg, jparams, _, _ = model
    eng = jax_paged.PagedServingEngine(jparams, jcfg, **POOL)
    tokens = _tokens(eng.run(_requests(jax_engine)))
    return tokens, np.asarray(eng.caches[0].lengths), eng.prefix_hits


def _engine(model):
    _, _, tcfg, tparams = model
    return torch_paged.PagedServingEngine(tparams, tcfg, **POOL)


def _spy(eng) -> list:
    seen, run = [], eng.prefill_programs.run

    def spy(tokens, slot, kv_end):
        seen.append(((np.shape(tokens)[-1], kv_end), slot))
        return run(tokens, slot, kv_end)

    eng.prefill_programs.run = spy
    return seen


def test_programs_give_jax_tokens_lengths_and_prefix_hits(model, jax_run):
    """Every chunk through the programs, with a prefix-cache hit that skips
    a chunk: JAX's tokens, lengths and prefix hits; one program a distinct
    key, the other chunks replays; one key at both slots."""
    eng = _engine(model)
    seen = _spy(eng)
    got = _tokens(eng.run(_requests(torch_engine)))
    want_tokens, want_lengths, want_hits = jax_run
    assert got == want_tokens
    assert np.array_equal(eng.caches.lengths.numpy(), want_lengths)
    assert eng.prefix_hits == want_hits == 2  # the 62-token prompt's two shared pages
    progs = eng.prefill_programs
    keys = {key for key, _ in seen}
    assert keys == set(KEYS) and progs.built() == keys and progs.captures == len(keys)
    chunks = sum(1 for event in eng.events if event[0] == "chunk")
    assert progs.replays == chunks - len(keys) == len(seen) - len(keys) > 0
    # 2 + 1 + 3 + 1 (the skipped first chunk does not run) + 1 chunks.
    assert len(seen) == 8
    slots_of = {}
    for key, slot in seen:
        slots_of.setdefault(key, set()).add(slot)
    assert slots_of[32, 32] == {0, 1}


def test_warmup_builds_every_key_and_the_run_builds_none(model, jax_run):
    """``warmup()``'s prompt of max_seq - 2B = 64 tokens reaches (32, 64);
    the clamped (16, 80) is run on slot 0, whose table points at the dump
    page. The prefix table and the pool are left as they were, and the run
    after it captures nothing and gives JAX's tokens and prefix hits."""
    eng = _engine(model)
    assert decode_loop.prefill_keys(eng) == KEYS
    free = eng.alloc.free_count
    eng.warmup()
    progs = eng.prefill_programs
    assert progs.built() == set(KEYS) and progs.captures == len(KEYS)
    assert eng.alloc.free_count == free and eng._prefix == {} and eng.prefix_cache_enabled
    replays = progs.replays
    got = _tokens(eng.run(_requests(torch_engine, first_id=100)), first_id=100)
    assert progs.captures == len(KEYS) and progs.replays - replays == sum(1 for e in eng.events if e[0] == "chunk")
    assert got == jax_run[0] and eng.prefix_hits == jax_run[2]


def _layer(kind: str, gen):
    """One layer's [16-page] cache for SLOTS slots of 4 pages (16 rows each)
    with random rows (int8: random payloads and scales), a random table
    (sinks: each slot's logical pages 1-3 cycling over two physical pages,
    as the paged ring aliases them) and random lengths."""
    quant = "int8" if kind == "int8" else "none"
    cache = init_paged_cache(num_pages=16, num_slots=SLOTS, pages_per_slot=4, kv_heads=2, page_size=16, head_dim=16,
                             dtype=torch.bfloat16 if kind == "bf16" else torch.float32, kv_quant=quant, device="cpu")
    for t in (cache.k_pages, cache.v_pages):
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen, dtype=torch.int8))
        else:
            t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    if cache.quantized():
        for t in (cache.k_scales, cache.v_scales):
            t.copy_(torch.rand(t.shape, generator=gen) * 0.02 + 0.001)
    pages = torch.randperm(15, generator=gen)[:12].reshape(SLOTS, 4) + 1
    if kind == "window + sinks":
        pages[:, 3] = pages[:, 1]
    cache.page_table.copy_(pages.to(torch.int32))
    return cache._replace(lengths=torch.randint(0, 64, (SLOTS,), generator=gen, dtype=torch.int32))


MASKS = {"bf16": {}, "int8": {}, "window": dict(sliding_window=20), "window + sinks": dict(sliding_window=20,
                                                                                         attention_sinks=4)}


def _copy(cache):
    return cache._replace(**{f: getattr(cache, f).clone() for f in cache._fields if getattr(cache, f) is not None})


@pytest.mark.parametrize("slot", range(SLOTS))
@pytest.mark.parametrize("kind", list(MASKS))
def test_device_slot_k8_and_write_are_the_host_slot_ones(kind, slot):
    """The chunk's page write (its pages through the slot's table row, and
    the slot's length) and K8's plain version over the slot's pages, with
    the slot a device int32 scalar, equal the host-int slot's bit for bit."""
    gen = torch.Generator().manual_seed(3 + slot)
    cache = _layer(kind, gen)
    dtype = cache.k_pages.dtype if not cache.quantized() else torch.float32
    start, kv_end = 32, 64 if kind == "window + sinks" else 48
    t = kv_end - start
    k_new, v_new = (torch.randn((2, t, 16), generator=gen).to(dtype) for _ in range(2))
    q = torch.randn((1, 4, t, 16), generator=gen).to(dtype)
    dev_slot = torch.tensor([slot], dtype=torch.int32)
    outs = []
    for s in (slot, dev_slot):
        c = paged_write_prefill(_copy(cache), k_new, v_new, s, kv_end, start=start)
        outs.append((c, paged_prefill_attention(q, c, s, kv_end, chunk_len=t, **MASKS[kind])))
    (host, o_host), (dev, o_dev) = outs
    assert torch.equal(o_host, o_dev)
    for a, b in zip(host, dev):
        assert (a is None and b is None) or torch.equal(a, b)
    assert int(dev.lengths[slot]) == kv_end
    assert not torch.equal(host.k_pages, cache.k_pages)  # the chunk's rows landed


def test_device_slot_refusals():
    """A slot tensor holds one index; a host int out of range raises as
    indexing the table would."""
    cache = _layer("bf16", torch.Generator().manual_seed(0))
    k_new = torch.zeros((2, 16, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="one index"):
        paged_write_prefill(cache, k_new, k_new, torch.tensor([0, 1], dtype=torch.int32), 16)
    with pytest.raises(IndexError):
        paged_write_prefill(cache, k_new, k_new, SLOTS, 16)
