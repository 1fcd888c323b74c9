"""Each prefill chunk as one program (``serving/decode_loop.PrefillPrograms``)
on the dense engine, on the CPU, against the JAX package's engine; and the
device-slot forms of the dense chunk path against its host-slot forms.

On ``ModelConfig.tiny()`` in fp32 (argmax ties deterministic) with the same
weights on both sides through ``params_from_jax``, every chunk runs
through the prefill programs' static buffers, as the card replays them
(here eagerly, mode "eager", a (T, kv_end) key's program built at its
first chunk as the card captures it). The chunk grid does not divide
``max_seq``, so a long prompt's last chunk is clamped short; two slots
serve six requests, so one key serves both slots. The tokens and the final
lengths equal JAX's, ``captures`` counts the distinct keys and the other
chunks are replays, ``warmup()`` builds every key a request can reach
(``decode_loop.prefill_keys``) and the run after it builds none.

The slot reaches the chunk path as a device scalar (JAX's traced slot):
K1's plain version with ``kv_batch`` over the whole cache, and
``attention_prefill_chunk`` over bf16 and int8 caches, the window, and the
rolling ring with sinks, give bit for bit what the host-int slot gives,
at every slot.
"""

import jax
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import transformer as jt
from flash_attention_tpu.serving import engine as jax_engine
from flash_attention_tpu_torch.models import attention as ta
from flash_attention_tpu_torch.models import transformer as tt
from flash_attention_tpu_torch.models.convert import params_from_jax
from flash_attention_tpu_torch.ops import _build
from flash_attention_tpu_torch.ops.flash_attention import flash_attention
from flash_attention_tpu_torch.serving import decode_loop
from flash_attention_tpu_torch.serving import engine as torch_engine
from flash_attention_tpu_torch.utils.checkpoint import _leaves

TINY = dict(dtype="float32")
# Chunks of 16 over 60 positions: a prompt of more than 48 tokens ends in the clamped chunk (12, 60).
DENSE = dict(max_slots=2, max_seq=60, prefill_chunk=16, decode_block_steps=8)
REQS = [
    (tuple(range(40, 90)), 6),  # 50 tokens: keys (16, 16), (16, 32), (16, 48), (12, 60)
    ((5, 9, 2), 7),
    (tuple(range(3, 23)), 9),  # 20 tokens: (16, 16), (16, 32)
    ((64,), 4),
    (tuple(range(100, 137)), 10),  # 37 tokens: (16, 16), (16, 32), (16, 48)
    ((11, 12, 13, 14), 5),
]
SLOTS = 3  # the device-slot checks' cache slots


@pytest.fixture(scope="module")
def model():
    jcfg = jt.ModelConfig.tiny(**TINY)
    jparams = jt.init_model_params(jax.random.key(0), jcfg)
    return jcfg, jparams, tt.ModelConfig.tiny(**TINY), params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _requests(mod, first_id=0):
    return [mod.Request(id=first_id + i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(REQS)]


def _tokens(out, first_id=0):
    return {i - first_id: c.tokens for i, c in out.items()}


def _chunks(eng) -> int:
    return sum(1 for event in eng.events if event[0] == "chunk")


@pytest.fixture(scope="module")
def jax_run(model):
    jcfg, jparams, _, _ = model
    eng = jax_engine.ServingEngine(jparams, jcfg, **DENSE)
    return _tokens(eng.run(_requests(jax_engine))), np.asarray(eng.caches[0].lengths)


def _engine(model):
    _, _, tcfg, tparams = model
    return torch_engine.ServingEngine(tparams, tcfg, **DENSE)


def _spy(eng) -> list:
    """Every chunk's (key, slot) as the programs run it."""
    seen, run = [], eng.prefill_programs.run

    def spy(tokens, slot, kv_end):
        seen.append(((np.shape(tokens)[-1], kv_end), slot))
        return run(tokens, slot, kv_end)

    eng.prefill_programs.run = spy
    return seen


def test_programs_give_jax_tokens_and_lengths(model, jax_run):
    """Every chunk through the programs: JAX's tokens, JAX's lengths in the
    engine's one lengths tensor, the K / V buffers at their addresses, and
    one program a distinct key, the other chunks replays."""
    eng = _engine(model)
    lengths = eng._lengths_of(eng.caches)
    kv = [t.data_ptr() for t in _leaves(eng.caches) if t is not lengths]
    seen = _spy(eng)
    got = _tokens(eng.run(_requests(torch_engine)))
    assert got == jax_run[0]
    assert eng._lengths_of(eng.caches) is lengths and np.array_equal(lengths.numpy(), jax_run[1])
    assert kv == [t.data_ptr() for t in _leaves(eng.caches) if t is not lengths]
    progs = eng.prefill_programs
    keys = {key for key, _ in seen}
    assert progs.mode == "eager" and progs.built() == keys and progs.captures == len(keys)
    assert (12, 60) in keys  # the clamped last chunk
    assert progs.replays == _chunks(eng) - len(keys) == len(seen) - len(keys) > 0


def test_one_key_serves_every_slot(model):
    """A key built at one slot runs at the other from the same program: the
    slot is the programs' device scalar, filled before each chunk."""
    eng = _engine(model)
    seen = _spy(eng)
    eng.run(_requests(torch_engine))
    slots_of = {}
    for key, slot in seen:
        slots_of.setdefault(key, set()).add(slot)
    assert slots_of[16, 16] == {0, 1}
    assert int(eng.prefill_programs.slot) == seen[-1][1]


def test_warmup_builds_every_key_and_the_run_builds_none(model, jax_run):
    """``warmup()``'s prompt of max_seq - 2B tokens reaches (16, 48); the
    clamped (12, 60) is built on a free slot, the lengths restored. The run
    after it captures nothing, replays every chunk and gives JAX's tokens."""
    eng = _engine(model)
    assert decode_loop.prefill_keys(eng) == [(16, 16), (16, 32), (16, 48), (12, 60)]
    lengths, before, run = eng._lengths_of(eng.caches), {}, eng.prefill_programs.run

    def spy(tokens, slot, kv_end):
        before.setdefault((np.shape(tokens)[-1], kv_end), (slot, lengths.clone()))
        return run(tokens, slot, kv_end)

    eng.prefill_programs.run = spy
    eng.warmup()
    slot, kept = before[12, 60]
    assert slot == 0 and torch.equal(lengths, kept)  # the walk past the prompt's positions left them as they were
    progs = eng.prefill_programs
    assert progs.built() == set(decode_loop.prefill_keys(eng)) and progs.captures == 4
    replays = progs.replays
    got = _tokens(eng.run(_requests(torch_engine, first_id=100)), first_id=100)
    assert progs.captures == 4 and progs.replays - replays == _chunks(eng) > 0
    assert got == jax_run[0]


@pytest.mark.parametrize("max_seq, chunk, keys", [
    (64, 16, [(16, 16), (16, 32), (16, 48), (16, 64)]),
    (49, 16, [(16, 16), (16, 32), (16, 48)]),  # max_seq - 1 is a chunk multiple: no clamped chunk
    (50, 16, [(16, 16), (16, 32), (16, 48), (2, 50)]),
    (10, 16, [(10, 10)]),  # one chunk, cut to max_seq
])
def test_prefill_keys_follow_start_prefills_grid(max_seq, chunk, keys):
    """``prefill_keys`` is the union of every admissible prompt's chunks, as
    ``start_prefill`` cuts them (the last clamped at max_seq)."""

    class Eng:
        pass

    eng = Eng()
    eng.max_seq, eng.chunk = max_seq, chunk
    assert decode_loop.prefill_keys(eng) == keys
    reach = set()
    for n in range(1, max_seq):
        padded = min(-(-n // chunk) * chunk, max_seq)
        reach |= {(min(lo + chunk, padded) - lo, min(lo + chunk, padded)) for lo in range(0, padded, chunk)}
    assert reach == set(keys)


def _cache(cfg, gen):
    """A [SLOTS]-slot cache of ``cfg``'s layer for 512 positions (a rolling
    one: a ring of 128 rows behind 128 sink rows) filled with random rows (a
    quantized one with random payloads and scales) and random lengths."""
    cache = ta.init_kv_cache(cfg, SLOTS, 512, device="cpu", prefill_chunk=16)
    for t in (cache.k, cache.v):
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen, dtype=torch.int8))
        else:
            t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    if cache.quantized():
        for t in (cache.k_scales, cache.v_scales):
            t.copy_(torch.rand(t.shape, generator=gen) * 0.02 + 0.001)
    return cache._replace(lengths=torch.randint(0, 512, (SLOTS,), generator=gen, dtype=torch.int32))


# (label, AttentionConfig fields, chunk start): past the window and the sinks where there is one.
CHUNK_CASES = [
    ("bf16", dict(dtype="bfloat16"), 32),
    ("int8 cache", dict(kv_quant="int8"), 32),
    ("window", dict(sliding_window=24), 48),
    ("rolling ring with sinks", dict(sliding_window=40, rolling=True, attention_sinks=4), 200),  # wraps the ring
    ("rolling ring, first chunk", dict(sliding_window=40, rolling=True, attention_sinks=4), 0),
]


@pytest.mark.parametrize("slot", range(SLOTS))
@pytest.mark.parametrize("label, over, start", CHUNK_CASES, ids=[c[0] for c in CHUNK_CASES])
def test_device_slot_chunk_is_the_host_slot_chunk(label, over, start, slot):
    """``attention_prefill_chunk`` with the slot as a device int32 scalar
    writes the same rows and lengths and returns the same output, bit for
    bit, as with the host int (the dequant, the ring's write and gather,
    the sinks' two passes and K1's ``kv_batch`` all index on the device)."""
    gen = torch.Generator().manual_seed(7 + slot)
    cfg = ta.AttentionConfig(model_dim=64, num_q_heads=4, num_kv_heads=2, head_dim=16, **{"dtype": "float32", **over})
    params = ta.init_attention_params(gen, cfg)
    x = torch.randn((1, 16, 64), generator=gen).to(cfg.torch_dtype)
    host = _cache(cfg, gen)
    dev = host._replace(**{f: getattr(host, f).clone() for f in host._fields if getattr(host, f) is not None})
    out_h, new_h = ta.attention_prefill_chunk(params, cfg, x, host, slot, start, start + 16)
    out_d, new_d = ta.attention_prefill_chunk(params, cfg, x, dev, torch.tensor([slot], dtype=torch.int32), start,
                                              start + 16)
    assert torch.equal(out_h, out_d)
    for a, b in zip(new_h, new_d):
        assert (a is None and b is None) or torch.equal(a, b)
    assert int(new_d.lengths[slot]) == start + 16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("slot", range(SLOTS))
def test_k1_plain_with_kv_batch_is_the_slot_view(dtype, window, slot):
    """``flash_attention`` with ``kv_batch`` over every slot's visible rows
    (the plain version's ``index_select``) equals K1's plain version over the
    slot's own view, bit for bit, with and without a window and with the
    LSE."""
    gen = torch.Generator().manual_seed(11)
    q = torch.randn((1, 4, 16, 32), generator=gen).to(dtype)
    k, v = (torch.randn((SLOTS, 2, 80, 32), generator=gen).to(dtype) for _ in range(2))
    kv_end = 48
    want = flash_attention(q, k[slot:slot + 1, :, :kv_end], v[slot:slot + 1, :, :kv_end], causal=True,
                           sliding_window=window, save_residuals=True)
    got = flash_attention(q, k[:, :, :kv_end], v[:, :, :kv_end], causal=True, sliding_window=window,
                          save_residuals=True, kv_batch=torch.tensor([slot], dtype=torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(want, got))


def test_kv_batch_refusals():
    """``kv_batch`` is int32 [batch] on q's device, takes no segment ids and
    no gradient."""
    q = torch.zeros((1, 2, 4, 8))
    kv = torch.zeros((3, 2, 4, 8))
    with pytest.raises(ValueError, match="kv_batch"):
        flash_attention(q, kv, kv, causal=True, kv_batch=torch.tensor([0]))  # int64
    with pytest.raises(ValueError, match="kv_batch"):
        flash_attention(q, kv, kv, causal=True, kv_batch=torch.tensor([0, 1], dtype=torch.int32))
    with pytest.raises(ValueError, match="segment ids"):
        flash_attention(q, kv, kv, causal=True, kv_batch=torch.tensor([0], dtype=torch.int32),
                        segment_ids=torch.zeros((1, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="not differentiable"):
        flash_attention(q.requires_grad_(), kv, kv, causal=True, kv_batch=torch.tensor([0], dtype=torch.int32))
    with pytest.raises(ValueError, match="q/kv shape"):
        flash_attention(q, kv, kv, causal=True)  # three batch rows without kv_batch


class _Lib:
    """A stand-in for the kernel library: each entry a namespace that takes
    the ``restype`` and ``argtypes`` ``_build._declare`` sets."""

    def __getattr__(self, name):
        entry = type(name, (), {})()
        setattr(self, name, entry)
        return entry


@pytest.mark.parametrize("entry", ["fat_flash_fwd", "fat_paged_prefill"])
def test_c_entries_take_their_declared_arguments(entry):
    """The ctypes declaration of the two forward entries, which now take the
    K / V batch index and the device slot, lists as many arguments as their
    C signatures in csrc/flash_fwd.cu (ctypes refuses a call of another
    count, and converts each argument by its declared type)."""
    lib = _Lib()
    _build._declare(lib)
    src = (_build.CSRC_DIR / "flash_fwd.cu").read_text()
    head = src[src.index(f'extern "C" int {entry}('):]
    params = head[head.index("(") + 1:head.index(")")]
    assert len(getattr(lib, entry).argtypes) == len(params.split(","))
