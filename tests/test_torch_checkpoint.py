"""KV-cache checkpoints (utils/checkpoint.py): the port's round trip, and
files that each package writes and the other loads.

The JAX package's tests/test_checkpoint.py cases on the port (a dense
layer cache over bf16 / int8 / fp8_e4m3, restored bit for bit, its decode
continuation identical; a scattered paged cache; a template of another
configuration refused), then cross-loading both ways: a file the JAX
package wrote loads into the port's template, and one the port wrote into
the JAX package's, with every leaf bit-equal (dense caches and the paged
pool, whose layout differs: one pool for all layers in the port, one
PagedKVCache a layer in JAX); and a tiny fp32 model's greedy decode resumed
from the other package's file gives the tokens of the uninterrupted run.
Inputs come from seeds; the JAX side runs its Pallas kernels in interpret
mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import attention as jattn
from flash_attention_tpu.models import transformer as jt
from flash_attention_tpu.utils import checkpoint as jckpt
from flash_attention_tpu_torch.models import attention as tattn
from flash_attention_tpu_torch.models import transformer as tt
from flash_attention_tpu_torch.models.convert import kv_cache_from_jax, params_from_jax
from flash_attention_tpu_torch.ops.paged import PagedKVCache, paged_decode_attention
from flash_attention_tpu_torch.utils.checkpoint import _leaves, load_kv_cache, save_kv_cache

CFG = dict(
    vocab_size=128, model_dim=128, num_layers=2, num_q_heads=4,
    num_kv_heads=2, head_dim=32, mlp_dim=256, dtype="float32",
)
LAYER = dict(model_dim=64, num_q_heads=4, num_kv_heads=2, head_dim=128)
MODES = ["none", "int8", "fp8_e4m3"]


def _bits(x) -> np.ndarray:
    """A leaf's bytes, for bit-equality of any dtype (bf16, fp8 included)."""
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _same_leaves(a, b) -> bool:
    return len(a) == len(b) and all(_bits(x).shape == _bits(y).shape and (_bits(x) == _bits(y)).all()
                                    for x, y in zip(a, b))


def _layer_cache(kv_quant, seed=0):
    """A JAX layer cache after a 16-token prefill of 2 sequences."""
    cfg = jattn.AttentionConfig(**LAYER, kv_quant=kv_quant)
    params = jattn.init_attention_params(jax.random.key(seed), cfg)
    x = jax.random.normal(jax.random.key(seed + 1), (2, 16, cfg.model_dim), jnp.float32).astype(cfg.jnp_dtype)
    _, cache = jattn.attention_prefill(params, cfg, x, jattn.init_kv_cache(cfg, 2, 128))
    return cfg, params, cache


# ---------------------------------------------------------------- the port's round trip


@pytest.mark.parametrize("kv_quant", MODES)
def test_dense_cache_roundtrip_decode_equivalence(tmp_path, kv_quant):
    jcfg, jparams, _ = _layer_cache(kv_quant)
    cfg = tattn.AttentionConfig(**LAYER, kv_quant=kv_quant)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 16, cfg.model_dim), np.float32)).to(cfg.torch_dtype)
    _, cache = tattn.attention_prefill(params, cfg, x, tattn.init_kv_cache(cfg, 2, 128, device="cpu"))

    save_kv_cache(tmp_path / "cache.npz", cache)
    restored = load_kv_cache(tmp_path / "cache.npz", tattn.init_kv_cache(cfg, 2, 128, device="cpu"))
    assert isinstance(restored, tattn.KVCache) and _same_leaves(_leaves(cache), _leaves(restored))

    step = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 1, cfg.model_dim), np.float32))
    step = step.to(cfg.torch_dtype)
    out_live, cache_live = tattn.attention_decode(params, cfg, step, cache)
    out_rest, cache_rest = tattn.attention_decode(params, cfg, step, restored)
    assert torch.equal(out_live, out_rest)
    assert _same_leaves(_leaves(cache_live), _leaves(cache_rest))


def _scattered_pages(seed, quantized=False):
    """A port PagedKVCache of 2 slots x 3 pages of 128 rows over a shuffled
    page table, random rows (int8 payload and scales if ``quantized``)."""
    g = torch.Generator().manual_seed(seed)
    num_pages, shape = 8, (8, 2, 128, 128)
    table = torch.randperm(num_pages, generator=g)[:6].reshape(2, 3).to(torch.int32)
    lengths = torch.tensor([300, 130], dtype=torch.int32)
    if quantized:
        k, v = (torch.randint(-127, 128, shape, generator=g, dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand(shape[:3], generator=g) * 0.01 for _ in range(2))
        return PagedKVCache(k, v, table, lengths, ks, vs)
    k, v = (torch.rand(shape, generator=g) - 0.5 for _ in range(2))
    return PagedKVCache(k.to(torch.bfloat16), v.to(torch.bfloat16), table, lengths)


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_cache_roundtrip(tmp_path, quantized):
    cache = _scattered_pages(11, quantized)
    save_kv_cache(tmp_path / "paged.npz", cache)
    template = PagedKVCache(*(None if t is None else torch.zeros_like(t) for t in cache))
    restored = load_kv_cache(tmp_path / "paged.npz", template)
    assert _same_leaves(_leaves(cache), _leaves(restored))
    q = (torch.rand((2, 4, 128), generator=torch.Generator().manual_seed(12)) - 0.5).to(torch.bfloat16)
    assert torch.equal(paged_decode_attention(q, cache), paged_decode_attention(q, restored))


def test_mismatched_template_fails(tmp_path):
    cfg = tattn.AttentionConfig(model_dim=64, num_q_heads=4, num_kv_heads=2)
    save_kv_cache(tmp_path / "c.npz", tattn.init_kv_cache(cfg, 2, 128, device="cpu"))
    with pytest.raises(ValueError, match="template|mismatch"):
        load_kv_cache(tmp_path / "c.npz", tattn.init_kv_cache(cfg, 2, 256, device="cpu"))  # wrong max_seq
    bad_cfg = tattn.AttentionConfig(model_dim=64, num_q_heads=4, num_kv_heads=2, kv_quant="int8")
    with pytest.raises(ValueError, match="leaves|structure"):
        load_kv_cache(tmp_path / "c.npz", tattn.init_kv_cache(bad_cfg, 2, 128, device="cpu"))  # extra scales


# ---------------------------------------------------------------- files across the packages


@pytest.mark.parametrize("kv_quant", MODES)
def test_dense_files_cross_load_both_ways(tmp_path, kv_quant):
    jcfg, _, jcache = _layer_cache(kv_quant, seed=3)
    tcfg = tattn.AttentionConfig(**LAYER, kv_quant=kv_quant)
    jckpt.save_kv_cache(tmp_path / "from_jax.npz", jcache)
    ours = load_kv_cache(tmp_path / "from_jax.npz", tattn.init_kv_cache(tcfg, 2, 128, device="cpu"))
    assert _same_leaves(_leaves(ours), jax.tree_util.tree_leaves(jcache))
    assert _same_leaves(_leaves(ours), _leaves(kv_cache_from_jax(jax.tree.map(np.asarray, jcache), device="cpu")))

    save_kv_cache(tmp_path / "from_port.npz", ours)
    theirs = jckpt.load_kv_cache(tmp_path / "from_port.npz", jattn.init_kv_cache(jcfg, 2, 128))
    assert _same_leaves(jax.tree_util.tree_leaves(theirs), jax.tree_util.tree_leaves(jcache))


def _model(kv_quant="none"):
    jcfg = jt.ModelConfig(**CFG, kv_quant=kv_quant)
    jparams = jt.init_model_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tt.ModelConfig(**CFG, kv_quant=kv_quant), tparams


PROMPTS = np.random.default_rng(5).integers(0, CFG["vocab_size"], (2, 7)).astype(np.int32)
DECODED, RESUMED = 3, 5  # greedy steps before the checkpoint and after it
POOL = dict(num_pages=8, num_slots=2, pages_per_slot=2, page_size=128)
TABLE = np.array([[3, 6], [5, 1]], np.int32)


def _jax_dense(jcfg, jparams):
    """(last tokens [2, 1], caches) after the prompts and DECODED steps."""
    logits, caches = jt.prefill(jparams, jcfg, jnp.asarray(PROMPTS), jt.init_caches(jcfg, 2, 64))
    tok = jnp.argmax(logits[:, -1:, :], axis=-1).astype(jnp.int32)
    for _ in range(DECODED):
        tok, caches = jt.decode_step(jparams, jcfg, tok, caches)
    return tok, caches


def _port_dense(tcfg, tparams):
    logits, caches = tt.prefill(tparams, tcfg, torch.from_numpy(PROMPTS), tt.init_caches(tcfg, 2, 64, device="cpu"))
    tok = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
    for _ in range(DECODED):
        tok, caches = tt.decode_step(tparams, tcfg, tok, caches)
    return tok, caches


def _padded(prompt):
    return np.pad(prompt, (0, 128 - len(prompt)))[None]


def _jax_paged(jcfg, jparams):
    caches = [c._replace(page_table=jnp.asarray(TABLE)) for c in jt.init_paged_caches(jcfg, **POOL)]
    toks = []
    for slot, prompt in enumerate(PROMPTS):
        logits, caches = jt.prefill_paged(jparams, jcfg, jnp.asarray(_padded(prompt)), caches, slot, len(prompt))
        toks.append(jnp.argmax(logits[0, len(prompt) - 1]))
    tok = jnp.stack(toks)[:, None].astype(jnp.int32)
    for _ in range(DECODED):
        tok, caches = jt.decode_step_paged(jparams, jcfg, tok, caches)
    return tok.astype(jnp.int32), caches


def _port_paged(tcfg, tparams):
    cache = tt.init_paged_caches(tcfg, **POOL, device="cpu")
    cache.page_table.copy_(torch.from_numpy(TABLE))
    toks = []
    for slot, prompt in enumerate(PROMPTS):
        logits, cache = tt.prefill_paged(tparams, tcfg, torch.from_numpy(_padded(prompt)), cache, slot, len(prompt))
        toks.append(torch.argmax(logits[0, len(prompt) - 1]))
    tok = torch.stack(toks)[:, None].to(torch.int32)
    for _ in range(DECODED):
        tok, cache = tt.decode_step_paged(tparams, tcfg, tok, cache)
    return tok, cache


def _resume_jax(step, jparams, jcfg, tok, caches) -> list:
    out = []
    for _ in range(RESUMED):
        tok, caches = step(jparams, jcfg, tok, caches)
        tok = tok.astype(jnp.int32)
        out.append(np.asarray(tok)[:, 0].tolist())
    return out


def _resume_port(step, tparams, tcfg, tok, caches) -> list:
    out = []
    for _ in range(RESUMED):
        tok, caches = step(tparams, tcfg, tok, caches)
        out.append(tok[:, 0].tolist())
    return out


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_decode_resumes_from_the_other_packages_file(tmp_path, layout):
    """The tiny fp32 model's two sequences: prompt, 3 greedy steps, a
    checkpoint, 5 more steps. A file of either package, loaded into the
    other's fresh template, resumes to the tokens the writer's own
    uninterrupted run gives; the loaded leaves equal the written ones."""
    jcfg, jparams, tcfg, tparams = _model()
    if layout == "dense":
        jax_state, port_state = _jax_dense(jcfg, jparams), _port_dense(tcfg, tparams)
        jax_template, port_template = jt.init_caches(jcfg, 2, 64), tt.init_caches(tcfg, 2, 64, device="cpu")
        jax_step, port_step = jt.decode_step, tt.decode_step
    else:
        jax_state, port_state = _jax_paged(jcfg, jparams), _port_paged(tcfg, tparams)
        jax_template, port_template = jt.init_paged_caches(jcfg, **POOL), tt.init_paged_caches(tcfg, **POOL, device="cpu")
        jax_step, port_step = jt.decode_step_paged, tt.decode_step_paged
    (jtok, jcaches), (ttok, tcaches) = jax_state, port_state
    assert np.asarray(jtok).tolist() == ttok.tolist()  # the two runs agree up to the checkpoint

    jckpt.save_kv_cache(tmp_path / "jax.npz", jcaches)
    loaded = load_kv_cache(tmp_path / "jax.npz", port_template)
    assert _same_leaves(_leaves(loaded), jax.tree_util.tree_leaves(jcaches))
    save_kv_cache(tmp_path / "port.npz", tcaches)
    jloaded = jckpt.load_kv_cache(tmp_path / "port.npz", jax_template)
    assert _same_leaves(jax.tree_util.tree_leaves(jloaded), _leaves(tcaches))

    want_jax = _resume_jax(jax_step, jparams, jcfg, jtok, jcaches)
    want_port = _resume_port(port_step, tparams, tcfg, ttok, tcaches)
    assert _resume_port(port_step, tparams, tcfg, torch.from_numpy(np.array(jtok)), loaded) == want_jax
    assert _resume_jax(jax_step, jparams, jcfg, jnp.asarray(ttok.numpy()), jloaded) == want_port
    assert want_jax == want_port


def test_paged_pool_refuses_layers_with_different_tables(tmp_path):
    """The port's pool shares one page table; a JAX file whose layers hold
    different tables cannot load into it."""
    jcfg, _, tcfg, _ = _model()
    caches = jt.init_paged_caches(jcfg, **POOL)
    caches = [caches[0]._replace(page_table=jnp.asarray(TABLE)), *caches[1:]]
    jckpt.save_kv_cache(tmp_path / "tables.npz", caches)
    with pytest.raises(ValueError, match="page_tables"):
        load_kv_cache(tmp_path / "tables.npz", tt.init_paged_caches(tcfg, **POOL, device="cpu"))


@pytest.mark.parametrize("kv_quant", ["int8", "fp8_e4m3"])
def test_quantized_paged_pool_files_cross_load(tmp_path, kv_quant):
    """A quantized pool of random payloads and scales: the port's file loads
    into JAX's per-layer caches ([pages, heads, 1, page] scales) and back
    into a fresh pool, bit for bit."""
    jcfg, _, tcfg, _ = _model(kv_quant)
    pool = tt.init_paged_caches(tcfg, **POOL, device="cpu")
    g = torch.Generator().manual_seed(13)
    pool.k_pool.copy_(torch.randint(-100, 100, pool.k_pool.shape, generator=g).to(pool.k_pool.dtype))
    pool.v_pool.copy_(torch.randint(-100, 100, pool.v_pool.shape, generator=g).to(pool.v_pool.dtype))
    pool.k_scales.copy_(torch.rand(pool.k_scales.shape, generator=g))
    pool.v_scales.copy_(torch.rand(pool.v_scales.shape, generator=g))
    pool.page_table.copy_(torch.from_numpy(TABLE))
    pool.lengths.copy_(torch.tensor([200, 17]))
    save_kv_cache(tmp_path / "port.npz", pool)
    theirs = jckpt.load_kv_cache(tmp_path / "port.npz", jt.init_paged_caches(jcfg, **POOL))
    assert theirs[0].k_scales.shape == (POOL["num_pages"], 2, 1, POOL["page_size"])
    assert _same_leaves(jax.tree_util.tree_leaves(theirs), _leaves(pool))
    jckpt.save_kv_cache(tmp_path / "jax.npz", theirs)
    back = load_kv_cache(tmp_path / "jax.npz", tt.init_paged_caches(tcfg, **POOL, device="cpu"))
    assert _same_leaves(list(back), list(pool))
