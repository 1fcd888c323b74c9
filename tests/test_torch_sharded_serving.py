"""Tensor-parallel serving on gloo CPU ranks: ``parallel/sharding.py``'s
``shard_model_params`` and ``make_cache_sharding`` behind both engines'
``shard_caches``.

JAX's tests/test_sharded_serving.py on the port: its config (fp32, 2
layers, 4 / 4 heads), its params (``models/convert.params_from_jax``) and
its four requests through the port's dense engine over a data 2 x model 4
mesh and its paged engine with the pools over model 4 (page 128), whose
tokens must be the JAX package's unsharded engines' on every rank. Then the
model against the port's own unsharded model, fp32 within 1e-5 of the
largest logit (the row-parallel sums add in another order, about 1e-7
here; a missing or doubled partial moves the logits by more than 1e-2):
the split of bf16 and W8A16 trees, chunked-prefill and decode logits under
model 2 and model 4, over an int8 cache, a window over the rolling ring,
int8 weights and the paged cache's deferred decode; every rank of a model
group holding the same logits bits; a one-rank mesh bit-identical to the
single-process model; a model axis that does not divide num_kv_heads
refused. And both engines over a (data 2, model 4) mesh with slot refills,
chunked prompts, pipelined blocks and a sampled request, equal to the
port's unsharded engines, each making only its rank's block of the caches
(the callable's block of the global caches, with an int8 cache and the
rolling ring too).

As in tests/test_torch_parallel.py, the port's side runs once for the
module in 8 gloo processes (``spawn_ranks``; this module imports no JAX at
the top, so the ranks start without it) with the plain kernel versions;
the JAX side runs in the test's process.
"""

import functools

import numpy as np
import pytest
import torch

from flash_attention_tpu_torch.utils.distributed import spawn_ranks

WORLD = 8
TOL = 1e-5
# tests/test_sharded_serving.py's config, requests and pool.
JAX_CFG = dict(vocab_size=128, model_dim=128, num_layers=2, num_q_heads=4, num_kv_heads=4, head_dim=32,
               mlp_dim=256, dtype="float32")
JAX_REQS = [((5, 9, 2), 5), ((100, 3, 44, 8), 6), ((64, 7), 4), ((11, 12), 3)]
JAX_POOL = dict(max_slots=4, num_pages=16, pages_per_slot=2, page_size=128)
# The model cases: GQA, 8 q / 4 kv heads, so model 4 leaves each rank 2 q heads over 1 kv head.
MODEL_CFG = dict(vocab_size=96, model_dim=64, num_layers=2, num_q_heads=8, num_kv_heads=4, head_dim=16, mlp_dim=128,
                 dtype="float32")
CHUNK = 4
PROMPTS = (10, 7)  # dense: two slots, chunked prefill in CHUNK-token chunks, 32 rows a slot
# The rolling ring holds 128 rows (window + chunk, 128-aligned): a 150-token prompt wraps it.
RING = dict(prompts=(150, 7), chunk=16, max_seq=256)
PAGE = 16
PAGED_PROMPTS = (32, 16)  # paged: whole pages, one PAGE-token chunk at a time
DECODE_STEPS = 5
# name: (ModelConfig fields, model axis, cache)
MODEL_CASES = {
    "model 2": ({}, 2, "dense"),
    "model 4": ({}, 4, "dense"),
    "int8 cache": (dict(kv_quant="int8"), 4, "dense"),
    "window over the rolling ring": (dict(sliding_window=8, rolling=True), 2, "dense"),
    "int8 weights": (dict(weight_quant="int8"), 4, "dense"),
    "paged, deferred decode": ({}, 4, "paged"),
    "paged, int8 pool": (dict(kv_quant="int8"), 2, "paged"),
}
# Engine case on the data 2 x model 4 mesh: 6 requests for 4 slots (refills), prompts over several chunks, one
# sampled (temperature, top-k, top-p, seed).
ENGINE_REQS = [((5, 9, 2, 7, 1), 6), ((90, 3, 44, 8, 21, 60, 7, 1, 2), 9), ((64,), 4), ((11, 12, 13, 14), 5),
               ((20, 2), 3), ((1, 2, 3, 4, 5, 6, 7), 7)]
SAMPLED = 3
# The caches an engine makes on the data 2 x model 4 mesh, against the callable's block of the global ones.
BLOCK_CASES = {"plain": {}, "int8 cache": dict(kv_quant="int8"),
               "window over the rolling ring": dict(sliding_window=8, rolling=True)}


def _tokens(out):
    return {i: c.tokens for i, c in out.items()}


def _requests(reqs, sampled=None):
    """Greedy requests, but for ``sampled``'s index (temperature, top-k,
    top-p and a seed)."""
    from flash_attention_tpu_torch.serving.engine import Request
    from flash_attention_tpu_torch.serving.sampling import SamplingParams

    return [Request(id=i, prompt=p, max_new_tokens=n,
                    sampling=SamplingParams(temperature=0.8, top_k=20, top_p=0.9, seed=7) if i == sampled else
                    SamplingParams())
            for i, (p, n) in enumerate(reqs)]


def _decode_tokens(cfg, slots):
    return torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (DECODE_STEPS, slots, 1))).int()


def _dense_logits(params, cfg, caches, group, prompts, chunk):
    """Chunked prefill of ``prompts`` into slots 0 and 1, then DECODE_STEPS
    steps of both on fixed tokens; every logit, flattened."""
    from flash_attention_tpu_torch.models.transformer import decode_step_logits, prefill_chunk

    rng = np.random.default_rng(2)
    out = []
    for slot, n in enumerate(prompts):
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, n)).int()
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            logits, caches = prefill_chunk(params, cfg, prompt[None, lo:hi], caches, slot, lo, hi, tp_group=group)
            out.append(logits.flatten())
    for tok in _decode_tokens(cfg, len(prompts)):
        logits, caches = decode_step_logits(params, cfg, tok, caches, tp_group=group)
        out.append(logits.flatten())
    return torch.cat(out)


def _paged_logits(params, cfg, cache, group):
    """The paged twin: PAGED_PROMPTS through prefill_chunk_paged over a
    shuffled table, then DECODE_STEPS deferred decode steps."""
    from flash_attention_tpu_torch.models.transformer import decode_step_logits_paged, prefill_chunk_paged

    cache.page_table.copy_(torch.tensor([[3, 1, 4, 0], [2, 5, 6, 0]], dtype=torch.int32))
    rng = np.random.default_rng(2)
    out = []
    for slot, n in enumerate(PAGED_PROMPTS):
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, n)).int()
        for lo in range(0, n, PAGE):
            logits, cache = prefill_chunk_paged(params, cfg, prompt[None, lo:lo + PAGE], cache, slot, lo, lo + PAGE,
                                                tp_group=group)
            out.append(logits.flatten())
    for tok in _decode_tokens(cfg, len(PAGED_PROMPTS)):
        logits, cache = decode_step_logits_paged(params, cfg, tok, cache, tp_group=group)
        out.append(logits.flatten())
    return torch.cat(out)


def _logits(cfg, params, kind, mesh=None):
    """The logits of ``kind``'s run: the single-process model, or with
    ``mesh`` the tensor-parallel one over its model axis (the caches made
    whole, then sharded, as an engine does)."""
    from flash_attention_tpu_torch.models.transformer import init_caches, init_paged_caches
    from flash_attention_tpu_torch.parallel.sharding import make_cache_sharding, shard_model_params

    if kind == "dense":
        run = RING if cfg.rolling else dict(prompts=PROMPTS, chunk=CHUNK, max_seq=32)
        caches = init_caches(cfg, 2, run["max_seq"], device="cpu", prefill_chunk=run["chunk"])
        run = functools.partial(_dense_logits, prompts=run["prompts"], chunk=run["chunk"])
    else:
        caches = init_paged_caches(cfg, num_pages=8, num_slots=2, pages_per_slot=4, page_size=PAGE, device="cpu")
        run = _paged_logits
    if mesh is None:
        return run(params, cfg, caches, None)
    params, local_cfg = shard_model_params(params, cfg, mesh)
    return run(params, local_cfg, make_cache_sharding(mesh)(caches), mesh.get_group("model"))


def _model_params(over):
    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params

    cfg = ModelConfig(**{**MODEL_CFG, **over})
    return cfg, init_model_params(torch.Generator().manual_seed(0), cfg)


def _same_split(local, glob, mesh, name: str) -> bool:
    """``local`` is this rank's block of ``glob`` as shard_model_params
    splits ``name``: gathered over the model axis it is ``glob`` bit for
    bit, and a W8A16 weight's scales split with its columns (the same
    tensor where the weight is row-parallel)."""
    from flash_attention_tpu_torch.ops.quant import QuantizedTensor
    from flash_attention_tpu_torch.parallel.mesh import gather

    dim = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "w_gate": 1, "w_up": 1, "w_down": 0}[name]
    spec = tuple("model" if d == dim else None for d in range(len(glob.shape)))
    if not isinstance(glob, QuantizedTensor):
        return local.dtype == glob.dtype and torch.equal(gather(local, mesh, spec), glob)
    scales_ok = (local.scales is glob.scales if dim == 0 else torch.equal(gather(local.scales, mesh, spec), glob.scales))
    return scales_ok and torch.equal(gather(local.values, mesh, spec), glob.values)


def _same_tensors(a, b) -> bool:
    """The two caches hold the same tensors: shapes, dtypes and values."""
    from flash_attention_tpu_torch.utils.checkpoint import _leaves

    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _port_side(jax_params) -> dict:
    """Every case on this rank; each rank returns its own results."""
    import torch.distributed as dist

    from flash_attention_tpu_torch.models.convert import params_from_jax
    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_caches, init_paged_caches
    from flash_attention_tpu_torch.parallel.mesh import all_gather, make_mesh
    from flash_attention_tpu_torch.parallel.sharding import make_cache_sharding, shard_model_params
    from flash_attention_tpu_torch.serving.engine import ServingEngine
    from flash_attention_tpu_torch.serving.paged_engine import PagedServingEngine

    torch.set_num_threads(1)
    rank = dist.get_rank()
    out = {"rank": rank, "logits": {}, "split": {}}

    # JAX's two engines on JAX's params: dense on data 2 x model 4, paged over model 4 (replicas over data).
    mesh = make_mesh(2, 4, device_type="cpu")
    cfg, params = ModelConfig(**JAX_CFG), params_from_jax(jax_params, device="cpu")
    dense = ServingEngine(params, cfg, max_slots=4, max_seq=64, shard_caches=make_cache_sharding(mesh))
    out["jax dense"] = _tokens(dense.run(_requests(JAX_REQS)))
    paged = PagedServingEngine(params, cfg, **JAX_POOL, shard_caches=make_cache_sharding(mesh))
    out["jax paged"] = _tokens(paged.run(_requests(JAX_REQS)))
    out["local shapes"] = (tuple(dense.caches[0].k.shape), tuple(paged.caches.k_pool.shape))

    # The block each engine makes is the one the callable keeps of the global caches, tensor for tensor.
    out["block"] = {}
    for label, over in BLOCK_CASES.items():
        cfg, params = _model_params(over)
        sharding = make_cache_sharding(mesh)
        dense = ServingEngine(params, cfg, max_slots=4, max_seq=32, prefill_chunk=CHUNK, shard_caches=sharding)
        paged = PagedServingEngine(params, cfg, max_slots=4, num_pages=12, pages_per_slot=2, page_size=PAGE,
                                   shard_caches=sharding)
        out["block"][label] = (
            _same_tensors(dense.caches, sharding(init_caches(cfg, 4, 32, device="cpu", prefill_chunk=dense.chunk))),
            _same_tensors(paged.caches, sharding(init_paged_caches(cfg, num_pages=12, num_slots=4, pages_per_slot=2,
                                                                   page_size=PAGE, device="cpu"))),
        )

    # Both engines with refills, chunked prompts, pipelined blocks and sampling, against the unsharded engines.
    cfg, params = _model_params({})
    for name, make, kw in (("dense", ServingEngine, dict(max_slots=4, max_seq=32)),
                           ("paged", PagedServingEngine, dict(max_slots=4, num_pages=12, pages_per_slot=2,
                                                              page_size=PAGE))):
        kw = {**kw, "prefill_chunk": CHUNK if name == "dense" else PAGE, "decode_block_steps": 4}
        want = _tokens(make(params, cfg, **kw).run(_requests(ENGINE_REQS, SAMPLED)))
        got = _tokens(make(params, cfg, **kw, shard_caches=make_cache_sharding(mesh)).run(_requests(ENGINE_REQS, SAMPLED)))
        out[f"engine {name}"] = (got, want)

    # The split of bf16 and W8A16 trees over model 4 (ranks 0-3).
    mesh = make_mesh(1, 4, device_type="cpu")
    for label, over in (("bf16", dict(dtype="bfloat16")), ("int8 weights", dict(weight_quant="int8"))):
        cfg, params = _model_params(over)
        if mesh.get_coordinate() is None:
            continue
        local, local_cfg = shard_model_params(params, cfg, mesh)
        same = [_same_split(local["layers"][i][part][n], lp[part][n], mesh, n)
                for i, lp in enumerate(params["layers"]) for part in ("attn", "mlp") for n in lp[part]]
        whole = local["embed"] is params["embed"] and local["final_norm"] is params["final_norm"]
        out["split"][label] = (all(same), whole, (local_cfg.num_q_heads, local_cfg.num_kv_heads, local_cfg.mlp_dim))

    # The tensor-parallel model against the unsharded one.
    for name, (over, m, kind) in MODEL_CASES.items():
        mesh = make_mesh(1, m, device_type="cpu")
        if mesh.get_coordinate() is None:
            continue
        cfg, params = _model_params(over)
        want, got = _logits(cfg, params, kind), _logits(cfg, params, kind, mesh)
        peers = all_gather(got[None], 0, mesh.get_group("model"))
        out["logits"][name] = (float((got - want).abs().max() / want.abs().max()),
                               all(torch.equal(p, got) for p in peers))

    # A one-rank mesh: the single-process model, bit for bit (rank 0).
    mesh = make_mesh(device_type="cpu")
    if rank == 0:
        out["one rank"] = {}
        for kind in ("dense", "paged"):
            cfg, params = _model_params({})
            out["one rank"][kind] = torch.equal(_logits(cfg, params, kind, mesh), _logits(cfg, params, kind))

    # A model axis of 8 over 4 kv heads.
    mesh = make_mesh(1, 8, device_type="cpu")
    cfg, params = _model_params({})
    try:
        shard_model_params(params, cfg, mesh)
    except ValueError as e:
        out["refused"] = str(e)
    return out


@pytest.fixture(scope="module")
def jax_model():
    import jax

    from flash_attention_tpu.models import transformer as jt

    jcfg = jt.ModelConfig(**JAX_CFG)
    return jcfg, jt.init_model_params(jax.random.key(0), jcfg)


@pytest.fixture(scope="module")
def port(jax_model):
    import jax

    return spawn_ranks(_port_side, WORLD, jax.tree.map(np.asarray, jax_model[1]), backend="gloo", timeout_s=300)


def _jax_tokens(jax_model, engine: str):
    from flash_attention_tpu.serving.engine import Request, ServingEngine
    from flash_attention_tpu.serving.paged_engine import PagedServingEngine

    jcfg, jparams = jax_model
    reqs = [Request(id=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(JAX_REQS)]
    if engine == "dense":
        out = ServingEngine(jparams, jcfg, max_slots=4, max_seq=64).run(reqs)
    else:
        out = PagedServingEngine(jparams, jcfg, **JAX_POOL).run(reqs)
    return {i: c.tokens for i, c in out.items()}


@pytest.mark.parametrize("engine", ["dense", "paged"])
def test_sharded_engine_matches_jax_unsharded(port, jax_model, engine):
    """tests/test_sharded_serving.py's two cases: the port's sharded engine
    returns the JAX package's unsharded engine's tokens on every rank, with
    only this rank's block of the caches."""
    want = _jax_tokens(jax_model, engine)
    assert all(len(want[i]) == n for i, (_, n) in enumerate(JAX_REQS))
    for r in port:
        assert r[f"jax {engine}"] == want, f"rank {r['rank']}"
        # Dense [4 slots over data 2, 4 kv heads over model 4]; the pools' kv heads over model 4.
        assert r["local shapes"] == ((2, 1, 64, 32), (2, 16, 1, 128, 32))


@pytest.mark.parametrize("engine", ["dense", "paged"])
def test_sharded_engine_matches_unsharded_with_refills_and_sampling(port, engine):
    got, want = port[0][f"engine {engine}"]
    assert got == want and len(got) == len(ENGINE_REQS)
    assert all(r[f"engine {engine}"][0] == got for r in port)


@pytest.mark.parametrize("label", list(BLOCK_CASES))
def test_engine_makes_only_its_block_of_the_caches(port, label):
    """Each rank's dense caches and paged pools, made directly at the rank's
    heads and slots, are what make_cache_sharding's callable keeps of the
    fresh global caches."""
    for r in port:
        assert r["block"][label] == (True, True), f"rank {r['rank']}"


@pytest.mark.parametrize("label", ["bf16", "int8 weights"])
def test_shard_model_params_splits_each_weight(port, label):
    """Every weight is its rank's block (gathered: the global one, bit for
    bit; dtypes kept), the embedding and norms are the global tensors, and
    the local config holds a quarter of the heads and the MLP."""
    for r in port[:4]:
        assert r["split"][label] == (True, True, (2, 1, 32)), f"rank {r['rank']}"


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_tensor_parallel_logits_match_unsharded(port, name):
    m = MODEL_CASES[name][1]
    for r in port[:m]:
        err, same_in_group = r["logits"][name]
        assert err <= TOL, f"rank {r['rank']}: {err}"
        assert same_in_group, f"rank {r['rank']}: the model group's logits differ"
    assert all(name not in r["logits"] for r in port[m:])


def test_one_rank_mesh_is_the_single_process_model(port):
    assert port[0]["one rank"] == {"dense": True, "paged": True}


def test_model_axis_must_divide_kv_heads(port):
    assert all("must divide num_kv_heads (4)" in r["refused"] for r in port)
