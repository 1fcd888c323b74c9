"""KV-cache checkpoints of tensor-parallel engines on gloo CPU ranks.

``utils/checkpoint``'s ``save_kv_cache`` on a sharded engine's caches
(``make_cache_sharding``'s callable carried by the tree) writes the GLOBAL
caches, as JAX's ``device_get`` gathers its global arrays, and
``load_kv_cache`` into such caches gives each rank its block. On
``ModelConfig.tiny()`` in fp32, with JAX's params on both sides, the dense
and the paged engine at model 2 (ranks 0-1) and at data 2 x model 2 serve
the same requests as the unsharded engines:

  * the sharded engine's file holds the unsharded port engine's leaves, in
    JAX's order, shapes and dtypes (the integer leaves bit for bit, the
    floating ones within 1e-5 of the largest value: the row-parallel sums
    add in another order), and each rank's block of it is its live caches
    bit for bit;
  * JAX's ``load_kv_cache`` reads that file into JAX's unsharded template,
    and JAX's greedy decode resumes from it with the tokens it resumes with
    from its own engine's file;
  * JAX's file loads into a fresh sharded port engine, each rank holding
    its block of it bit for bit, and the engine's decode program resumes
    with JAX's tokens.

The paged resume maps every slot onto pages of its own (the served run
released them all to the dump page). The port's side runs once for the
module in four gloo processes (``spawn_ranks``; this module imports no JAX
at the top), the JAX side in the test's process.
"""

import json

import numpy as np
import pytest
import torch

from flash_attention_tpu_torch.utils.distributed import spawn_ranks

WORLD = 4
TOL = 1e-5
MESHES = ((1, 2), (2, 2))  # (data, model)
DENSE = dict(max_slots=4, max_seq=64, prefill_chunk=16)
PAGED = dict(max_slots=4, num_pages=17, pages_per_slot=4, page_size=16, prefill_chunk=16)
# Six requests on four slots (refills); every slot ends with room for RESUME more rows.
REQS = [((5, 9, 2), 9), ((100, 3, 44, 8, 21, 60, 7), 12), ((64,), 20), ((11, 12, 13, 14), 6),
        (tuple(range(30, 48)), 11), ((90, 2), 7)]
RESUME = 4  # greedy decode steps from the checkpoint
TABLE = (1 + np.arange(16, dtype=np.int32)).reshape(4, 4)  # the paged resume: four pages of its own a slot
CASES = [f"{kind} {d}x{m}" for kind in ("dense", "paged") for d, m in MESHES]


def _engine(kind, params, cfg, **kw):
    from flash_attention_tpu_torch.serving.engine import ServingEngine
    from flash_attention_tpu_torch.serving.paged_engine import PagedServingEngine

    if kind == "dense":
        return ServingEngine(params, cfg, **DENSE, **kw)
    return PagedServingEngine(params, cfg, **PAGED, **kw)


def _serve(eng) -> dict:
    from flash_attention_tpu_torch.serving.engine import Request

    out = eng.run([Request(id=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(REQS)])
    return {i: c.tokens for i, c in out.items()}


def _resume(eng, kind, last) -> list:
    """RESUME greedy steps of every slot from the engine's caches and the
    last tokens ``last``, through its decode program: [RESUME, slots]."""
    slots = eng.max_slots
    if kind == "paged":
        eng.caches.page_table.copy_(torch.from_numpy(TABLE))
    eng.programs.upload(np.asarray(last, np.int32), np.ones(slots, bool), np.zeros(slots, np.float32),
                        np.zeros(slots, np.int32), np.ones(slots, np.float32), np.zeros(slots, np.int32))
    return eng._gather_tokens(eng.programs.run(RESUME, True)).tolist()


def _same(a, b) -> bool:
    from flash_attention_tpu_torch.utils.checkpoint import _leaves

    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _port_side(jax_params, tmp: str, last: dict) -> dict:
    """Every case on this rank; each rank returns its own results."""
    import torch.distributed as dist

    from flash_attention_tpu_torch.models.convert import params_from_jax
    from flash_attention_tpu_torch.models.transformer import ModelConfig
    from flash_attention_tpu_torch.parallel.mesh import make_mesh
    from flash_attention_tpu_torch.parallel.sharding import make_cache_sharding
    from flash_attention_tpu_torch.utils.checkpoint import load_kv_cache, save_kv_cache

    torch.set_num_threads(1)
    rank = dist.get_rank()
    cfg, params = ModelConfig.tiny(dtype="float32"), params_from_jax(jax_params, device="cpu")
    out = {"rank": rank}
    if rank == 0:  # the unsharded engines' files
        for kind in ("dense", "paged"):
            eng = _engine(kind, params, cfg)
            out[f"{kind} tokens"] = _serve(eng)
            save_kv_cache(f"{tmp}/port_{kind}.npz", eng.caches)
    for kind in ("dense", "paged"):
        for d, m in MESHES:
            mesh = make_mesh(d, m, device_type="cpu")
            if mesh.get_coordinate() is None:
                continue
            case = f"{kind} {d}x{m}"
            sharding = make_cache_sharding(mesh)
            eng = _engine(kind, params, cfg, shard_caches=sharding)
            res = {"tokens": _serve(eng), "local": tuple(eng.caches[0].k.shape if kind == "dense"
                                                         else eng.caches.k_pool.shape)}
            path = f"{tmp}/sharded_{kind}_{d}x{m}.npz"
            save_kv_cache(path, eng.caches)  # every rank of the mesh; the first one writes
            whole = load_kv_cache(path, sharding.global_shapes(eng.caches), device_put=False)
            res["block of the file"] = _same(sharding(whole), eng.caches)
            # JAX's file into a fresh sharded engine and into an unsharded one.
            fresh, plain = _engine(kind, params, cfg, shard_caches=sharding), _engine(kind, params, cfg)
            fresh.caches = load_kv_cache(f"{tmp}/jax_{kind}.npz", fresh.caches)
            plain.caches = load_kv_cache(f"{tmp}/jax_{kind}.npz", plain.caches)
            res["block of jax's file"] = _same(sharding(plain.caches), fresh.caches)
            res["carries its sharding"] = fresh.caches.sharding is sharding
            res["resumed"] = _resume(fresh, kind, last[kind])
            res["resumed unsharded"] = _resume(plain, kind, last[kind])
            out[case] = res
    return out


def _file_leaves(path) -> list:
    """A checkpoint file's leaves as tensors, read by its own header."""
    from flash_attention_tpu_torch.utils.checkpoint import _DTYPES

    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        return [torch.from_numpy(np.ascontiguousarray(z[f"leaf_{i}"])).view(_DTYPES[rec["dtype"]]).reshape(rec["shape"])
                for i, rec in enumerate(meta["leaves"])]


def _jax_engine(kind, jcfg, jparams):
    from flash_attention_tpu.serving.engine import ServingEngine
    from flash_attention_tpu.serving.paged_engine import PagedServingEngine

    if kind == "dense":
        return ServingEngine(jparams, jcfg, **DENSE)
    return PagedServingEngine(jparams, jcfg, **PAGED)


def _jax_resume(kind, jcfg, jparams, path, last) -> list:
    """JAX's load_kv_cache of ``path`` into JAX's unsharded template, then
    RESUME greedy steps of JAX's decode: [RESUME, slots]."""
    import jax.numpy as jnp

    from flash_attention_tpu.models import transformer as jt
    from flash_attention_tpu.utils import checkpoint as jckpt

    if kind == "dense":
        caches, step = jt.init_caches(jcfg, DENSE["max_slots"], DENSE["max_seq"]), jt.decode_step
    else:
        caches = jt.init_paged_caches(jcfg, num_pages=PAGED["num_pages"], num_slots=PAGED["max_slots"],
                                      pages_per_slot=PAGED["pages_per_slot"], page_size=PAGED["page_size"])
        step = jt.decode_step_paged
    caches = jckpt.load_kv_cache(path, caches)
    if kind == "paged":
        caches = [c._replace(page_table=jnp.asarray(TABLE)) for c in caches]
    tok, out = jnp.asarray(np.asarray(last, np.int32))[:, None], []
    for _ in range(RESUME):
        tok, caches = step(jparams, jcfg, tok, caches)
        out.append(np.asarray(tok)[:, 0].tolist())
    return out


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """JAX's engines serve REQS and write their files; then the port's
    ranks run every case (``_port_side``)."""
    import jax

    from flash_attention_tpu.models import transformer as jt
    from flash_attention_tpu.utils import checkpoint as jckpt

    tmp = tmp_path_factory.mktemp("sharded_ckpt")
    jcfg = jt.ModelConfig.tiny(dtype="float32")
    jparams = jt.init_model_params(jax.random.key(0), jcfg)
    jax_side = {}
    for kind in ("dense", "paged"):
        eng = _jax_engine(kind, jcfg, jparams)
        out = eng.run([jax_engine_request(i, p, n) for i, (p, n) in enumerate(REQS)])
        jckpt.save_kv_cache(tmp / f"jax_{kind}.npz", eng.caches)
        last = eng.last_token.copy()
        jax_side[kind] = {"tokens": {i: c.tokens for i, c in out.items()}, "last": last,
                          "resumed": _jax_resume(kind, jcfg, jparams, tmp / f"jax_{kind}.npz", last)}
    port = spawn_ranks(_port_side, WORLD, jax.tree.map(np.asarray, jparams), str(tmp),
                       {kind: s["last"] for kind, s in jax_side.items()}, backend="gloo", timeout_s=300)
    return {"tmp": tmp, "jax": jax_side, "port": port, "jcfg": jcfg, "jparams": jparams}


def jax_engine_request(i, prompt, n):
    from flash_attention_tpu.serving.engine import Request

    return Request(id=i, prompt=prompt, max_new_tokens=n)


def _ranks(sides, case):
    return [r for r in sides["port"] if case in r]


@pytest.mark.parametrize("case", CASES)
def test_sharded_file_is_the_unsharded_engines_file(sides, case):
    kind = case.split()[0]
    ranks = _ranks(sides, case)
    d, m = (int(x) for x in case.split()[1].split("x"))
    assert len(ranks) == d * m
    want_tokens = sides["port"][0][f"{kind} tokens"]
    assert want_tokens == sides["jax"][kind]["tokens"]
    for r in ranks:
        assert r[case]["tokens"] == want_tokens and r[case]["block of the file"], f"rank {r['rank']}"
    got = _file_leaves(sides["tmp"] / f"sharded_{kind}_{d}x{m}.npz")
    want = _file_leaves(sides["tmp"] / f"port_{kind}.npz")
    assert [(t.dtype, t.shape) for t in got] == [(t.dtype, t.shape) for t in want]
    for a, b in zip(got, want):
        if a.dtype.is_floating_point:
            assert float((a - b).abs().max()) <= TOL * max(float(b.abs().max()), 1.0)
        else:
            assert torch.equal(a, b)
    # Only this rank's block was held: the kv heads over the model axis, the dense slots over the data axis.
    local = ranks[0][case]["local"]
    whole = want[0].shape
    if kind == "dense":
        assert local == (whole[0] // d, whole[1] // m, *whole[2:])
    else:
        assert local[2] == whole[1] // m


@pytest.mark.parametrize("case", CASES)
def test_jax_resumes_from_the_sharded_file(sides, case):
    kind, shape = case.split()
    got = _jax_resume(kind, sides["jcfg"], sides["jparams"], sides["tmp"] / f"sharded_{kind}_{shape}.npz",
                      sides["jax"][kind]["last"])
    assert got == sides["jax"][kind]["resumed"]


@pytest.mark.parametrize("case", CASES)
def test_jax_file_loads_into_the_sharded_engine_and_resumes(sides, case):
    kind = case.split()[0]
    want = sides["jax"][kind]["resumed"]
    assert len(want) == RESUME and len(set(map(tuple, want))) > 1
    for r in _ranks(sides, case):
        res = r[case]
        assert res["block of jax's file"] and res["carries its sharding"], f"rank {r['rank']}"
        assert res["resumed"] == res["resumed unsharded"] == want, f"rank {r['rank']}"
