"""KV-cache checkpoint / resume: save a cache to one file and restore it.

Counterpart of the JAX package's ``utils/checkpoint.py``, in its file
format, so each package loads the other's checkpoints:

  * one ``.npz`` (zip) file; member ``__meta__`` holds a JSON header with a
    format version and each leaf's logical dtype name and shape, and member
    ``leaf_<i>`` holds leaf i's raw bytes as uint8, so bf16 and fp8
    payloads survive numpy serialisation bit for bit;
  * the leaves are the JAX package's ``tree_leaves`` of the same cache, in
    its order, with absent (None) leaves dropped: a dense ``KVCache`` is
    (k, v, k_scales, v_scales, lengths), where the port's tuple keeps the
    lengths third; a paged ``PagedKVCache`` is (k_pages, v_pages,
    page_table, lengths, k_scales, v_scales) with scales recorded in the
    JAX package's [pages, kv_heads, 1, page_size] shape (the port keeps
    [pages, kv_heads, page_size], the same bytes); a ``PagedModelCache``
    (one pool for all layers) is written as its ``.layers()``, JAX's list
    of one PagedKVCache a layer, and read back into the pool;
  * ``load_kv_cache`` restores into the structure of a template cache and
    checks the version, the leaf count and every leaf's shape and dtype, so
    a checkpoint of another configuration fails loudly;
  * the file is written beside its path and renamed into place, so a
    reader never sees a partial one;
  * a tensor-parallel engine's caches (this rank's block, carrying the
    ``make_cache_sharding`` callable: ``parallel.sharding.with_sharding``)
    are the GLOBAL caches in the file, as JAX's ``device_get`` gathers its
    global arrays: every rank of the mesh calls ``save_kv_cache``, the
    blocks are gathered over the mesh, the mesh's first rank writes and the
    others wait for it; ``load_kv_cache`` into such a template reads the
    global leaves and gives each rank its block.

The dtype names are mapped here (``DTYPE_NAMES``), without ``ml_dtypes``.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch
import torch.distributed as dist

from flash_attention_tpu_torch.models.attention import KVCache
from flash_attention_tpu_torch.ops.paged import PagedKVCache, PagedModelCache
from flash_attention_tpu_torch.parallel.mesh import barrier
from flash_attention_tpu_torch.parallel.sharding import with_sharding

FORMAT_VERSION = 1
DTYPE_NAMES = {
    torch.bfloat16: "bfloat16", torch.float16: "float16", torch.float32: "float32",
    torch.float8_e4m3fn: "float8_e4m3fn", torch.float8_e5m2: "float8_e5m2",
    torch.int8: "int8", torch.int32: "int32",
}
_DTYPES = {name: dtype for dtype, name in DTYPE_NAMES.items()}


def _paged_leaves(c: PagedKVCache) -> list:
    scales = [None if s is None else s.unsqueeze(2) for s in (c.k_scales, c.v_scales)]
    return [c.k_pages, c.v_pages, c.page_table, c.lengths, *scales]


def _leaves(cache) -> list[torch.Tensor]:
    """The cache's tensors in the JAX package's leaf order (see the module
    docstring), None leaves dropped."""
    if isinstance(cache, KVCache):
        leaves = [cache.k, cache.v, cache.k_scales, cache.v_scales, cache.lengths]
    elif isinstance(cache, PagedModelCache):
        leaves = [t for layer in cache.layers() for t in _paged_leaves(layer)]
    elif isinstance(cache, PagedKVCache):
        leaves = _paged_leaves(cache)
    elif isinstance(cache, (list, tuple)):
        return [t for sub in cache for t in _leaves(sub)]
    elif isinstance(cache, torch.Tensor):
        return [cache]
    elif cache is None:
        return []
    else:
        raise TypeError(f"not a cache tree of tensors: {type(cache).__name__}")
    return [t for t in leaves if t is not None]


def _rebuild(template, leaves):
    """``template``'s structure over the tensors of the iterator ``leaves``
    (in ``_leaves``' order)."""
    if isinstance(template, KVCache):
        k, v = next(leaves), next(leaves)
        k_s, v_s = (next(leaves), next(leaves)) if template.quantized() else (None, None)
        return KVCache(k, v, next(leaves), k_s, v_s)
    if isinstance(template, PagedModelCache):
        layers = [_rebuild(layer, leaves) for layer in template.layers()]
        for name in ("page_table", "lengths"):
            if any(not torch.equal(getattr(x, name), getattr(layers[0], name)) for x in layers[1:]):
                raise ValueError(f"the checkpoint's layers hold different {name}s; a PagedModelCache shares one")
        pools = [None if getattr(layers[0], name) is None else torch.stack([getattr(x, name) for x in layers])
                 for name in ("k_pages", "v_pages", "k_scales", "v_scales")]
        return PagedModelCache(*pools[:2], layers[0].page_table, layers[0].lengths, *pools[2:])
    if isinstance(template, PagedKVCache):
        k, v, table, lengths = (next(leaves) for _ in range(4))
        scales = [next(leaves).squeeze(2), next(leaves).squeeze(2)] if template.quantized() else [None, None]
        return PagedKVCache(k, v, table, lengths, *scales)
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(sub, leaves) for sub in template)
    return None if template is None else next(leaves)


def _dtype_name(t: torch.Tensor) -> str:
    if t.dtype not in DTYPE_NAMES:
        raise ValueError(f"a checkpoint leaf is one of {sorted(DTYPE_NAMES.values())}, got {t.dtype}")
    return DTYPE_NAMES[t.dtype]


def save_kv_cache(path, cache) -> None:
    """Write ``cache`` to ``path`` (.npz) in the JAX package's format.

    ``cache``: a ``KVCache``, ``PagedKVCache`` or ``PagedModelCache``, a list
    or tuple of them (an engine's per-layer caches), or tensors, on any
    device. A tensor-parallel engine's caches are written whole: every rank
    of their mesh calls this (see the module docstring).
    """
    path = pathlib.Path(path)
    sharding = getattr(cache, "sharding", None)
    if sharding is not None:
        mesh = sharding.mesh
        cache = sharding.gather(cache)
        if dist.get_rank() != int(mesh.mesh.min()):
            barrier(mesh)  # returns once the writer has published the file
            return
    host = [t.detach().contiguous().cpu() for t in _leaves(cache)]
    meta = {
        "version": FORMAT_VERSION,
        "leaves": [{"dtype": _dtype_name(t), "shape": list(t.shape)} for t in host],
    }
    arrays = {f"leaf_{i}": t.view(torch.uint8).reshape(-1).numpy() for i, t in enumerate(host)}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    tmp.replace(path)  # atomic publish
    if sharding is not None:
        barrier(mesh)


def load_kv_cache(path, template, *, device_put: bool = True):
    """Restore a cache written by ``save_kv_cache`` (or by the JAX package's)
    into ``template``'s structure.

    Args:
      path: the ``.npz`` file.
      template: a cache of the same structure, shapes and dtypes as the one
        saved (e.g. a fresh ``init_kv_cache`` / ``init_caches`` /
        ``init_paged_caches`` of the same config); only its structure,
        shapes, dtypes and devices are read. A tensor-parallel engine's
        caches take the global caches' file and give this rank its block.
      device_put: put each restored leaf on its template leaf's device
        (False keeps them on the CPU).

    Returns:
      A cache of the template's type holding the checkpoint's values (a
      sharded template's block, carrying its sharding).

    Raises:
      ValueError: version, leaf count, shape or dtype mismatch.
    """
    sharding = getattr(template, "sharding", None)
    if sharding is not None:
        whole = load_kv_cache(path, sharding.global_shapes(template), device_put=False)
        block = _leaves(sharding(whole))
        out = (b.to(t.device) if device_put else b for b, t in zip(block, _leaves(template)))
        return with_sharding(_rebuild(template, out), sharding)
    path = pathlib.Path(path)
    t_leaves = _leaves(template)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        if meta.get("version") != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {meta.get('version')!r}")
        recs = meta["leaves"]
        if len(recs) != len(t_leaves):
            raise ValueError(
                f"checkpoint has {len(recs)} leaves, template has {len(t_leaves)} — different cache structure/config"
            )
        out = []
        for i, (rec, t) in enumerate(zip(recs, t_leaves)):
            want_dtype, want_shape = _DTYPES.get(rec["dtype"]), tuple(rec["shape"])
            if want_shape != tuple(t.shape) or want_dtype != t.dtype:
                raise ValueError(
                    f"leaf {i}: checkpoint {rec['dtype']}{list(want_shape)} vs template "
                    f"{DTYPE_NAMES.get(t.dtype, t.dtype)}{list(t.shape)} — config mismatch"
                )
            raw = torch.from_numpy(np.ascontiguousarray(z[f"leaf_{i}"]))
            leaf = raw.view(want_dtype).reshape(want_shape)
            out.append(leaf.to(t.device) if device_put else leaf)
    return _rebuild(template, iter(out))
