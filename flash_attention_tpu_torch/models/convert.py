"""Parameters and caches of the JAX package, as the port's.

``params_from_jax`` maps the JAX parameter tree (nested dicts and lists of
arrays, as the JAX package's ``init_model_params`` makes it, with its
quantized leaves) onto the same tree of torch tensors, so both packages
compute the same function in the parity tests; ``kv_cache_from_jax`` does the
same for a dense or paged KV cache. Both read the leaves through numpy and
import nothing of JAX: the JAX package's NamedTuples (``QuantizedTensor``,
``KVCache``, ``PagedKVCache``) are recognised by their fields.
"""

from __future__ import annotations

import numpy as np
import torch

from flash_attention_tpu_torch.models.attention import KVCache
from flash_attention_tpu_torch.ops.paged import PagedKVCache
from flash_attention_tpu_torch.ops.quant import QuantizedTensor

# numpy dtypes (ml_dtypes) that torch.from_numpy rejects, with the torch
# dtype their bytes are.
_BIT_VIEWS = {"float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2}


def _tensor(leaf, device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy rejects; widening to
        # float32 is exact, and the cast back restores the same bits.
        return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    if arr.dtype.name in _BIT_VIEWS:
        return torch.from_numpy(arr.view(np.uint8).copy()).view(_BIT_VIEWS[arr.dtype.name]).to(device)
    return torch.from_numpy(np.array(arr)).to(device)  # a writable copy


def _fields(tree) -> tuple:
    return getattr(type(tree), "_fields", ())


def params_from_jax(tree, *, device: str | torch.device = "cuda"):
    """The same tree with every array leaf as a torch tensor on ``device``
    (the card by default; the CPU parity tests pass ``device="cpu"``), and
    every quantized weight as the port's QuantizedTensor."""
    if _fields(tree) == ("values", "scales"):
        return QuantizedTensor(_tensor(tree.values, device), _tensor(tree.scales, device))
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device=device) for v in tree]
    return _tensor(tree, device)


def kv_cache_from_jax(cache, *, device: str | torch.device = "cuda"):
    """A JAX ``KVCache`` (k, v, k_scales, v_scales, lengths) or
    ``PagedKVCache`` (k_pages, v_pages, page_table, lengths, k_scales,
    v_scales) as the port's, payload and scales with the same bits. Paged
    scales drop the JAX package's size-1 lane axis: [P, Hkv, 1, page] ->
    [P, Hkv, page], the same memory order. A rolling (ring) cache comes
    across as it is: its rows in ring order and lengths that count every
    position written, past the ring's rows; the ring's layout (window,
    sinks) lives in the AttentionConfig both packages share, and a paged
    ring's in its page table."""

    def get(name):
        x = getattr(cache, name)
        return None if x is None else _tensor(x, device)

    if "k_pages" in _fields(cache):
        scales = [get(n) for n in ("k_scales", "v_scales")]
        scales = [None if s is None else s.reshape(s.shape[0], s.shape[1], s.shape[3]) for s in scales]
        return PagedKVCache(get("k_pages"), get("v_pages"), get("page_table"), get("lengths"), *scales)
    return KVCache(get("k"), get("v"), get("lengths"), get("k_scales"), get("v_scales"))
