"""Parameters of the JAX package, as the port's parameters.

``params_from_jax`` maps the JAX parameter tree (nested dicts and lists of
arrays, as ``flash_attention_tpu.models.transformer.init_model_params``
makes it) onto the same tree of torch tensors, so both packages compute the
same function in the parity tests. It reads the leaves through numpy and
imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(leaf, device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy rejects; widening to
        # float32 is exact, and the cast back restores the same bits.
        return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)  # a writable copy


def params_from_jax(tree, *, device: str | torch.device = "cuda"):
    """The same tree with every array leaf as a torch tensor on ``device``
    (the card by default; the CPU parity tests pass ``device="cpu"``)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device=device) for v in tree]
    return _tensor(tree, device)
