"""flash_attention_tpu_torch — the PyTorch and CUDA port of the JAX package.

The JAX package ``flash_attention_tpu`` is the reference; this package mirrors
its layout so each module's counterpart is found by name:

  ops/       attention ops: a hand-written CUDA kernel per op (csrc/) beside
             its plain PyTorch version, plus the fp32 oracle
  models/    RoPE, the GQA attention layer with its KV cache, the transformer
  serving/   continuous-batching engine, sampling, scheduler wrapper
  native/    the C++ scheduler, allocator and oracle sources and their
             ctypes loader
  parallel/  the (data, model, context) mesh on torch.distributed, head /
             batch / context sharding, ring attention with its backward
  utils/     seeded inputs, the oracle-diff harness, KV-cache checkpoints
             and the multi-process failure policy

Public layouts follow the JAX package: attention tensors are [B, H, S, D],
caches [B, Hkv, max_seq, D], decode queries [B, Hq, D]. Importing the package
builds nothing: a kernel is compiled with nvcc on its first CUDA launch. The
top level exports the names of the JAX package's ``__all__`` that are ported,
with the JAX package's keywords, and the port's tensor-parallel serving
(``shard_model_params``, ``make_cache_sharding``: the ``shard_caches`` both
engines take), which JAX gets from GSPMD without a name of its own.
"""

from flash_attention_tpu_torch.ops.decode import decode_attention, decode_attention_split
from flash_attention_tpu_torch.ops.flash_attention import flash_attention
from flash_attention_tpu_torch.ops.merge import merge_partial_attention, merge_two
from flash_attention_tpu_torch.ops.quant import QuantizedTensor, quantize_kv, quantize_weight
from flash_attention_tpu_torch.ops.reference import reference_attention
from flash_attention_tpu_torch.parallel.sharding import make_cache_sharding, shard_model_params
from flash_attention_tpu_torch.utils.checkpoint import load_kv_cache, save_kv_cache
from flash_attention_tpu_torch.utils.distributed import StepWatchdog, fail_fast, initialize_distributed

__all__ = [
    "reference_attention",
    "flash_attention",
    "decode_attention",
    "decode_attention_split",
    "quantize_weight",
    "merge_partial_attention",
    "merge_two",
    "QuantizedTensor",
    "quantize_kv",
    "save_kv_cache",
    "load_kv_cache",
    "initialize_distributed",
    "fail_fast",
    "StepWatchdog",
    "shard_model_params",
    "make_cache_sharding",
]
