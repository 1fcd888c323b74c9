"""Multi-rank attention on torch.distributed: the (data, model, context)
mesh and its collectives (mesh.py), head / batch / context sharding
(sharding.py), tensor-parallel serving (sharding.py's
``shard_model_params`` and ``make_cache_sharding``, the engines'
``shard_caches``) and ring attention with its backward (ring.py)."""

from flash_attention_tpu_torch.parallel.mesh import auto_mesh, make_mesh
from flash_attention_tpu_torch.parallel.sharding import make_cache_sharding, shard_model_params

__all__ = ["make_mesh", "auto_mesh", "shard_model_params", "make_cache_sharding"]
