"""Multi-rank attention on torch.distributed: the (data, model, context)
mesh and its collectives (mesh.py), head / batch / context sharding
(sharding.py) and ring attention with its backward (ring.py)."""
