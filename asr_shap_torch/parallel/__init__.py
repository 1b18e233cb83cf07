"""Scale-out over ``torch.distributed``: the process mesh (``mesh.py``) and
Megatron-style tensor parallelism (``tp.py``)."""
