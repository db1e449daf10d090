"""Tensor parallelism over rank processes (``torch.distributed``):
``mesh.py`` (the rank processes, their groups and collectives) and
``tp.py`` (the sharding plan and the model's row-parallel sums)."""
