"""Sharding over a torch.distributed process group (parallel/mesh.py)."""
