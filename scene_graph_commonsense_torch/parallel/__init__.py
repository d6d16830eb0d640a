"""Data parallelism over torch.distributed (parallel/mesh.py) and the
launch of a group's processes on one host (parallel/launch.py)."""
