"""Data and tensor parallelism over torch.distributed (parallel/mesh.py,
parallel/tp.py) and the launch of a group's processes on one host
(parallel/launch.py)."""
