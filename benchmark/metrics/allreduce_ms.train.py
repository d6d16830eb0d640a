"""Device milliseconds of the NCCL kernels (parallel/mesh: the gradient
and metric all-reduce) per step and card, from the profiled window."""


def read(r):
    if r.profile is None or not r.traced_units:
        return None
    nccl = sum(t for name, t in r.profile["kernels"].items()
               if "nccl" in name.lower())
    return 1e3 * nccl / len(r.traced_units) if nccl > 0 else None
