"""The DETR trunk's kernels (ops/stem, ops/bottleneck: K3-K6) against
their least time on the traced requests, in % of the roofline."""


def read(r):
    return r.stage_roofline("trunk")
