"""The encoder's kernels (ops/attention, ops/ffn: K7, K8) against their
least time on the traced requests, in % of the roofline."""


def read(r):
    return r.stage_roofline("encoder")
