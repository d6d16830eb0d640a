"""The pair pool's train kernels (ops/pair_pool: the forward with its
winner index and the backward, K2) against their least time on the traced
steps' live pairs, in % of the roofline."""


def read(r):
    return r.stage_roofline("pair_pool_train")
