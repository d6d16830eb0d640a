"""The eval step's pair pool (ops/pair_pool forward, K1) against its least
time on the traced requests' live pairs, in % of the roofline."""


def read(r):
    return r.stage_roofline("pair_pool_fwd")
