"""Least time of the eval forward pair pool (K1) of one request over its
live pairs."""

from benchmark import work


def least_s(u, pk):
    if u["kind"] != "serve":
        return None
    return sum(work.pair_pool_s(u, v, pk, index=False) for v in u["views"])
