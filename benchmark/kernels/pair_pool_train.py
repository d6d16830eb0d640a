"""Least time of the train step's pair pools (K2: the forward with its
winner index, and the backward) of every view over its live pairs."""

from benchmark import work


def least_s(u, pk):
    if u["kind"] != "train":
        return None
    return sum(work.pair_pool_s(u, v, pk, index=True)
               + work.pair_pool_bwd_s(u, v, pk) for v in u["views"])
