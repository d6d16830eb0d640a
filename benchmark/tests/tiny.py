"""Tiny versions of the cells for the CPU tests: the configurations and
traffic of BENCHMARK.json cut to shapes a CPU test can hold, and a run of a
cell's driver on the CPU, past the harness's look for a card."""

import copy

import torch

from benchmark import harness
from benchmark.run import Ctx


def conf(name: str, serve: bool = False, dtype: str = "bfloat16") -> dict:
    c = copy.deepcopy(harness.config(name))
    c["model"].update(hidden_dim=8, feature_size=8 if serve else 16,
                      num_img_feature=256 if serve else 16,
                      compute_dtype=dtype, image_size=256,
                      detr_blocks=[1, 2, 1, 1], detr_enc_layers=1)
    c["data"]["max_objects"] = 6
    c["training"].update(pair_capacity=40, aug_pair_capacity=10)
    return c


def traffic(name: str) -> dict:
    t = copy.deepcopy(harness.traffic(name))
    if t["mode"] == "train":
        t.update(images_per_rank=4, pool_batches=3, mean_objects=4.0)
    else:
        t.update(images=3, pool_requests=2, mean_objects=4.0,
                 check_requests=2, top_k=10)
    return t


def cell(name: str, dtype: str = "bfloat16"):
    """(conf, traffic) of a BENCHMARK.json cell at the tiny size."""
    c = harness.cell(name)
    tr = traffic(c["traffic"])
    return conf(c["config"], tr["mode"] == "serve", dtype), tr


def run(name: str, seed: int = 2 ** 31 + 11, dtype: str = "bfloat16",
        seconds: float = 0.5) -> dict:
    """One run of the cell's driver on the CPU: its record, its numbers."""
    c, tr = cell(name, dtype)
    ctx = Ctx(c, tr, 1, seed, seconds, 0, torch.device("cpu"))
    return harness.driver(tr["mode"]).run(ctx)
