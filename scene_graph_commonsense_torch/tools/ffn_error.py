"""Measures the bf16 FFN + LayerNorm kernel's error (csrc/ffn.cu,
ffn_ln_hopper) against a float64 truth beside its plain version's, over the
shapes of tests/test_torch_ffn_cuda.py: the ratio its tests and
chip_smoke.py hold at F = 2048, and what it is at small F:

    python -m scene_graph_commonsense_torch.tools.ffn_error

The inputs are the tests' (seeded numpy: x ~ N(0, 1), W1 ~ N(0, 1/D), W2 ~
N(0, 1/F), biases ~ N(0, 1)); the truth has the kernel's roundings (x and
h to bf16, bf16 weights) and exact sums.  Prints one JSON line per shape
(the largest error of each version and their ratio), then the card's name
and power limit.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from scene_graph_commonsense_torch import bench
from scene_graph_commonsense_torch.ops import ffn

SHAPES = ((80, 128), (512, 2048), (2048, 64), (4096, 192), (4096, 320),
          (12288, 2048), (12288 + 64 + 7, 2048), (24576, 2048))


def inputs(n, f, dev, seed=0):
    rng = np.random.default_rng(seed)
    d = ffn.MODEL_DIM
    arrays = (rng.standard_normal((n, d)),
              rng.standard_normal((d, f)) / np.sqrt(d), rng.standard_normal(f),
              rng.standard_normal((f, d)) / np.sqrt(f), rng.standard_normal(d),
              1 + 0.1 * rng.standard_normal(d), 0.1 * rng.standard_normal(d))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrays]


def truth(x, w1, b1, w2, b2, g, beta, cd):
    f64 = torch.float64
    h = torch.relu(x.to(cd).to(f64) @ w1.to(cd).to(f64) + b1.to(f64))
    y = h.to(cd).to(f64) @ w2.to(cd).to(f64) + b2.to(f64) + x.to(f64)
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    return (y - mu) / torch.sqrt(var + 1e-5) * g.to(f64) + beta.to(f64)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ffn_error needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, cd = torch.device("cuda"), torch.bfloat16
    for n, f in SHAPES:
        x, w1, b1, w2, b2, g, beta = inputs(n, f, dev)
        args = (x, w1.to(cd), b1, w2.to(cd), b2, g, beta)
        got = ffn.ffn_ln_kernel(*args)
        want = ffn.ffn_ln_plain(*args, compute_dtype=cd)
        t = truth(x, w1, b1, w2, b2, g, beta, cd)
        err = (got.double() - t).abs().max().item()
        plain_err = (want.double() - t).abs().max().item()
        print(json.dumps({"n": n, "f": f, "err_vs_f64": err,
                          "plain_err_vs_f64": plain_err,
                          "ratio": err / plain_err}), flush=True)
    print(bench.card_name(), flush=True)


if __name__ == "__main__":
    main()
