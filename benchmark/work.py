"""Live work: the operations and bytes that a cell's inputs need, from their
shapes and their valid objects and pairs, never from the program's buffer
capacities.

A unit is one train step of one rank or one served request, described by
`train_unit` / `serve_unit`.  Operations are counted 2 per multiply-add;
a backward is counted as twice its forward (the input and the weight
gradients), as the port's bench.py counts it.  Layers that run per pair
count the live pairs (the valid directed pairs that fit the buffer, and
for the augmented view the connected ones), per-object layers the valid
objects, per-image layers the images; the trunk and the encoder count the
ResNet-101 and the encoder layers at the image size.  Padding slots count
nothing, so a program that stops computing them still reads at most 100%.

The least time of a kernel stage (benchmark/kernels/<stage>.py) is the sum
over its launches of the larger of bytes / HBM bandwidth and operations /
the peak rate of their type: each input byte read once, each output byte
written once.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BF16 = 2


def peaks() -> Dict[str, float]:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)


def least_s(nbytes: float, ops: float, rate: float,
            pk: Dict[str, float]) -> float:
    """The larger of the memory time and the operation time."""
    return max(nbytes / pk["hbm_bytes_per_s"], ops / rate)


def _pairs(ok: np.ndarray, capacity: int) -> np.ndarray:
    return np.argwhere(ok)[:capacity]


def _touched(pairs: np.ndarray, n: int) -> int:
    """Distinct subject rows plus distinct object rows the pairs read."""
    if len(pairs) == 0:
        return 0
    flat_s = pairs[:, 0] * n + pairs[:, 1]
    flat_o = pairs[:, 0] * n + pairs[:, 2]
    return len(np.unique(flat_s)) + len(np.unique(flat_o))


def _valid_pairs(valid: np.ndarray) -> np.ndarray:
    v = np.asarray(valid, bool)
    return v[:, :, None] & v[:, None, :] & ~np.eye(v.shape[1], dtype=bool)


def head_dims(conf: Dict) -> Dict:
    m = conf["model"]
    return {"S": m["feature_size"], "C": m["num_img_feature"] + 1,
            "h": m["hidden_dim"],
            "K": m["num_super_classes"] if conf["use_super"] else 0,
            "R": m["num_relations"]}


def train_unit(conf: Dict, batch: Dict, capacity: int,
               aug_capacity: int) -> Dict:
    """One rank's train step on `batch` (numpy): its views, each with its
    images, valid objects, live pairs and the stream rows they touch."""
    ok = _valid_pairs(batch["valid"])
    n = batch["valid"].shape[1]
    objects = int(np.asarray(batch["valid"]).sum())
    images = batch["valid"].shape[0]
    main = _pairs(ok, capacity)
    views = [{"images": images, "objects": objects, "pairs": len(main),
              "touched": _touched(main, n)}]
    if "features_aug" in batch:
        conn = _pairs(ok & (np.asarray(batch["rel"]) >= 0), aug_capacity)
        views.append({"images": images, "objects": objects,
                      "pairs": len(conn), "touched": _touched(conn, n)})
    return {"kind": "train", **head_dims(conf), "views": views}


def serve_unit(conf: Dict, request: Dict) -> Dict:
    """One PredCLS request: the images through the trunk and the encoder,
    then the eval forward over every valid pair."""
    m = conf["model"]
    ok = _valid_pairs(request["valid"])
    n = request["valid"].shape[1]
    pairs = np.argwhere(ok)
    b = request["valid"].shape[0]
    return {"kind": "serve", **head_dims(conf), "B": b,
            "side": m["image_size"], "blocks": list(m["detr_blocks"]),
            "layers": m["detr_enc_layers"], "D": m["detr_d_model"],
            "F": m["detr_ffn"],
            "views": [{"images": b,
                       "objects": int(np.asarray(request["valid"]).sum()),
                       "pairs": len(pairs), "touched": _touched(pairs, n)}]}


def view_forward_flops(u: Dict, v: Dict) -> float:
    """One view's forward (bench.py's count at live sizes): conv1 once per
    image and stream, conv2 once per valid object and stream, conv3, fc1,
    fc2 and the heads once per live pair."""
    s, c, h = u["S"], u["C"], u["h"]
    conv1 = 2 * v["images"] * s * s * c * h * 2
    conv2 = 2 * v["objects"] * s * s * 9 * h * 4 * h * 2
    conv3 = v["pairs"] * (s // 2) ** 2 * 9 * 4 * h * 8 * h * 2
    fc1 = v["pairs"] * 8 * h * (s // 4) ** 2 * 4096 * 2
    heads = u["R"] + 1 + 3
    fc2 = v["pairs"] * (4096 + 2 * u["K"] + heads) * 512 * 2
    return float(conv1 + conv2 + conv3 + fc1 + fc2)


def train_step_flops(u: Dict) -> float:
    """Forward of every view, x 3 for the backward."""
    return 3 * sum(view_forward_flops(u, v) for v in u["views"])


def trunk_blocks(u: Dict) -> List[Dict]:
    """Each ResNet-101 bottleneck's input and output sizes at the image
    size: b, h, w (input), ho, wo, c (in), m (width), co, projection."""
    b, side = u["B"], u["side"]
    hw = side // 4
    c = 64
    out = []
    for stage, (m, n) in enumerate(zip((64, 128, 256, 512), u["blocks"])):
        for i in range(n):
            s = 2 if i == 0 and stage > 0 else 1
            out.append({"b": b, "h": hw, "w": hw, "ho": hw // s,
                        "wo": hw // s, "c": c, "m": m, "co": 4 * m,
                        "proj": i == 0})
            hw //= s
            c = 4 * m
    return out


def bottleneck_flops(k: Dict) -> float:
    p_in, p_out = k["b"] * k["h"] * k["w"], k["b"] * k["ho"] * k["wo"]
    m, c, co = k["m"], k["c"], k["co"]
    return 2.0 * (p_in * c * m + p_out * (9 * m * m + m * co
                                          + (c * co if k["proj"] else 0)))


def stem_flops(u: Dict) -> float:
    return 2.0 * u["B"] * (u["side"] // 2) ** 2 * 147 * 64


def encoder_layer_flops(u: Dict) -> Dict[str, float]:
    """Per encoder layer: the four projections, the attention products,
    the FFN."""
    b, d, f = u["B"], u["D"], u["F"]
    length = (u["side"] // 32) ** 2
    return {"projections": 4 * 2.0 * b * length * d * d,
            "attention": 4.0 * b * length * length * d,
            "ffn": 4.0 * b * length * d * f}


def serve_flops(u: Dict) -> float:
    """Trunk, input_proj, encoder and the eval forward of one request."""
    length = (u["side"] // 32) ** 2
    enc = sum(encoder_layer_flops(u).values()) * u["layers"]
    return (stem_flops(u) + sum(bottleneck_flops(k) for k in trunk_blocks(u))
            + 2.0 * u["B"] * length * 2048 * u["D"] + enc
            + view_forward_flops(u, u["views"][0]))


def pair_pool_s(u: Dict, v: Dict, pk: Dict, index: bool) -> float:
    """relu(maxpool2(a[sub] + b[obj])) over a view's live pairs: the
    output (and with `index` its int8 winner index) written once, each
    touched stream row and the indices read once; 8 float32 operations per
    output element, 11 with the index."""
    s, c4 = u["S"], 4 * u["h"]
    out = v["pairs"] * (s // 2) ** 2 * c4
    nbytes = out * BF16 + (out if index else 0) \
        + v["touched"] * s * s * c4 * BF16 + v["pairs"] * 2 * 4
    return least_s(nbytes, (11 if index else 8) * out, pk["fp32_flops"], pk)


def pair_pool_bwd_s(u: Dict, v: Dict, pk: Dict) -> float:
    """The pair pool's backward over a view's live pairs: g and the index
    read once, the gradients of the valid objects' rows of both streams
    written once; 4 float32 operations per g element."""
    s, c4 = u["S"], 4 * u["h"]
    g = v["pairs"] * (s // 2) ** 2 * c4
    nbytes = g * BF16 + g + 2 * v["objects"] * s * s * c4 * BF16 \
        + v["pairs"] * 2 * 4
    return least_s(nbytes, 4 * g, pk["fp32_flops"], pk)
