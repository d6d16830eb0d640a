"""The live-work counts behind mfu.* and *_roofline: hand-worked shapes,
ResNet-101's published size, and padding that counts nothing."""

import numpy as np
import pytest

from benchmark import harness, work
from benchmark.tests import tiny

PK = {"bf16_tensor_flops": 989e12, "fp32_flops": 67e12,
      "hbm_bytes_per_s": 3.35e12}


def tiny_unit(pairs=2, objects=2, images=1):
    return {"kind": "train", "S": 8, "C": 17, "h": 2, "K": 3,
            "R": 5, "views": [{"images": images, "objects": objects,
                               "pairs": pairs, "touched": 2}]}


def test_view_forward_by_hand():
    # conv1 2*1*64*17*2*2, conv2 2*2*64*9*2*8*2, conv3 2*16*9*8*16*2,
    # fc1 2*16*4*4096*2, fc2 and heads 2*(4096+2*3+5+1+3)*512*2
    want = 8704 + 73728 + 73728 + 1048576 + 8419328
    u = tiny_unit()
    assert work.view_forward_flops(u, u["views"][0]) == want
    assert work.train_step_flops(u) == 3 * want


def test_padding_counts_nothing():
    conf = tiny.conf("vg-hiercom")
    batch = {"valid": np.zeros((2, 6), bool), "rel": np.full((2, 6, 6), -1),
             "features_aug": None}
    batch["valid"][0, :3] = True                  # 6 live pairs of 60
    batch["rel"][0, 0, 1] = 4
    u = work.train_unit(conf, batch, capacity=40, aug_capacity=10)
    assert [v["pairs"] for v in u["views"]] == [6, 1]
    assert [v["objects"] for v in u["views"]] == [3, 3]
    full = {**u, "views": [{**v, "pairs": 40} for v in u["views"]]}
    flops = harness.driver("train").unit_flops
    assert flops(u) < flops(full)
    assert work.pair_pool_s(u, u["views"][0], PK, True) \
        < work.pair_pool_s(full, full["views"][0], PK, True)


def test_capacity_truncates_live_pairs():
    conf = tiny.conf("vg-hiercom")
    batch = {"valid": np.ones((2, 6), bool), "rel": np.full((2, 6, 6), -1)}
    u = work.train_unit(conf, batch, capacity=40, aug_capacity=10)
    assert u["views"][0]["pairs"] == 40            # 60 valid, 40 fit
    assert len(u["views"]) == 1                    # no augmented view


def test_resnet101_matches_its_published_size():
    # torchvision's ResNet-101 at 224^2: 7.83 G multiply-adds, ~2 M of them
    # in the classifier this trunk does not have
    u = {"B": 1, "side": 224, "blocks": [3, 4, 23, 3]}
    flops = work.stem_flops(u) + sum(work.bottleneck_flops(k)
                                     for k in work.trunk_blocks(u))
    assert flops / 2 == pytest.approx(7.83e9, rel=0.02)
    blocks = work.trunk_blocks({"B": 12, "side": 1024,
                                "blocks": [3, 4, 23, 3]})
    assert len(blocks) == 33
    assert (blocks[0]["h"], blocks[0]["c"], blocks[0]["co"]) == (256, 64, 256)
    assert (blocks[-1]["ho"], blocks[-1]["co"]) == (32, 2048)


def test_bottleneck_by_hand():
    k = {"b": 1, "h": 8, "w": 8, "ho": 4, "wo": 4, "c": 16, "m": 4,
         "co": 16, "proj": True}
    # conv1 on 64 input pixels, conv2, conv3 and the projection on 16
    assert work.bottleneck_flops(k) == 2 * (64 * 16 * 4 + 16 * (
        9 * 16 + 4 * 16 + 16 * 16))


def test_pair_pool_by_hand():
    u = {"S": 32, "h": 128}
    v = {"pairs": 10, "touched": 4, "objects": 3}
    out = 10 * 16 * 16 * 512
    nbytes = out * 2 + 4 * 32 * 32 * 512 * 2 + 10 * 2 * 4
    assert work.pair_pool_s(u, v, PK, index=False) == pytest.approx(
        max(nbytes / 3.35e12, 8 * out / 67e12))
    g_bytes = out * 2 + out + 2 * 3 * 32 * 32 * 512 * 2 + 10 * 2 * 4
    assert work.pair_pool_bwd_s(u, v, PK) == pytest.approx(
        max(g_bytes / 3.35e12, 4 * out / 67e12))


def test_encoder_by_hand():
    u = {"B": 2, "side": 64, "D": 8, "F": 16}
    f = work.encoder_layer_flops(u)        # 4 tokens an image
    assert f == {"projections": 4 * 2.0 * 2 * 4 * 8 * 8,
                 "attention": 4.0 * 2 * 16 * 8, "ffn": 4.0 * 2 * 4 * 8 * 16}


def test_stage_bounds_follow_the_unit_kind():
    stages = harness.stages()
    u = tiny_unit()
    assert stages["pair_pool_train"]["least_s"](u, PK) > 0
    for name in ("trunk", "encoder", "pair_pool_fwd"):
        assert stages[name]["least_s"](u, PK) is None
