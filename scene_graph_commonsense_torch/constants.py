"""Label-space tables that PredCLS evaluation and serving need.

A subset of scene_graph_commonsense_tpu/constants.py, copied so that the port
imports nothing of the JAX package (reference dataset_utils.py:586-644,
utils.py:270-274, 355-373).
"""

from __future__ import annotations

import numpy as np

# Visual Genome objects (150 classes, ordered by training-set frequency).
# reference dataset_utils.py:586-601
VG_OBJECTS = (
    "tree", "man", "window", "shirt", "building", "person", "sign", "leg",
    "head", "pole", "table", "woman", "hair", "hand", "car", "door", "leaf",
    "light", "pant", "fence", "ear", "shoe", "chair", "people", "plate",
    "arm", "glass", "jacket", "street", "sidewalk", "snow", "tail", "face",
    "wheel", "handle", "flower", "hat", "rock", "boy", "tile", "short",
    "bag", "roof", "letter", "girl", "umbrella", "helmet", "bottle",
    "branch", "tire", "plant", "train", "track", "nose", "boat", "post",
    "bench", "shelf", "wave", "box", "food", "pillow", "jean", "bus",
    "bowl", "eye", "trunk", "horse", "clock", "counter", "neck", "elephant",
    "giraffe", "mountain", "board", "house", "cabinet", "banana", "paper",
    "hill", "logo", "dog", "wing", "book", "bike", "coat", "seat", "truck",
    "glove", "zebra", "bird", "cup", "plane", "cap", "lamp", "motorcycle",
    "cow", "skateboard", "wire", "surfboard", "beach", "mouth", "sheep",
    "kite", "sink", "cat", "pizza", "bed", "animal", "ski", "curtain",
    "bear", "sock", "player", "flag", "finger", "windshield", "towel",
    "desk", "number", "railing", "lady", "stand", "vehicle", "child",
    "boot", "tower", "basket", "laptop", "engine", "vase", "toilet",
    "drawer", "racket", "tie", "pot", "paw", "airplane", "fork", "screen",
    "room", "guy", "orange", "phone", "fruit", "vegetable", "sneaker",
    "skier", "kid", "men",
)

# 50 predicates in the Motif super-category blocks
# geometric(15) | possessive(11) | semantic(24).
# reference dataset_utils.py:639-644
VG_RELATIONS_BY_SUPER = (
    "above", "across", "against", "along", "and", "at", "behind", "between",
    "in", "in front of", "near", "on", "on back of", "over", "under",
    "belonging to", "for", "from", "has", "made of", "of", "part of", "to",
    "wearing", "wears", "with", "attached to", "carrying", "covered in",
    "covering", "eating", "flying in", "growing on", "hanging from",
    "holding", "laying on", "looking at", "lying on", "mounted on",
    "painted on", "parked on", "playing", "riding", "says", "sitting on",
    "standing on", "using", "walking in", "walking on", "watching",
)

# OIv6 per-class weights for the weighted mAP (reference utils.py:270-274).
OIV6_WMAP_WEIGHT = np.array(
    [1974, 120, 27, 2, 284, 571, 2059, 8, 26, 2, 0, 163, 25, 30, 2, 0, 0,
     1, 0, 17, 0, 29, 14, 4, 3, 0, 6, 0, 67, 5], dtype=np.int64) + 1

# SGDET/SGCLS object-category equivalence for label matching.
# reference utils.py:355-373
OBJ_EQUIV_GROUPS = (
    (1, 5, 11, 23, 38, 44, 121, 124, 148, 149),   # person-like
    (0, 50),                                      # tree / plant
    (92, 137),                                    # plane / airplane
)
OBJ_EQUIV_UNSYMMETRIC = {
    123: (14, 63, 95, 87, 123),                           # vehicle
    108: (89, 102, 67, 72, 71, 81, 96, 105, 90, 111, 108),  # animal
    60: (145, 106, 142, 144, 77, 60),                     # food
}


def object_equivalence_matrix(num_classes: int = 150) -> np.ndarray:
    """Dense (C, C) bool matrix: equiv[p, t] == compare_object_cat(p, t)
    (reference utils.py:355-373), for vectorized SGDET/SGCLS label matching."""
    eq = np.eye(num_classes, dtype=bool)
    for group in OBJ_EQUIV_GROUPS:
        g = np.array(group)
        eq[np.ix_(g, g)] = True
    for key, members in OBJ_EQUIV_UNSYMMETRIC.items():
        m = np.array(members)
        eq[key, m] = True
        eq[m, key] = True
    return eq
