"""Label-space tables that evaluation, serving, training and the detection
post-process need.

A subset of scene_graph_commonsense_tpu/constants.py, copied so that the port
imports nothing of the JAX package (reference dataset_utils.py:586-650,
606-614, 749-757, 764-787, utils.py:250-274, 355-373, train_test.py:105-106).
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

# 17 object super-classes.  reference dataset_utils.py:576-583
VG_OBJECT_SUPER_CLASSES = (
    "vehicle", "animal", "part", "person", "clothes", "food", "artifact",
    "location", "furniture", "flora", "building", "table", "structure",
    "door", "perosn", "laptop", "phone",
)

# 50 predicates ordered by training-set frequency.  reference
# dataset_utils.py:631-636
VG_RELATIONS_BY_FREQ = (
    "on", "has", "in", "of", "wearing", "near", "with", "above", "holding",
    "behind", "under", "sitting on", "wears", "standing on", "in front of",
    "attached to", "at", "hanging from", "over", "for", "riding", "carrying",
    "eating", "walking on", "playing", "covering", "laying on", "along",
    "watching", "and", "between", "belonging to", "painted on", "against",
    "looking at", "from", "parked on", "to", "made of", "covered in",
    "mounted on", "says", "part of", "across", "flying in", "using",
    "on back of", "lying on", "growing on", "walking in",
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

# Frequency-order -> Motif super-category-order predicate permutation
# (reference dataloader.py:144-146, dataset_utils.py:647-650).
REL_FREQ2SCAT = np.array(
    [11, 18, 8, 20, 23, 10, 25, 0, 34, 6, 14, 44, 24, 45, 9, 26, 5, 33, 13,
     16, 42, 27, 30, 48, 41, 29, 35, 3, 49, 4, 7, 15, 39, 2, 36, 17, 40, 22,
     19, 28, 38, 43, 21, 1, 31, 46, 12, 37, 32, 47, -1], dtype=np.int32)

# Alternative clustering permutations (frequency order -> cluster order).
# reference dataset_utils.py:764-787
REL_FREQ2GPT2 = np.array(
    [9, 10, 11, 12, 41, 13, 14, 15, 16, 17, 18, 42, 19, 0, 20, 21, 22, 43,
     23, 24, 25, 44, 26, 1, 27, 28, 45, 29, 30, 31, 32, 33, 2, 34, 3, 35,
     46, 36, 47, 48, 4, 37, 49, 38, 5, 39, 40, 6, 7, 8], dtype=np.int32)
REL_FREQ2BERT = np.array(
    [12, 13, 14, 15, 16, 17, 18, 19, 37, 0, 20, 38, 21, 39, 1, 2, 22, 3,
     23, 24, 25, 26, 40, 41, 27, 28, 42, 29, 43, 30, 31, 44, 4, 32, 45, 33,
     5, 34, 6, 7, 8, 35, 9, 10, 46, 36, 11, 47, 48, 49], dtype=np.int32)
REL_FREQ2CLIP = np.array(
    [42, 43, 44, 45, 0, 1, 2, 3, 4, 5, 6, 27, 7, 28, 29, 30, 46, 31,
     8, 47, 9, 10, 11, 12, 13, 14, 32, 15, 16, 48, 17, 33, 34, 18, 35, 19,
     36, 49, 20, 37, 38, 21, 22, 23, 39, 24, 40, 41, 25, 26], dtype=np.int32)

CLUSTER_INDEX_MAPS = {
    "motif": REL_FREQ2SCAT[:50],
    "gpt2": REL_FREQ2GPT2,
    "bert": REL_FREQ2BERT,
    "clip": REL_FREQ2CLIP,
}

# Training-sample count per predicate class, frequency order.
# reference utils.py:250-255
VG_REL_COUNTS_FREQ = np.array(
    [712432, 277943, 251756, 146339, 136099, 96589, 66425, 47342, 42722,
     41363, 22596, 18643, 15457, 14185, 13715, 10191, 9903, 9894, 9317,
     9145, 8856, 5213, 4688, 4613, 3810, 3806, 3739, 3624, 3490, 3477,
     3411, 3288, 3095, 3092, 3083, 2945, 2721, 2517, 2380, 2312, 2253,
     2241, 2065, 1996, 1973, 1925, 1914, 1869, 1853, 1740], dtype=np.int64)

# The same counts reordered into Motif super-category order, as the
# reference transcribed them (utils.py:258-265; see class_weights).
VG_REL_COUNTS_SCAT = np.array(
    [47342, 1996, 3092, 3624, 3477, 9903, 41363, 3411, 251756,
     13715, 96589, 712432, 1914, 9317, 22596, 3288, 9145, 2945,
     277943, 2312, 146339, 2065, 2517, 136099, 15457, 66425, 10191,
     5213, 2312, 3806, 4688, 1973, 1853, 9894, 42722, 3739,
     3083, 1869, 2253, 3095, 2721, 3810, 8856, 2241, 18643,
     14185, 1925, 1740, 4613, 3490], dtype=np.int64)

# OpenImages V6 (30 relations) and the permutation that orders them by
# super-category (data/oiv6.py applies it to the raw triplets).
# reference dataset_utils.py:749-757
OIV6_RELATIONS = (
    "at", "holds", "wears", "surf", "hang", "drink", "holding_hands", "on",
    "ride", "dance", "skateboard", "catch", "highfive", "inside_of", "eat",
    "cut", "contain", "handshake", "kiss", "talk_on_phone", "interacts_with",
    "under", "hug", "throw", "hits", "snowboard", "kick", "ski", "plays",
    "read",
)
OIV6_REORDER_BY_SUPER = np.array(
    [0, 6, 5, 7, 8, 9, 10, 1, 11, 12, 13, 14, 15, 2, 16, 17, 4, 18, 19, 20,
     21, 3, 22, 23, 24, 25, 26, 27, 28, 29], dtype=np.int32)

OIV6_REL_COUNTS = np.array(
    [150983, 7665, 841, 455, 9402, 52561, 145480, 157, 175, 77, 27, 4827,
     1146, 198, 77, 1, 12, 4, 43, 702, 8, 1111, 51, 43, 367, 10, 462, 11,
     2094, 114], dtype=np.int64)

# OIv6 per-class weights for the weighted mAP (reference utils.py:270-274).
OIV6_WMAP_WEIGHT = np.array(
    [1974, 120, 27, 2, 284, 571, 2059, 8, 26, 2, 0, 163, 25, 30, 2, 0, 0,
     1, 0, 17, 0, 29, 14, 4, 3, 0, 6, 0, 67, 5], dtype=np.int64) + 1

# DETR label remap.  The pretrained DETR-101 detector orders VG object
# classes alphabetically; the pipeline orders them by frequency (index 150,
# the no-object slot, maps to itself).  reference dataset_utils.py:606-614
OBJ_ALP2FRE = np.array(
    [137, 108, 25, 41, 77, 127, 100, 111, 107, 56, 84, 90, 74, 54, 83, 125,
     47, 64, 59, 38, 48, 4, 63, 76, 93, 14, 105, 22, 124, 68, 85, 69, 96,
     91, 110, 118, 81, 15, 132, 20, 71, 129, 65, 32, 19, 115, 114, 35, 60,
     138, 144, 72, 44, 26, 88, 141, 12, 13, 34, 36, 8, 46, 79, 67, 75, 27,
     62, 148, 103, 121, 94, 128, 16, 7, 43, 17, 80, 1, 149, 95, 73, 101,
     70, 53, 119, 142, 18, 78, 136, 23, 5, 143, 61, 106, 92, 50, 24, 113,
     9, 55, 135, 133, 120, 37, 42, 140, 139, 86, 102, 57, 3, 21, 40, 29, 6,
     104, 97, 109, 147, 146, 30, 112, 122, 28, 99, 10, 31, 134, 39, 49,
     131, 117, 126, 52, 51, 0, 87, 66, 45, 130, 145, 123, 58, 33, 2, 116,
     82, 98, 11, 89, 150], dtype=np.int32)

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


def rel_index_map(clustering: str) -> np.ndarray:
    """Frequency-order -> cluster-order predicate permutation (50,)."""
    return CLUSTER_INDEX_MAPS[clustering]


def class_weights(dataset: str = "vg", clustering: str = "motif",
                  faithful: bool = False) -> np.ndarray:
    """Relation-loss class weights 1 - count / sum(count) (reference
    train_test.py:105-106), float32, in the order the dataset emits targets
    in: cluster order for VG, super-category order for OIv6.

    VG counts are scattered from frequency order through the clustering's
    permutation; the reference's own reordered table (utils.py:258-263)
    has a transcription typo (2312 twice, 2380 missing) and ignores the
    clustering, and `faithful=True` uses it as it is, for parity runs
    against reference checkpoints.  The OIv6 table is already in
    super-category order and is used as it is."""
    if dataset == "vg" and faithful:
        counts = VG_REL_COUNTS_SCAT.astype(np.float64)
    elif dataset == "vg":
        m = rel_index_map(clustering)
        counts = np.zeros(len(m), np.float64)
        counts[m] = VG_REL_COUNTS_FREQ
    else:
        counts = OIV6_REL_COUNTS.astype(np.float64)
    return (1.0 - counts / counts.sum()).astype(np.float32)


def triplet_id(sub: np.ndarray, rel: np.ndarray, obj: np.ndarray,
               num_classes: int = 150, num_relations: int = 50) -> np.ndarray:
    """Dense integer id of a (subject_cat, relation, object_cat) triplet for
    O(1) table lookups (replaces the reference's per-row Python dict probes,
    reference evaluator.py:151-152)."""
    return (np.asarray(sub) * num_relations + np.asarray(rel)) * num_classes \
        + np.asarray(obj)


NUM_TRIPLET_IDS_VG = 150 * 50 * 150


# ---------------------------------------------------------------------------
# GQA label space (reference dataset_utils.py:708-747).
# ---------------------------------------------------------------------------
GQA_OBJECTS = (
    "window", "man", "shirt", "tree", "wall", "person", "sky", "building",
    "ground", "sign", "head", "pole", "hand", "grass", "hair", "leg", "car",
    "woman", "trees", "table", "leaves", "ear", "eye", "people", "pants",
    "water", "door", "fence", "nose", "wheel", "arm", "shoe", "clouds",
    "hat", "floor", "jacket", "chair", "leaf", "tail", "plate", "letter",
    "flower", "face", "road", "number", "windows", "cloud", "shorts",
    "sidewalk", "snow", "bag", "rock", "glass", "roof", "umbrella", "tire",
    "helmet", "boy", "logo", "jeans", "foot", "street", "cap", "boat",
    "bush", "mouth", "post", "girl", "flowers", "picture", "legs", "shoes",
    "bottle", "bus", "bench", "field", "pillow", "glasses", "mirror",
    "clock", "neck", "bowl", "dirt", "kite", "box", "train", "letters",
    "airplane", "bird", "food", "house", "lamp", "trunk", "cup", "coat",
    "horse", "street light", "shelf", "wing", "sheep", "paper", "book",
    "plant", "elephant", "branch", "dog", "giraffe", "counter",
    "motorcycle", "seat", "glove", "zebra", "skateboard", "banana", "eyes",
    "racket", "frame", "ceiling", "rocks", "surfboard", "truck", "bike",
    "wheels", "cabinet", "sink", "sand", "cow", "flag", "traffic light",
    "ball", "hands", "bushes", "feet", "child", "cat", "windshield", "bed",
    "finger", "stone", "hill", "word", "backpack", "basket", "player",
    "tie", "container", "paw", "vase", "buildings", "sock",
)

GQA_RELATIONS = (
    "to the left of", "to the right of", "on", "near", "in", "behind",
    "in front of", "holding", "on top of", "above", "next to", "below",
    "under", "on the side of", "beside", "inside", "at", "around",
    "on the front of", "on the back of", "wearing", "of", "with", "by",
    "contain", "filled with", "full of", "sitting on", "standing on",
    "carrying", "walking on", "riding", "standing in", "hanging on",
    "looking at", "covered by", "lying on", "watching", "eating",
    "covering", "hanging from", "riding on", "sitting in", "using",
    "parked on", "covered in", "walking in", "flying in", "crossing",
    "swinging",
)

# object label -> super-category ids (reference dataset_utils.py:725-740)
GQA_LABEL2SUPER = {
    0: (5,), 1: (0,), 2: (14,), 3: (2,), 4: (5,), 5: (0,), 6: (6,), 7: (5,),
    8: (5, 15), 9: (13,), 10: (0, 3, 11), 11: (13,), 12: (0, 3, 11),
    13: (6,), 14: (0, 11), 15: (0, 3, 11), 16: (4,), 17: (0,), 18: (2,),
    19: (12,), 20: (2, 11), 21: (0, 3, 11), 22: (0, 3, 11), 23: (0,),
    24: (14,), 25: (6,), 26: (5, 11), 27: (13,), 28: (0, 3, 11),
    29: (4, 11), 30: (0, 3, 11), 31: (14,), 32: (6,), 33: (14,), 34: (5,),
    35: (14,), 36: (12,), 37: (2, 11, 15), 38: (3, 11), 39: (9, 13),
    40: (13,), 41: (15,), 42: (0, 3, 11), 43: (6,), 44: (13,), 45: (5, 11),
    46: (6,), 47: (14,), 48: (6,), 49: (6,), 50: (13,), 51: (7,),
    52: (5, 13), 53: (5, 11), 54: (13,), 55: (4, 11), 56: (14,), 57: (0,),
    58: (13,), 59: (14,), 60: (0, 3, 11), 61: (6,), 62: (14,), 63: (4,),
    64: (14,), 65: (0, 3, 11), 66: (13,), 67: (0,), 68: (15,), 69: (13,),
    70: (0, 3, 11), 71: (14,), 72: (13,), 73: (4,), 74: (12,), 75: (6,),
    76: (12,), 77: (14,), 78: (12,), 79: (12, 13), 80: (0, 3, 11),
    81: (10, 13), 82: (7,), 83: (13,), 84: (13,), 85: (4,), 86: (13,),
    87: (4,), 88: (3,), 89: (1,), 90: (5,), 91: (12, 13), 92: (4,),
    93: (9, 10, 13), 94: (14,), 95: (3, 4), 96: (13,), 97: (12,),
    98: (3, 11), 99: (3,), 100: (13,), 101: (13,), 102: (2,), 103: (1, 7),
    104: (2, 11), 105: (3,), 106: (3,), 107: (12,), 108: (4,), 109: (12,),
    110: (13,), 111: (3,), 112: (13,), 113: (1, 8), 114: (0, 3, 11),
    115: (13,), 116: (12, 13), 117: (5,), 118: (7,), 119: (4, 13),
    120: (4,), 121: (4,), 122: (4, 11), 123: (12,), 124: (13,), 125: (7,),
    126: (3,), 127: (13,), 128: (13,), 129: (13,), 130: (0, 3, 11),
    131: (14,), 132: (0, 3, 11), 133: (0,), 134: (3,), 135: (4, 11),
    136: (12,), 137: (0, 3, 11), 138: (7,), 139: (6,), 140: (13,),
    141: (9, 13), 142: (9, 13), 143: (0,), 144: (14,), 145: (9,),
    146: (3, 11), 147: (9, 13), 148: (5,), 149: (14,),
}

# 3DSSG CLIP clustering (reference dataset_utils.py:790-796)
REL_3DSSG_CLIP_INDEX = np.array(
    [0, 5, 20, 21, 22, 6, 7, 23, 8, 9, 10, 11, 12, 24, 13, 14, 0, 1,
     15, 2, 16, 17, 18, 19, 25, 3, 4], dtype=np.int32)
