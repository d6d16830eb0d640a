"""Dataset artifacts: triplet tables, zero-shot sets and the super-category
multi-hot (numpy).

The loader half of scene_graph_commonsense_tpu/data/artifacts.py and its
super_multi_hot, copied so that the port imports nothing of the JAX package.
One .npz per dataset holds the triplet id lists; absent files load as an
empty bundle (None tables).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

NUM_OBJ = 150
NUM_REL = 50
NUM_SUPER = 17


def triplet_table_from_ids(sub, rel, obj, num_obj=NUM_OBJ,
                           num_rel=NUM_REL) -> np.ndarray:
    """Dense (num_obj * num_rel * num_obj,) bool membership table."""
    table = np.zeros(num_obj * num_rel * num_obj, dtype=bool)
    tid = (np.asarray(sub, np.int64) * num_rel + np.asarray(rel)) \
        * num_obj + np.asarray(obj)
    table[tid] = True
    return table


def super_multi_hot(super_lists, num_super: int = NUM_SUPER,
                    faithful: bool = True) -> np.ndarray:
    """Per-object super-category multi-hot from lists of super ids.

    `faithful=True` replicates the reference's `process_super_class`
    (reference utils.py:123-133) exactly, including its quirk: the loop
    `for i in range(1, 4): idx = [len(s) == i + 1]` only ever adds element
    s[i] when it is the last element, so an object with k > 2
    super-categories contributes a two-hot of {s[0], s[-1]}: the middle
    entries are dropped.  13 of VG's 150 object classes have 3
    super-categories and are affected; reference checkpoints were trained
    with this encoding, so parity requires it.  `faithful=False` encodes
    the full multi-hot instead.
    """
    mh = np.zeros((len(super_lists), num_super), dtype=np.float32)
    for i, ls in enumerate(super_lists):
        ls = list(ls) if isinstance(ls, (list, tuple, np.ndarray)) else [ls]
        if not ls:
            continue
        if faithful and len(ls) > 1:
            ls = [ls[0], ls[-1]]
        mh[i, np.asarray(ls, np.int64)] = 1.0
    return mh


def parse_triplet_strings(keys) -> Dict[str, np.ndarray]:
    """'sub_rel_obj' string keys -> id arrays (the reference keys its
    train/test/zero-shot dicts this way, reference dataset_utils.py:251)."""
    subs, rels, objs = [], [], []
    for k in keys:
        s, r, o = k.split("_")
        subs.append(int(s))
        rels.append(int(r))
        objs.append(int(o))
    return {"sub": np.asarray(subs, np.int32),
            "rel": np.asarray(rels, np.int32),
            "obj": np.asarray(objs, np.int32)}


class VGArtifacts:
    """Loaded artifact bundle for Visual Genome."""

    def __init__(self, zs_table=None, train_table=None, test_table=None,
                 sub2super=None, cs_aligned=None, cs_violated=None):
        self.zs_table = zs_table            # (obj*rel*obj,) bool
        self.train_table = train_table
        self.test_table = test_table
        self.sub2super = sub2super          # (num_obj, 17) bool multi-hot
        self.cs_aligned = cs_aligned        # (obj*rel*obj,) bool
        self.cs_violated = cs_violated


def load_vg_artifacts(artifacts_dir: str) -> VGArtifacts:
    path = os.path.join(artifacts_dir, "vg_artifacts.npz")
    if not os.path.exists(path):
        return VGArtifacts()
    data = np.load(path)

    def table(data_, prefix):
        if f"{prefix}_sub" not in data_:
            return None
        return triplet_table_from_ids(data_[f"{prefix}_sub"],
                                      data_[f"{prefix}_rel"],
                                      data_[f"{prefix}_obj"])

    cs_aligned = table(data, "cs_aligned")
    cs_violated = table(data, "cs_violated")
    # a locally produced prepare_cs run takes precedence over the converted
    # reference tables
    cs_path = os.path.join(artifacts_dir, "commonsense_triplets.npz")
    if os.path.exists(cs_path):
        cs = np.load(cs_path)
        cs_aligned = table(cs, "cs_aligned")
        cs_violated = table(cs, "cs_violated")

    return VGArtifacts(
        zs_table=table(data, "zs"), train_table=table(data, "train"),
        test_table=table(data, "test"),
        sub2super=data["sub2super"] if "sub2super" in data else None,
        cs_aligned=cs_aligned, cs_violated=cs_violated)


def default_sub2super(num_obj: int = NUM_OBJ,
                      num_super: int = NUM_SUPER) -> np.ndarray:
    """Fallback multi-hot map when the converted artifact is unavailable
    (used by synthetic tests only)."""
    mh = np.zeros((num_obj, num_super), dtype=bool)
    mh[np.arange(num_obj), np.arange(num_obj) % num_super] = True
    return mh
