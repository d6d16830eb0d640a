"""Offline Visual Genome preprocessing CLI (the port's counterpart of the
repo's tools/preprocess_vg.py: the same stages, arguments, files and printed
lines).

Pipeline (reference preprocess.py + prepare_datasets.py):
  1. raw VG JSONs -> instances_vg_{train,test}.json  (--stage instances)
  2. instances json -> per-image annotation cache    (--stage annotations)
  3. train/test/zero-shot triplet tables             (--stage triplets)
  4. annotation cache -> SGRC binary records for the C++ batch packer
     (--stage sgrecords; tools/sgrecords.py, consumed via data.sgrc_dir)

Usage (from the repo root; the instances stage reads the vocabulary files
under datasets/vg_scene_graph_annot, the others the paths of --config):
  python -m scene_graph_commonsense_torch.tools.preprocess_vg \\
      --stage instances --raw_dir datasets/vg/annotations \\
      --h5 datasets/vg/VG-SGG-with-attri.h5
  python -m scene_graph_commonsense_torch.tools.preprocess_vg \\
      --stage annotations --split train --with_depth [--device cpu]
  python -m scene_graph_commonsense_torch.tools.preprocess_vg \\
      --stage triplets
  python -m scene_graph_commonsense_torch.tools.preprocess_vg \\
      --stage sgrecords --split test --out datasets/vg_sgrc_test

--with_depth runs MiDaS on --device (default cuda) when torch.hub's cache
holds it (data/depth.make_midas_depth_fn), else writes zero depth maps.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from scene_graph_commonsense_torch.config import derive, load_config
from scene_graph_commonsense_torch.constants import rel_index_map
from scene_graph_commonsense_torch.data import preprocess as pp

VOCAB_DIR = "datasets/vg_scene_graph_annot"
# the sizes of VG-SGG-with-attri.h5's split (reference preprocess.py:37)
H5_SPLIT_SIZES = (75651, 32422)


def write_instances(cfg, raw_dir: str, train_idx, test_idx,
                    vocab_dir: str = VOCAB_DIR):
    """The instances stage's work: the raw JSONs under raw_dir ->
    cfg.data.annotation_{train,test}, the images split by index into the
    list of uncorrupted images.  Returns (train, test, sub2super)."""
    loaded = []
    for name in ("image_data", "objects", "relationships"):
        with open(os.path.join(raw_dir, name + ".json")) as f:
            loaded.append(json.load(f))
    train, test, sub2super = pp.build_instances_dataset(
        *loaded,
        os.path.join(vocab_dir, "object_alias.txt"),
        os.path.join(vocab_dir, "predicate_alias.txt"),
        os.path.join(vocab_dir, "object_list.txt"),
        os.path.join(vocab_dir, "object_types.txt"),
        train_idx, test_idx)
    with open(cfg.data.annotation_train, "w") as f:
        json.dump(train, f)
    with open(cfg.data.annotation_test, "w") as f:
        json.dump(test, f)
    print(f"wrote {cfg.data.annotation_train} "
          f"({len(train['images'])} images) and {cfg.data.annotation_test} "
          f"({len(test['images'])} images)")
    return train, test, sub2super


def stage_instances(args, cfg):
    train_idx, test_idx = pp.load_h5_split(args.h5)
    if (len(train_idx), len(test_idx)) != H5_SPLIT_SIZES:
        raise ValueError(
            "split must match VG-SGG-with-attri.h5 (reference "
            f"preprocess.py:37): {len(train_idx)} / {len(test_idx)} images, "
            f"want {H5_SPLIT_SIZES[0]} / {H5_SPLIT_SIZES[1]}")
    write_instances(cfg, args.raw_dir, train_idx, test_idx)


def stage_annotations(args, cfg):
    """Returns the number of annotation files written."""
    annot = (cfg.data.annotation_train if args.split == "train"
             else cfg.data.annotation_test)
    with open(annot) as f:
        dataset = json.load(f)
    depth_fn = None
    if args.with_depth:
        from scene_graph_commonsense_torch.data.depth import (
            make_midas_depth_fn)
        depth_fn = make_midas_depth_fn(feature_size=cfg.model.feature_size,
                                       device=args.device)
        if depth_fn is None:
            print("MiDaS unavailable; writing zero depth maps")
    n = pp.build_all_annotations(dataset, cfg.data.annot_dir,
                                 cfg.model.feature_size, depth_fn,
                                 cfg.data.image_dir, verbose=True)
    print(f"wrote {n} per-image annotation files under "
          f"{cfg.data.annot_dir}")
    return n


def stage_triplets(args, cfg):
    """Train/test/zero-shot triplet tables in the configured clustering's
    predicate order (reference dataset_utils.py:231-290 incl. the
    wears->wearing merge), written into vg_artifacts.npz under
    cfg.data.artifacts_dir (the other tables of an existing file kept).
    The order must match what the dataset emits (data/dataset.py applies
    rel_index_map) or zsR@k counts the wrong triplets — regenerate the
    tables when changing --cluster."""
    rel_map = rel_index_map(cfg.data.supcat_clustering)
    tables = {}
    for split, path in [("train", cfg.data.annotation_train),
                        ("test", cfg.data.annotation_test)]:
        with open(path) as f:
            anns = json.load(f)["annotations"]
        keys = set()
        for a in anns:
            rel = a["relation_id"]
            if rel == 12:
                rel = 4
            rel = int(rel_map[rel])
            keys.add((a["category1"], rel, a["category2"]))
        tables[split] = keys
        print(f"{split}: {len(keys)} unique triplets")
    zs = tables["test"] - tables["train"]
    print(f"zero-shot: {len(zs)} triplets")

    def unzip(keys):
        keys = sorted(keys)
        return (np.asarray([k[0] for k in keys], np.int32),
                np.asarray([k[1] for k in keys], np.int32),
                np.asarray([k[2] for k in keys], np.int32))

    out = {}
    for prefix, keys in [("train", tables["train"]),
                         ("test", tables["test"]), ("zs", zs)]:
        s, r, o = unzip(keys)
        out[f"{prefix}_sub"] = s
        out[f"{prefix}_rel"] = r
        out[f"{prefix}_obj"] = o
    os.makedirs(cfg.data.artifacts_dir, exist_ok=True)
    path = os.path.join(cfg.data.artifacts_dir, "vg_artifacts.npz")
    if os.path.exists(path):
        with np.load(path) as npz:
            existing = dict(npz)
        existing.update(out)
        out = existing
    np.savez_compressed(path, **out)
    print(f"wrote {path}")
    return path


def stage_sgrecords(args, cfg, log_fn=print):
    """Per-image annotations -> SGRC records (tools/sgrecords.py); returns
    the number written."""
    from scene_graph_commonsense_torch.tools.sgrecords import (
        write_sgrecords)
    return write_sgrecords(cfg, args.split, args.out,
                           embed_images=args.embed_images, log_fn=log_fn)


STAGES = {"instances": stage_instances, "annotations": stage_annotations,
          "triplets": stage_triplets, "sgrecords": stage_sgrecords}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--stage", required=True, choices=list(STAGES))
    ap.add_argument("--raw_dir", default="datasets/vg/annotations")
    ap.add_argument("--h5", default="datasets/vg/VG-SGG-with-attri.h5")
    ap.add_argument("--split", default="train", choices=["train", "test"])
    ap.add_argument("--with_depth", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where --with_depth runs MiDaS")
    ap.add_argument("--out", default="datasets/vg_sgrc",
                    help="output dir for --stage sgrecords")
    ap.add_argument("--embed-images", action="store_true",
                    help="write v2 records with the raw RGB image "
                         "embedded so TRAINING batches (per-epoch "
                         "contrastive view) can be assembled by the C++ "
                         "packer (data.sgrc_dir + train)")
    ap.add_argument("--cluster", default="motif",
                    choices=["motif", "gpt2", "bert", "clip"],
                    help="predicate order for the triplet tables (must "
                         "match the training --cluster)")
    ap.add_argument("--config", default=None,
                    help="optional YAML config (paths, feature_size, "
                         "max_objects) — same schema as the CLI's --config")
    args = ap.parse_args(argv)
    if args.config:
        cfg = load_config(args.config, supcat_clustering=args.cluster)
    else:
        cfg = derive("vg", supcat_clustering=args.cluster)
    STAGES[args.stage](args, cfg)


if __name__ == "__main__":
    main()
