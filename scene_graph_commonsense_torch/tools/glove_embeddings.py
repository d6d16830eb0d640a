"""Convert GloVe word vectors into a label-embedding init table for the
plug-and-play context models (the port's counterpart of the repo's
tools/glove_embeddings.py: the same arguments, table and output path).

The reference's graft targets (Scene-Graph-Benchmark context predictors)
initialize object-label embeddings from GloVe vectors on disk (reference
README_PLUGANDPLAY.md:56-69): each class name takes the mean of the vectors
of its in-vocabulary whitespace tokens; names with no in-vocabulary token
are left to the model's random init (the hook skips them).

Usage:
  python -m scene_graph_commonsense_torch.tools.glove_embeddings \\
      --glove /path/glove.6B.100d.txt [--dataset vg] \\
      [--out datasets/artifacts/glove_labels_vg.npz]

Output npz: `vectors` (num_classes, dim) float32, `found` (num_classes,)
bool, `source`.  Read by train.pnp_engine.apply_glove_init when
cfg.model.glove_embeddings points at it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from scene_graph_commonsense_torch.constants import VG_OBJECTS

# the repository's root: the default --out lies under its datasets/artifacts
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_table(names, glove_path):
    """(vectors, found) of `names` from a GloVe text file: each name the
    mean of its tokens' vectors (the first occurrence of a token counts)."""
    wanted = {}
    for name in names:
        for tok in name.lower().split():
            wanted.setdefault(tok, None)
    dim = None
    with open(glove_path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            tok = parts[0]
            if tok in wanted and wanted[tok] is None:
                wanted[tok] = np.asarray(parts[1:], np.float32)
                dim = len(parts) - 1
    if dim is None:
        sys.exit(f"no requested token found in {glove_path}")
    vecs = np.zeros((len(names), dim), np.float32)
    found = np.zeros(len(names), bool)
    for i, name in enumerate(names):
        hits = [wanted[t] for t in name.lower().split()
                if wanted.get(t) is not None]
        if hits:
            vecs[i] = np.mean(hits, axis=0)
            found[i] = True
    return vecs, found


def build_synthetic_table(names, dim=100):
    """Deterministic stand-in when no GloVe file is at hand: per-TOKEN unit
    vectors from a token-seeded generator, mean-pooled per class exactly
    like build_table, so classes sharing a token ('race car' / 'car') get
    correlated rows.  This is NOT GloVe — the npz records
    source='synthetic-hash' so nothing downstream can mistake it for the
    real table."""
    tok_vecs = {}
    for name in names:
        for tok in name.lower().split():
            if tok not in tok_vecs:
                seed = int.from_bytes(tok.encode(), "little") % (2 ** 31)
                v = np.random.default_rng(seed).standard_normal(dim)
                tok_vecs[tok] = (v / np.linalg.norm(v)).astype(np.float32)
    vecs = np.zeros((len(names), dim), np.float32)
    found = np.zeros(len(names), bool)
    for i, name in enumerate(names):
        hits = [tok_vecs[t] for t in name.lower().split()]
        if hits:
            vecs[i] = np.mean(hits, axis=0)
            found[i] = True
    return vecs, found


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--glove", default=None,
                    help="GloVe txt file (e.g. glove.6B.100d.txt)")
    ap.add_argument("--synthetic", action="store_true",
                    help="build the deterministic name-hash stand-in "
                         "table instead (no GloVe file needed; see "
                         "build_synthetic_table)")
    ap.add_argument("--dim", type=int, default=100,
                    help="--synthetic vector dimension")
    ap.add_argument("--dataset", default="vg", choices=["vg", "oiv6"])
    ap.add_argument("--names-json", default=None,
                    help="JSON list of class names (required for oiv6 — "
                         "its 601 names live in the dataset files, not "
                         "constants)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.names_json:
        with open(args.names_json) as f:
            names = json.load(f)
    elif args.dataset == "vg":
        names = VG_OBJECTS
    else:
        sys.exit("--names-json is required for oiv6")
    if args.synthetic:
        vecs, found = build_synthetic_table(names, args.dim)
        source = "synthetic-hash"
        suffix = ".synthetic"
    elif args.glove:
        vecs, found = build_table(names, args.glove)
        source = os.path.basename(args.glove)
        suffix = ""
    else:
        sys.exit("one of --glove or --synthetic is required")
    out = args.out or os.path.join(
        ROOT, "datasets", "artifacts",
        f"glove_labels_{args.dataset}{suffix}.npz")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez(out, vectors=vecs, found=found, source=source)
    print(f"wrote {out} (source={source}): {found.sum()}/{len(names)} "
          f"classes resolved, dim {vecs.shape[1]}")
    return out


if __name__ == "__main__":
    main()
