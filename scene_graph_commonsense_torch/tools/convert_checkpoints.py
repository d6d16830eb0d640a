"""Converts the reference's torch checkpoints into the port's files (the
counterpart of the repo's tools/convert_checkpoints.py; a host tool: file
conversion, no device).

  # DETR-101 detector (VG- or OIv6-pretrained), its detectron2 key names
  # renamed to torch-hub names through detr101_key_{before,after}.txt
  python -m scene_graph_commonsense_torch.tools.convert_checkpoints \\
      --kind detr --src checkpoints/detr101_vg_ckpt.pth \\
      --out checkpoints/detr101_vg.pth --remap datasets/vg_scene_graph_annot

  # relation classifier (Hier/Flat RelationModel *.pth)
  python -m scene_graph_commonsense_torch.tools.convert_checkpoints \\
      --kind relation --hierar \\
      --src checkpoints/HierRelationModel_Baseline_motif2_0.pth \\
      --out checkpoints/HierRelationModel_Baseline_motif0.pt

DDP's 'module.' prefixes are dropped first.  --kind detr writes a
torch-hub-named state dict: point model.detr_pretrained
at it (train/loop.load_detr reads it as it reads the hub's).  --kind
relation writes train/checkpoint.save's .pt, the file the CLI's --run_mode
eval restores from training.checkpoint_path (name it
<Hier|Flat>RelationModel_Baseline_<cluster><test_epoch>.pt there).
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Dict

import torch

from scene_graph_commonsense_torch.models import weights
from scene_graph_commonsense_torch.train import checkpoint as ckpt_lib


def relation_widths(state) -> Dict[str, int]:
    """hidden_dim and feature_size of a reference relation checkpoint, read
    from its shapes: conv1_1 has hidden_dim output channels, and fc1 takes
    the 8 hidden_dim channels of a (feature_size / 4)^2 grid (the
    reference's are 128 and 32)."""
    st = weights.strip_ddp_prefix(state)
    hidden = int(st["conv1_1.weight"].shape[0])
    cells = int(st["fc1.weight"].shape[1]) // (8 * hidden)
    side = math.isqrt(cells)
    if side * side * 8 * hidden != st["fc1.weight"].shape[1]:
        raise ValueError(f"fc1 takes {st['fc1.weight'].shape[1]} inputs, "
                         f"not 8 * {hidden} channels of a square grid")
    return {"hidden_dim": hidden, "feature_size": 4 * side}


def convert_relation(state, hierarchical: bool, dataset: str = "vg"
                     ) -> Dict[str, torch.Tensor]:
    """The port's state dict of a reference relation checkpoint (VG: 150
    classes with super-category inputs; OIv6: 601 without)."""
    return weights.from_reference_state_dict(
        state, hierarchical=hierarchical, use_super=(dataset == "vg"),
        num_classes=150 if dataset == "vg" else 601,
        **relation_widths(state))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--kind", required=True, choices=["detr", "relation"])
    ap.add_argument("--src", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--remap", default=None,
                    help="dir with detr101_key_{before,after}.txt")
    ap.add_argument("--hierar", action="store_true")
    ap.add_argument("--dataset", default="vg", choices=["vg", "oiv6"])
    args = ap.parse_args(argv)

    state = weights.strip_ddp_prefix(weights.load_torch_checkpoint(args.src))
    if args.kind == "detr":
        if args.remap:
            state = weights.apply_key_remap(
                state,
                os.path.join(args.remap, "detr101_key_before.txt"),
                os.path.join(args.remap, "detr101_key_after.txt"))
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        torch.save(state, args.out)
        print(f"wrote {args.out}")
    else:
        ckpt_lib.save(args.out, convert_relation(state, args.hierar,
                                                 args.dataset))
        print(f"wrote relation checkpoint {args.out}")


if __name__ == "__main__":
    main()
