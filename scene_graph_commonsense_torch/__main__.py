"""Command line of the port, mirroring main.py:

  python -m scene_graph_commonsense_torch --run_mode train|train_cs|eval|eval_cs
      --eval_mode pc|sgc|sgd [--hierar] [--cluster C] [--dataset D]
      [--synthetic N] [--config YAML] [--batch_size B] [--device cpu|cuda]

train / train_cs run train.loop.fit from the seeded initialisation over N
synthetic VG-shaped batches per epoch (seed 0 + epoch, with the augmented
view), each epoch ending in a checkpoint <training.checkpoint_path>/<name>.pt
and a PredCLS test pass over max(N // 4, 1) synthetic batches (seed 100 +
epoch), as main.py does.  eval / eval_cs load the checkpoint of
training.test_epoch if it exists (else warn and evaluate the seeded
initialisation), run PredCLS evaluation over max(N // 4, 1) synthetic
batches (seed 100) and print the result as one JSON line.  SGCLS and
SGDET evaluation (--eval_mode sgc|sgd) need detector outputs on real
images: with --synthetic they exit as main.py does, and without it the
Visual Genome loader is not ported yet.  prepare_cs, and real data for any
run mode, exit with a message.
"""

import argparse
import json
import os
import sys

import numpy as np


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--run_mode", default=None,
                    choices=["train", "eval", "prepare_cs", "train_cs",
                             "eval_cs"])
    ap.add_argument("--eval_mode", default=None,
                    choices=["pc", "sgc", "sgd"])
    ap.add_argument("--cluster", default=None,
                    choices=["motif", "gpt2", "bert", "clip"])
    ap.add_argument("--hierar", action="store_const",
                    const=True, default=None)
    ap.add_argument("--dataset", default=None, choices=["vg", "oiv6"])
    ap.add_argument("--config", default=None, help="optional YAML config")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="run on synthetic batches instead of real data")
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args()


def build_cfg(args):
    import dataclasses
    from scene_graph_commonsense_torch.config import load_config
    cfg = load_config(args.config, dataset=args.dataset,
                      supcat_clustering=args.cluster,
                      hierarchical_pred=args.hierar,
                      run_mode=args.run_mode, eval_mode=args.eval_mode)
    if args.batch_size:
        cfg = cfg.replace(training=dataclasses.replace(
            cfg.training, batch_size=args.batch_size))
    return cfg


def synthetic_batches(cfg, n_batches, seed, with_aug=False):
    from scene_graph_commonsense_torch.data.synthetic import synthetic_batch
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        yield synthetic_batch(
            rng, batch_size=cfg.training.batch_size,
            max_objects=cfg.data.max_objects,
            feature_size=cfg.model.feature_size,
            num_channels=cfg.model.num_img_feature,
            num_classes=cfg.model.num_classes,
            num_relations=cfg.model.num_relations, with_aug=with_aug)


def _result_view(res):
    """The one-line JSON result record: scalars and metric lists, plus the
    Top-3 sub-dict (as main.py prints it)."""
    return {k: v for k, v in res.items()
            if (isinstance(v, (int, float, list)) or k == "top3")
            and k != "recall_per_class"}


def main():
    args = parse_args()
    cfg = build_cfg(args)
    print(f"run_mode={cfg.training.run_mode} eval_mode="
          f"{cfg.training.eval_mode} dataset={cfg.data.dataset} "
          f"hierar={cfg.model.hierarchical_pred} "
          f"cluster={cfg.data.supcat_clustering}")
    run_mode = cfg.training.run_mode
    if run_mode == "prepare_cs":
        sys.exit(f"run_mode={run_mode} is not yet ported to PyTorch; the "
                 f"port runs --run_mode train|train_cs|eval|eval_cs (use "
                 f"main.py for the rest)")
    if not args.synthetic:
        sys.exit("the Visual Genome loader is not yet ported to PyTorch; "
                 "use --synthetic N")
    if run_mode in ("eval", "eval_cs") and cfg.training.eval_mode != "pc":
        sys.exit("sgc/sgd need detector outputs; run on real data with a "
                 "converted DETR checkpoint")

    from scene_graph_commonsense_torch.data.artifacts import (
        load_vg_artifacts)
    from scene_graph_commonsense_torch.eval import engines
    from scene_graph_commonsense_torch.models.relation_head import (
        make_relation_classifier)
    from scene_graph_commonsense_torch.train import checkpoint as ckpt_lib

    artifacts = (load_vg_artifacts(cfg.data.artifacts_dir)
                 if cfg.data.dataset == "vg" else None)
    if run_mode in ("train", "train_cs"):
        from scene_graph_commonsense_torch.train.loop import fit
        model = make_relation_classifier(cfg, device=args.device)
        n = args.synthetic
        try:
            fit(cfg, model,
                lambda epoch: synthetic_batches(cfg, n, seed=epoch,
                                                with_aug=True),
                lambda epoch: synthetic_batches(cfg, max(n // 4, 1),
                                                seed=100 + epoch),
                steps_per_epoch=n, artifacts=artifacts, device=args.device)
        except ValueError as e:       # train_cs without triplet tables
            sys.exit(str(e))
        return

    use_cs = run_mode == "eval_cs"
    name = ckpt_lib.checkpoint_name(
        cfg.model.hierarchical_pred, "train_cs" if use_cs else "train",
        cfg.data.supcat_clustering, cfg.training.test_epoch)
    ckpt = os.path.join(cfg.training.checkpoint_path, name + ".pt")
    state_dict = None
    if os.path.exists(ckpt):
        state_dict = ckpt_lib.load(ckpt)
        print(f"Loaded relation checkpoint {ckpt}")
    else:
        print(f"WARNING: relation checkpoint {ckpt} not found — "
              f"evaluating randomly initialized weights")
    model = make_relation_classifier(cfg, device=args.device,
                                     state_dict=state_dict)
    batches = synthetic_batches(cfg, max(args.synthetic // 4, 1), seed=100)
    res = engines.run_eval_pc(cfg, model, batches, artifacts=artifacts,
                              use_cs=use_cs, device=args.device)
    print(json.dumps(_result_view(res), default=str))


if __name__ == "__main__":
    main()
