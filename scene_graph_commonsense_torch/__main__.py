"""Command line of the port, mirroring main.py:

  python -m scene_graph_commonsense_torch
      --run_mode train|eval|prepare_cs|train_cs|eval_cs
      --eval_mode pc|sgc|sgd [--hierar] [--cluster C] [--dataset vg|oiv6]
      [--synthetic N] [--config YAML] [--batch_size B] [--epochs E]
      [--device cpu|cuda] [--mesh_data D] [--mock-llm]
      [--predictor motifs|transformer|vctree|vtranse [--tde]]

Without --synthetic the run reads Visual Genome from disk as main.py does:
the YAML's data.annotation_train / annotation_test (instances JSON),
annot_dir (per-image *_annotations.pkl or .npz), image_dir, and optionally
features_dir (a feature cache, python -m
scene_graph_commonsense_torch.tools.precompute_features) and sgrc_dir (SGRC
records for the C++ packer).  Batches come from the C++ packer over the
records for training, and for PredCLS evaluation when a feature cache is
given; otherwise from the Python loader (data/dataset.py).  The frozen
DETR-101 featurizer encodes the images (model.detr_pretrained, seeded
random weights with a warning when absent).

train / train_cs run train.loop.fit from the seeded initialisation (real
data: 1000 steps per epoch for the learning-rate schedule; --synthetic N: N
synthetic VG-shaped batches per epoch, seed 0 + epoch, with the augmented
view), each epoch ending in a checkpoint <training.checkpoint_path>/<name>.pt
and a PredCLS test pass (synthetic: max(N // 4, 1) batches, seed 100 +
epoch).  eval / eval_cs load the checkpoint of training.test_epoch if it
exists (else warn and evaluate the seeded initialisation), run PredCLS,
SGCLS or SGDET evaluation and print the result as one JSON line; SGCLS and
SGDET run the frozen DETR-101 detector on the detection canvas (one model
gives the features and the detections) and with --synthetic exit as
main.py does.  prepare_cs loads the train checkpoint of
training.test_epoch (else warns), runs the baseline over the training
batches of epoch 0, asks the LLM (OpenAI; --mock-llm: a deterministic
offline stand-in) about each image's top predictions, and writes
<data.artifacts_dir>/commonsense_triplets.npz (per-image files under
<data.annot_dir>/cs_top10, which a rerun resumes from), the table train_cs
and eval_cs read.

--dataset oiv6 reads OpenImages V6 as main.py does: SGTR-style
vrd-{train,test}-anno.json records (data.annotation_train / _test), JPEGs
<img_fn>.jpg under data.image_dir, optionally depth maps under
data.depth_dir and a feature cache; OIv6 has no commonsense tables, and
PredCLS results carry the weighted mAP (wmap_rel, wmap_phrase).

--predictor trains (train / train_cs) or evaluates (eval / eval_cs, PredCLS
scoring, --tde for Total Direct Effect) a plug-and-play predictor family
(train/pnp_engine.py) in place of the flagship relation head; its
checkpoints are <training.checkpoint_path>/Pnp<Family>Model[_CS]_<cluster>
<epoch>.pt.  --tde without --predictor and --predictor with prepare_cs exit
with a message.

Data parallel: launched as N processes (torchrun --nproc_per_node N -m
scene_graph_commonsense_torch ...), the run joins torchrun's process group
(NCCL on cuda, gloo with --device cpu) and trains or PredCLS-evaluates over
a data axis of --mesh_data D processes (-1: parallel.data_axis, whose -1
picks the largest divisor of the batch size that fits the world, as
main.py does).  The axis must fill the world and divide the batch size:
unlike a spare TPU device, a launched process cannot sit idle.  PredCLS,
SGCLS and SGDET evaluation and --predictor evaluation run sharded over the
axis; --predictor training and prepare_cs run on rank 0 alone, as main.py
runs them on one device, while the other ranks wait for it and exit
without output.  Rank 0 alone prints and writes.  With
training.save_vis_results, PredCLS evaluation writes each batch's top
predictions beside its targets to
<training.result_path>/visualization/<i>_vis_results.json.
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
    ap.add_argument("--predictor", default=None,
                    choices=["motifs", "transformer", "vctree", "vtranse"],
                    help="train/eval a plug-and-play predictor family "
                         "(context model + hierarchical head) instead of "
                         "the flagship relation classifier")
    ap.add_argument("--tde", action="store_true",
                    help="score predictor eval by Total Direct Effect "
                         "(counterfactual debiasing; with --predictor)")
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--mesh_data", type=int, default=-1,
                    help="data-parallel mesh axis size (-1 = all "
                         "processes)")
    ap.add_argument("--mock-llm", action="store_true",
                    help="prepare_cs with a deterministic offline stand-in "
                         "for the OpenAI transport")
    return ap.parse_args()


def mock_llm_transport():
    """Deterministic offline LLM (a copy of main.py's): an edge's verdict is
    a hash of its text, answered coherently across the 4 paraphrases
    (prompts 2/3 are negated, commonsense/client.PROMPT_VARIATIONS), so
    majority votes are clean +1/-1 and prepare_cs produces a meaningful
    aligned/violated split."""
    import hashlib
    import re

    def transport(prompts):
        out = []
        for p in prompts:
            m = re.search(r"'(.+?)'", p) \
                or re.search(r"either a (.+?) or a", p) \
                or re.search(r"relation (.+?) impossible", p)
            edge = m.group(1) if m else p
            positive = int(hashlib.md5(edge.lower().encode()).hexdigest(),
                           16) % 4 != 0       # ~75% of edges pass
            negated = p.startswith("Regardless") or "impossible" in p
            out.append("Yes" if positive != negated else "No")
        return out

    return transport


def build_cfg(args):
    import dataclasses
    from scene_graph_commonsense_torch.config import load_config
    cfg = load_config(args.config, dataset=args.dataset,
                      supcat_clustering=args.cluster,
                      hierarchical_pred=args.hierar,
                      run_mode=args.run_mode, eval_mode=args.eval_mode)
    training = {}
    if args.batch_size:
        training["batch_size"] = args.batch_size
    if args.epochs:
        training["num_epoch"] = args.epochs
    if training:
        cfg = cfg.replace(training=dataclasses.replace(cfg.training,
                                                       **training))
    return cfg


def make_cli_mesh(args, cfg):
    """The mesh of a launch of several processes, data axis by
    --mesh_data or parallel.data_axis, model axis (tensor parallelism) by
    parallel.model_axis, or None in a single process (main.py's rule, with
    the port's one difference: the mesh must fill the world).  Exits with a
    message where it cannot."""
    from scene_graph_commonsense_torch.parallel.mesh import (
        make_mesh, world_size)
    world = world_size()
    if world == 1:
        return None
    model_axis = cfg.parallel.model_axis
    data_axis = (args.mesh_data if args.mesh_data != -1
                 else cfg.parallel.data_axis)
    b = cfg.training.batch_size
    if data_axis <= 0:
        # the largest divisor of the global batch that fits the world
        avail = world // model_axis
        data_axis = max(d for d in range(1, avail + 1) if b % d == 0)
    if data_axis * model_axis != world or b % data_axis:
        sys.exit(f"batch size {b} cannot be sharded over the {world} "
                 f"launched processes (data axis {data_axis}, model axis "
                 f"{model_axis}): a process cannot sit idle, so launch "
                 f"model axis times a number of processes that divides "
                 f"the batch size")
    return make_mesh(data=data_axis, model=model_axis, device=args.device)


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


def native_batches(cfg, training: bool = False):
    """Batch source assembled by the C++ packer (data/native): SGRC records
    under cfg.data.sgrc_dir plus the feature cache.

    Eval (PredCLS): annotation-only v1 records, features from the cache.
    Training: v2 records with the embedded raw image; native threads
    compute the per-epoch jittered contrastive view; the main view comes
    from the feature cache when there is one, else from the natively
    resized plain view."""
    import glob
    from scene_graph_commonsense_torch.data.pipeline import (
        NativeRecordPipeline)
    have_cache = bool(cfg.data.features_dir)
    if not training and not have_cache:
        sys.exit("data.sgrc_dir eval requires data.features_dir: SGRC "
                 "records carry no plain view for PredCLS (python -m "
                 "scene_graph_commonsense_torch.tools.precompute_features)")
    paths = sorted(glob.glob(os.path.join(cfg.data.sgrc_dir, "**",
                                          "*.sgrec"), recursive=True))
    if not paths:
        sys.exit(f"no .sgrec records under {cfg.data.sgrc_dir}; write them "
                 f"with python -m scene_graph_commonsense_torch.tools."
                 f"sgrecords" + (" --embed-images" if training else ""))
    pct = cfg.data.percent_train if training else cfg.data.percent_test
    paths = paths[:max(1, int(pct * len(paths)))]
    pipe = NativeRecordPipeline(
        paths, cfg.training.batch_size,
        max_objects=cfg.data.max_objects,
        feature_size=cfg.model.feature_size, shuffle=training,
        seed=cfg.training.seed, training=training,
        image_size=cfg.model.image_size if training else 0,
        want_plain=training and not have_cache)

    def attach_features(batch):
        if not have_cache:
            return batch
        feats = []
        for p in batch["annot_path"]:
            name = os.path.splitext(os.path.basename(p))[0]
            fp = os.path.join(cfg.data.features_dir,
                              name + "_features.npz")
            feats.append(np.load(fp)["features"].astype(np.float32))
        batch["features"] = np.stack(feats)
        return batch

    def gen(epoch=0):
        return map(attach_features, pipe.iter_epoch(epoch))

    return gen


def real_batches(cfg, training: bool):
    """epoch -> batches of the split, chosen as main.py chooses: the C++
    packer for training (v2 records carry pixels) and for PredCLS eval with
    a feature cache (v1 records are annotation-only); otherwise the Python
    loader."""
    if (cfg.data.sgrc_dir and cfg.data.dataset == "vg"
            and (training or (cfg.training.eval_mode == "pc"
                              and cfg.data.features_dir))):
        return native_batches(cfg, training=training)
    annot = (cfg.data.annotation_train if training
             else cfg.data.annotation_test)
    if not os.path.exists(annot):
        sys.exit(f"annotation file {annot} not found; run the preprocessing "
                 f"pipeline (tools/preprocess_vg.py) or use --synthetic N")
    if cfg.data.dataset == "oiv6":
        from scene_graph_commonsense_torch.data.oiv6 import (
            OIV6Dataset, oiv6_batches)
        ds = OIV6Dataset(cfg, annot, training=training,
                         image_dir=cfg.data.image_dir,
                         depth_dir=cfg.data.depth_dir or None,
                         load_images=True)

        def gen_oiv6(epoch=0):
            return oiv6_batches(ds, cfg.training.batch_size, seed=epoch,
                                shuffle=training)

        return gen_oiv6
    from scene_graph_commonsense_torch.data.dataset import (
        VGDataset, batches_from_dataset)
    with open(annot) as f:
        annotations = json.load(f)
    ds = VGDataset(cfg, annotations, training=training)
    pct = cfg.data.percent_train if training else cfg.data.percent_test

    def gen(epoch=0):
        return batches_from_dataset(ds, cfg.training.batch_size,
                                    seed=epoch, shuffle=training,
                                    percent=pct)

    return gen


def prepped_batches(cfg, batches, featurize):
    """Background-prefetched (and DETR-featurized) batch stream for the eval
    paths; training.prefetch_batches=0 loads synchronously."""
    from scene_graph_commonsense_torch.data.pipeline import (
        prefetch_iterator)
    if cfg.training.prefetch_batches > 0:
        return prefetch_iterator(batches, cfg.training.prefetch_batches,
                                 featurize)
    return map(featurize, batches) if featurize is not None else batches


def _result_view(res):
    """The one-line JSON result record: scalars and metric lists, plus the
    Top-3 sub-dict (as main.py prints it)."""
    return {k: v for k, v in res.items()
            if (isinstance(v, (int, float, list)) or k == "top3")
            and k != "recall_per_class"}


def run_predictor(args, cfg, train_fn, test_fn, steps_per_epoch, artifacts,
                  featurize, mesh, say):
    """--predictor: fit_predictor for train / train_cs; for eval / eval_cs
    the checkpoint of training.test_epoch (else a warning and the seeded
    initialisation) through run_eval_pc_predictor (sharded over `mesh`'s
    eval mesh), printed by `say` as one JSON line."""
    from scene_graph_commonsense_torch.train import loop
    from scene_graph_commonsense_torch.train import checkpoint as ckpt_lib
    from scene_graph_commonsense_torch.train import pnp_engine
    run_mode = cfg.training.run_mode
    if run_mode in ("train", "train_cs"):
        try:
            pnp_engine.fit_predictor(
                cfg, args.predictor, train_fn, test_fn, artifacts=artifacts,
                featurize=featurize, steps_per_epoch=steps_per_epoch,
                device=args.device)
        except ValueError as e:       # train_cs without triplet tables
            sys.exit(str(e))
        return
    ckpt = pnp_engine.checkpoint_file(cfg, args.predictor,
                                      cfg.training.test_epoch, run_mode)
    state_dict = None
    if os.path.exists(ckpt):
        state_dict = ckpt_lib.load(ckpt)
        say(f"Loaded predictor checkpoint {ckpt}")
    else:
        say(f"WARNING: predictor checkpoint {ckpt} not found — "
            f"evaluating randomly initialized weights")
    predictor = pnp_engine.make_predictor(cfg, args.predictor,
                                          device=args.device,
                                          state_dict=state_dict, log_fn=say)
    try:
        res = pnp_engine.run_eval_pc_predictor(
            cfg, predictor, test_fn(0), artifacts=artifacts,
            featurize=featurize, use_cs=run_mode == "eval_cs",
            tde=args.tde, device=args.device,
            mesh=loop.eval_mesh(cfg, mesh))
    except ValueError as e:           # eval_cs without triplet tables
        sys.exit(str(e))
    say(json.dumps(_result_view(res), default=str))


def main():
    import torch.distributed as dist
    from scene_graph_commonsense_torch.parallel.mesh import init_multihost
    args = parse_args()
    cfg = build_cfg(args)
    # torchrun's environment, if launched so: the process group first (a
    # caller's group is used as it is, and left up)
    owned = not dist.is_initialized()
    init_multihost(device=args.device)
    try:
        mesh = make_cli_mesh(args, cfg)
        if mesh is not None and (cfg.training.run_mode == "prepare_cs" or (
                args.predictor
                and cfg.training.run_mode in ("train", "train_cs"))):
            # main.py runs these unsharded on one device: rank 0 runs them
            # as one process would (one checkpoint, one set of LLM
            # queries, one cache file); the other ranks have nothing to do
            if mesh.rank == 0:
                run(args, cfg, None)
        else:
            run(args, cfg, mesh)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def run(args, cfg, mesh):
    """The run of main(), over `mesh` (None: one process)."""
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a: None)
    say(f"run_mode={cfg.training.run_mode} eval_mode="
        f"{cfg.training.eval_mode} dataset={cfg.data.dataset} "
        f"hierar={cfg.model.hierarchical_pred} "
        f"cluster={cfg.data.supcat_clustering}")
    run_mode = cfg.training.run_mode
    if args.tde and not args.predictor:
        # refuse instead of running plain (biased) scoring that would be
        # reported as +TDE numbers
        sys.exit("--tde requires --predictor (TDE scoring is implemented "
                 "for the plug-and-play predictor eval path)")
    if args.predictor and run_mode == "prepare_cs":
        # prepare_cs collects triplets from the flagship PredCLS path
        sys.exit(f"--predictor does not support run_mode {run_mode}")
    training = run_mode in ("train", "train_cs")
    # the predictor families score PredCLS only: no detector
    detect = run_mode in ("eval", "eval_cs") \
        and cfg.training.eval_mode != "pc" and not args.predictor
    if args.synthetic and detect:
        sys.exit("sgc/sgd need detector outputs; run on real data with a "
                 "converted DETR checkpoint")
    if detect:
        from scene_graph_commonsense_torch.eval.engines import (
            check_detector_classes)
        try:
            check_detector_classes(cfg)
        except ValueError as e:           # OIv6: no class remap defined
            sys.exit(str(e))

    from scene_graph_commonsense_torch.data.artifacts import (
        load_vg_artifacts)
    from scene_graph_commonsense_torch.eval import engines
    from scene_graph_commonsense_torch.models.relation_head import (
        make_relation_classifier)
    from scene_graph_commonsense_torch.train import checkpoint as ckpt_lib
    from scene_graph_commonsense_torch.train import loop

    artifacts = (load_vg_artifacts(cfg.data.artifacts_dir)
                 if cfg.data.dataset == "vg" else None)
    featurize = detr = None
    if args.synthetic:
        n = args.synthetic
        steps_per_epoch = n

        def train_fn(epoch):
            return synthetic_batches(cfg, n, seed=epoch, with_aug=True)

        def test_fn(epoch):
            return synthetic_batches(cfg, max(n // 4, 1), seed=100 + epoch)
    else:
        steps_per_epoch = 1000
        train_fn = (real_batches(cfg, training=True)
                    if training or run_mode == "prepare_cs" else None)
        test_fn = real_batches(cfg, training=False)
        # the frozen DETR-101 (reference train_utils.py:9-18); SGCLS and
        # SGDET build the whole detector once and take the features from
        # its encode half
        detr = loop.load_detr(cfg, device=args.device, log_fn=say,
                              detection=detect)
        featurize = loop.make_detr_featurize_fn(cfg, detr)

    if args.predictor:
        run_predictor(args, cfg, train_fn, test_fn, steps_per_epoch,
                      artifacts, featurize, mesh, say)
        return
    if training:
        model = make_relation_classifier(cfg, device=args.device)
        try:
            loop.fit(cfg, model, train_fn, test_fn,
                     steps_per_epoch=steps_per_epoch, artifacts=artifacts,
                     device=args.device, featurize=featurize, mesh=mesh)
        except ValueError as e:       # train_cs without triplet tables
            sys.exit(str(e))
        return

    use_cs = run_mode == "eval_cs"
    # eval_cs evaluates the CS-trained weights; prepare_cs queries the LLM
    # about the trained baseline's predictions (reference main.py:106-114)
    name = ckpt_lib.checkpoint_name(
        cfg.model.hierarchical_pred, "train_cs" if use_cs else "train",
        cfg.data.supcat_clustering, cfg.training.test_epoch)
    ckpt = os.path.join(cfg.training.checkpoint_path, name + ".pt")
    state_dict = None
    if os.path.exists(ckpt):
        state_dict = ckpt_lib.load(ckpt)
        say(f"Loaded relation checkpoint {ckpt}")
    else:
        what = ("prepare_cs will query predictions of"
                if run_mode == "prepare_cs" else "evaluating")
        say(f"WARNING: relation checkpoint {ckpt} not found — {what} "
            f"randomly initialized weights")
    model = make_relation_classifier(cfg, device=args.device,
                                     state_dict=state_dict)
    if run_mode == "prepare_cs":
        from scene_graph_commonsense_torch.commonsense.pipeline import (
            run_prepare_cs)
        path = run_prepare_cs(
            cfg, model, prepped_batches(cfg, train_fn(0), featurize),
            artifacts, transport=mock_llm_transport() if args.mock_llm
            else None, device=args.device)
        print(f"Wrote commonsense triplet tables {path}")
        return
    emesh = loop.eval_mesh(cfg, mesh)
    prep = featurize
    if emesh is not None:
        # each rank encodes, and detects on, only its rows of a test batch
        def prep(batch):
            return engines.shard_eval_batch(emesh, batch, featurize)
    if detect:
        runner = (engines.run_eval_sgc if cfg.training.eval_mode == "sgc"
                  else engines.run_eval_sgd)
        res = runner(cfg, model, prepped_batches(cfg, test_fn(0), prep),
                     engines.make_detr_detect_fn(cfg, detr, mesh=emesh),
                     artifacts=artifacts, use_cs=use_cs, device=args.device,
                     mesh=emesh)
    else:
        res = engines.run_eval_pc(
            cfg, model, prepped_batches(cfg, test_fn(0), prep),
            artifacts=artifacts, use_cs=use_cs, device=args.device,
            on_batch=vis_hook(cfg), mesh=emesh)
    say(json.dumps(_result_view(res), default=str))


def vis_hook(cfg):
    """run_eval_pc's on_batch writing each batch's visualization records
    under <result_path>/visualization (training.save_vis_results; None when
    off), with main.py's square image-space size."""
    if not cfg.training.save_vis_results:
        return None
    from scene_graph_commonsense_torch.eval.visualization import (
        save_visualization_results)
    s = cfg.model.image_size

    def on_batch(i, out, cand, tgt):
        save_visualization_results(
            os.path.join(cfg.training.result_path, "visualization"), i,
            cand, tgt, heights=[s] * cfg.training.batch_size,
            widths=[s] * cfg.training.batch_size,
            feature_size=cfg.model.feature_size)

    return on_batch


if __name__ == "__main__":
    main()
