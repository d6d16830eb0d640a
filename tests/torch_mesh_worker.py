"""One rank of the port's data- and tensor-parallel CPU tests
(tests/test_torch_mesh.py, tests/test_torch_mesh_detect.py,
tests/test_torch_mesh_pnp.py, tests/test_torch_tp.py,
tests/test_torch_mesh_tp.py, tests/test_torch_tp_global.py).

    python tests/torch_mesh_worker.py WORK_DIR RANK

Joins a gloo group of the spec's world size through a file store in
WORK_DIR, builds the mesh of the spec's model axis (default 1), runs every
scenario of WORK_DIR/spec.pt in order on its rows of the global batches and
saves what each returns to WORK_DIR/<scenario>_rank<RANK>.pt.  A scenario's entries named *state_dict
name tensors of the spec's "tensors".  A failure writes the traceback to
WORK_DIR/error_rank<RANK>.txt and exits 1.  Imports only the port (no JAX,
no conftest)."""

import contextlib
import io
import os
import sys
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

from scene_graph_commonsense_torch import __main__ as cli  # noqa: E402
from scene_graph_commonsense_torch.constants import (  # noqa: E402
    class_weights)
from scene_graph_commonsense_torch.data.artifacts import (  # noqa: E402
    load_vg_artifacts)
from scene_graph_commonsense_torch.eval import engines  # noqa: E402
from scene_graph_commonsense_torch.inference import (  # noqa: E402
    SceneGraphPredictor)
from scene_graph_commonsense_torch.models import detr as detr_lib  # noqa
from scene_graph_commonsense_torch.models.predictors import (  # noqa: E402
    HierarchicalPredictor)
from scene_graph_commonsense_torch.models.relation_head import (  # noqa
    make_relation_classifier)
from scene_graph_commonsense_torch.models import weights  # noqa: E402
from scene_graph_commonsense_torch.parallel import mesh as mesh_lib  # noqa
from scene_graph_commonsense_torch.parallel import tp  # noqa: E402
from scene_graph_commonsense_torch.train import (  # noqa: E402
    engine, loop, pnp_engine)

ARTIFACTS_DIR = "datasets/artifacts"


def _model(cfg, state_dict, dtype):
    return make_relation_classifier(cfg, device="cpu",
                                    state_dict=state_dict).to(dtype)


def _snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _same_as_rank0(mesh, tensors):
    """Whether this rank holds rank 0's bits of every tensor."""
    same = True
    for t in tensors.values():
        buf = t.clone()
        dist.broadcast(buf, src=0)
        same = same and torch.equal(buf, t)
    return same


def train_steps(mesh, sc):
    """sc: cfg, state dict name, dtype, batches (global), clip, faithful.
    Per step: rank 0's parameters (rank 1's are compared with them here),
    the metrics, and whether this rank's parameters equal rank 0's."""
    cfg = sc["cfg"]
    model = _model(cfg, sc["state_dict"], sc["dtype"])
    opt = engine.make_optimizer(1e-3, grad_clip_norm=sc["clip"])
    state = engine.init_train_state(model, opt)
    mesh_lib.replicate_tree(mesh, state.params)
    step = engine.make_train_step(
        model, cfg, opt, class_weights("vg", faithful=sc["faithful"]),
        mesh=mesh)
    trail = []
    for b in sc["batches"]:
        state, met = step(state, mesh_lib.shard_batch(mesh, b))
        params = _snapshot(model)
        trail.append((params if mesh.rank == 0 else None,
                      {k: float(v) for k, v in met.items()},
                      _same_as_rank0(mesh, params)))
    return trail


def eval_step(mesh, sc):
    """The sharded eval step on each global batch; run_eval_pc with an
    on_batch hook that records its calls; run_eval_pc on batches sharded
    ahead (shard_eval_batch) through a featurize that records the rows it
    is given."""
    cfg = sc["cfg"]
    model = _model(cfg, sc["state_dict"], sc["dtype"])
    estep = engine.make_eval_step(model, cfg, mesh=mesh)
    outs = [engines.to_numpy(estep(mesh_lib.shard_batch(mesh, b)))
            for b in sc["batches"]]
    calls = []
    res = engines.run_eval_pc(
        cfg, model, sc["batches"], mesh=mesh,
        on_batch=lambda i, out, cand, tgt: calls.append(i))
    rows = []

    def featurize(b):
        rows.append(len(b["cats"]))
        return dict(b)

    pre = engines.run_eval_pc(
        cfg, model, [engines.shard_eval_batch(mesh, b, featurize)
                     for b in sc["batches"]], mesh=mesh)
    return {"outs": outs, "calls": calls, "results": res,
            "presharded_results": pre, "featurized_rows": rows}


def fit(mesh, sc):
    cfg = sc["cfg"]
    model = _model(cfg, sc["state_dict"], sc["dtype"])
    lines = []
    state = loop.fit(cfg, model, lambda e: iter(sc["train"]),
                     lambda e: iter(sc["test"]),
                     steps_per_epoch=len(sc["train"]),
                     artifacts=load_vg_artifacts(ARTIFACTS_DIR), mesh=mesh,
                     log_fn=lines.append)
    params = _snapshot(model)
    return {"state_dict": params if mesh.rank == 0 else None,
            "same_as_rank0": _same_as_rank0(mesh, params), "lines": lines,
            "step": state.step}


def cli_runs(mesh, sc):
    """Each argv through the CLI's main() in this group (as under
    torchrun, main() finds the group up); stdout and the exit message of
    each."""
    got = []
    for argv in sc["argvs"]:
        out = io.StringIO()
        code = None
        sys.argv = ["scene_graph_commonsense_torch", *argv]
        with contextlib.redirect_stdout(out):
            try:
                cli.main()
            except SystemExit as e:
                code = str(e.code)
        got.append({"stdout": out.getvalue(), "exit": code})
    return got


def detect(mesh, sc):
    """make_detr_detect_fn(mesh=) on each global batch and on the batch
    sharded ahead (shard_eval_batch); the error of a batch of 3."""
    cfg = sc["cfg"]
    detr = detr_lib.make_detr(cfg, device="cpu",
                              state_dict=sc["detr_state_dict"],
                              detection=True)
    fn = engines.make_detr_detect_fn(cfg, detr, mesh=mesh)
    odd = None
    try:
        fn({k: v[:3] for k, v in sc["batches"][0].items()})
    except ValueError as e:
        odd = str(e)
    return {"dets": [fn(b) for b in sc["batches"]],
            "presharded": [fn(engines.shard_eval_batch(mesh, b))
                           for b in sc["batches"]], "odd": odd}


def sg_eval(mesh, sc):
    """run_eval_sgc / run_eval_sgd (mesh=) with the given global
    detections per batch, or with the detector (make_detr_detect_fn(mesh=))
    on batches sharded ahead."""
    cfg = sc["cfg"]
    model = _model(cfg, sc["state_dict"], sc["dtype"])
    batches = sc["batches"]
    if sc.get("detr_state_dict") is not None:
        detr = detr_lib.make_detr(cfg, device="cpu",
                                  state_dict=sc["detr_state_dict"],
                                  detection=True)
        detect_fn = engines.make_detr_detect_fn(cfg, detr, mesh=mesh)
        batches = [engines.shard_eval_batch(mesh, b) for b in batches]
    else:
        dets = iter(sc["dets"])

        def detect_fn(batch):
            return next(dets)
    run = engines.run_eval_sgc if sc["mode"] == "sgc" \
        else engines.run_eval_sgd
    return run(cfg, model, batches, detect_fn,
               artifacts=load_vg_artifacts(ARTIFACTS_DIR), mesh=mesh)


def predictor(mesh, sc):
    """SceneGraphPredictor(mesh=) from features; and from images through a
    seeded tiny DETR (the rows each rank featurizes recorded), beside the
    unsharded predictor's graphs of the same request."""
    cfg = sc["cfg"]
    model = _model(cfg, sc["state_dict"], sc["dtype"])
    graphs = SceneGraphPredictor(cfg, model, mesh=mesh).predict(
        sc["batch"], top_k=sc["top_k"])
    icfg = sc["image_cfg"]
    imodel = _model(icfg, sc["image_state_dict"], sc["dtype"])
    torch.manual_seed(0)
    detr = detr_lib.DETR(**sc["detr_kw"]).to(sc["dtype"]).eval() \
        .requires_grad_(False)
    sharded = SceneGraphPredictor(icfg, imodel, detr_model=detr, mesh=mesh)
    rows = []
    featurize = sharded.featurize

    def recorded(b):
        rows.append(len(b["cats"]))
        return featurize(b)

    sharded.featurize = recorded
    image_graphs = sharded.predict(sc["image_batch"], top_k=sc["top_k"])
    single = SceneGraphPredictor(icfg, imodel, detr_model=detr,
                                 device="cpu").predict(sc["image_batch"],
                                                       top_k=sc["top_k"])
    return {"graphs": graphs, "image_graphs": image_graphs,
            "single_image_graphs": single, "featurized_rows": rows}


def _predictor(sc, family):
    p = HierarchicalPredictor(family=family, **sc["kw"]).to(sc["dtype"])
    p.load_state_dict(sc["state_dicts"][family])
    return p


def pnp_eval(mesh, sc):
    """make_pnp_eval_step(mesh=) without and with TDE for each family on
    the global batch; run_eval_pc_predictor(mesh=, tde=True) of the first
    family through a featurize that records the rows it is given."""
    cfg = sc["cfg"]
    outs = {}
    for family in sc["families"]:
        p = _predictor(sc, family)
        for tde in (False, True):
            step = pnp_engine.make_pnp_eval_step(p, cfg, tde=tde, mesh=mesh)
            outs[family, tde] = engines.to_numpy(
                step(mesh_lib.shard_batch(mesh, sc["batch"])))
    rows = []

    def featurize(b):
        rows.append(len(b["cats"]))
        return dict(b)

    res = pnp_engine.run_eval_pc_predictor(
        cfg, _predictor(sc, sc["families"][0]), sc["eval_batches"],
        featurize=featurize, tde=True, mesh=mesh)
    return {"outs": outs, "results": res, "featurized_rows": rows}


def pnp_train(mesh, sc):
    """make_pnp_train_step(mesh=) over the global batches: per step rank
    0's parameters, the metrics and whether this rank's parameters equal
    rank 0's."""
    cfg = sc["cfg"]
    p = _predictor(sc, sc["family"])
    opt = engine.make_optimizer(sc["lr"], grad_clip_norm=sc["clip"])
    state = engine.init_train_state(p, opt)
    step = pnp_engine.make_pnp_train_step(p, cfg, opt,
                                          cs_tables=sc["cs_tables"],
                                          mesh=mesh)
    trail = []
    for b in sc["batches"]:
        state, met = step(state, mesh_lib.shard_batch(mesh, b))
        params = _snapshot(p)
        trail.append((params if mesh.rank == 0 else None,
                      {k: float(v) for k, v in met.items()},
                      _same_as_rank0(mesh, params)))
    return trail


def _replicas_identical(mesh, model):
    """Whether this rank holds the bits of rank 0's replicated parameters
    and of its data group's first rank's TP shards."""
    same = True
    for p in model.parameters():
        buf = p.detach().clone()
        if tp.is_shard(p):
            dist.broadcast(buf, src=mesh.model_index, group=mesh.data_group)
        else:
            dist.broadcast(buf, src=0)
        same = same and torch.equal(buf, p.detach())
    return same


def _full(mesh, model):
    """The gathered parameters on rank 0 (every rank joins the gather)."""
    full = {k: v.clone() for k, v in tp.full_state_dict(model).items()}
    return full if mesh.rank == 0 else None


def tp_layout(mesh, sc):
    """The state dict's TP shards: shard_params of the full state dict,
    from_flax(mesh=) of the flax tree, the shapes shard_module leaves, and
    the gather of the shards (gather_params) against the full dict."""
    sd = sc["state_dict"]
    shards = tp.shard_params(sd, mesh)
    model = _model(sc["cfg"], sd, sc["dtype"])
    tp.shard_module(model, mesh)
    gathered = tp.gather_params(shards, mesh)
    return {"shards": shards,
            "from_flax": weights.from_flax(sc["flax"], mesh),
            "module": _snapshot(model),
            "round_trip": all(torch.equal(gathered[k], v)
                              for k, v in sd.items())}


def tp_train(mesh, sc):
    """make_train_step(mesh=) with the model axis: the step shards the
    model, the TrainState is built after it; sc["global_batch"] picks the
    global-batch step.  Per step: the gathered parameters (rank 0), the
    metrics and whether the replicas agree."""
    cfg = sc["cfg"]
    model = _model(cfg, sc["state_dict"], sc["dtype"])
    opt = engine.make_optimizer(1e-3, grad_clip_norm=sc["clip"])
    step = engine.make_train_step(
        model, cfg, opt, class_weights("vg", faithful=sc["faithful"]),
        mesh=mesh, chunk_size=sc.get("chunk", 0),
        global_batch=sc.get("global_batch", False))
    state = engine.init_train_state(model, opt)
    trail = []
    for b in sc["batches"]:
        state, met = step(state, mesh_lib.shard_batch(mesh, b))
        trail.append((_full(mesh, model),
                      {k: float(v) for k, v in met.items()},
                      _replicas_identical(mesh, model)))
    return trail


def tp_eval(mesh, sc):
    """The eval step over the mesh (the model sharded by it) on each
    global batch, and run_eval_pc(mesh=)'s results."""
    cfg = sc["cfg"]
    model = _model(cfg, sc["state_dict"], sc["dtype"])
    estep = engine.make_eval_step(model, cfg, mesh=mesh)
    outs = [engines.to_numpy(estep(mesh_lib.shard_batch(mesh, b)))
            for b in sc["batches"]]
    return {"outs": outs, "sharded": tp.is_shard(model.fc1.weight),
            "results": engines.run_eval_pc(cfg, model, sc["batches"],
                                           mesh=mesh)}


def tp_fit(mesh, sc):
    """fit(mesh=) with the model axis: the gathered parameters (rank 0),
    whether the replicas agree, the log lines and the step count."""
    cfg = sc["cfg"]
    model = _model(cfg, sc["state_dict"], sc["dtype"])
    lines = []
    state = loop.fit(cfg, model, lambda e: iter(sc["train"]),
                     lambda e: iter(sc["test"]),
                     steps_per_epoch=len(sc["train"]),
                     artifacts=load_vg_artifacts(ARTIFACTS_DIR), mesh=mesh,
                     log_fn=lines.append)
    return {"state_dict": _full(mesh, model),
            "replicas_identical": _replicas_identical(mesh, model),
            "sharded": tp.is_shard(model.fc1.weight), "lines": lines,
            "step": state.step}


def collectives(mesh, sc):
    """parallel.mesh's global-batch collectives on rank-dependent inputs:
    exclusive_prefix of the counts (data index + 1, 10 * (data index + 1)),
    gather_rows of a (2, 3) block of float64 with its gradient under the
    loss sum(gathered * weights), and global_losses of a ratio whose
    denominator is the group's."""
    i = mesh.data_index
    offsets = mesh_lib.exclusive_prefix(
        mesh, torch.tensor([i + 1, 10 * (i + 1)]))
    t = (torch.arange(6, dtype=torch.float64).reshape(2, 3) + 100 * i) \
        .requires_grad_()
    gathered = mesh_lib.gather_rows(mesh, t)
    weights_ = torch.arange(gathered.numel(), dtype=torch.float64) \
        .reshape(gathered.shape)
    (gathered * weights_).sum().backward()
    x = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64) * (i + 1)
    share = mesh_lib.global_losses(
        mesh, lambda total: x.sum() / total(torch.tensor(
            float(x.numel()), dtype=torch.float64)))
    return {"offsets": offsets,
            "gathered": gathered.detach(), "grad": t.grad, "share": share}


SCENARIOS = {"train": train_steps, "eval": eval_step, "fit": fit,
             "cli": cli_runs, "detect": detect, "sg_eval": sg_eval,
             "predictor": predictor, "pnp_eval": pnp_eval,
             "pnp_train": pnp_train, "tp_layout": tp_layout,
             "tp_train": tp_train, "tp_eval": tp_eval, "tp_fit": tp_fit,
             "collectives": collectives}


def main():
    work, rank = sys.argv[1], int(sys.argv[2])
    torch.set_num_threads(2)
    try:
        spec = torch.load(os.path.join(work, "spec.pt"), weights_only=False)
        # a rank that fails leaves its peers waiting in a collective: the
        # timeout bounds the wait
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(work, 'rdv.store')}",
            world_size=spec["world"], rank=rank,
            timeout=timedelta(seconds=120))
        mesh = mesh_lib.make_mesh(model=spec.get("model", 1), device="cpu")
        for name, sc in spec["scenarios"]:
            sc = {k: spec["tensors"][v] if k.endswith("state_dict")
                  and v is not None else v for k, v in sc.items()}
            result = SCENARIOS[sc["kind"]](mesh, sc)
            torch.save(result, os.path.join(work, f"{name}_rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(work, f"error_rank{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)


if __name__ == "__main__":
    main()
