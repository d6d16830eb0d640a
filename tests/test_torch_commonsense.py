"""The port's commonsense loop (commonsense/cache.py, client.py,
pipeline.py, the CLI's prepare_cs) against the JAX package's on the CPU:
the caches, the prompts and votes, the concurrent fan-out, edge selection,
the triplet store, and run_prepare_cs on the same weights, batches and
deterministic transport (the tables equal key by key, the per-image files
equal), with its resume and gpt4v paths; then the CLI's prepare_cs ->
train_cs -> eval_cs.  The models run in float64 in both packages (JAX with
x64 on), so the ranking of near-equal confidences cannot flip."""

import base64
import os
import shutil
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from test_torch_tiny import batches, cfgs, flax_params, torch_model

from scene_graph_commonsense_tpu.commonsense import cache as jax_cache
from scene_graph_commonsense_tpu.commonsense import client as jax_client
from scene_graph_commonsense_tpu.commonsense import (
    pipeline as jax_pipeline)
from scene_graph_commonsense_tpu.eval import recall as jax_recall
from scene_graph_commonsense_tpu.models.relation_head import (
    make_relation_classifier)
from scene_graph_commonsense_torch.__main__ import mock_llm_transport
from scene_graph_commonsense_torch.commonsense import cache, client
from scene_graph_commonsense_torch.commonsense.client import (
    IMAGE_MARKER, PROMPT_VARIATIONS, batch_query_edges,
    batch_query_edges_concurrent, build_prompts, majority_vote)
from scene_graph_commonsense_torch.commonsense.pipeline import (
    TripletStore, run_prepare_cs, select_related_top_k)
from scene_graph_commonsense_torch.eval import recall

ARTIFACTS_DIR = "datasets/artifacts"


class FixedRng:
    def __init__(self, v):
        self.v = v

    def random(self):
        return self.v


def test_torch_edge_cache_lfu_eviction():
    for lib in (cache, jax_cache):
        c = lib.EdgeCache(max_cache_size=2)
        c.put("a", 1)
        c.put("b", 1)
        c.put("a", -1)         # a: frequency 2, the fresh vote kept
        c.put("c", 1)          # evicts b, the least frequent
        assert (c.get("a"), c.get("b"), c.get("c")) == (-1, None, 1)
        assert c.cache_info() == (2, 2)


def test_torch_probabilistic_cache_lookup():
    c = cache.EdgeCache(10)
    c.put("edge", 1)
    assert cache.probabilistic_cache_lookup(c, "edge", 0.9,
                                            FixedRng(0.5)) == 1
    assert c.access_frequency["edge"] == 2          # the hit refreshed it
    assert cache.probabilistic_cache_lookup(c, "edge", 0.9,
                                            FixedRng(0.95)) is None
    assert cache.probabilistic_cache_lookup(c, "missing", 0.9,
                                            FixedRng(0.0)) is None


def test_torch_prompts_and_votes_match_jax():
    edges = ["man riding horse", "cup on table"]
    prompts = build_prompts(edges)
    assert prompts == jax_client.build_prompts(edges)
    assert len(prompts) == 4 * len(edges)
    assert prompts[1].count("man riding horse") == 2
    # prompt 0 counts double, prompts 2 and 3 are negated; a non-answer
    # counts against the edge
    comps = (["Yes, it makes sense", "No", "No", "No"]
             + ["No way", "Yes", "Yes", "Yes"] + ["", "", "", ""])
    assert majority_vote(comps, 3) == [1, -1, -1]
    rng = np.random.default_rng(0)
    words = np.array(["Yes", "No", "Yes and No", "", "no", "YES"])
    comps = list(words[rng.integers(0, len(words), 4 * 50)])
    assert majority_vote(comps, 50) == jax_client.majority_vote(comps, 50)
    texts = ["Let us see... Yes", "yes.", "No", "Yesterday", ""]
    assert [client.parse_vision_vote(t) for t in texts] \
        == [jax_client.parse_vision_vote(t) for t in texts] \
        == [1, 1, -1, -1, -1]


def test_torch_batch_query_edges_caches():
    calls = []

    def transport(prompts):
        calls.append(len(prompts))
        return ["Yes"] * len(prompts)

    c = cache.EdgeCache(10)
    votes, hits = batch_query_edges(["a rel b", "c rel d"], c, transport,
                                    rng=FixedRng(0.0))
    assert votes == [1, 1] and hits == 0
    assert sum(calls) == 2 * len(PROMPT_VARIATIONS)
    votes, hits = batch_query_edges(["a rel b", "c rel d"], c, transport,
                                    rng=FixedRng(0.0))
    assert votes == [1, 1] and hits == 2
    assert sum(calls) == 2 * len(PROMPT_VARIATIONS)    # no new queries


def _yes_for_person(prompts):
    return ["Yes" if "person" in p else "No" for p in prompts]


def test_torch_concurrent_queries_match_sequential_and_jax():
    """The fan-out gives the per-list sequential votes and cache hits, runs
    the transport on worker threads, and equals the JAX package's
    fan-out on the same seeded draws."""
    threads = set()

    def recording(prompts):
        threads.add(threading.get_ident())
        return _yes_for_person(prompts)

    lists = [[f"person wearing shirt {i}" for i in range(3)],
             [f"dog riding horse {i}" for i in range(5)], [],
             ["person on bench"], ["person wearing shirt 1"]]
    got = batch_query_edges_concurrent(lists, cache.EdgeCache(), recording,
                                       rng=np.random.default_rng(0),
                                       max_workers=4)
    seq_cache, seq_rng = cache.EdgeCache(), np.random.default_rng(0)
    want = [batch_query_edges(e, seq_cache, _yes_for_person, rng=seq_rng)
            for e in lists[:4]]
    assert got[:4] == want
    assert got[4] == ([1], 1)           # in flight: dispatched once, shared
    assert got == jax_client.batch_query_edges_concurrent(
        lists, jax_cache.EdgeCache(), _yes_for_person,
        rng=np.random.default_rng(0), max_workers=4)
    assert threading.get_ident() not in threads


def test_torch_concurrent_queries_share_cache_across_lists():
    calls = []

    def transport(prompts):
        calls.append(prompts)
        return ["Yes"] * len(prompts)

    c = cache.EdgeCache()
    rng = np.random.default_rng(0)
    batch_query_edges_concurrent([["person on bench"]], c, transport,
                                 rng=rng)
    n_calls = len(calls)
    got = batch_query_edges_concurrent(
        [["person on bench"], ["person on bench"]], c, transport,
        reuse_prob=1.0, rng=rng)
    assert len(calls) == n_calls and all(v == [1] for v, _ in got)


def test_torch_vision_query_and_image_cache_match_jax(tmp_path):
    """The gpt4v path: the same union-box crops (base64 JPEG after the
    marker) as the JAX client, one query per edge, votes parsed; a missing
    image gives None; the image cache keys on the crop."""
    rng = np.random.default_rng(1)
    path = str(tmp_path / "scene.jpg")
    Image.fromarray(rng.integers(0, 255, (64, 48, 3),
                                 dtype=np.uint8)).save(path)
    edges = ["man riding horse", "rock eating cloud"]
    sub = [np.array([0, 10, 0, 10.7]), np.array([2, 8, 2, 8])]
    obj = [np.array([5, 20, 5, 20]), np.array([1, 4, 1, 4])]
    seen = {}

    def transport_for(key):
        def transport(prompts):
            seen.setdefault(key, []).extend(prompts)
            return ["Let us see... Yes" if "man riding" in p else "No"
                    for p in prompts]
        return transport

    got = client.query_edges_vision(edges, path, sub, obj,
                                    cache.ImageCache(64, 2),
                                    transport_for("torch"))
    want = jax_client.query_edges_vision(edges, path, sub, obj,
                                         jax_cache.ImageCache(64, 2),
                                         transport_for("jax"))
    assert got == want == [1, -1]
    assert seen["torch"] == seen["jax"] and len(seen["torch"]) == 2
    text, _, b64 = seen["torch"][0].partition(IMAGE_MARKER)
    assert "man riding horse" in text
    assert base64.b64decode(b64)[:2] == b"\xff\xd8"      # JPEG
    assert client.query_edges_vision(
        edges[:1], str(tmp_path / "missing.jpg"), sub[:1], obj[:1],
        cache.ImageCache(64, 2), transport_for("torch")) is None
    ic = cache.ImageCache(image_size=32, feature_size=32)
    crop = ic.get_image(path, bbox=[4, 20, 4, 20])
    assert ic.get_image(path, bbox=[4, 20, 4, 20]) is crop
    assert ic.get_image(path) is not crop


def _scene(lib):
    boxes = np.array([[0, 10, 0, 10], [5, 15, 5, 15], [20, 30, 20, 30]],
                     np.float64)
    cand = lib.Candidates(
        img=np.zeros(3, int), conf=np.array([3.0, 2.0, 1.0]),
        rel=np.array([4, 7, 9]), sub_cat=np.array([1, 2, 5]),
        obj_cat=np.array([2, 1, 6]), sub_box=boxes,
        obj_box=boxes[::-1].copy())
    tgt = lib.Targets(
        img=np.zeros(2, int), rel=np.array([4, -1]),
        sub_cat=np.array([1, 9]), obj_cat=np.array([3, 9]),
        sub_box=boxes[:2].copy(), obj_box=boxes[:2].copy())
    return cand, tgt


def test_torch_select_related_top_k_and_triplet_store():
    cand, tgt = _scene(recall)
    predictions, graph = select_related_top_k(cand, tgt, image=0)
    want_p, want_g = jax_pipeline.select_related_top_k(
        *_scene(jax_recall), image=0)
    assert predictions == want_p and len(predictions) == 1
    assert graph[0]["rel"] == 4 and graph[0]["sub_cat"] == 1
    assert [{k: np.asarray(v).tolist() for k, v in g.items()}
            for g in graph] == [{k: np.asarray(v).tolist()
                                 for k, v in g.items()} for g in want_g]
    st = TripletStore()
    rel = np.full((3, 3), -1, np.int32)
    rel[1, 0] = 4
    st.add_gt_image(rel, np.array([2, 1, 7]))
    assert st.gt == {(1, 4, 2): 1}
    st.aligned[(5, 6, 7)] = 2
    st.violated[(1, 4, 2)] = 3      # a GT triplet wrongly rejected
    st.violated[(8, 9, 10)] = 1
    aligned, violated = st.finalize()
    assert aligned == {(5, 6, 7): 2, (1, 4, 2): 1}
    assert violated == {(8, 9, 10): 1}


def _prepare_cfgs(tmp_path, llm="gpt3.5"):
    data = {"annot_dir": str(tmp_path / "annot"),
            "artifacts_dir": str(tmp_path / "art"),
            "image_dir": str(tmp_path / "images")}
    return cfgs(model={"llm_model": llm}, data=data,
                training={"run_mode": "prepare_cs"})


def _write_images(tmp_path, n_batches, b=4):
    os.makedirs(tmp_path / "images", exist_ok=True)
    rng = np.random.default_rng(2)
    for bi in range(n_batches):
        for i in range(b):
            Image.fromarray(rng.integers(0, 255, (40, 56, 3),
                                         dtype=np.uint8)).save(
                tmp_path / "images" / f"batch{bi}_img{i}.jpg")


def _run_both(tmp_path, llm, data, params):
    """run_prepare_cs of both packages on the same inputs, each into its
    own directory; returns ((table, per-image dir, prompts) per package)."""
    out = {}
    for pkg in ("jax", "torch"):
        jc, tc = _prepare_cfgs(tmp_path, llm)
        prompts = []

        def transport(ps, _seen=prompts):
            _seen.extend(ps)
            return mock_llm_transport()(ps) if llm != "gpt4v" else [
                "Yes" if len(p) % 3 else "No" for p in ps]

        per_image = str(tmp_path / pkg / "cs")
        if pkg == "jax":
            with jax.enable_x64():
                path = jax_pipeline.run_prepare_cs(
                    jc, make_relation_classifier(jc),
                    jax.tree.map(jnp.asarray, params),
                    [{k: jnp.asarray(v) for k, v in b.items()}
                     for b in data], transport=transport, out_dir=per_image)
        else:
            path = run_prepare_cs(tc, torch_model(tc, params), data,
                                  transport=transport, out_dir=per_image,
                                  device="cpu")
        out[pkg] = (path, per_image, prompts)
    return out


def _assert_same_npz(got, want):
    g, w = np.load(got), np.load(want)
    assert sorted(g.files) == sorted(w.files)
    for k in w.files:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("llm", ["gpt3.5", "gpt4v"])
def test_torch_prepare_cs_matches_jax(tmp_path, llm):
    """run_prepare_cs on the same float64 weights, 2 batches and a
    deterministic transport: the same prompts, the same
    commonsense_triplets.npz key by key and the same per-image files; a
    second pass over the files queries nothing and writes the same table.
    gpt4v: every image on disk, one crop per queried edge."""
    params = flax_params()
    data = batches(2, seed=21, with_aug=False)
    if llm == "gpt4v":
        _write_images(tmp_path, len(data))
    runs = _run_both(tmp_path, llm, data, params)
    (t_path, t_dir, t_prompts), (j_path, j_dir, j_prompts) = \
        runs["torch"], runs["jax"]
    assert t_prompts == j_prompts and len(t_prompts) > 0
    if llm == "gpt4v":
        assert all(IMAGE_MARKER in p for p in t_prompts)
    assert t_path == os.path.join(t_dir, "commonsense_triplets.npz")
    _assert_same_npz(t_path, j_path)
    table = np.load(t_path)
    assert len(table["cs_aligned_sub"]) > 0
    assert len(table["cs_violated_sub"]) > 0
    names = sorted(f for f in os.listdir(j_dir) if f.endswith(
        "_pseudo_annotations.npz"))
    assert names == sorted(f for f in os.listdir(t_dir) if f.endswith(
        "_pseudo_annotations.npz")) and names
    for f in names:
        _assert_same_npz(os.path.join(t_dir, f), os.path.join(j_dir, f))

    # resume from the files: no query, the same rows
    _, tc = _prepare_cfgs(tmp_path, llm)
    first = {k: np.load(t_path)[k] for k in np.load(t_path).files}

    def refuse(prompts):
        raise AssertionError("resumed images were queried again")

    path = run_prepare_cs(tc, torch_model(tc, params), data,
                          transport=refuse, out_dir=t_dir, device="cpu")
    again = np.load(path)
    for prefix in ("cs_aligned", "cs_violated"):
        cols = ("sub", "rel", "obj", "count")
        rows = [sorted(zip(*(t[f"{prefix}_{c}"].tolist() for c in cols)))
                for t in (first, again)]
        assert rows[0] == rows[1]


def test_torch_prepare_cs_missing_images_write_nothing(tmp_path, capsys):
    """gpt4v with no image files: no query, no per-image file, a warning per
    image; the table holds the GT triplets."""
    params = flax_params()
    _, tc = _prepare_cfgs(tmp_path, "gpt4v")
    calls = []
    path = run_prepare_cs(tc, torch_model(tc, params),
                          batches(1, seed=22, with_aug=False),
                          transport=lambda p: calls.append(p) or [],
                          out_dir=str(tmp_path / "cs"), device="cpu")
    assert calls == []
    assert not [f for f in os.listdir(tmp_path / "cs")
                if f.endswith("_pseudo_annotations.npz")]
    assert "not found" in capsys.readouterr().out
    assert len(np.load(path)["cs_aligned_sub"]) > 0


def test_torch_mock_llm_transport_matches_main():
    import main
    edges = ["man riding horse", "cup on table", "tree has leaf",
             "dog eating pizza"]
    prompts = build_prompts(edges)
    got = mock_llm_transport()(prompts)
    assert got == main.mock_llm_transport()(prompts)
    votes = majority_vote(got, len(edges))
    assert set(votes) <= {1, -1}


def _cli(tmp_path, *args):
    art = tmp_path / "art"
    art.mkdir(exist_ok=True)
    shutil.copy(os.path.join(ARTIFACTS_DIR, "vg_artifacts.npz"), art)
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(
        "model: {feature_size: 16, hidden_dim: 8, num_img_feature: 16,\n"
        "        compute_dtype: float32}\n"
        f"data: {{max_objects: 6, artifacts_dir: {art},\n"
        f"       annot_dir: {tmp_path / 'annot'}}}\n"
        "training: {batch_size: 2, num_epoch: 1, print_freq: 1,\n"
        "           grad_clip_norm: 1.0, test_epoch: 0,\n"
        f"           checkpoint_path: {tmp_path / 'ck'},\n"
        f"           result_path: {tmp_path / 'res'}}}\n")
    return subprocess.run(
        [sys.executable, "-m", "scene_graph_commonsense_torch",
         "--config", str(cfg), "--eval_mode", "pc", "--hierar",
         "--synthetic", "2", "--device", "cpu", *args], cwd=os.getcwd(),
        capture_output=True, text=True, timeout=300)


def test_torch_cli_prepare_cs_then_train_cs_and_eval_cs(tmp_path):
    res = _cli(tmp_path, "--run_mode", "prepare_cs", "--mock-llm")
    assert res.returncode == 0, res.stderr
    assert "not found" in res.stdout       # no train checkpoint: warned
    table = tmp_path / "art" / "commonsense_triplets.npz"
    assert f"Wrote commonsense triplet tables {table}" in res.stdout
    assert len(np.load(table)["cs_aligned_sub"]) > 0
    assert any(f.endswith("_pseudo_annotations.npz")
               for f in os.listdir(tmp_path / "annot" / "cs_top10"))
    res = _cli(tmp_path, "--run_mode", "train_cs")
    assert res.returncode == 0, res.stderr
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("TRAIN")]
    assert len(lines) == 2
    assert any("commonsense=0.0000" not in ln for ln in lines)
    assert (tmp_path / "ck" / "HierRelationModel_CS_motif0.pt").exists()
    res = _cli(tmp_path, "--run_mode", "eval_cs")
    assert res.returncode == 0, res.stderr
    assert "Loaded relation checkpoint" in res.stdout
    assert '"recall"' in res.stdout.splitlines()[-1]


def test_torch_prepare_cs_config_dirs(tmp_path):
    """Without an out_dir the per-image files go under
    <annot_dir>/cs_top<k> and the table into <artifacts_dir>."""
    _, tc = _prepare_cfgs(tmp_path)
    path = run_prepare_cs(tc, torch_model(tc, flax_params()),
                          batches(1, seed=23, with_aug=False),
                          transport=mock_llm_transport(), top_k=5,
                          device="cpu")
    assert path == str(tmp_path / "art" / "commonsense_triplets.npz")
    assert os.listdir(tmp_path / "annot" / "cs_top5")
