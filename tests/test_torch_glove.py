"""The port's GloVe table tool (tools/glove_embeddings.py) against the
repo's tools/glove_embeddings.py, on the CPU, and its table through the
port's apply_glove_init into a Motifs predictor.

Tolerance: none.  build_table's vectors and found flags equal JAX's on a
fabricated GloVe text file (multi-word names, out-of-vocabulary names,
repeated tokens, a name list from --names-json); the tool's .npz files equal
the JAX tool's key by key; the synthetic table equals the committed
datasets/artifacts/glove_labels_vg.synthetic.npz byte for byte; the
predictor's label_embed rows that the table resolves equal its vectors."""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import glove_embeddings as jax_tool  # noqa: E402

from scene_graph_commonsense_torch.config import derive  # noqa: E402
from scene_graph_commonsense_torch.constants import VG_OBJECTS  # noqa
from scene_graph_commonsense_torch.tools import glove_embeddings  # noqa
from scene_graph_commonsense_torch.train import pnp_engine  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(ROOT, "datasets", "artifacts",
                         "glove_labels_vg.synthetic.npz")
DIM = 100


@pytest.fixture(scope="module")
def glove_file(tmp_path_factory):
    """A GloVe text file of dim DIM over VG's tokens and others: every
    third VG token missing, a token twice (the first counts)."""
    rng = np.random.default_rng(4)
    tokens = sorted({t for n in VG_OBJECTS for t in n.split()})
    path = tmp_path_factory.mktemp("glove") / "glove.txt"
    with open(path, "w", encoding="utf-8") as f:
        for i, tok in enumerate(tokens + ["zebra", "unrelated", "the"]):
            if i % 3 == 1 and i < len(tokens):
                continue
            vec = rng.standard_normal(DIM).round(5)
            f.write(tok + " " + " ".join(f"{v:.5f}" for v in vec) + "\n")
    return str(path)


def _run_both(monkeypatch, args, tmp_path):
    outs = {n: str(tmp_path / f"{n}.npz") for n in ("t", "j")}
    glove_embeddings.main(args + ["--out", outs["t"]])
    monkeypatch.setattr(sys, "argv", ["glove_embeddings.py", *args,
                                      "--out", outs["j"]])
    jax_tool.main()
    got, want = (np.load(outs[n]) for n in ("t", "j"))
    assert got.files == want.files
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return outs["t"]


def test_torch_build_table_matches_jax(glove_file):
    names = list(VG_OBJECTS) + ["traffic light", "xyzzy", "tree xyzzy"]
    got, want = glove_embeddings.build_table(names, glove_file), \
        jax_tool.build_table(names, glove_file)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert 0 < got[1].sum() < len(names)


@pytest.mark.parametrize("names_json", [False, True])
def test_torch_glove_tool_matches_jax(glove_file, tmp_path, monkeypatch,
                                      names_json):
    args = ["--glove", glove_file]
    if names_json:
        path = tmp_path / "names.json"
        path.write_text(json.dumps(["the car", "race car", "xyzzy",
                                    "unrelated"]))
        args += ["--dataset", "oiv6", "--names-json", str(path)]
    _run_both(monkeypatch, args, tmp_path)


def test_torch_glove_tool_refuses_oiv6_without_names(tmp_path):
    with pytest.raises(SystemExit, match="names-json"):
        glove_embeddings.main(["--dataset", "oiv6", "--synthetic",
                               "--out", str(tmp_path / "x.npz")])


def test_torch_synthetic_table_equals_the_committed_file(tmp_path,
                                                         monkeypatch):
    out = _run_both(monkeypatch, ["--synthetic"], tmp_path)
    with open(out, "rb") as a, open(COMMITTED, "rb") as b:
        assert a.read() == b.read()


def test_torch_glove_table_initialises_motifs_embeddings(glove_file,
                                                         tmp_path):
    out = str(tmp_path / "glove_labels_vg.npz")
    glove_embeddings.main(["--glove", glove_file, "--out", out])
    cfg = derive("vg", model={"glove_embeddings": out},
                 training={"eval_mode": "pc"})
    predictor = pnp_engine.make_predictor(cfg, "motifs", device="cpu",
                                          log_fn=lambda *a: None)
    with np.load(out) as table:
        vecs, found = table["vectors"], table["found"]
    tabs = {k: v for k, v in predictor.state_dict().items()
            if k.endswith("label_embed.weight")}
    assert tabs
    for key, tab in tabs.items():
        rows = np.nonzero(found)[0]
        np.testing.assert_array_equal(tab[rows].numpy(), vecs[rows],
                                      err_msg=key)
        assert tab[np.nonzero(~found)[0]].abs().sum() > 0
