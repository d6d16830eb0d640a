"""Relation-head checkpoints: the reference-compatible name and a torch.save
of the state dict (the JAX package writes orbax directories under the same
name; the port adds a ".pt" suffix so the two never collide).  `load` is
the counterpart of the JAX package's `restore`: a state dict needs no
template (the shapes and dtypes orbax restores into), so it takes none."""

from __future__ import annotations

import os
from typing import Dict

import torch


def checkpoint_name(hierarchical: bool, run_mode: str, clustering: str,
                    epoch: int) -> str:
    """Reference-compatible checkpoint naming (train_test.py:311-319)."""
    head = "HierRelationModel" if hierarchical else "FlatRelationModel"
    tag = "CS" if run_mode in ("train_cs",) else "Baseline"
    return f"{head}_{tag}_{clustering}{epoch}"


def save(path: str, model) -> None:
    """torch.save of a module's state dict, or of a state dict."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(model.state_dict() if isinstance(model, torch.nn.Module)
               else model, path)


def load(path: str) -> Dict[str, torch.Tensor]:
    """State dict on the CPU (load_state_dict copies it to the model's
    device)."""
    return torch.load(path, map_location="cpu", weights_only=True)

