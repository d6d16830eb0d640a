"""Result recording: console lines and JSON record files (a copy of
scene_graph_commonsense_tpu/utils/logging.py).

The reference's record_train_results / record_test_results (reference
utils.py:425-487): rolling JSON files under result_path plus human-readable
R@k / mR@k / zsR@k / loss lines.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional


class ResultRecorder:
    def __init__(self, result_path: str, name: str, fresh: bool = True):
        os.makedirs(result_path, exist_ok=True)
        self.path = os.path.join(result_path, f"{name}.json")
        self.records: List[Dict] = []
        if not fresh and os.path.exists(self.path):
            with open(self.path) as f:
                self.records = json.load(f)
        else:
            self._flush()

    def _flush(self):
        with open(self.path, "w") as f:
            json.dump(self.records, f)

    def add(self, record: Dict):
        self.records.append(record)
        self._flush()


def format_train_line(epoch: int, batch: int, lr: float, recall,
                      mean_recall, recall_zs=None,
                      losses: Optional[Dict] = None) -> str:
    parts = [f"TRAIN, epoch {epoch}, batch {batch}, lr: {lr:.7f}"]
    if recall is not None:
        parts.append("R@k: " + ", ".join(f"{r:.4f}" for r in recall))
        parts.append("mR@k: " + ", ".join(f"{r:.4f}" for r in mean_recall))
    if recall_zs is not None:
        parts.append("zsR@k: " + ", ".join(f"{r:.4f}" for r in recall_zs))
    if losses:
        parts.append("loss: " + ", ".join(
            f"{k.replace('loss_', '')}={v:.4f}" for k, v in losses.items()
            if k.startswith("loss")))
    return ", ".join(parts)


def format_test_line(epoch: int, recall, mean_recall, recall_zs=None,
                     wmap_rel=None, wmap_phrase=None) -> str:
    parts = [f"TEST, epoch {epoch}"]
    if recall is not None:
        parts.append("R@k: " + ", ".join(f"{r:.4f}" for r in recall))
        parts.append("mR@k: " + ", ".join(f"{r:.4f}" for r in mean_recall))
    if recall_zs is not None:
        parts.append("zsR@k: " + ", ".join(f"{r:.4f}" for r in recall_zs))
    if wmap_rel is not None:
        parts.append(f"wmap_rel: {wmap_rel:.4f}, "
                     f"wmap_phrase: {wmap_phrase:.4f}")
    return ", ".join(parts)
