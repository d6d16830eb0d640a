"""Host-side input pipeline: a background producer keeps batches in flight
(prefetch_iterator, a copy of the one in
scene_graph_commonsense_tpu/data/pipeline.py), and to_device copies a numpy
batch to the card on that thread, so host work overlaps the train step.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch


def prefetch_iterator(batches: Iterable[Dict], prefetch: int = 2,
                      transform: Optional[Callable[[Dict], Dict]] = None
                      ) -> Iterator[Dict]:
    """Runs the batch source (and an optional transform, e.g. to_device) on
    a background thread, keeping `prefetch` batches ready."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    done = object()
    err_box = []
    stop = threading.Event()

    def _put(item) -> bool:
        # a bounded put that gives up when the consumer is gone, so an
        # abandoned iterator cannot pin the producer and its queued
        # batches forever
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for b in batches:
                if not _put(transform(b) if transform is not None else b):
                    return
        except BaseException as e:   # surface worker errors to the consumer
            err_box.append(e)
        finally:
            _put(done)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                if err_box:
                    raise err_box[0]
                return
            yield item
    finally:
        stop.set()


def to_device(batch: Dict, device: torch.device) -> Dict:
    """The batch's arrays as tensors on `device`.  On a card the copy goes
    through pinned memory and is queued without waiting (ordered before the
    step's kernels on the same stream); other entries pass through."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)):
            t = torch.as_tensor(v)
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            else:
                t = t.to(device)
            out[k] = t
        else:
            out[k] = v
    return out
