"""Host-side input pipeline: a background producer keeps batches in flight
(prefetch_iterator), NativeRecordPipeline assembles batches from SGRC
records with the C++ packer (data/native), both copies of the ones in
scene_graph_commonsense_tpu/data/pipeline.py, and to_device copies a numpy
batch to the card on the producer's thread, so host work overlaps the train
step.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from scene_graph_commonsense_torch.utils import profiling


def prefetch_iterator(batches: Iterable[Dict], prefetch: int = 2,
                      transform: Optional[Callable[[Dict], Dict]] = None
                      ) -> Iterator[Dict]:
    """Runs the batch source and an optional transform on a background
    thread, keeping `prefetch` batches ready.  train.loop.fit passes the
    DETR featurizer and the device copy as the transform, so both overlap
    the train step.  The transform runs in span feed.produce, the
    consumer's wait for a batch in span feed.wait (utils/profiling)."""
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
                if transform is not None:
                    with profiling.span("feed.produce"):
                        b = transform(b)
                if not _put(b):
                    return
        except BaseException as e:   # surface worker errors to the consumer
            err_box.append(e)
        finally:
            _put(done)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            with profiling.span("feed.wait"):
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
    step's kernels on the same stream); tensors already on the device (the
    featurizer's output) and other entries pass through."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)):
            t = torch.as_tensor(v)
            if t.device.type == device.type and device.index in (
                    None, t.device.index):
                pass
            elif device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            else:
                t = t.to(device)
            out[k] = t
        else:
            out[k] = v
    return out


class NativeRecordPipeline:
    """SGRC record files -> padded batches via the C++ packer.

    `paths` is the record list (one file per image); batches are assembled
    with the sgc_pack.cc thread pool, under-filled slots (rejected records)
    are dropped and the batch refilled from the tail to keep shapes static.

    With training=True the records must be v2 (embedded raw image) and each
    batch also carries the per-epoch jittered contrastive view 'image_aug'
    (and the plain square view 'image' when want_plain; skip it when the
    main view comes from the feature cache).  The ColorJitter sample is
    drawn here (data.dataset.color_jitter_params on the epoch-seeded numpy
    RNG) and applied in C++, so the random draws are the Python loader's
    while the pixel work runs on native threads."""

    def __init__(self, paths: Sequence[str], batch_size: int,
                 max_objects: int = 20, feature_size: int = 32,
                 num_super: int = 17, num_threads: int = 8,
                 seed: int = 0, shuffle: bool = True,
                 training: bool = False, image_size: int = 0,
                 want_plain: bool = False):
        from scene_graph_commonsense_torch.data.native import (
            NativeBatchPacker)
        if training and image_size <= 0:
            raise ValueError("training=True needs image_size for the "
                             "square contrastive views")
        self.packer = NativeBatchPacker(max_objects, feature_size,
                                        num_super, num_threads)
        self.paths = list(paths)
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.training = training
        self.image_size = image_size
        self.want_plain = want_plain

    def _pack(self, chunk, rng):
        keys = ("cats", "boxes", "rel", "valid", "super_mh", "depth")
        if not self.training:
            return self.packer.pack(chunk), keys
        from scene_graph_commonsense_torch.data.dataset import (
            color_jitter_params)
        jitter = np.zeros((len(chunk), 9), np.float32)
        for i in range(len(chunk)):
            apply, order, factors = color_jitter_params(rng)
            jitter[i, 0] = float(apply)
            jitter[i, 1:5] = order
            jitter[i, 5:9] = factors
        out = self.packer.pack_train(chunk, jitter, self.image_size,
                                     want_plain=self.want_plain)
        return out, keys + ("image_aug",) + (
            ("image",) if self.want_plain else ())

    def iter_epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed + epoch)
        order = np.arange(len(self.paths))
        if self.shuffle:
            rng.shuffle(order)
        pending = [self.paths[i] for i in order]
        buf: list = []
        cursor = 0
        while cursor < len(pending) or len(buf) >= self.batch_size:
            while len(buf) < self.batch_size and cursor < len(pending):
                take = self.batch_size - len(buf)
                chunk = pending[cursor:cursor + take]
                cursor += take
                out, keys = self._pack(chunk, rng)
                for k in range(len(chunk)):
                    if out["ok"][k]:
                        ex = {key: out[key][k] for key in keys}
                        ex["annot_path"] = chunk[k]
                        buf.append(ex)
            if len(buf) < self.batch_size:
                break
            batch = {k: np.stack([ex[k] for ex in buf[:self.batch_size]])
                     for k in buf[0] if k != "annot_path"}
            batch["annot_path"] = [ex["annot_path"]
                                   for ex in buf[:self.batch_size]]
            buf = buf[self.batch_size:]
            yield batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iter_epoch(0)
