"""Caches for the LLM/VLM commonsense validators (a copy of
scene_graph_commonsense_tpu/commonsense/cache.py).

EdgeCache: LFU-purging ordered cache with probabilistic reuse (reference
query_llm.py:16-47, 68-74).  ImageCache: resized/cropped base64 JPEG cache
for the GPT-4V path (reference query_llm.py:161-181).
"""

from __future__ import annotations

import base64
import io
import random
from collections import OrderedDict
from typing import Optional


class EdgeCache:
    """Ordered cache capped at max_cache_size; eviction removes the least
    frequently accessed entry (reference query_llm.py:16-47)."""

    def __init__(self, max_cache_size: int = 10000):
        self.cache: "OrderedDict[str, int]" = OrderedDict()
        self.max_cache_size = max_cache_size
        self.access_frequency = {}

    def get(self, key):
        return self.cache.get(key, None)

    def put(self, key, value):
        if key in self.cache:
            # documented deviation: the reference only bumps frequency and
            # keeps the stale value (query_llm.py:25-30), permanently
            # pinning an edge's first-ever vote across re-queries; here a
            # re-queried edge's fresh vote replaces the old one
            self.cache[key] = value
            self.cache.move_to_end(key)
            self.access_frequency[key] += 1
        else:
            if len(self.cache) >= self.max_cache_size:
                self._purge_least_frequent()
            self.cache[key] = value
            self.access_frequency[key] = 1

    def _purge_least_frequent(self):
        least = min(self.access_frequency, key=self.access_frequency.get)
        self.cache.pop(least, None)
        self.access_frequency.pop(least, None)

    def cache_info(self):
        return len(self.cache), self.max_cache_size


class ImageCache:
    """Caches base64-encoded (optionally union-box-cropped) JPEGs.

    Documented deviation: the reference caches by path alone
    (query_llm.py:167-181), so every edge after the first in an image
    receives the FIRST edge's crop and GPT-4V judges the wrong region;
    here the key includes the crop box."""

    def __init__(self, image_size: int = 1024, feature_size: int = 32,
                 max_cache_size: int = 1000):
        # bounded FIFO: crops only ever re-hit within the same image, so a
        # small cap keeps the hits while preventing a full-dataset pass
        # from pinning one ~100KB base64 JPEG per (image, crop) forever
        self.cache = OrderedDict()
        self.max_cache_size = max_cache_size
        self.image_size = image_size
        self.feature_size = feature_size

    def get_image(self, image_path: str, bbox: Optional[list] = None) -> str:
        key = (image_path, tuple(int(v) for v in bbox)
               if bbox is not None else None)
        if key not in self.cache:
            from PIL import Image
            img = Image.open(image_path).convert("RGB")
            img = img.resize((self.image_size, self.image_size))
            if bbox is not None:
                x1, x2, y1, y2 = key[1]
                img = img.crop((x1, y1, x2, y2))
            buf = io.BytesIO()
            img.save(buf, format="JPEG")
            while len(self.cache) >= self.max_cache_size:
                self.cache.popitem(last=False)
            self.cache[key] = base64.b64encode(
                buf.getvalue()).decode("utf-8")
        return self.cache[key]


def probabilistic_cache_lookup(cache: EdgeCache, edge: str,
                               reuse_prob: float = 0.9,
                               rng: Optional[random.Random] = None):
    """90%-probability cache reuse (reference query_llm.py:68-74): a cached
    answer is reused with probability reuse_prob, otherwise re-queried."""
    rng = rng or random
    cached = cache.get(edge)
    if cached is not None and rng.random() < reuse_prob:
        cache.put(edge, cached)   # refresh access frequency
        return cached
    return None
