"""LLM/VLM query client for commonsense validation (a copy of
scene_graph_commonsense_tpu/commonsense/client.py).

Reproduces the reference's validation protocols (reference query_llm.py):
  * GPT-3.5-instruct path: four prompt paraphrases per edge (two affirmative,
    two negated) with a weighted majority vote — the first prompt counts
    double, the last two reverse Yes/No polarity (reference
    query_llm.py:90-158);
  * GPT-4V path: one chain-of-thought yes/no query over the union-box crop
    (reference query_llm.py:193-257);
  * probabilistic EdgeCache reuse between queries.

The network layer is an injectable `transport(prompts) -> list[str]`
(completion texts), so tests and offline runs use a mock; the default
transport posts to the OpenAI API when a key is configured.  Unlike the
reference's ThreadPoolExecutor that mutates shared evaluator state from
worker threads (reference evaluator.py:450-456 — a data race), this client
is purely functional: inputs in, votes out.
"""

from __future__ import annotations

import os
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from scene_graph_commonsense_torch.commonsense.cache import (
    EdgeCache, ImageCache, probabilistic_cache_lookup)

PROMPT_VARIATIONS = [
    "Is the relation '{}' generally make sense or a trivially true fact? "
    "Answer with 'Yes' or 'No' and justify your answer. A trivially true "
    "relation is still a 'Yes'.",
    "Could there be either a {} or a {}s? Yes or No and justify your "
    "answer.",
    "Regardless of whether it is basic or redundant, is the relation '{}' "
    "incorrect and is a mis-classification in scene graph generation? Show "
    "your reasoning and answer 'Yes' or 'No'.",
    "Is the relation {} impossible in real world? Answer 'Yes' or 'No' and "
    "explain your answer.",
]


def build_prompts(edges: Sequence[str]) -> List[str]:
    prompts = []
    for edge in edges:
        for i, variation in enumerate(PROMPT_VARIATIONS):
            if i == 1:
                prompts.append(variation.format(edge, edge))
            else:
                prompts.append(variation.format(edge))
    return prompts


def majority_vote(completions: Sequence[str], num_edges: int) -> List[int]:
    """Weighted vote over the 4 paraphrases per edge -> +1 / -1 (reference
    query_llm.py:121-157): prompt 0 counts double; prompts 2 and 3 are
    negated.  A non-answer counts AGAINST the edge on every prompt
    (reference parity: the else branches at query_llm.py:136/146 both
    increment no_votes)."""
    votes = []
    k = len(PROMPT_VARIATIONS)
    for i in range(num_edges):
        yes, no = 0, 0
        for j in range(k):
            text = completions[i * k + j]
            if j in (2, 3):                 # reversed polarity
                if re.search(r"Yes", text):
                    no += 1
                elif re.search(r"No", text):
                    yes += 1
                else:
                    no += 1
            else:
                weight = 2 if j == 0 else 1
                if re.search(r"Yes", text):
                    yes += weight
                else:
                    no += weight
        votes.append(1 if yes > no else -1)
    return votes


def openai_completion_transport(model: str = "gpt-3.5-turbo-instruct",
                                key_path: str = "openai_key.txt"):
    """Default network transport (requires an API key and egress)."""

    def transport(prompts: List[str]) -> List[str]:
        import requests
        key = os.environ.get("OPENAI_API_KEY")
        if key is None and os.path.exists(key_path):
            with open(key_path) as f:
                key = f.read().strip()
        if key is None:
            raise RuntimeError("no OpenAI API key configured")
        resp = requests.post(
            "https://api.openai.com/v1/completions",
            headers={"Authorization": f"Bearer {key}"},
            json={"model": model, "prompt": prompts, "temperature": 0,
                  "max_tokens": 100}, timeout=120)
        choices = resp.json()["choices"]
        ordered = sorted(choices, key=lambda c: c.get("index", 0))
        return [c.get("text", "") for c in ordered]

    return transport


def batch_query_edges(edges: Sequence[str], cache: EdgeCache,
                      transport: Callable[[List[str]], List[str]],
                      batch_size: int = 4, reuse_prob: float = 0.9,
                      rng=None) -> Tuple[List[int], int]:
    """Text-only validation with probabilistic cache reuse (reference
    query_llm.py:50-87).  Returns (votes per edge, cache hits)."""
    responses: List[Optional[int]] = [None] * len(edges)
    cache_hits = 0
    to_query, query_slots = [], []
    for i, edge in enumerate(edges):
        cached = probabilistic_cache_lookup(cache, edge, reuse_prob, rng)
        if cached is not None:
            responses[i] = cached
            cache_hits += 1
        else:
            to_query.append(edge)
            query_slots.append(i)

    for start in range(0, len(to_query), batch_size):
        chunk = to_query[start:start + batch_size]
        completions = transport(build_prompts(chunk))
        votes = majority_vote(completions, len(chunk))
        for off, vote in enumerate(votes):
            idx = query_slots[start + off]
            responses[idx] = vote
            cache.put(edges[idx], vote)
    return [int(r) for r in responses], cache_hits


IMAGE_MARKER = "\n<image-b64>"


def openai_vision_transport(model: str = "gpt-4-vision-preview",
                            key_path: str = "openai_key.txt"):
    """Vision transport: prompts carry the base64 crop after IMAGE_MARKER
    (see build_vision_prompt); the marker is split off and posted as a
    proper image content part to the chat-completions API."""

    def transport(prompts: List[str]) -> List[str]:
        import requests
        key = os.environ.get("OPENAI_API_KEY")
        if key is None and os.path.exists(key_path):
            with open(key_path) as f:
                key = f.read().strip()
        if key is None:
            raise RuntimeError("no OpenAI API key configured")
        out = []
        for p in prompts:
            text, _, b64 = p.partition(IMAGE_MARKER)
            content = [{"type": "text", "text": text}]
            if b64:
                content.append({"type": "image_url", "image_url": {
                    "url": f"data:image/jpeg;base64,{b64}"}})
            resp = requests.post(
                "https://api.openai.com/v1/chat/completions",
                headers={"Authorization": f"Bearer {key}"},
                json={"model": model, "temperature": 0, "max_tokens": 300,
                      "messages": [{"role": "user", "content": content}]},
                timeout=120)
            out.append(resp.json()["choices"][0]["message"]["content"])
        return out

    return transport


def build_vision_prompt(edge: str, b64: str) -> str:
    """One CoT yes/no prompt (reference query_llm.py:228-233) carrying the
    FULL base64 crop after IMAGE_MARKER; vision transports split it off
    and attach it as an image part, mock transports just see the text."""
    return (f"Does the image contain a relation '{edge}'? Let us think "
            f"about it step by step and answer with Yes or No in the end."
            f"{IMAGE_MARKER}{b64}")


def query_edges_vision(edges: Sequence[str], image_path: str,
                       sub_boxes, obj_boxes, image_cache: ImageCache,
                       transport: Callable[[List[str]], List[str]]
                       ) -> Optional[List[int]]:
    """GPT-4V path: one CoT yes/no query per edge over the union-box crop
    (reference query_llm.py:193-257).  Returns None when the image file is
    missing — callers must NOT persist artifacts for it (a silently
    all-negative vote would poison the triplet tables and, with resume,
    stick forever)."""
    return query_edges_vision_concurrent(
        [(edges, image_path, sub_boxes, obj_boxes)], image_cache,
        transport, max_workers=1)[0]


def build_vision_prompts(edges, image_path, sub_boxes, obj_boxes,
                         image_cache: ImageCache) -> List[str]:
    """Crop + encode (ImageCache mutation stays in the calling thread) and
    render one prompt per edge."""
    import numpy as np
    import torch

    from scene_graph_commonsense_torch.ops.boxes import union_box
    # grid boxes -> resized-image coordinates.  Documented deviation: the
    # reference multiplies by feature_size (query_llm.py:212-213), which
    # is correct only when image_size == feature_size**2 (1024 == 32**2 at
    # its defaults); the general factor is image_size / feature_size.
    scale = image_cache.image_size / image_cache.feature_size
    prompts = []
    for edge, sb, ob in zip(edges, sub_boxes, obj_boxes):
        # float32, as the JAX package computes it (jnp without x64)
        ub = union_box(
            torch.as_tensor(np.asarray(sb) * scale, dtype=torch.float32),
            torch.as_tensor(np.asarray(ob) * scale, dtype=torch.float32)
        ).numpy()
        b64 = image_cache.get_image(image_path, bbox=ub.tolist())
        prompts.append(build_vision_prompt(edge, b64))
    return prompts


def parse_vision_vote(text: str) -> int:
    return 1 if re.search(r"\bYes\b", text, re.IGNORECASE) else -1


def query_edges_vision_concurrent(
        per_image: Sequence[Tuple[Sequence[str], str, Any, Any]],
        image_cache: ImageCache,
        transport: Callable[[List[str]], List[str]],
        max_workers: int = 8) -> List[Optional[List[int]]]:
    """Vision validation for several images with the transport calls
    fanned out across worker threads (same structure as
    batch_query_edges_concurrent: ImageCache crops/encodes in the calling
    thread, workers run only the pure transport).  per_image entries are
    (edges, image_path, sub_boxes, obj_boxes); missing images yield
    None."""
    from concurrent.futures import ThreadPoolExecutor

    tasks = []          # (result index, prompts)
    results: List[Optional[List[int]]] = []
    for edges, image_path, sub_boxes, obj_boxes in per_image:
        if not os.path.exists(image_path):
            results.append(None)
            continue
        results.append([])   # placeholder, filled below
        tasks.append((len(results) - 1, build_vision_prompts(
            edges, image_path, sub_boxes, obj_boxes, image_cache)))
    if tasks:
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            votes = list(pool.map(lambda t: transport(t[1]), tasks))
        for (idx, _), texts in zip(tasks, votes):
            results[idx] = [parse_vision_vote(t) for t in texts]
    return results


def batch_query_edges_concurrent(
        edge_lists: Sequence[Sequence[str]], cache: EdgeCache,
        transport: Callable[[List[str]], List[str]],
        batch_size: int = 4, reuse_prob: float = 0.9, rng=None,
        max_workers: int = 8) -> List[Tuple[List[int], int]]:
    """Validates several images' edge lists with the network fan-out the
    reference gets from its ThreadPoolExecutor (reference
    evaluator.py:450-456) but without its data race: cache probes and
    insertions run in the calling thread, and worker threads execute only
    the pure `transport(prompts) -> completions` calls.  Semantically
    identical to calling batch_query_edges per list (same cache-probe
    order, same votes); only the network waits overlap.

    An edge repeated across (or within) the lists is dispatched ONCE and
    its vote shared — the in-flight analogue of the sequential path, where
    the first occurrence's cached vote serves the later ones; shared
    occurrences count as cache hits.  (The one remaining deviation from
    strict per-list sequencing: the sequential path re-queries duplicates
    with probability 1-reuse_prob; the fan-out never does.)

    Returns one (votes, cache_hits) pair per edge list.
    """
    from concurrent.futures import ThreadPoolExecutor

    # phase 1 (calling thread): probabilistic cache probes + in-flight
    # dedup
    responses: List[List[Optional[int]]] = []
    hits: List[int] = []
    pending: Dict[str, List[Tuple[int, int]]] = {}
    order: List[str] = []
    for li, edges in enumerate(edge_lists):
        resp: List[Optional[int]] = [None] * len(edges)
        hit = 0
        for i, edge in enumerate(edges):
            if edge in pending:
                pending[edge].append((li, i))
                hit += 1
                continue
            cached = probabilistic_cache_lookup(cache, edge, reuse_prob,
                                                rng)
            if cached is not None:
                resp[i] = cached
                hit += 1
            else:
                pending[edge] = [(li, i)]
                order.append(edge)
        responses.append(resp)
        hits.append(hit)

    chunks = [order[start:start + batch_size]
              for start in range(0, len(order), batch_size)]

    # phase 2 (worker threads): pure transport calls only
    if chunks:
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            completions = list(pool.map(
                lambda c: transport(build_prompts(c)), chunks))
    else:
        completions = []

    # phase 3 (calling thread): votes + cache insertion + slot fill
    for chunk, comps in zip(chunks, completions):
        votes = majority_vote(comps, len(chunk))
        for edge, vote in zip(chunk, votes):
            cache.put(edge, vote)
            for li, slot in pending[edge]:
                responses[li][slot] = vote
    return [([int(r) for r in resp], hit)
            for resp, hit in zip(responses, hits)]
