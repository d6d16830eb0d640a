"""Native (C++) batch packer of the input pipeline, loaded with ctypes (the
port's copy of scene_graph_commonsense_tpu/data/native).

`write_sgrec` serializes one image's annotation to the flat SGRC binary
format (byte for byte the JAX package's writer); `NativeBatchPacker` packs
padded batches from such records with the C++ thread pool of `sgc_pack.cc`,
replacing the per-image Python work (the lower-triangular -> directed grid
expansion is O(N^2) per image; the training view's colour jitter and resize
are per pixel).

The library is built by g++ at first use, never at import, into
`scene_graph_commonsense_torch/_build/`, keyed by a hash of the source and
the flags; the build writes a temporary file and moves it into place, so
several processes may build at once.  A failed build raises: nothing falls
back to the Python loader silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from scene_graph_commonsense_torch.ops._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "sgc_pack.cc"
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")

MAGIC = 0x43524753


def write_sgrec(path: str, cats: np.ndarray, boxes: np.ndarray,
                super_mh: np.ndarray, relationships: Sequence[np.ndarray],
                subj_or_obj: Sequence[np.ndarray], depth: np.ndarray,
                feature_size: int = 32, num_super: int = 17,
                image: Optional[np.ndarray] = None) -> None:
    """Serializes one image's annotation to the SGRC binary format.

    With `image` (an (H, W, 3) uint8 raw RGB array) the record is written
    as v2, carrying the pixels the training path needs for the per-epoch
    contrastive view (the jittered square view is computed by the C++
    packer at batch-assembly time, sgc_pack.cc)."""
    n = len(cats)
    tri = n * (n - 1) // 2
    rel_lower = np.concatenate(
        [np.asarray(r, np.int32) for r in relationships]) \
        if n > 1 else np.zeros(0, np.int32)
    dir_lower = np.concatenate(
        [np.asarray(d, np.float32) for d in subj_or_obj]) \
        if n > 1 else np.zeros(0, np.float32)
    if len(rel_lower) != tri or len(dir_lower) != tri:
        raise ValueError(f"relationships / subj_or_obj hold "
                         f"{len(rel_lower)} / {len(dir_lower)} entries, "
                         f"want {tri} for {n} objects")
    depth_flat = np.asarray(depth, np.float32).reshape(-1)
    if depth_flat.size != feature_size * feature_size:
        # a short write would misalign every following field
        raise ValueError(f"depth has {depth_flat.size} values, want "
                         f"{feature_size}^2")
    if image is not None:
        image = np.ascontiguousarray(image)
        if image.dtype != np.uint8 or image.ndim != 3 \
                or image.shape[2] != 3:
            raise ValueError(f"image must be (H, W, 3) uint8, got "
                             f"{image.dtype} {image.shape}")
    version = 1 if image is None else 2
    header = np.asarray([MAGIC, version, n, feature_size, num_super],
                        np.int32)
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(depth_flat.tobytes())
        f.write(np.asarray(cats, np.int32).tobytes())
        f.write(np.asarray(boxes, np.float32).reshape(n, 4).tobytes())
        f.write(np.asarray(super_mh, np.uint8).reshape(n,
                                                       num_super).tobytes())
        f.write(rel_lower.tobytes())
        f.write(dir_lower.tobytes())
        if image is not None:
            f.write(np.asarray(image.shape[:2], np.int32).tobytes())
            f.write(image.tobytes())


def library_path() -> Path:
    key = hashlib.sha256(SRC.read_bytes()
                         + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libsgc_pack_{key[:16]}.so"


def build_library() -> Path:
    """Compiles sgc_pack.cc with g++ unless this source's library is built;
    returns its path.  Raises RuntimeError when g++ is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("could not build libsgc_pack.so: g++ not "
                           "found") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SRC.name}:\n{proc.stderr}")
    os.replace(tmp, out)      # atomic: a concurrent build sees all or none
    return out


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


class NativeBatchPacker:
    """ctypes wrapper over sgc_pack_batch and sgc_pack_train_batch."""

    def __init__(self, max_objects: int = 20, feature_size: int = 32,
                 num_super: int = 17, num_threads: int = 8):
        self.lib = ctypes.CDLL(str(build_library()))
        i32, f32, u8 = (ctypes.POINTER(ctypes.c_int32),
                        ctypes.POINTER(ctypes.c_float),
                        ctypes.POINTER(ctypes.c_uint8))
        paths, cint = ctypes.POINTER(ctypes.c_char_p), ctypes.c_int
        self.lib.sgc_pack_batch.restype = cint
        self.lib.sgc_pack_batch.argtypes = [
            paths, cint, cint, cint, cint, i32, f32, i32, u8, f32, f32, u8,
            cint]
        self.lib.sgc_pack_train_batch.restype = cint
        self.lib.sgc_pack_train_batch.argtypes = [
            paths, cint, cint, cint, cint, cint, f32, i32, f32, i32, u8,
            f32, f32, f32, f32, u8, cint]
        self.n = max_objects
        self.s = feature_size
        self.k = num_super
        self.num_threads = num_threads

    def _buffers(self, b: int) -> Dict[str, np.ndarray]:
        n, s, k = self.n, self.s, self.k
        return {"cats": np.zeros((b, n), np.int32),
                "boxes": np.zeros((b, n, 4), np.float32),
                "rel": np.zeros((b, n, n), np.int32),
                "valid": np.zeros((b, n), np.uint8),
                "super_mh": np.zeros((b, n, k), np.float32),
                "depth": np.zeros((b, s, s), np.float32),
                "ok": np.zeros(b, np.uint8)}

    @staticmethod
    def _result(buf: Dict[str, np.ndarray], packed: int) -> Dict:
        out = dict(buf)
        out["valid"] = buf["valid"].astype(bool)
        out["depth"] = buf["depth"][..., None]
        out["ok"] = buf["ok"].astype(bool)
        out["num_packed"] = packed
        return out

    def pack(self, paths: Sequence[str]) -> Dict[str, np.ndarray]:
        """Annotation-only batch (v1 or v2 records): padded cats, boxes,
        rel, valid, super_mh and depth, with `ok` per slot (records with
        fewer than 2 or more than max_objects objects, unreadable or
        missing files leave their slot invalid) and `num_packed`."""
        b = len(paths)
        buf = self._buffers(b)
        c_paths = (ctypes.c_char_p * b)(*[p.encode() for p in paths])
        packed = self.lib.sgc_pack_batch(
            c_paths, b, self.n, self.s, self.k,
            _ptr(buf["cats"], ctypes.c_int32),
            _ptr(buf["boxes"], ctypes.c_float),
            _ptr(buf["rel"], ctypes.c_int32),
            _ptr(buf["valid"], ctypes.c_uint8),
            _ptr(buf["super_mh"], ctypes.c_float),
            _ptr(buf["depth"], ctypes.c_float),
            _ptr(buf["ok"], ctypes.c_uint8), self.num_threads)
        if packed < 0:
            raise RuntimeError("sgc_pack_batch failed")
        return self._result(buf, packed)

    def pack_train(self, paths: Sequence[str], jitter: np.ndarray,
                   image_size: int,
                   want_plain: bool = False) -> Dict[str, np.ndarray]:
        """Training batch from v2 records: the annotation payload of `pack`
        plus the jittered contrastive square view 'image_aug' (and the
        plain square view 'image' when want_plain; skip it when features
        come from the cache).  `jitter` is the (B, 9) float32 matrix of
        [apply, order[4], factors[4]] rows from
        data.dataset.color_jitter_params.  v1 records are rejected."""
        b = len(paths)
        jitter = np.ascontiguousarray(jitter, np.float32)
        if jitter.shape != (b, 9):
            raise ValueError(f"jitter must be ({b}, 9), got {jitter.shape}")
        if image_size <= 0:
            raise ValueError(f"image_size must be positive: {image_size}")
        buf = self._buffers(b)
        aug = np.zeros((b, image_size, image_size, 3), np.float32)
        plain = (np.zeros((b, image_size, image_size, 3), np.float32)
                 if want_plain else None)
        c_paths = (ctypes.c_char_p * b)(*[p.encode() for p in paths])
        packed = self.lib.sgc_pack_train_batch(
            c_paths, b, self.n, self.s, self.k, image_size,
            _ptr(jitter, ctypes.c_float),
            _ptr(buf["cats"], ctypes.c_int32),
            _ptr(buf["boxes"], ctypes.c_float),
            _ptr(buf["rel"], ctypes.c_int32),
            _ptr(buf["valid"], ctypes.c_uint8),
            _ptr(buf["super_mh"], ctypes.c_float),
            _ptr(buf["depth"], ctypes.c_float),
            _ptr(aug, ctypes.c_float),
            _ptr(plain, ctypes.c_float) if plain is not None
            else ctypes.cast(None, ctypes.POINTER(ctypes.c_float)),
            _ptr(buf["ok"], ctypes.c_uint8), self.num_threads)
        if packed < 0:
            raise RuntimeError("sgc_pack_train_batch failed")
        out = self._result(buf, packed)
        out["image_aug"] = aug
        if plain is not None:
            out["image"] = plain
        return out
