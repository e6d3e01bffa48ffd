"""Checkpointing: per-leaf npy blobs (zstd-compressed or raw) + a manifest
with integrity hashes, and an async background writer.

The graph engine checkpoints at global-iteration boundaries (paper §5.3).
The format is the reference's (``repro.checkpoint.ckpt``), leaf for leaf:
a tree of dataclasses, dicts, tuples and tensors flattens as
``jax.tree_util`` flattens the reference's — dataclass fields in field
order, named ``.field``; dict keys sorted; tuple positions as bare
indices; static dataclass fields skipped — so the manifest names match
(``.state/dist``, ``.pending/dist/0/0``, ``.counters/.iterations``, …),
and dtypes are recorded by their numpy names.  A checkpoint the reference
wrote reads back here, and the reverse; only the port's counters are
int64 where the reference's are int32 (see ``repro_torch.convert``).

Blobs are zstd-compressed when the optional ``zstandard`` package is
present, raw ``.npy`` bytes otherwise; the manifest records the codec so a
checkpoint written either way restores anywhere the codec is available.
Every structural problem — missing/torn manifest, leaf-count mismatch,
per-leaf name/shape/dtype disagreement with the restoring tree, blob hash
corruption — raises :class:`CheckpointError` (an ``IOError``), never a bare
``assert`` (which ``python -O`` strips) and never a silently transposed
restore.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import queue
import shutil
import threading
from typing import Any

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

try:                               # optional: raw codec works without it
    import zstandard as zstd
except ImportError:                # pragma: no cover - env without zstandard
    zstd = None

from repro_torch.device import resolve_device
from repro_torch.obs import clock as obs_clock

Tree = Any

__all__ = ["CheckpointError", "save_checkpoint", "load_checkpoint",
           "load_checkpoint_arrays", "read_manifest", "AsyncCheckpointer",
           "latest_checkpoint", "checkpoint_bytes"]


class CheckpointError(IOError):
    """A checkpoint directory failed validation (torn write, corrupt blob,
    or a restore into a tree whose structure does not match the manifest)."""


def _default_codec() -> str:
    return "zstd" if zstd is not None else "raw"


def _encode(raw: bytes, codec: str) -> bytes:
    if codec == "zstd":
        if zstd is None:
            raise CheckpointError(
                "codec 'zstd' needs the optional 'zstandard' package "
                "(pip install zstandard, see requirements.txt)")
        return zstd.ZstdCompressor(level=3).compress(raw)
    if codec == "raw":
        return raw
    raise CheckpointError(f"unknown checkpoint codec {codec!r}")


def _decode(blob: bytes, codec: str) -> bytes:
    if codec == "zstd":
        if zstd is None:
            raise CheckpointError(
                "checkpoint was written with codec 'zstd'; restoring needs "
                "the optional 'zstandard' package")
        return zstd.ZstdDecompressor().decompress(blob)
    if codec == "raw":
        return blob
    raise CheckpointError(f"unknown checkpoint codec {codec!r}")


def _data_fields(obj) -> list[str]:
    """A dataclass's pytree children: its fields, static ones left out."""
    return [f.name for f in dataclasses.fields(obj)
            if not f.metadata.get("static")]


def _flatten_with_names(tree: Tree, path: tuple = (),
                        is_leaf=None) -> list[tuple[str, Any]]:
    """``(name, leaf)`` pairs in ``jax.tree_util``'s order and naming (see
    the module docstring); ``None`` holds no leaf."""
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [("/".join(path), tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [pair for name in _data_fields(tree)
                for pair in _flatten_with_names(getattr(tree, name),
                                                path + ("." + name,), is_leaf)]
    if isinstance(tree, Mapping):
        return [pair for k in sorted(tree)
                for pair in _flatten_with_names(tree[k], path + (str(k),),
                                                is_leaf)]
    if isinstance(tree, (tuple, list)):
        return [pair for i, v in enumerate(tree)
                for pair in _flatten_with_names(v, path + (str(i),), is_leaf)]
    return [("/".join(path), tree)]


def _leaf_path_names(tree: Tree) -> list[str]:
    """The manifest names of ``tree``'s leaves, in order."""
    return [name for name, _ in _flatten_with_names(tree)]


def _unflatten(template: Tree, leaves) -> Tree:
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if template is None:
        return None
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            name: _unflatten(getattr(template, name), leaves)
            for name in _data_fields(template)})
    if isinstance(template, Mapping):
        done = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: done[k] for k in template}
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array that is a copy, never a view of the
    live state: ``.cpu()`` of a CPU tensor and ``np.asarray`` of an array
    return the object itself, so those are copied."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        return (leaf.clone() if leaf.device.type == "cpu"
                else leaf.cpu()).numpy()
    return np.array(leaf)


def _np_dtype(leaf) -> np.dtype:
    """A leaf's dtype under its numpy name (``int64``, not
    ``torch.int64``): what manifests record."""
    if isinstance(leaf, torch.Tensor):
        return torch.empty(0, dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def read_manifest(path: str) -> dict:
    """Load + validate a checkpoint manifest; :class:`CheckpointError` on a
    missing or torn file."""
    mpath = os.path.join(path, "manifest.json")
    if not os.path.exists(mpath):
        raise CheckpointError(f"{path}: no manifest.json (torn write?)")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointError(f"{mpath}: corrupt or truncated json "
                              f"({e})") from None
    if not isinstance(manifest, dict) or "leaves" not in manifest:
        raise CheckpointError(f"{mpath}: not a checkpoint manifest")
    return manifest


def save_checkpoint(path: str, tree: Tree, step: int,
                    extra_meta: dict | None = None,
                    codec: str | None = None) -> None:
    """Write ``tree`` (tensors on any device, numpy arrays, scalars) as
    one checkpoint directory; the manifest is renamed into place last."""
    _write(path, [(name, _host(leaf))
                  for name, leaf in _flatten_with_names(tree)], step,
           extra_meta, codec or _default_codec())


def _write(path: str, named: list[tuple[str, np.ndarray]], step: int,
           extra_meta: dict | None, codec: str) -> None:
    os.makedirs(path, exist_ok=True)
    ext = ".npy.zst" if codec == "zstd" else ".npy"
    manifest = {"step": int(step), "codec": codec, "leaves": [],
                "meta": extra_meta or {}}
    for i, (name, arr) in enumerate(named):
        buf = io.BytesIO()
        np.save(buf, arr, allow_pickle=False)
        blob = _encode(buf.getvalue(), codec)
        fn = f"leaf_{i:05d}{ext}"
        with open(os.path.join(path, fn), "wb") as f:
            f.write(blob)
        manifest["leaves"].append({
            "name": name, "file": fn, "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "sha256": hashlib.sha256(blob).hexdigest(),
        })
    tmp = os.path.join(path, "manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(path, "manifest.json"))   # atomic commit


def _read_leaf(path: str, rec: dict, codec: str, verify: bool) -> np.ndarray:
    full = os.path.join(path, rec["file"])
    if not os.path.exists(full):
        raise CheckpointError(f"{full}: leaf blob missing")
    with open(full, "rb") as f:
        blob = f.read()
    if verify:
        h = hashlib.sha256(blob).hexdigest()
        if h != rec["sha256"]:
            raise CheckpointError(f"checkpoint corruption in {rec['file']}")
    arr = np.load(io.BytesIO(_decode(blob, codec)), allow_pickle=False)
    if list(arr.shape) != list(rec["shape"]) or str(arr.dtype) != rec["dtype"]:
        raise CheckpointError(
            f"{full}: decoded {arr.dtype}{arr.shape}, manifest says "
            f"{rec['dtype']}{tuple(rec['shape'])}")
    return arr


def load_checkpoint(path: str, tree_like: Tree, device=None,
                    verify: bool = True,
                    shardings: Tree | None = None) -> tuple[Tree, int]:
    """Restore into the structure of ``tree_like``.  Where ``tree_like``
    holds a tensor the restored leaf is a tensor, on ``device`` when one
    is given and else on that tensor's own device (a DTensor's: its
    shard's); other leaves come back as numpy arrays.

    ``shardings`` (the structure of ``tree_like``, a
    ``sharding.util.NamedSharding`` at each leaf to place, e.g. from
    ``named(specs, mesh)``) restores those leaves as DTensors holding this
    rank's shard, on any mesh, whatever world size wrote the checkpoint
    (the reference's elastic restore).

    Every leaf is validated against the manifest — path name, shape and
    dtype — so restoring into a mismatched tree (renamed field, transposed
    axes, wrong dtype) raises :class:`CheckpointError` instead of silently
    pouring bytes into the wrong slots.
    """
    manifest = read_manifest(path)
    codec = manifest.get("codec", "zstd")
    named = _flatten_with_names(tree_like)
    placed = {}
    if shardings is not None:
        from repro_torch.sharding.util import NamedSharding
        placed = dict(_flatten_with_names(
            shardings, is_leaf=lambda x: isinstance(x, NamedSharding)))
    if device is not None:
        device = resolve_device(device)
    if len(named) != len(manifest["leaves"]):
        raise CheckpointError(
            f"{path}: checkpoint has {len(manifest['leaves'])} leaves, "
            f"restoring tree has {len(named)}")
    out = []
    for (name, leaf), rec in zip(named, manifest["leaves"]):
        if rec["name"] != name:
            raise CheckpointError(
                f"{path}: leaf {rec['file']} is {rec['name']!r} in the "
                f"manifest but {name!r} in the restoring tree")
        shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
        dtype = str(_np_dtype(leaf))
        if tuple(rec["shape"]) != shape or rec["dtype"] != dtype:
            raise CheckpointError(
                f"{path}: leaf {name!r} is {rec['dtype']}"
                f"{tuple(rec['shape'])} on disk but {dtype}{shape} in the "
                f"restoring tree")
        arr = _read_leaf(path, rec, codec, verify)
        if isinstance(leaf, torch.Tensor):
            from repro_torch.sharding.fsdp import local_of
            dev = device if device is not None else local_of(leaf).device
            if name in placed:
                from repro_torch.sharding.util import place
                arr = place(_tensor(arr, "cpu"), placed[name], dev)
            else:
                arr = _tensor(arr, dev)
        out.append(arr)
    return _unflatten(tree_like, iter(out)), manifest["step"]


def _tensor(arr: np.ndarray, device) -> torch.Tensor:
    """A decoded leaf as a tensor on ``device`` (decoded arrays may be
    read-only views of the blob: those are copied once)."""
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def load_checkpoint_arrays(path: str, verify: bool = True
                           ) -> tuple[dict[str, np.ndarray], dict]:
    """Raw restore: every leaf as ``{manifest name: np.ndarray}`` plus the
    manifest, with no target tree.  The elastic paths use this to re-shard a
    checkpoint written under a *different* partitioning, where no
    same-shaped ``tree_like`` exists."""
    manifest = read_manifest(path)
    codec = manifest.get("codec", "zstd")
    arrs = {rec["name"]: _read_leaf(path, rec, codec, verify)
            for rec in manifest["leaves"]}
    return arrs, manifest


def checkpoint_bytes(path: str) -> int:
    """Total on-disk bytes of one checkpoint directory (blobs + manifest) —
    the recovery path's 'bytes read' metric."""
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path)
               if os.path.isfile(os.path.join(path, f)))


class AsyncCheckpointer:
    """Background writer: snapshot to host (in the calling thread: the
    device-to-host copy of every leaf), then encode, hash and write
    off-thread; keeps the last ``keep`` checkpoints.

    A failure in the background writer is surfaced on the *next* ``save()``
    or ``wait()`` call (the step loop must find out, not a daemon thread's
    stderr).  ``wait()`` blocks until every queued checkpoint is durable —
    the recovery path calls it before trusting ``latest_checkpoint``."""

    def __init__(self, base: str, keep: int = 3, codec: str | None = None):
        self.base = base
        self.keep = keep
        self.codec = codec or _default_codec()
        _encode(b"", self.codec)   # fail on the caller thread, not the worker
        self.q: queue.Queue = queue.Queue(maxsize=2)
        self._err: Exception | None = None
        self.bytes_written = 0
        self.written = 0           # checkpoints made durable
        self.save_seconds = 0.0    # snapshot time billed to the step loop
        self.write_seconds = 0.0   # encode + hash + write, off-thread
        self.t = threading.Thread(target=self._worker, daemon=True)
        self.t.start()

    def _worker(self):
        while True:
            item = self.q.get()
            try:
                if item is None:
                    return
                step, named, meta = item
                path = os.path.join(self.base, f"step_{step:08d}")
                t0 = obs_clock.perf_counter()
                _write(path, named, step, meta, self.codec)
                self.write_seconds += obs_clock.perf_counter() - t0
                self.bytes_written += checkpoint_bytes(path)
                self.written += 1
                self._gc()
            except Exception as e:       # surfaced on next save()/wait()
                self._err = e
            finally:
                self.q.task_done()       # wait() joins on this

    def _gc(self):
        if not os.path.isdir(self.base):
            return
        ckpts = sorted(d for d in os.listdir(self.base)
                       if d.startswith("step_"))
        for d in ckpts[:-self.keep]:
            shutil.rmtree(os.path.join(self.base, d), ignore_errors=True)

    def _raise_pending(self):
        if self._err:
            err, self._err = self._err, None
            raise err

    def save(self, step: int, tree: Tree, meta: dict | None = None):
        self._raise_pending()
        t0 = obs_clock.perf_counter()
        named = [(name, _host(leaf))                        # snapshot
                 for name, leaf in _flatten_with_names(tree)]
        self.save_seconds += obs_clock.perf_counter() - t0
        self.q.put((int(step), named, meta))

    def wait(self):
        self.q.join()
        self._raise_pending()

    def close(self):
        self.q.put(None)
        self.t.join(timeout=30)


def latest_checkpoint(base: str) -> str | None:
    """Newest complete checkpoint under ``base`` — a directory whose
    ``manifest.json`` exists (the manifest is renamed into place *after*
    every blob, so its presence certifies the write committed; a torn
    directory is skipped, falling back to the previous step)."""
    if not os.path.isdir(base):
        return None
    ckpts = sorted(d for d in os.listdir(base) if d.startswith("step_")
                   and os.path.exists(os.path.join(base, d, "manifest.json")))
    return os.path.join(base, ckpts[-1]) if ckpts else None
