"""Sharded, atomic, async checkpointing with restore-time resizing.

Counterpart of ``repro.checkpoint.manager``, with its on-disk format, so
a checkpoint written by either package restores through the other:

    <dir>/step_00000042/  leaf_00000.bin ... manifest.json

Leaves are numbered in the tree's leaf order (``repro_torch.tree``:
sorted dict keys, sequence items in order — the reference's pytree
order).  A leaf is its raw bytes in C order; the manifest names its
dtype the way numpy does ("float32", "bfloat16", "int32").  A
``ShardedTensor`` leaf saved with ``sharded=True`` is written per shard
(``leaf_00000.shard_000.bin ...``) with a manifest shard map of global
indices, so no rank's piece is gathered into the whole leaf; restore
assembles it by global index.  Writes go to ``step_X.tmp``, which is
renamed only after its files and the manifest are fsynced, and the
parent directory is fsynced after the rename: a killed run never leaves
a half checkpoint visible.

An async save copies every leaf to host memory on the caller's thread (a
consistent cut: the caller may go on changing its tensors in place) and
writes the files on a background thread.

Restore returns tensors on the device asked for.  ``allow_resize_1d``
truncates or zero-pads a 1-D leaf whose saved length differs from the
expected one: ZeRO optimizer leaves are [values, trailing zeros] padded
to a multiple of the data-parallel width, so they move exactly onto
another width.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.tree import flatten, unflatten

_DTYPES = {str(d).rsplit(".", 1)[-1]: d
           for d in (torch.float32, torch.float64, torch.float16,
                     torch.bfloat16, torch.int8, torch.uint8, torch.int16,
                     torch.int32, torch.int64, torch.bool)}


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype: what the manifest stores."""
    return str(dtype).rsplit(".", 1)[-1]


Bounds = List[List[int]]     # [[lo, hi], ...] per dimension


@dataclasses.dataclass
class ShardedTensor:
    """A global tensor held as pieces: ``shards`` are ``(bounds, piece)``
    pairs, ``bounds`` the piece's global index, ``[[lo, hi], ...]`` per
    dimension.  What a ZeRO optimizer leaf is across the thread ranks of
    one run (each rank's chunk of the flat padded leaf)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    shards: List[Tuple[Bounds, torch.Tensor]]

    def dense(self, device=None) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.dtype, device=device)
        for bounds, piece in self.shards:
            out[tuple(slice(lo, hi) for lo, hi in bounds)] = piece.to(
                out.device)
        return out


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy the caller can no longer change."""
    return t.detach().to("cpu", copy=True).contiguous()


def _to_bytes(t: torch.Tensor) -> bytes:
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _from_bytes(buf: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype not in _DTYPES:
        raise ValueError(f"checkpoint dtype {dtype!r} has no torch dtype")
    dt = _DTYPES[dtype]
    if not buf:
        return torch.empty(tuple(shape), dtype=dt)
    return torch.frombuffer(bytearray(buf), dtype=dt).reshape(tuple(shape))


def _dir_fsync(path: str) -> None:
    """fsync a directory so a rename into it survives a crash."""
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _snapshot_leaf(leaf, sharded: bool):
    """Host snapshot of one leaf: per shard when asked and the leaf is a
    ``ShardedTensor`` (distinct shards only), else dense."""
    if isinstance(leaf, ShardedTensor):
        if sharded:
            seen = {}
            for bounds, piece in leaf.shards:
                key = tuple(tuple(b) for b in bounds)
                if key not in seen:
                    seen[key] = ([list(b) for b in bounds], _host(piece))
            return ShardedTensor(tuple(leaf.shape), leaf.dtype,
                                 [seen[k] for k in sorted(seen)])
        return _host(leaf.dense())
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.as_tensor(leaf)
    return _host(leaf)


def save_checkpoint(directory: str, step: int, tree: Any,
                    async_: bool = False,
                    meta: Optional[dict] = None,
                    sharded: bool = False,
                    on_complete: Optional[Any] = None
                    ) -> "Optional[threading.Thread]":
    """Write ``tree`` as checkpoint ``step``.  With ``async_=True`` the
    files are written on a returned daemon thread (already started); join
    it to be sure they are durable.  ``meta``: a JSON sidecar stored in
    the manifest.  ``sharded=True``: ``ShardedTensor`` leaves are written
    per shard.  ``on_complete`` runs once the rename is durable."""
    os.makedirs(directory, exist_ok=True)
    leaves, _ = flatten(tree)
    host_leaves = [_snapshot_leaf(l, sharded) for l in leaves]

    def write():
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        def dump(fname, buf):
            with open(os.path.join(tmp, fname), "wb") as f:
                f.write(buf)
                f.flush()
                os.fsync(f.fileno())

        manifest = {"step": step, "num_leaves": len(host_leaves),
                    "treedef": "repro_torch.tree", "meta": meta or {},
                    "leaves": []}
        for i, leaf in enumerate(host_leaves):
            if isinstance(leaf, ShardedTensor):
                entry = {"dtype": dtype_name(leaf.dtype),
                         "shape": list(leaf.shape), "shards": []}
                for r, (bounds, piece) in enumerate(leaf.shards):
                    fname = f"leaf_{i:05d}.shard_{r:03d}.bin"
                    dump(fname, _to_bytes(piece))
                    entry["shards"].append({"file": fname, "index": bounds,
                                            "shape": list(piece.shape)})
            else:
                fname = f"leaf_{i:05d}.bin"
                dump(fname, _to_bytes(leaf))
                entry = {"file": fname, "dtype": dtype_name(leaf.dtype),
                         "shape": list(leaf.shape)}
            manifest["leaves"].append(entry)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)               # atomic publish...
        _dir_fsync(directory)               # ...durable once the parent
        if on_complete is not None:         # dirent is on disk
            on_complete()

    if async_:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                steps.append(int(name[5:]))
            except ValueError:
                pass
    return max(steps) if steps else None


def load_manifest(directory: str, step: Optional[int] = None) -> dict:
    """A checkpoint's manifest (with its ``meta`` sidecar), leaves
    untouched.  ``step=None`` reads the latest."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}", "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest.setdefault("meta", {})
    return manifest


def _bucket_layout_hint(abstract_tree: Any, abs_leaves,
                        leaves_meta) -> Optional[str]:
    """Name the two layouts when a compressed+bucketed run restores with
    another ``bucket_bytes``: its EF state is one flat f32 leaf per
    bucket, so the leaf count moves by the change in bucket count."""
    if not (isinstance(abstract_tree, dict)
            and isinstance(abstract_tree.get("ef"), (tuple, list))):
        return None
    expected_ef = list(abstract_tree["ef"])
    if not all(getattr(l, "ndim", None) == 1 for l in expected_ef):
        return None
    n_other = len(abs_leaves) - len(expected_ef)
    n_saved_ef = len(leaves_meta) - n_other
    if n_saved_ef < 0 or n_saved_ef == len(expected_ef):
        return None            # the mismatch is not (only) the EF state
    # "ef" sorts before "opt", "params" and "step": the checkpoint's EF
    # leaves are the leading ones.
    saved = leaves_meta[:n_saved_ef]
    if not all(m["dtype"] == "float32" and len(m["shape"]) == 1
               for m in saved):
        return None
    saved_sizes = [m["shape"][0] for m in saved]
    expected_sizes = [int(l.shape[0]) for l in expected_ef]
    return (f"compressed+bucketed EF state layout mismatch: the "
            f"checkpoint was saved with {n_saved_ef} gradient bucket(s) "
            f"of sizes {saved_sizes}, but this run plans "
            f"{len(expected_ef)} bucket(s) of sizes {expected_sizes}. "
            f"The bucket layout is determined by TrainCfg.bucket_bytes "
            f"(--bucket-bytes); restore with the value the run was saved "
            f"with, or start a fresh run")


def _read_leaf(path: str, meta: dict) -> Tuple[torch.Tensor, str]:
    if "shards" in meta:
        arr = torch.zeros(tuple(meta["shape"]), dtype=_DTYPES[meta["dtype"]])
        for sm in meta["shards"]:
            with open(os.path.join(path, sm["file"]), "rb") as f:
                piece = _from_bytes(f.read(), meta["dtype"], sm["shape"])
            arr[tuple(slice(lo, hi) for lo, hi in sm["index"])] = piece
        return arr, meta["shards"][0]["file"]
    with open(os.path.join(path, meta["file"]), "rb") as f:
        return (_from_bytes(f.read(), meta["dtype"], meta["shape"]),
                meta["file"])


def restore_checkpoint(directory: str, abstract_tree: Any,
                       step: Optional[int] = None, device="cpu",
                       allow_resize_1d: bool = False) -> Any:
    """Load a checkpoint into the structure of ``abstract_tree`` (tensors
    of any device, ``meta`` included: only shapes count), onto
    ``device``.  ``allow_resize_1d``: a 1-D saved leaf whose length
    differs from the 1-D expected one is truncated or zero-padded at the
    end instead of refused."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_meta = manifest["leaves"]
    abs_leaves, paths = flatten(abstract_tree)
    if len(abs_leaves) != len(leaves_meta):
        hint = _bucket_layout_hint(abstract_tree, abs_leaves, leaves_meta)
        raise ValueError(
            f"checkpoint has {len(leaves_meta)} leaves, expected "
            f"{len(abs_leaves)} — "
            + (hint if hint else "structure changed since save"))
    out = []
    for meta, ref in zip(leaves_meta, abs_leaves):
        arr, name = _read_leaf(path, meta)
        want = tuple(ref.shape)
        if tuple(arr.shape) != want:
            if allow_resize_1d and arr.ndim == 1 and len(want) == 1:
                n = want[0]
                if n <= arr.shape[0]:
                    arr = arr[:n]
                else:
                    arr = torch.cat([arr, arr.new_zeros(n - arr.shape[0])])
            else:
                raise ValueError(f"{name}: shape {tuple(arr.shape)} != "
                                 f"expected {want}")
        out.append(arr.to(device))
    return unflatten(paths, out)


class CheckpointManager:
    """Every-N-steps async checkpointing with retention.

    ``saves`` records each save's times on the host clock: ``wait_s``
    (the call waiting for the previous save, one being in flight at
    most), ``call_s`` (the rest of the call: the copy to host on the
    caller's thread) and ``durable_s`` (from the end of the wait until
    the rename is durable), with the wall times ``t0``, ``t_called`` and
    ``t_durable``."""

    def __init__(self, directory: str, every: int = 100, keep: int = 3,
                 async_: bool = True, sharded: bool = False):
        self.directory = directory
        self.every = every
        self.keep = keep
        self.async_ = async_
        self.sharded = sharded
        self._pending: Optional[threading.Thread] = None
        self.last_restore_seconds: float = 0.0
        self.saves: List[dict] = []

    def latest(self) -> Optional[int]:
        return latest_step(self.directory)

    def due(self, step: int) -> bool:
        """Is ``step`` one that ``maybe_save`` saves?"""
        return self.every > 0 and step % self.every == 0

    def maybe_save(self, step: int, tree: Any, force: bool = False) -> bool:
        if not (force or self.due(step)):
            return False
        t0 = time.perf_counter()
        self.wait()                          # one outstanding save at most
        t1 = time.perf_counter()
        record = {"step": step, "t0": t0, "wait_s": t1 - t0}

        def done():
            record["t_durable"] = time.perf_counter()
            record["durable_s"] = record["t_durable"] - t1
            # async: gc as soon as the writer publishes, so retention
            # never exceeds `keep` between rare saves
            if self.async_:
                self._gc()

        self._pending = save_checkpoint(self.directory, step, tree,
                                        async_=self.async_,
                                        sharded=self.sharded,
                                        on_complete=done)
        record["t_called"] = time.perf_counter()
        record["call_s"] = record["t_called"] - t1
        self.saves.append(record)
        if not self.async_:
            self._gc()
        return True

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
            self._gc()

    def _gc(self) -> None:
        if not os.path.isdir(self.directory):
            return
        steps = []
        for n in os.listdir(self.directory):
            if not n.startswith("step_"):
                continue
            if n.endswith(".tmp"):
                # orphaned by a killed writer; never the live writer's,
                # which renames its tmp before its on_complete gc runs
                pending = self._pending
                if (pending is None or not pending.is_alive()
                        or pending is threading.current_thread()):
                    shutil.rmtree(os.path.join(self.directory, n),
                                  ignore_errors=True)
                continue
            try:
                steps.append(int(n[5:]))
            except ValueError:
                pass                         # a stray name: not ours
        steps.sort()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, abstract_tree: Any, device="cpu",
                       allow_resize_1d: bool = False):
        step = latest_step(self.directory)
        if step is None:
            return None, None
        t0 = time.perf_counter()
        tree = restore_checkpoint(self.directory, abstract_tree, step=step,
                                  device=device,
                                  allow_resize_1d=allow_resize_1d)
        self.last_restore_seconds = time.perf_counter() - t0
        return tree, step
