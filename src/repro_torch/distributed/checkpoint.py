"""Checkpointing: atomic, with async save (port of
`repro.distributed.checkpoint`).

  * each leaf is saved as .npy inside a per-step directory; the directory is
    written under a tmp name and atomically renamed (a crash mid-save never
    corrupts the latest checkpoint);
  * `save_async` snapshots to host memory and writes on a background thread
    (the caller continues — hides checkpoint latency, the standard trick);
    the snapshot is a copy taken on the calling thread before `save`
    returns, so the caller may update the saved tensors in place at once
    (a CPU tensor's `.numpy()` and a numpy leaf would otherwise be the live
    storage, which the writer would read after the update);
  * on a device mesh (a state with DTensor leaves) every rank calls `save`:
    each DTensor is assembled whole on the calling thread with all-reduces
    only (`sharding.assemble`), rank 0 writes and publishes, the others
    return; `wait` (and so `restore`, and the next `save`) is then a
    barrier of every rank after rank 0's writer, so no rank reads the
    directory before rank 0 has published. The writer thread issues no
    collective;
  * `restore` puts the leaves on the device the caller names (the card by
    default) or returns them as host numpy at their stored precision, or
    re-shards them onto a device mesh (`shardings=`, elastic: any mesh
    shape whose shards divide the leaves);
  * retention: keep_last N, never deleting a checkpoint that is mid-write.

The leaf order is `jax.tree.flatten`'s (dicts by sorted key, lists and
tuples in order, `None` an empty subtree), and a step directory holds the
same files and the same META.json as the JAX package's, so a directory
written by either package restores in the other. Torch tensors are leaves
and move to the host on save; a bfloat16 leaf is saved as float32 (exact),
and a JAX package's bfloat16 leaf (a 2-byte void array on disk) is read as
its bits.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import assemble, is_dtensor


def _flatten(tree):
    """(leaves, rebuild): the leaves in `jax.tree.flatten` order, and a
    function that puts a list of new leaves back into the tree's shape."""
    if tree is None:
        return [], lambda leaves: None
    if isinstance(tree, (dict, list, tuple)):
        if isinstance(tree, dict):
            # jax sorts a dict's keys; an OrderedDict keeps its own order
            keys = list(tree) if isinstance(tree, OrderedDict) else sorted(tree)
            children = [tree[k] for k in keys]
        else:
            children = list(tree)
        parts = [_flatten(c) for c in children]
        leaves = [leaf for sub, _ in parts for leaf in sub]

        def rebuild(new):
            out, i = [], 0
            for sub, build in parts:
                out.append(build(new[i:i + len(sub)]))
                i += len(sub)
            if isinstance(tree, dict):
                return type(tree)(zip(keys, out))
            return type(tree)(out)

        return leaves, rebuild
    return [tree], lambda leaves: leaves[0]


def _aligned(tree, like) -> list:
    """`tree`'s nodes at the positions of `like`'s leaves (`_flatten`
    order); a node that is not a container (a sharding, None) stands for
    every leaf beneath it."""
    if like is None:
        return []
    if isinstance(like, (dict, list, tuple)):
        if isinstance(like, dict):
            keys = list(like) if isinstance(like, OrderedDict) else sorted(like)
        else:
            keys = range(len(like))
        nested = isinstance(tree, (dict, list, tuple))
        return [x for k in keys for x in _aligned(tree[k] if nested else tree, like[k])]
    return [tree]


def _load_leaf(path) -> np.ndarray:
    """A saved leaf. numpy saves a bfloat16 array of the JAX package
    (ml_dtypes' bfloat16, which has no numpy type code) as a 2-byte void
    type; such a leaf is read as its bfloat16 bits and returned as the
    float32 array that holds those values exactly."""
    arr = np.load(path)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        arr = (np.ascontiguousarray(arr).view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return arr


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a restored tensor leaf takes with `host=True`:
    float32 for bfloat16 (numpy has none; float32 holds it exactly)."""
    return np.dtype(np.float32) if dtype == torch.bfloat16 else torch.empty(
        0, dtype=dtype).numpy().dtype


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host numpy array that shares no memory with it (the
    snapshot); a bfloat16 tensor (numpy has no bfloat16) as float32, which
    holds it exactly and restores into a bfloat16 leaf bit for bit; a
    DTensor assembled whole first (every rank of its mesh takes part)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if is_dtensor(leaf):
            leaf = assemble(leaf)
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()  # a copy
        elif leaf.device.type == "cpu":
            leaf = leaf.clone()
        return leaf.cpu().numpy()  # on the card, `.cpu()` is the copy
    return np.array(leaf, copy=True)


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._save_thread: threading.Thread | None = None
        # a save of DTensors whose publication every rank has yet to wait for
        self._mesh_save_pending = False

    # -- paths ---------------------------------------------------------------
    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    def _is_complete(self, d: Path) -> bool:
        """A step directory is complete when its META.json sentinel parses
        (it is written LAST, after every leaf) and every advertised leaf
        file is present with an intact npy header + data region. Guards
        against torn checkpoints — a crash mid-write, a truncated leaf on a
        filesystem that renamed before the data hit disk — which used to
        surface as a raise (or garbage) at restore time."""
        try:
            meta = json.loads((d / "META.json").read_text())
            n = int(meta["n_leaves"])
            for i in range(n):
                # mmap parses the header and validates the file is large
                # enough for the advertised shape WITHOUT reading the data
                np.load(d / f"leaf_{i:05d}.npy", mmap_mode="r")
            return True
        except Exception:  # noqa: BLE001 — any tear means incomplete
            return False

    def _steps(self) -> list[int]:
        return sorted(
            int(p.name.split("_")[1]) for p in self.dir.glob("step_*") if p.is_dir()
        )

    def completed_steps(self) -> list[int]:
        """Steps whose directories pass the completeness check."""
        return [s for s in self._steps() if self._is_complete(self._step_dir(s))]

    def latest_step(self, complete_only: bool = True) -> int | None:
        """Newest restorable step (pass `complete_only=False` for the raw
        newest directory, torn or not)."""
        steps = self.completed_steps() if complete_only else self._steps()
        return steps[-1] if steps else None

    def meta(self, step: int | None = None) -> dict:
        """The META.json document of a step (newest complete by default) —
        includes any `manifest` the save recorded."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no complete checkpoints in {self.dir}")
        return json.loads((self._step_dir(step) / "META.json").read_text())

    # -- save ----------------------------------------------------------------
    def save(self, step: int, state: dict, blocking: bool = True,
             manifest: dict | None = None, campaign_id: str | None = None):
        """state: arbitrary tree (dicts, lists, tuples) of tensors, numpy
        arrays or scalars. `manifest`: optional JSON-able document stored in
        META.json alongside the leaves (e.g. the tree structure, rng state,
        counters) — readable via `meta()` without loading a single leaf.
        `campaign_id`: multi-tenant provenance stamped at the META.json top
        level, so a service-tier checkpoint directory names the campaign
        that produced it.

        The snapshot is a copy, taken here before this returns. A state
        with DTensor leaves is a mesh's: every rank of it calls `save` (the
        leaves are assembled with collectives), rank 0 writes, and each
        rank's `wait` waits for rank 0's publication (a blocking save waits
        before it returns)."""
        self.wait()  # one save in flight at a time
        leaves, _ = _flatten(state)
        host_leaves = [_to_host(l) for l in leaves]  # device->host snapshot
        on_mesh = any(is_dtensor(l) for l in leaves)
        if _rank() == 0 or not on_mesh:
            if blocking:
                self._write(step, host_leaves, manifest, campaign_id)
            else:
                self._save_thread = threading.Thread(
                    target=self._write,
                    args=(step, host_leaves, manifest, campaign_id), daemon=True,
                )
                self._save_thread.start()
        self._mesh_save_pending = on_mesh and dist.get_world_size() > 1
        if blocking:
            self.wait()

    def save_async(self, step: int, state: dict, manifest: dict | None = None,
                   campaign_id: str | None = None):
        self.save(step, state, blocking=False, manifest=manifest,
                  campaign_id=campaign_id)

    def wait(self):
        """Until this process's save thread has published; after a save of
        a mesh's state, a barrier of every rank, so that on each rank the
        save is published (by rank 0) when this returns. Every rank of the
        mesh calls it at the same point (the train loop's replicated
        decisions do)."""
        if self._save_thread is not None and self._save_thread.is_alive():
            self._save_thread.join()
        if self._mesh_save_pending:
            self._mesh_save_pending = False
            dist.barrier()

    def _write(self, step: int, host_leaves: list, manifest: dict | None = None,
               campaign_id: str | None = None):
        final = self._step_dir(step)
        tmp = self.dir / f".tmp_step_{step:08d}_{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        for i, leaf in enumerate(host_leaves):
            np.save(tmp / f"leaf_{i:05d}.npy", leaf)
        # META.json doubles as the completeness sentinel: written after the
        # last leaf, so a directory holding leaves but no META is torn
        doc = {
            "step": step, "n_leaves": len(host_leaves), "t": time.time(),
            "manifest": manifest or {},
        }
        if campaign_id is not None:
            doc["campaign_id"] = campaign_id
        (tmp / "META.json").write_text(json.dumps(doc))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
        self._gc()

    def _gc(self):
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.dir.glob("step_*") if p.is_dir()
        )
        for s in steps[: -self.keep_last] if self.keep_last else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def restore(self, state_like, step: int | None = None, shardings=None,
                host: bool = False, device=None):
        """Restore into the structure of `state_like` (a tree of tensors,
        arrays or scalars). `host=True` returns plain numpy leaves at their
        stored precision (a tensor leaf of `state_like` gives the matching
        numpy dtype; float32 for bfloat16), which bit-exact campaign resume
        needs (`core.fleet`).
        Otherwise every leaf is a tensor on `device` (default: the card, as
        every entry point of the port), in the dtype of its `state_like`
        leaf. `shardings=`: a matching tree of `distributed.sharding.Sharding`s
        (from `sanitized_shardings`) for elastic re-sharding onto the
        current mesh: such a leaf comes back as a `DTensor` with those
        placements on the mesh's device, each rank reading the full array
        and keeping its own shard, so nothing is broadcast; a leaf whose
        sharding is None comes back as without `shardings=`.

        With `step=None` torn directories are SKIPPED — restore lands on
        the newest COMPLETE step, so a crash mid-save costs at most one
        checkpoint interval, never the campaign. An explicitly requested
        torn step raises (the caller named it; silently substituting a
        different step would be worse). A save still being written, here
        or (on a mesh) by rank 0, is waited for first (`wait`)."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no complete checkpoints in {self.dir}")
        elif not self._is_complete(self._step_dir(step)):
            raise ValueError(
                f"checkpoint step {step} in {self.dir} is incomplete (torn "
                f"write); newest complete step: {self.latest_step()}"
            )
        d = self._step_dir(step)
        meta = json.loads((d / "META.json").read_text())
        leaves, rebuild = _flatten(state_like)
        if meta["n_leaves"] != len(leaves):
            raise ValueError(
                f"checkpoint/state structure mismatch: step {step} holds "
                f"{meta['n_leaves']} leaves, state_like has {len(leaves)}"
            )
        # imported here: repro_torch.core's package imports this module
        from repro_torch.core.device import resolve_device

        device = None if host else resolve_device(device)
        placed = _aligned(shardings, state_like) if shardings is not None else [None] * len(leaves)
        out = []
        for i, (ref, sh) in enumerate(zip(leaves, placed)):
            arr = _load_leaf(d / f"leaf_{i:05d}.npy")
            if isinstance(ref, torch.Tensor):
                if sh is not None:
                    out.append(sh.from_full(torch.as_tensor(arr).to(ref.dtype)))
                    continue
                if host:
                    out.append(arr.astype(_numpy_dtype(ref.dtype)))
                else:
                    out.append(torch.as_tensor(arr).to(device=device, dtype=ref.dtype))
                continue
            arr = arr.astype(ref.dtype) if hasattr(ref, "dtype") else arr
            if sh is not None:
                out.append(sh.from_full(torch.as_tensor(arr)))
            else:
                out.append(arr if host else torch.as_tensor(arr, device=device))
        return rebuild(out), step
