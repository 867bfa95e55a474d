"""Checkpointing: atomic, with async save (port of
`repro.distributed.checkpoint`).

  * each leaf is saved as .npy inside a per-step directory; the directory is
    written under a tmp name and atomically renamed (a crash mid-save never
    corrupts the latest checkpoint);
  * `save_async` snapshots to host memory and writes on a background thread
    (the caller continues — hides checkpoint latency, the standard trick);
  * `restore` puts the leaves on the device the caller names (the card by
    default) or returns them as host numpy at their stored precision;
  * retention: keep_last N, never deleting a checkpoint that is mid-write.

The leaf order is `jax.tree.flatten`'s (dicts by sorted key, lists and
tuples in order, `None` an empty subtree), and a step directory holds the
same files and the same META.json as the JAX package's, so a directory
written by either package restores in the other. Torch tensors are leaves
and move to the host on save. There is no mesh on one card: `shardings=`
raises (ROADMAP queue 1, item 14).
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

from repro_torch.core.device import resolve_device


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


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._save_thread: threading.Thread | None = None

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
        that produced it."""
        leaves, _ = _flatten(state)
        host_leaves = [_to_host(l) for l in leaves]  # device->host snapshot
        if blocking:
            self._write(step, host_leaves, manifest, campaign_id)
        else:
            self.wait()  # one async save in flight at a time
            self._save_thread = threading.Thread(
                target=self._write,
                args=(step, host_leaves, manifest, campaign_id), daemon=True,
            )
            self._save_thread.start()

    def save_async(self, step: int, state: dict, manifest: dict | None = None,
                   campaign_id: str | None = None):
        self.save(step, state, blocking=False, manifest=manifest,
                  campaign_id=campaign_id)

    def wait(self):
        if self._save_thread is not None and self._save_thread.is_alive():
            self._save_thread.join()

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
        numpy dtype), which bit-exact campaign resume needs (`core.fleet`).
        Otherwise every leaf is a tensor on `device` (default: the card, as
        every entry point of the port), in the dtype of its `state_like`
        leaf. `shardings=` is the JAX package's elastic re-sharding onto a
        mesh: there is no mesh on one card (ROADMAP queue 1, item 14).

        With `step=None` torn directories are SKIPPED — restore lands on
        the newest COMPLETE step, so a crash mid-save costs at most one
        checkpoint interval, never the campaign. An explicitly requested
        torn step raises (the caller named it; silently substituting a
        different step would be worse)."""
        if shardings is not None:
            raise NotImplementedError(
                "restore(shardings=): re-sharding onto a device mesh is not "
                "ported; one card has no mesh (ROADMAP queue 1, item 14)"
            )
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
        device = None if host else resolve_device(device)
        out = []
        for i, ref in enumerate(leaves):
            arr = np.load(d / f"leaf_{i:05d}.npy")
            if isinstance(ref, torch.Tensor):
                if host:
                    arr = arr.astype(torch.empty(0, dtype=ref.dtype).numpy().dtype)
                    out.append(arr)
                else:
                    out.append(torch.as_tensor(arr).to(device=device, dtype=ref.dtype))
                continue
            arr = arr.astype(ref.dtype) if hasattr(ref, "dtype") else arr
            out.append(arr if host else torch.as_tensor(arr, device=device))
        return rebuild(out), step
