"""Crash-consistent campaign state (port of `repro.core.fleet`, its
`CampaignCheckpoint` only).

`CampaignCheckpoint` sits on `distributed.checkpoint.CheckpointManager`:
one atomic snapshot holds the sampler arrays (chain positions, sample
prefix, adapters), the rng state, the router's learned EWMA/lifecycle state
and the online-surrogate training window. `ensemble_mlda`/`ensemble_mala`
and the fused runners (`uq.fused`) accept it via `checkpoint=` and resume a
killed campaign exactly (restored rng stream → the same trajectory the
uninterrupted run would have produced). The manifest is the JAX package's,
so a host campaign checkpointed by one package resumes in the other.

The rest of the reference module, `FleetManager` (the elastic policy loop
over a `FabricRouter`) and `FaultInjector` (the seeded chaos wrapper), needs
the wire (`core/client.py`: health probes, HTTP backends) and is not ported
yet: ROADMAP queue 1, item 5 (item 9).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fabric import EvaluationFabric, FabricRouter
from repro_torch.distributed.checkpoint import CheckpointManager


class CampaignCheckpoint:
    """Crash-consistent campaign state for the ensemble samplers.

    Built on `CheckpointManager` (atomic tmp-dir + rename publish, torn-dir
    detection), so a driver killed mid-save costs at most one checkpoint
    interval. The numeric payload (chain positions, sample prefix, adapted
    proposals, surrogate window) lands as npy leaves; everything JSON-able
    — the rng bit-generator state, counters, the key/shape/dtype manifest
    that lets `resume()` rebuild the tree without knowing it a priori, and
    the router's learned EWMA/lifecycle state — rides in META.json.

    Attach the infrastructure once and the samplers stay oblivious:

        ckpt = CampaignCheckpoint(dir, router=fabric, surrogate=screen)
        ensemble_mlda(..., checkpoint=ckpt, checkpoint_every=50)

    On resume, `ensemble_mlda` restores its own arrays while the checkpoint
    re-applies the router EWMA (`FabricRouter.load_state`) and the surrogate
    window (`OnlineGP.restore`) — the resumed campaign is statistically
    indistinguishable from the uninterrupted one (identical, in fact: the
    rng stream continues exactly where the snapshot left it).
    """

    def __init__(self, directory: str, *, keep_last: int = 3,
                 router=None, surrogate=None, campaign_id: str | None = None):
        self.manager = CheckpointManager(directory, keep_last=keep_last)
        self._router = router
        self._surrogate = surrogate
        # multi-tenant provenance: the owning campaign's id rides in every
        # manifest (and META.json top level), so a checkpoint directory is
        # attributable to the campaign that wrote it
        self.campaign_id = campaign_id

    def attach(self, *, router=None, surrogate=None):
        """Late-bind the infra whose state rides along (chainable)."""
        if router is not None:
            self._router = router
        if surrogate is not None:
            self._surrogate = surrogate
        return self

    # -- rng key manifest ----------------------------------------------------
    # The host samplers snapshot `rng.bit_generator.state` (JSON-able, rides
    # in META.json); the device-resident fused samplers (`uq.fused`) carry a
    # `torch.Generator` instead. Its state (`get_state()`: seed and Philox
    # offset on the card, the Mersenne Twister state on the CPU) is an
    # ordinary uint8 array, so it lands as an npy leaf like any other
    # sampler array — these two helpers are the boundary where a generator
    # becomes checkpoint payload and back, keeping resume bit-exact (same
    # state -> same stream). The writer records the generator's device type
    # in the manifest's meta, so resume restores onto the device that wrote
    # it.

    @staticmethod
    def pack_key(gen: torch.Generator) -> np.ndarray:
        """Generator -> its state as a uint8 array for the npy payload."""
        return gen.get_state().numpy().copy()

    @staticmethod
    def unpack_key(data: np.ndarray, device) -> torch.Generator:
        """uint8 state array (as restored) -> a generator on `device` (the
        device type the writer recorded) with that state."""
        gen = torch.Generator(device=device)
        gen.set_state(torch.as_tensor(np.asarray(data, np.uint8)))
        return gen

    def _router_obj(self) -> FabricRouter | None:
        r = self._router
        if isinstance(r, EvaluationFabric):
            r = r.backend
        return r if isinstance(r, FabricRouter) else None

    def _gp_obj(self):
        s = self._surrogate
        if s is None:
            return None
        return getattr(s, "gp", s)  # SurrogateScreen/Store -> OnlineGP

    # -- save ----------------------------------------------------------------
    def save(self, step: int, arrays: dict, meta: dict,
             blocking: bool = True) -> None:
        """Snapshot `arrays` (str -> ndarray) + `meta` (JSON-able) plus the
        attached router/surrogate state, atomically, as step `step`."""
        arrays = {k: np.asarray(v) for k, v in arrays.items()}
        meta = dict(meta)
        if self.campaign_id is not None:
            meta["campaign_id"] = self.campaign_id
        router = self._router_obj()
        if router is not None:
            meta["router"] = router.state_dict()
        gp = self._gp_obj()
        if gp is not None and hasattr(gp, "snapshot"):
            snap = gp.snapshot()
            if snap.get("X") is not None:
                arrays["surrogate_X"] = np.asarray(snap["X"])
                arrays["surrogate_y"] = np.asarray(snap["y"])
            meta["surrogate"] = {
                k: snap[k] for k in ("n_seen", "since_refit", "err_ewma", "frozen")
            }
        manifest = {
            "meta": meta,
            "keys": {
                k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                for k, v in arrays.items()
            },
        }
        self.manager.save(int(step), arrays, blocking=blocking,
                          manifest=manifest, campaign_id=self.campaign_id)

    def wait(self):
        self.manager.wait()

    # -- resume --------------------------------------------------------------
    def resume(self, step: int | None = None):
        """(arrays, meta, step) from the newest complete snapshot — or None
        when the directory holds none (fresh campaign). Re-applies the
        attached router/surrogate state as a side effect."""
        try:
            doc = self.manager.meta(step)
        except FileNotFoundError:
            return None
        manifest = doc.get("manifest", {})
        keys = manifest.get("keys", {})
        if not keys:
            return None
        state_like = {
            k: np.zeros(tuple(v["shape"]), dtype=v["dtype"])
            for k, v in keys.items()
        }
        state, got = self.manager.restore(state_like, step=int(doc["step"]),
                                          host=True)
        arrays = {k: np.asarray(v) for k, v in state.items()}
        meta = dict(manifest.get("meta", {}))
        router = self._router_obj()
        if router is not None and "router" in meta:
            router.load_state(meta["router"])
        gp = self._gp_obj()
        if gp is not None and "surrogate" in meta and hasattr(gp, "restore"):
            gp.restore({
                "X": arrays.pop("surrogate_X", None),
                "y": arrays.pop("surrogate_y", None),
                **meta["surrogate"],
            })
        return arrays, meta, got
