"""Distributed infrastructure of the port. Only the checkpoint is ported so
far; the mesh tooling (`sharding.py`) and the fault harness (`fault.py`)
wait in ROADMAP queue 1 (items 14 and 9)."""
from repro_torch.distributed.checkpoint import CheckpointManager  # noqa: F401
