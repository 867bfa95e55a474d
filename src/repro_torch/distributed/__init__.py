"""Distributed infrastructure of the port: the checkpoint and the fault
harness (`fault.py`: `StepFailure`, `FlakyStep`, `FaultPolicy`,
`loss_is_bad`). The mesh tooling (`sharding.py`) waits in ROADMAP queue 1,
item 14."""
from repro_torch.distributed.checkpoint import CheckpointManager  # noqa: F401
from repro_torch.distributed.fault import (  # noqa: F401
    FaultPolicy,
    FlakyStep,
    StepFailure,
    loss_is_bad,
)
