"""Distributed infrastructure of the port: the checkpoint (elastic restore
onto a mesh: `restore(shardings=)`), the fault harness (`fault.py`:
`StepFailure`, `FlakyStep`, `FaultPolicy`, `loss_is_bad`) and the mesh's
sharding rules (`sharding.py`: `ShardingCtx` over a `DeviceMesh`; the
meshes themselves come from `repro_torch.launch.mesh`; the LM's layout on
them is `models.model.param_specs` and `shard_params`)."""
from repro_torch.distributed.checkpoint import CheckpointManager  # noqa: F401
from repro_torch.distributed.fault import (  # noqa: F401
    FaultPolicy,
    FlakyStep,
    StepFailure,
    loss_is_bad,
)
from repro_torch.distributed.sharding import (  # noqa: F401
    AbstractMesh,
    P,
    PartitionSpec,
    Sharding,
    ShardingCtx,
    chain_carry_shardings,
    logical_to_mesh,
    make_test_mesh,
    sanitize_spec,
    sanitized_shardings,
    shard_size_bytes,
    tree_shardings,
)
