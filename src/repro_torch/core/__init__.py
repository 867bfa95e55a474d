from repro_torch.core.interface import Model, TorchModel  # noqa: F401
from repro_torch.core.pool import ModelPool, ThreadedPool  # noqa: F401
from repro_torch.core.fabric import (  # noqa: F401
    BudgetExhausted,
    CallableBackend,
    EvaluationFabric,
    FabricBackend,
    FabricRouter,
    HTTPBackend,
    ModelBackend,
    Overloaded,
    SPMDBackend,
    ThreadedBackend,
    as_backend,
)
from repro_torch.core.fleet import (  # noqa: F401
    CampaignCheckpoint,
    FaultInjector,
    FleetManager,
)
from repro_torch.core.service import Campaign, UQService  # noqa: F401
from repro_torch.core.hierarchy import MultilevelModel  # noqa: F401
from repro_torch.core.scheduler import BatchingExecutor  # noqa: F401
