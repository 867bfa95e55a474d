from repro_torch.core.interface import Model, TorchModel  # noqa: F401
from repro_torch.core.pool import ThreadedPool  # noqa: F401
from repro_torch.core.fabric import (  # noqa: F401
    BudgetExhausted,
    CallableBackend,
    EvaluationFabric,
    FabricBackend,
    FabricRouter,
    ModelBackend,
    Overloaded,
    ThreadedBackend,
    as_backend,
)
from repro_torch.core.hierarchy import MultilevelModel  # noqa: F401
