from repro_torch.core.interface import Model  # noqa: F401
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
