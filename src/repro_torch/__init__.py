"""repro_torch — the PyTorch/CUDA port of the `repro` UQ system.

Laid out like `repro` (`core/`, `kernels/`, `apps/`, `uq/`, `analysis/`) so
every module has a counterpart there. Imports `torch`, numpy and scipy,
never `jax` and nothing of `repro`: it stands alone on a CUDA machine.
Entry points run on the GPU unless the caller asks for the CPU.
"""
