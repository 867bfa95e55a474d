"""Hand-written Hopper kernels of the port: one folder per TPU kernel of the
JAX package, each with `csrc/*.cu`, a plain PyTorch version (`ref.py`) and
the wrapper (`ops.py`). `_build` compiles and loads them at first use."""
