"""PyTorch port: the deployment driver `repro_torch.launch.serve` (the
counterpart of `repro.launch.serve`) and the port's examples
(`examples/torch_*.py`), on the CPU.

`build_model` for each of the reference's four names (tsunami and composite
constructed only); the driver as a subprocess on a free port (`--port 0`):
an L2-Sea Evaluate round trip equal to the in-process model's, and a reduced
LM whose `/ModelInfo` lists all eight UM-Bridge operations and whose
Gradient over the wire equals the in-process one (float64 JSON carries the
float32 values exactly; both processes run one torch thread, the same
arithmetic); then four examples run to exit 0 with `--device cpu`
(`torch_mlda_inversion.py`, minutes of CPU solves, runs on the card in
chip_smoke.py)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.apps.composite import CompositeModel
from repro_torch.apps.l2sea import L2SeaModel
from repro_torch.apps.lm_model import LMUQModel
from repro_torch.apps.tsunami import TsunamiModel
from repro_torch.core.client import HTTPModel, supported_models
from repro_torch.launch import serve

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
#: a driver must name its address within this many seconds (a reduced LM
#: on the CPU takes ~3 s to import torch and build)
START_S = 120.0
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@pytest.mark.parametrize("name,cls", [("l2sea", L2SeaModel), ("composite", CompositeModel),
                                      ("tsunami", TsunamiModel), ("lm", LMUQModel)])
def test_build_model_builds_each_name_on_the_cpu(name, cls):
    model = serve.build_model(name, "qwen3-0.6b", True, "cpu")
    assert isinstance(model, cls) and model.device == torch.device("cpu")
    if name == "lm":
        assert model.name == "lm-qwen3-0.6b" and model.cfg.n_layers <= 4


def test_build_model_refuses_an_unknown_name_and_a_missing_card():
    with pytest.raises(ValueError, match="unknown model"):
        serve.build_model("nope", "qwen3-0.6b", True, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.build_model("l2sea", "qwen3-0.6b", True)


def test_driver_serves_l2sea_on_a_free_port():
    proc, url = serve.start(["--model", "l2sea", "--port", "0", "--device", "cpu"], START_S,
                            ENV)
    try:
        assert url.startswith("http://127.0.0.1:") and not url.endswith(":0")
        assert supported_models(url) == ["forward"]
        theta = [0.3, -6.0] + [0.0] * 14
        got = HTTPModel(url, "forward")([theta], {"fidelity": 3})
        want = L2SeaModel(device="cpu")([theta], {"fidelity": 3})
        assert got == want
    finally:
        serve.stop(proc)


def test_driver_serves_a_reduced_lm_with_all_eight_operations():
    proc, url = serve.start(["--model", "lm", "--reduced", "--port", "0", "--device", "cpu"],
                            START_S, ENV)
    try:
        remote = HTTPModel(url, "lm-qwen3-0.6b")
        local = serve.build_model("lm", "qwen3-0.6b", True, "cpu")
        caps = remote.capabilities()
        assert caps.to_json() == local.capabilities().to_json()
        assert len(caps.names()) == 8
        theta = [[1.1, 0.9]]
        assert remote(theta) == local(theta)
        got = remote.gradient(0, 0, theta, [1.0])
        want = local.gradient(0, 0, theta, [1.0])
        assert len(got) == 2 and np.isfinite(got).all()
        assert got == want
    finally:
        serve.stop(proc)


def test_a_silent_driver_is_stopped_and_reported():
    with pytest.raises(RuntimeError, match="named no address"):
        serve.start(["--model", "nope"], START_S, ENV)


@pytest.mark.parametrize("script,args", [
    ("torch_quickstart.py", ["--port", "0"]),
    ("torch_sparse_grid_uq.py", []),
    ("torch_serve_uq.py", []),
    ("torch_train_lm.py", ["--steps", "4"]),
])
def test_example_runs_on_the_cpu(script, args, tmp_path):
    if script == "torch_train_lm.py":
        args = args + ["--ckpt-dir", str(tmp_path / "ckpt")]
    env = {**ENV, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script), "--device", "cpu",
                          *args], env=env, capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    last = out.stdout.strip().splitlines()[-1]
    print(f"{script}: {last}")
    if script == "torch_serve_uq.py":
        assert "dNLL/d(emb_scale, temp)" in last
    if script == "torch_train_lm.py":
        assert "over 4 steps" in last
