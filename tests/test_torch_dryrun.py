"""PyTorch port: the dry-run tooling (`repro_torch.launch.dryrun`,
`hlo_analysis`, `perf`) against the JAX package's.

* The ring model (`hlo_analysis.ring_bytes`) equals the reference's
  `_collective_bytes` for all five collective classes at group sizes 2, 4
  and 16, fed the same op, result shape and group size.
* The port's `run_cell` against the reference's `run_cell` for reduced
  qwen3-0.6b, deepseek-moe-16b and mamba2-1.3b x `train_4k`, `prefill_32k`
  and `decode_32k`, on 1x1 and 2x2x2 (the reference on an Auto-axis
  `jax.sharding.Mesh` of 8 forced host devices: its own CLI's
  `jax.make_mesh` gives Explicit axes, which its `with_sharding_constraint`
  refuses in jax 0.9, ROADMAP queue 3):
  - `total_params`, `active_params`, `model_flops_per_device`,
    `param_local_bytes` and `cache_local_bytes` are equal;
  - on 1x1 the recorded matmul flops are within FLOPS_RTOL of the
    reference's HLO flops. The port's `prefill_step` runs the LM head on
    the last position only, where the reference computes ``[B, S, V]``
    logits and keeps the last row (`models/model.py::prefill_step`): the
    prefill cells add back the 2·B·(S−1)·d·V flops of the rows the
    reference drops before they are compared;
  - the 2x2x2 flops of both packages are printed (`-s`): the collectives
    DTensor chooses are not XLA's, nor its local work;
  - the train cells show all-reduce plus reduce-scatter bytes > 0 (the
    gradients' reduction), in both packages;
  - the CLI (`--mesh tiny --reduced`) writes the nine cells. These last two
    are the counterparts of tests/test_sharding_dryrun.py's two tests that
    fail on the reference's own CLI.
* `launch/perf.py` re-traces a cell and prints its roofline deltas against
  a baseline cell.

The cells run in subprocesses, each group with its own time limit, all
started at once: the reference at 1x1 and at 2x2x2, the port at 1x1, and
the port's CLI once per arch (the 2x2x2 cells)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.launch.hlo_analysis import Instr, _collective_bytes
from repro_torch.launch.hlo_analysis import COLLECTIVES, ring_bytes

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-0.6b", "deepseek-moe-16b", "mamba2-1.3b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
CELLS = [f"{a}__{s}" for a in ARCHS for s in SHAPES]
EQUAL = ("total_params", "active_params", "model_flops_per_device", "param_local_bytes",
         "cache_local_bytes")
#: the 1x1 matmul flops' bound (measured: 0 for qwen3 and deepseek; mamba2's
#: SSD scan 0.8-0.9% below the reference's)
FLOPS_RTOL = 0.02
TIMEOUT_S = 300

_REFERENCE = """
import json, sys
import repro.launch.dryrun as D  # sets XLA_FLAGS before JAX starts
import jax, numpy as np
from jax.sharding import Mesh
shape = tuple(int(x) for x in sys.argv[1].split("x"))
axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), axes)
json.dump({f"{a}__{s}": D.run_cell(a, s, mesh, reduced=True)
           for a in sys.argv[3].split(",") for s in sys.argv[4].split(",")},
          open(sys.argv[2], "w"))
"""
_PORT = """
import json, sys
import repro_torch.launch.dryrun as D
mesh = D.fake_mesh((1, 1), ("data", "model"))
json.dump({f"{a}__{s}": D.run_cell(a, s, mesh, reduced=True)
           for a in sys.argv[2].split(",") for s in sys.argv[3].split(",")},
          open(sys.argv[1], "w"))
"""


def _env(**extra):
    return dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu", **extra)


def _start(args, **env):
    return subprocess.Popen([sys.executable, *args], cwd=str(REPO), env=_env(**env),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name, proc):
    try:
        out, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{name} ran past {TIMEOUT_S} s")
    assert proc.returncode == 0, f"{name} failed:\n{out[-4000:]}"
    return out


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Every cell of both packages on both meshes, and the CLI's output."""
    where = tmp_path_factory.mktemp("dryrun")
    cli = where / "cli"
    a, s = ",".join(ARCHS), ",".join(SHAPES)
    procs = {
        "reference 1x1": _start(["-c", _REFERENCE, "1x1", str(where / "ref11.json"), a, s],
                                DRYRUN_DEVICES="8"),
        "reference 2x2x2": _start(["-c", _REFERENCE, "2x2x2", str(where / "ref222.json"), a, s],
                                  DRYRUN_DEVICES="8"),
        "port 1x1": _start(["-c", _PORT, str(where / "port11.json"), a, s]),
    }
    for arch in ARCHS:
        procs[f"port CLI {arch}"] = _start(["-m", "repro_torch.launch.dryrun", "--arch", arch,
                                            "--shape", s, "--mesh", "tiny", "--reduced",
                                            "--out", str(cli)])
    logs = {name: _finish(name, p) for name, p in procs.items()}
    return {
        "1x1": (json.loads((where / "ref11.json").read_text()),
                json.loads((where / "port11.json").read_text())),
        "2x2x2": (json.loads((where / "ref222.json").read_text()),
                  {c: json.loads((cli / f"{c}__tiny.json").read_text()) for c in CELLS}),
        "cli": cli, "logs": logs,
    }


@pytest.mark.parametrize("n", [2, 4, 16])
@pytest.mark.parametrize("op", COLLECTIVES)
def test_ring_model_matches_the_reference(op, n):
    """The same collective (f32[64,256] result, a group of n) priced by both."""
    ins = Instr("c", "f32[64,256]{1,0}", op,
                f"f32[64,256]{{1,0}} %p), replica_groups=[{32 // n},{n}]<=[32], dimensions={{0}}")
    _, want = _collective_bytes(ins, 32)
    assert ring_bytes(op, 64 * 256 * 4, n) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("mesh", ["1x1", "2x2x2"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_quantities_equal_the_reference(cells, cell, mesh):
    ref, port = (d[cell] for d in cells[mesh])
    assert port["mesh"] == mesh and port["n_devices"] == ref["n_devices"]
    for key in EQUAL:
        assert port[key] == ref[key], (cell, mesh, key)
    print(f"{cell} on {mesh}: flops/device reference {ref['hlo_flops_per_device']:.4g}, "
          f"port {port['flops_per_device']:.4g}; collective bytes reference "
          f"{ref['collective_bytes_per_device']:.4g}, port "
          f"{port['collective_bytes_per_device']:.4g} (analysis)")
    assert port["flops_per_device"] > 0 and port["roofline_terms_s"]["compute_s"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_one_device_flops_within_bound(cells, cell):
    ref, port = (d[cell] for d in cells["1x1"])
    flops = port["flops_per_device"]
    if port["kind"] == "prefill":
        from repro_torch.configs import get_config

        cfg = get_config(port["arch"], reduced=True)
        flops += 2 * port["global_batch"] * (port["seq_len"] - 1) * cfg.d_model * cfg.padded_vocab
    err = abs(flops / ref["hlo_flops_per_device"] - 1)
    print(f"{cell} 1x1 flops: port {flops:.6g} vs reference {ref['hlo_flops_per_device']:.6g} "
          f"({err:.3g}, bound {FLOPS_RTOL})")
    assert err <= FLOPS_RTOL


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cells_reduce_gradients(cells, arch):
    for which, data in zip(("reference", "port"), cells["2x2x2"]):
        coll = data[f"{arch}__train_4k"]["collectives"]["per_device_bytes"]
        assert coll["all-reduce"] + coll["reduce-scatter"] > 0, which


def test_cli_writes_the_nine_tiny_cells(cells):
    files = sorted(cells["cli"].glob("*.json"))
    assert len(files) == 9
    for f in files:
        data = json.loads(f.read_text())
        assert data["flops_per_device"] > 0 and data["t_trace_s"] >= 0
        assert data["dominant"] in data["roofline_terms_s"]
        assert data["hardware"] == "h100-sxm5-80gb" and data["memory"]["peak_bytes"] is None
    assert all("all cells passed" in log for name, log in cells["logs"].items() if "CLI" in name)


def test_perf_prints_deltas_against_the_baseline(cells, tmp_path):
    out = _finish("perf", _start(["-m", "repro_torch.launch.perf", "--arch", "qwen3-0.6b",
                                  "--shape", "decode_32k", "--mesh", "tiny", "--reduced",
                                  "--baseline", str(cells["cli"]), "--out", str(tmp_path)]))
    rows = {line.split()[0]: line.split() for line in out.splitlines()
            if line.split() and line.split()[0] in ("compute_s", "memory_s", "collective_s")}
    assert set(rows) == {"compute_s", "memory_s", "collective_s"}
    for row in rows.values():
        assert row[3] == "+0.0%"  # the same cell as the baseline
    assert len(list(tmp_path.glob("*.json"))) == 1
