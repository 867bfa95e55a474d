"""PyTorch port: the analysis gate (`repro_torch.analysis`). The four rules
it shares with the JAX package (capability, wave, exactness, locks) give
the reference's findings on the reference's fixtures, line for line; both
linters find nothing in either package. The `torch` rule resolves the
port's captured CUDA-graph bodies, flags a host sync and a capture in a
loop injected into copies of the port's own modules, and is silent on the
tree. The reference's linter tests (waivers, baseline, line-free keys,
scopes) run against both packages' linters. Everything runs on the CPU."""
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import repro.analysis as ref_analysis
import repro_torch.analysis as port_analysis
from repro.analysis.selftest import FIXTURES as REF_FIXTURES
from repro_torch.analysis.lint import (
    DEFAULT_BASELINE,
    REPO_ROOT,
    apply_baseline,
    load_baseline,
    write_baseline,
)
from repro_torch.analysis.rules.torch_discipline import captured_bodies
from repro_torch.analysis.selftest import FIXTURES, run_selftest

SHARED_RULES = ("capability", "wave", "exactness", "locks")
PORT = REPO_ROOT / "src" / "repro_torch"
LINTERS = {"repro": ref_analysis.run_lint, "repro_torch": port_analysis.run_lint}

#: the port's captured bodies, as the rule names them
CAPTURED = {
    "src/repro_torch/uq/fused.py::_Block._body",
    "src/repro_torch/uq/fused.py::_Block._capture.body",
    "src/repro_torch/apps/tsunami.py::_Sweep.forward.body",
    "src/repro_torch/apps/tsunami.py::_Sweep.pull.body",
    "src/repro_torch/apps/composite.py::_CG.steps",
}


def _write_tree(root: Path, tree: dict[str, str]) -> Path:
    for rel, src in tree.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return root


def _lint_tree(tmp_path: Path, tree: dict[str, str], rules=None, pkg="repro_torch"):
    _write_tree(tmp_path, tree)
    return LINTERS[pkg]([tmp_path], rules=rules, root=tmp_path)


def _sites(findings):
    return [(f.rule, f.path, f.line, f.symbol, f.message) for f in findings]


def _cli(*args, cwd=REPO_ROOT):
    env = {**os.environ, "PYTHONPATH": str(REPO_ROOT / "src")}
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


# -- parity with the reference's linter ---------------------------------------


@pytest.mark.parametrize("kind", ["bad", "good"])
@pytest.mark.parametrize("rule", SHARED_RULES)
def test_shared_rule_matches_the_reference_on_its_fixtures(tmp_path, rule, kind):
    tree = REF_FIXTURES[rule][kind]
    if rule == "capability":
        tree = {rel: src.replace("JAXModel", "TorchModel") for rel, src in tree.items()}
    _write_tree(tmp_path, tree)
    ref = ref_analysis.run_lint([tmp_path], rules=[rule], root=tmp_path)
    port = port_analysis.run_lint([tmp_path], rules=[rule], root=tmp_path)
    assert _sites(port) == _sites(ref)
    assert bool(port) == (kind == "bad")


@pytest.mark.parametrize("tree", ["repro", "repro_torch"])
@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_wave_exactness_locks_find_nothing_in_either_package(pkg, tree):
    findings = LINTERS[pkg]([REPO_ROOT / "src" / tree], rules=["wave", "exactness", "locks"])
    assert not findings, "\n".join(map(str, findings))


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_capability_finds_nothing_in_its_own_package(pkg):
    findings = LINTERS[pkg]([REPO_ROOT / "src" / pkg], rules=["capability"])
    assert not findings, "\n".join(map(str, findings))


def test_capability_treats_torchmodel_as_every_op_base(tmp_path):
    # L2SeaModel's shape: a TorchModel subclass advertising derivative
    # waves it inherits
    tree = {
        "src/repro_torch/core/interface.py": '''
            class Model:
                def evaluate_batch(self, thetas, config=None):
                    return [self(t, config) for t in thetas]


            class TorchModel(Model):
                def __call__(self, parameters, config=None):
                    return parameters
                def gradient_batch(self, thetas, senss, config=None):
                    return senss
            ''',
        "src/repro_torch/apps/m.py": '''
            class Inherits(TorchModel):
                def capabilities(self, config=None):
                    return Capabilities(evaluate=True, gradient_batch=True)


            class Lies(Model):
                def capabilities(self, config=None):
                    return Capabilities(evaluate=True, gradient_batch=True)
            ''',
    }
    findings = _lint_tree(tmp_path, tree, rules=["capability"])
    assert {f.symbol for f in findings} == {"Lies"}


# -- the torch rule on the port's own modules ---------------------------------


def test_captured_bodies_resolve_every_capture_route():
    bodies = captured_bodies([PORT])
    assert CAPTURED <= bodies, sorted(bodies)
    # (b) transitively: what _CG.steps calls runs in the graph too
    assert {"src/repro_torch/apps/composite.py::_CG.step",
            "src/repro_torch/apps/composite.py::_apply_K"} <= bodies
    # the code around the captures is not
    for outside in ("apps/composite.py::_CG.run", "uq/fused.py::_Block.run",
                    "apps/tsunami.py::_replay", "apps/tsunami.py::_Sweep.forward"):
        assert f"src/repro_torch/{outside}" not in bodies


def test_torch_rule_is_silent_on_the_port():
    findings = port_analysis.run_lint([PORT], rules=["torch"])
    assert not findings, "\n".join(map(str, findings))


def _copy_with(tmp_path: Path, rel: str, old: str, new: str) -> Path:
    src = (PORT / rel).read_text()
    assert src.count(old) == 1, f"{rel}: the anchor moved"
    dst = tmp_path / "src" / "repro_torch" / rel
    dst.parent.mkdir(parents=True)
    dst.write_text(src.replace(old, new))
    return dst


def test_torch_rule_flags_a_host_sync_injected_into_the_fused_block(tmp_path):
    anchor = "            outs.append(torch.cat([xs, lps[:, None]], dim=1))\n"
    _copy_with(tmp_path, "uq/fused.py", anchor, "            lps.sum().item()\n" + anchor)
    findings = port_analysis.run_lint([tmp_path], rules=["torch"], root=tmp_path)
    assert len(findings) == 1, [str(f) for f in findings]
    assert findings[0].symbol == "_Block._body" and ".item()" in findings[0].message


def test_torch_rule_flags_the_cg_capture_moved_into_a_loop(tmp_path):
    _copy_with(tmp_path, "apps/composite.py", "        if self.graph is None:\n",
               "        while self.graph is None:\n")
    findings = port_analysis.run_lint([tmp_path], rules=["torch"], root=tmp_path)
    assert len(findings) == 1, [str(f) for f in findings]
    assert findings[0].symbol == "_CG.run" and "loop" in findings[0].message


def test_torch_rule_follows_a_body_handed_to_the_replay_runner(tmp_path):
    anchor = "            idx.add_(1)\n"
    _copy_with(tmp_path, "apps/tsunami.py", anchor,
               anchor + "            arr.to('cpu')\n")
    findings = port_analysis.run_lint([tmp_path], rules=["torch"], root=tmp_path)
    assert [(f.symbol, "cpu" in f.message) for f in findings] == [("_Sweep.forward.body", True)]


def test_torch_rule_leaves_fd_code_that_consults_the_dtype(tmp_path):
    findings = _lint_tree(tmp_path, {
        "src/repro_torch/core/fd.py": '''
            import torch


            def _fd_step(theta):
                return torch.as_tensor(theta, dtype=torch.float32)


            def _fd_gradient(theta):
                x = torch.as_tensor(theta)
                return x.float() if x.dtype != torch.float64 else x
            ''',
    }, rules=["torch"])
    assert [(f.symbol, f.line) for f in findings] == [("_fd_step", 6)]


# -- torch's global stream (exactness) ----------------------------------------


def test_exactness_flags_torch_global_draws_in_scope(tmp_path):
    findings = _lint_tree(tmp_path, {
        "src/repro_torch/uq/noise.py": '''
            import torch


            def noise(x):
                torch.manual_seed(0)
                torch.cuda.manual_seed_all(0)
                a = torch.randn(x.shape)
                b = torch.randint(0, 4, (3,))
                x.normal_()
                return a, b, torch.multinomial(x.abs(), 1)
            ''',
        "src/repro_torch/core/noise.py": '''
            import torch


            def noise(x):
                return torch.randn(x.shape)
            ''',
    }, rules=["exactness"])
    assert {f.path for f in findings} == {"src/repro_torch/uq/noise.py"}
    assert [f.line for f in findings] == [6, 7, 8, 9, 10, 11]


def test_exactness_allows_generator_draws(tmp_path):
    findings = _lint_tree(tmp_path, {
        "src/repro_torch/uq/seeded.py": '''
            import torch


            def draws(x, seed):
                gen = torch.Generator(device=x.device).manual_seed(seed)
                z = torch.randn(x.shape, generator=gen)
                u = torch.rand(x.shape, dtype=x.dtype, device=x.device, generator=gen)
                x.uniform_(generator=gen)
                return z, u, torch.normal(z, 1.0, generator=gen)
            ''',
    }, rules=["exactness"])
    assert not findings, [str(f) for f in findings]


# -- the gate ------------------------------------------------------------------


def test_port_lints_clean_without_baseline():
    """src/repro_torch itself satisfies all five invariants."""
    findings = port_analysis.run_lint([PORT])
    assert not findings, "\n".join(map(str, findings))


def test_port_baseline_is_empty():
    assert DEFAULT_BASELINE == PORT / "analysis" / "baseline.json"
    assert json.loads(DEFAULT_BASELINE.read_text())["baselined"] == []
    assert port_analysis.RULE_IDS == ("capability", "wave", "exactness", "torch", "locks")


def test_cli_exits_0_on_the_port_and_1_on_an_injected_finding(tmp_path):
    clean = _cli()
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert re.search(r"0 finding\(s\) in .*src/repro_torch", clean.stdout)
    _write_tree(tmp_path, {"src/repro_torch/uq/mcmc.py": '''
        def shattered_wave(model, thetas):
            return [model(t) for t in thetas]
        '''})
    dirty = _cli(str(tmp_path), "--baseline", "none", "--json")
    assert dirty.returncode == 1, dirty.stdout + dirty.stderr
    assert json.loads(dirty.stdout)["counts"]["new"] == 1
    assert _cli(str(tmp_path / "missing")).returncode == 2
    assert _cli("--rules", "jax").returncode == 2


def test_cli_selftest_passes():
    out = _cli("--selftest")
    assert out.returncode == 0, out.stdout + out.stderr
    for rule in ("capability", "wave", "exactness", "torch", "locks"):
        assert re.search(rf"{rule}\s+ok", out.stdout), out.stdout
    assert "selftest: passed" in out.stdout


def test_importing_the_package_does_not_import_the_stress_harness():
    code = ("import sys, repro_torch.analysis, repro_torch.core.fabric\n"
            "assert 'repro_torch.analysis.stress' not in sys.modules\n")
    env = {**os.environ, "PYTHONPATH": str(REPO_ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# -- the reference's linter tests, against both packages' linters -------------


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_detects_injected_violation(tmp_path, rule):
    spec = FIXTURES[rule]
    findings = [f for f in _lint_tree(tmp_path / "bad", spec["bad"], rules=[rule])
                if f.rule == rule]
    assert len(findings) >= spec["expect_min"], [str(f) for f in findings]


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_silent_on_lookalikes(tmp_path, rule):
    spec = FIXTURES[rule]
    findings = [f for f in _lint_tree(tmp_path / "good", spec["good"], rules=[rule])
                if f.rule == rule]
    assert not findings, [str(f) for f in findings]


def test_selftest_passes():
    report = run_selftest()
    assert report["passed"], json.dumps(report, indent=2)
    assert sorted(report["rules"]) == sorted(port_analysis.RULE_IDS)


@pytest.mark.parametrize("pkg", LINTERS)
def test_exactness_allows_seeded_rngs(tmp_path, pkg):
    findings = _lint_tree(tmp_path, {
        f"src/{pkg}/uq/seeded.py": '''
            import random

            import numpy as np


            def draws(seed):
                rng = np.random.default_rng(np.random.SeedSequence(seed))
                jitter = random.Random(seed * 7919 + 1)
                return rng.standard_normal(4), jitter.random()
            ''',
    }, rules=["exactness"], pkg=pkg)
    assert not findings, [str(f) for f in findings]


@pytest.mark.parametrize("pkg", LINTERS)
def test_exactness_flags_unseeded_in_scope_only(tmp_path, pkg):
    src = '''
        import numpy as np


        def noise(n):
            return np.random.normal(size=n)
        '''
    tree = {f"src/{pkg}/uq/bad.py": src, f"src/{pkg}/core/ok.py": src}
    findings = _lint_tree(tmp_path, tree, rules=["exactness"], pkg=pkg)
    assert [f.path for f in findings] == [f"src/{pkg}/uq/bad.py"]


@pytest.mark.parametrize("pkg", LINTERS)
def test_wave_rule_ignores_base_class_fallback_module(tmp_path, pkg):
    findings = _lint_tree(tmp_path, {
        f"src/{pkg}/core/interface.py": '''
            class Model:
                def evaluate_batch(self, thetas, config=None):
                    return [self.model(t, config) for t in thetas]
            ''',
    }, rules=["wave"], pkg=pkg)
    assert not findings


@pytest.mark.parametrize("pkg", LINTERS)
def test_wave_rule_ignores_prior_loops_in_hot_modules(tmp_path, pkg):
    findings = _lint_tree(tmp_path, {
        f"src/{pkg}/uq/mlda.py": '''
            def prior_scan(logprior, thetas):
                return [float(logprior(t)) for t in thetas]
            ''',
    }, rules=["wave"], pkg=pkg)
    assert not findings


@pytest.mark.parametrize("pkg", LINTERS)
def test_locks_rule_honors_caller_holds_the_lock(tmp_path, pkg):
    findings = _lint_tree(tmp_path, {
        f"src/{pkg}/core/telem.py": '''
            import threading


            class T:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.stats = {"n": 0}

                def bump(self):
                    with self._lock:
                        self._bump()

                def _bump(self):  # caller holds the lock
                    self.stats["n"] += 1
            ''',
    }, rules=["locks"], pkg=pkg)
    assert not findings


@pytest.mark.parametrize("pkg", LINTERS)
def test_waiver_suppresses_named_rule_on_next_line(tmp_path, pkg):
    base = '''
        def shattered(model, thetas):
            {waiver}
            outs = [model(t) for t in thetas]
            return outs
        '''
    rel = f"src/{pkg}/uq/mcmc.py"
    waived = _lint_tree(tmp_path / "a", {
        rel: base.format(waiver="# repro-lint: allow wave -- measured per-point baseline"),
    }, rules=["wave"], pkg=pkg)
    assert not waived
    unwaived = _lint_tree(tmp_path / "b", {rel: base.format(waiver="# a plain comment")},
                          rules=["wave"], pkg=pkg)
    assert len(unwaived) == 1
    # a waiver for a DIFFERENT rule must not suppress this one
    wrong = _lint_tree(tmp_path / "c", {rel: base.format(waiver="# repro-lint: allow exactness")},
                       rules=["wave"], pkg=pkg)
    assert len(wrong) == 1


def test_torch_waiver_reads_like_the_reference(tmp_path):
    src = '''
        import torch


        def run(x):
            for _ in range(3):
                {waiver}
                g = torch.cuda.CUDAGraph()
            return g
        '''
    rel = "src/repro_torch/apps/g.py"
    waived = _lint_tree(tmp_path / "a", {
        rel: src.format(waiver="# repro-lint: allow torch -- one graph a shape, cached"),
    }, rules=["torch"])
    assert not waived
    # the reference's rule id is no waiver here
    jax_waiver = _lint_tree(tmp_path / "b", {rel: src.format(waiver="# repro-lint: allow jax")},
                            rules=["torch"])
    assert len(jax_waiver) == 1


@pytest.mark.parametrize("pkg", LINTERS)
def test_baseline_round_trip_grandfathers_old_findings(tmp_path, pkg):
    run_lint = LINTERS[pkg]
    findings = _lint_tree(tmp_path, {
        f"src/{pkg}/uq/old.py": '''
            import numpy as np


            def legacy(n):
                return np.random.normal(size=n)
            ''',
    }, rules=["exactness"], pkg=pkg)
    assert findings
    bl_path = tmp_path / "baseline.json"
    write_baseline(bl_path, findings)
    baseline = load_baseline(bl_path)
    new, old = apply_baseline(findings, baseline)
    assert not new and len(old) == len(findings)
    # a NEW violation in the same tree is not grandfathered
    (tmp_path / f"src/{pkg}/uq/new.py").write_text(
        "import numpy as np\n\n\ndef fresh(n):\n"
        "    return np.random.rand(n)\n"
    )
    findings2 = run_lint([tmp_path], rules=["exactness"], root=tmp_path)
    new2, old2 = apply_baseline(findings2, baseline)
    assert [f.path for f in new2] == [f"src/{pkg}/uq/new.py"]
    assert len(old2) == len(old)


@pytest.mark.parametrize("pkg", LINTERS)
def test_finding_keys_are_line_number_free(tmp_path, pkg):
    a = _lint_tree(tmp_path / "a", {
        f"src/{pkg}/uq/x.py": '''
            import numpy as np


            def f():
                return np.random.normal()
            ''',
    }, rules=["exactness"], pkg=pkg)
    b = _lint_tree(tmp_path / "b", {
        f"src/{pkg}/uq/x.py": '''
            import numpy as np

            PADDING = 1


            def f():
                return np.random.normal()
            ''',
    }, rules=["exactness"], pkg=pkg)
    assert {f.key() for f in a} == {f.key() for f in b}
    assert a[0].line != b[0].line
