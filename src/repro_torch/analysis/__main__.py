"""CLI: ``python -m repro_torch.analysis [paths...]``.

Exit codes: 0 = clean (or everything baselined), 1 = non-baselined
findings / selftest failure / stress violations, 2 = usage error.

Modes:
  (default)        lint the given paths (default: src/repro_torch)
  --selftest       inject one violation per rule class; verify the gate
                   catches each and stays silent on the lookalikes
  --stress         run the race-detector stress harness (lock-order
                   cycles, exactly-once tap, pool shutdown) and report;
                   the tap's online GP sits on --device (default: the
                   GPU, raising without one; pass --device cpu there)
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.lint import (
    DEFAULT_BASELINE,
    REPO_ROOT,
    apply_baseline,
    load_baseline,
    render_json,
    render_text,
    run_lint,
    write_baseline,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repro_torch invariant linter + fabric race detector",
    )
    ap.add_argument("paths", nargs="*", help="files/directories to lint "
                    "(default: the repo's src/repro_torch)")
    ap.add_argument("--rules", help="comma-separated rule subset "
                    "(capability,wave,exactness,torch,locks)")
    ap.add_argument("--json", action="store_true", help="emit JSON instead of text")
    ap.add_argument("--baseline", default=str(DEFAULT_BASELINE),
                    help="baseline file ('none' to disable)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="grandfather every current finding into the baseline")
    ap.add_argument("--selftest", action="store_true",
                    help="verify each rule class catches an injected violation")
    ap.add_argument("--stress", action="store_true",
                    help="run the race-detector stress harness")
    ap.add_argument("--threads", type=int, default=8, help="stress threads")
    ap.add_argument("--seed", type=int, default=0, help="stress seed")
    ap.add_argument("--no-perturb", action="store_true",
                    help="disable schedule perturbation in --stress")
    ap.add_argument("--device", default=None,
                    help="device of the stress tap's online GP (default: the GPU)")
    args = ap.parse_args(argv)

    if args.selftest:
        from repro_torch.analysis.selftest import run_selftest

        report = run_selftest()
        if args.json:
            print(json.dumps(report, indent=2))
        else:
            for rule, entry in report["rules"].items():
                status = "ok" if entry["passed"] else "FAIL"
                print(f"  {rule:<12} {status}  (bad fixture: "
                      f"{entry['bad_findings']} finding(s); good fixture "
                      f"{'clean' if entry['clean_on_good'] else 'NOISY'})")
                for fp in entry.get("false_positives", []):
                    print(f"    false positive: {fp}")
            print(f"selftest: {'passed' if report['passed'] else 'FAILED'}")
        return 0 if report["passed"] else 1

    if args.stress:
        from repro_torch.analysis.stress import run_stress

        report = run_stress(
            n_threads=args.threads, seed=args.seed, perturb=not args.no_perturb,
            device=args.device,
        )
        print(json.dumps(report, indent=2))
        return 0 if report["passed"] else 1

    paths = [Path(p) for p in args.paths]
    if not paths:
        paths = [REPO_ROOT / "src" / "repro_torch"]
    missing = [p for p in paths if not p.exists()]
    if missing:
        print(f"error: no such path(s): {missing}", file=sys.stderr)
        return 2
    rules = args.rules.split(",") if args.rules else None
    try:
        findings = run_lint(paths, rules=rules)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    baseline_path = None if args.baseline == "none" else Path(args.baseline)
    if args.write_baseline:
        if baseline_path is None:
            print("error: --write-baseline needs a --baseline path", file=sys.stderr)
            return 2
        doc = write_baseline(baseline_path, findings)
        print(f"baselined {len(doc['baselined'])} finding(s) -> {baseline_path}")
        return 0

    baseline = load_baseline(baseline_path)
    new, old = apply_baseline(findings, baseline)
    if args.json:
        print(json.dumps(render_json(new, old, paths), indent=2))
    else:
        print(render_text(new, old, paths))
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
