"""Perf-iteration driver (counterpart of `repro.launch.perf`): re-trace one
dry-run cell with config overrides and print the roofline-term deltas
against a baseline cell's JSON (`launch/dryrun.py`). Like the dry run, its
numbers are analysis of the traced op stream against the `types.H100`
datasheet peaks, not measurements.

    PYTHONPATH=src python -m repro_torch.launch.perf --arch minicpm3-4b \\
        --shape train_4k --mesh single --set remat=dots loss_chunk=512

Overrides are ModelConfig fields (bools: true/false; ints/floats parsed).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch.dryrun import run_cell


def _parse_val(v: str):
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "tiny"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--set", nargs="*", default=[], help="field=value overrides")
    ap.add_argument("--baseline", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="experiments/perf_torch")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = _parse_val(v)

    res = run_cell(args.arch, args.shape, args.mesh, reduced=args.reduced, overrides=overrides)
    base_fp = Path(args.baseline) / f"{args.arch}__{args.shape}__{args.mesh}.json"
    base = json.loads(base_fp.read_text()) if base_fp.exists() else None

    t = res["roofline_terms_s"]
    print(f"\n{'term':14s} {'baseline':>12s} {'now':>12s} {'delta':>8s}  (analysis)")
    for k in ("compute_s", "memory_s", "collective_s"):
        b = base["roofline_terms_s"][k] if base else float("nan")
        d = (t[k] / b - 1) * 100 if base and b else float("nan")
        print(f"{k:14s} {b:12.4e} {t[k]:12.4e} {d:+7.1f}%")
    print(f"dominant: {res['dominant']}  (baseline: {base['dominant'] if base else '?'})")
    coll = res["collectives"]["per_device_bytes"]
    print(f"collectives: { {k: f'{v:.2e}' for k, v in coll.items() if v} }")

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    tag = args.tag or "_".join(f"{k}-{v}" for k, v in overrides.items()) or "baseline"
    fp = outdir / f"{args.arch}__{args.shape}__{args.mesh}__{tag}.json"
    fp.write_text(json.dumps(res, indent=1))
    print(f"-> {fp}")
    return res


if __name__ == "__main__":
    main()
