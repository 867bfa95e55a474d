"""The two-rank trainer of chip_smoke.py's `mesh_two_ranks` on its own, at a
chosen learning rate and step count: two `gloo` rank processes on one card
train qwen3-0.6b (`chip_smoke.MESH_TRAIN_LAYERS` layers, full width) FSDP
over data = 2, then TP over model = 2 from that checkpoint
(`chip_smoke.rank_train_elastic`), and this process trains the same model
on one device (`chip_smoke.mesh_two_ranks_references`); it prints one JSON
line: both histories, the largest relative loss difference, the card.

    python3 scripts/mesh_slice_check.py --lr 1e-3 --steps 3,6
    python3 scripts/mesh_slice_check.py          # chip_smoke.py's own settings

Needs a GPU (the ranks share it over `gloo`). `--out FILE` also writes the
line to FILE.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402


def _settings(args) -> None:
    C.MESH_TRAIN_LR = args.lr
    C.MESH_TRAIN_FIRST, C.MESH_TRAIN_STEPS = (int(n) for n in args.steps.split(","))


def rank_main(rank: int, where: Path) -> None:
    import torch.distributed as dist

    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.launch.mesh import destroy_ranks, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    ctx21 = ShardingCtx(make_mesh((2, 1), ("data", "model"), backend="gloo", rank=rank,
                                  world_size=2, store=dist.FileStore(str(where / "store"), 2),
                                  timeout_s=C.MESH_COLLECTIVE_TIMEOUT_S))
    ctx12 = ShardingCtx(make_mesh((1, 2), ("data", "model"), backend="gloo"))
    try:
        train = C.rank_train_elastic(torch, where, ctx21, ctx12)
    finally:
        destroy_ranks()
    (where / f"rank{rank}.json").write_text(json.dumps(train, default=float))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lr", type=float, default=C.MESH_TRAIN_LR)
    ap.add_argument("--steps", default=f"{C.MESH_TRAIN_FIRST},{C.MESH_TRAIN_STEPS}",
                    help="FSDP steps, total steps")
    ap.add_argument("--out", default=None)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    _settings(args)
    if args.rank is not None:
        rank_main(args.rank, Path(args.dir))
        return 0
    if not torch.cuda.is_available():
        print("mesh_slice_check: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    where = ROOT / "build" / "mesh_slice_check"
    shutil.rmtree(where, ignore_errors=True)
    where.mkdir(parents=True)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, __file__, "--lr", str(args.lr), "--steps",
                               args.steps, "--rank", str(r), "--dir", str(where)])
             for r in range(2)]
    codes = [p.wait(C.MESH_RANKS_TIMEOUT_S) for p in procs]
    if codes != [0, 0]:
        print(f"mesh_slice_check: rank exit codes {codes}", file=sys.stderr)
        return 1
    ranks = [json.loads((where / f"rank{r}.json").read_text()) for r in range(2)]
    ref, _ = C.mesh_two_ranks_references(torch, dev)
    want = np.array([l for _, l in ref])
    hists = [r["fsdp"]["hist"] + r["tp"]["hist"] for r in ranks]
    err = max(float(np.max(np.abs(np.array([l for _, l in h]) / want - 1.0))) for h in hists)
    line = json.dumps({"lr": args.lr, "steps": args.steps, "one_device": ref,
                       "rank0": hists[0], "max_rel_diff": err, "bound": C.MESH_TRAIN_RTOL,
                       "wall_s": time.perf_counter() - t0, "card": C.nvidia_smi()})
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
