"""Train a small LM end-to-end on the PyTorch port with the production train
loop (checkpointing, fault policy, deterministic data) — a scaled-down qwen3
(examples/train_lm.py on `repro_torch`, one device, no mesh).

Run: PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--device cpu]
(on the card unless --device says otherwise)
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.launch.train import train
from repro_torch.types import TrainConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--ckpt-dir", default="checkpoints/example")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=True)
    if cfg.family in ("ssm", "hybrid"):
        # the SSD kernel has no backward yet: these families train on the
        # plain SSD, as repro_torch.launch.train does
        cfg = cfg.replace(attn_impl="plain")
    tc = TrainConfig(
        lr=1e-3, warmup_steps=max(args.steps // 10, 1), total_steps=args.steps,
        checkpoint_every=50,
    )
    _, _, hist = train(
        cfg, tc, steps=args.steps, global_batch=8, seq_len=128,
        ckpt_dir=args.ckpt_dir, log_every=20, device=args.device,
    )
    print(f"\nNLL {hist[0][1]:.3f} -> {hist[-1][1]:.3f} over {args.steps} steps")


if __name__ == "__main__":
    main()
