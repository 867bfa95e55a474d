"""End-to-end serving driver on the PyTorch port (examples/serve_uq.py on
`repro_torch`): a small LM served behind the UM-Bridge interface with
batched parallel requests from a UQ method — sparse-grid + MC sensitivity
of the LM's NLL to (embedding scale, temperature), then its gradient
through the same interface.

Run: PYTHONPATH=src python examples/torch_serve_uq.py [--device cpu]
(on the card unless --device says otherwise)
"""
import argparse

import numpy as np

from repro_torch.apps.lm_model import LMUQModel
from repro_torch.core.fabric import EvaluationFabric
from repro_torch.core.pool import ModelPool
from repro_torch.uq import sparse_grid as sg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    # the "expensive model": an LM forward pass (the reduced config; the same
    # wrapper serves the published widths, `reduced=False`)
    lm = LMUQModel("qwen3-0.6b", reduced=True, batch=2, seq=64, device=args.device)
    pool = ModelPool(lm)
    fabric = EvaluationFabric(pool)  # ONE dispatch layer for every request kind
    print(f"serving {lm.name} on {lm.device}: {pool.n_instances} instance(s)")

    # 1) batched requests through the fabric (the paper's cluster dispatch):
    # sparse-grid surrogate of NLL(emb_scale, temperature) — the driver
    # accepts the fabric directly in place of a bare callable
    knots = [sg.knots_uniform_leja(0.7, 1.3), sg.knots_uniform_leja(0.7, 1.3)]
    S = sg.smolyak_grid(2, 4, knots)
    Sr = sg.reduce_sparse_grid(S)
    vals = sg.evaluate_on_sparse_grid(fabric, Sr)
    print(f"sparse grid: {len(Sr.points)} LM evaluations")

    # surrogate-based forward UQ: emb_scale ~ U(0.9,1.1), temp ~ U(0.8,1.2)
    rng = np.random.default_rng(0)
    sample = np.stack([rng.uniform(0.9, 1.1, 4000), rng.uniform(0.8, 1.2, 4000)], 1)
    nlls = sg.interpolate_on_sparse_grid(S, Sr, vals, sample)[:, 0]
    print(f"NLL under calibration uncertainty: mean={nlls.mean():.4f} "
          f"std={nlls.std():.4f} p95={np.percentile(nlls, 95):.4f}")

    # 2) per-point submits (prototype-style code) batch transparently
    futs = [fabric.submit([1.0 + 0.02 * i, 1.0]) for i in range(8)]
    sens = [float(f.result()[0]) for f in futs]
    print("NLL vs embedding scale 1.00..1.14:", np.round(sens, 4))
    t = fabric.telemetry()
    print(f"fabric: {t['waves']} waves for {t['points']} evaluations "
          f"(mean wave {t['mean_wave_size']:.1f})")

    # 3) gradients through the SAME interface (one forward and one reverse
    # pass through the flash kernels, no extra model code)
    g = lm.gradient(0, 0, [[1.0, 1.0]], [1.0])
    print(f"dNLL/d(emb_scale, temp) = ({g[0]:.4f}, {g[1]:.4f})")
    fabric.shutdown()


if __name__ == "__main__":
    main()
