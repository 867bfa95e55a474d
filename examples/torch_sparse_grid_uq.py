"""Paper §4.1 on the PyTorch port: sparse-grid UQ of ship resistance with
the L2-Sea analogue — the SGMK Matlab snippet, line for line
(examples/sparse_grid_uq.py on `repro_torch`).

Run: PYTHONPATH=src python examples/torch_sparse_grid_uq.py [--device cpu]
(on the card unless --device says otherwise)
"""
import argparse

import numpy as np

from repro_torch.apps.l2sea import DRAFT_RANGE, FROUDE_RANGE, L2SeaModel, make_inputs
from repro_torch.core.fabric import EvaluationFabric
from repro_torch.core.pool import ThreadedPool
from repro_torch.uq import sparse_grid as sg
from repro_torch.uq.distributions import Beta, Triangular
from repro_torch.uq.kde import kde


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    # fabric = EvaluationFabric(['http://104.199.68.148'])  # the real server
    # (here: in-process pool of 8 instances — the UQ code is identical;
    # swapping the backend is the paper's separation-of-concerns claim)
    fabric = EvaluationFabric(ThreadedPool([L2SeaModel(device=args.device) for _ in range(8)]))
    config = {"fidelity": 3, "sinkoff": "y", "trimoff": "y"}

    # L2-Sea takes 16 inputs but we use only the first two
    f = lambda y: fabric.evaluate_batch(make_inputs(y), config)

    # knots for F (triangular) and D (beta), nested Leja families
    knots_froude = sg.knots_triangular_leja(*FROUDE_RANGE)
    knots_draft = sg.knots_beta_leja(10, 10, *DRAFT_RANGE)

    # build sparse grid  (N=2; w=5)
    S = sg.smolyak_grid(2, 5, [knots_froude, knots_draft])
    Sr = sg.reduce_sparse_grid(S)
    print(f"sparse grid: {len(Sr.points)} points")

    # call L2-Sea on each point (the pool parallelizes — Matlab's parfor)
    f_values = sg.evaluate_on_sparse_grid(f, Sr)

    # random sample of (F, D) by their PDFs, evaluate the surrogate
    rng = np.random.default_rng(0)
    froude, draft = Triangular(*FROUDE_RANGE), Beta(10, 10, *DRAFT_RANGE)
    random_sample = np.stack([froude.sample(rng, 5000), draft.sample(rng, 5000)], 1)
    surrogate_evals = sg.interpolate_on_sparse_grid(S, Sr, f_values, random_sample)

    # ksdensity(..., 'support','positive','Bandwidth',0.1)
    ksd_pdf, ksd_points = kde(surrogate_evals[:, 0], support="positive", bandwidth=0.1)
    mode = ksd_points[np.argmax(ksd_pdf)]
    print(f"PDF of R_T: mode ~ {mode:.1f} kN, mean ~ {surrogate_evals.mean():.1f} kN")
    fabric.shutdown()


if __name__ == "__main__":
    main()
