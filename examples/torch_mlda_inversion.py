"""Paper §4.3 on the PyTorch port: tsunami source inversion with 3-level
MLDA (GP emulator <- smoothed SWE <- fully-resolved SWE), as
examples/mlda_inversion.py runs it, with the hierarchy built from the
port's own parts (`apps/tsunami.py`, `uq/gp.py`, `uq/mlda.py`) the way
benchmarks/mlda_tsunami.py builds the reference's.

Two sampling disciplines over the same hierarchy:

* independent chains (`run_chains` + `mlda`) — the paper's 100-parallel-
  samplers pattern; the fabric coalesces their requests into waves;
* `ensemble_mlda` — K chains in LOCKSTEP: every coarse-subchain step and
  fine acceptance test across all chains is ONE `evaluate_batch` wave.

Run: PYTHONPATH=src python examples/torch_mlda_inversion.py [--device cpu]
(on the card unless --device says otherwise; every PDE wave is one launch
of the SWE solve kernel there, the GPs fit there too)
"""
import argparse
import time

import numpy as np

from repro_torch.apps.tsunami import TsunamiModel
from repro_torch.core.fabric import EvaluationFabric, ModelBackend
from repro_torch.uq.gp import GP
from repro_torch.uq.mcmc import run_chains
from repro_torch.uq.mlda import batched_level_logposts, ensemble_mlda, fabric_logposts, mlda
from repro_torch.uq.qmc import sobol

TRUE_THETA = np.array([90.0, 2.5])
PRIOR = ((30.0, 150.0), (0.5, 4.0))  # x0 [km], amplitude [m]
NOISE_SD = np.array([0.5, 0.05, 0.5, 0.05])  # arrival [min], height [m]


def build_hierarchy(n_gp_train: int = 128, seed: int = 3, device=None) -> dict:
    """The three levels of benchmarks/mlda_tsunami.py's `build_hierarchy`
    on the port: synthetic data from the fine level plus noise, four GPs
    on a scrambled Sobol' design of the smoothed level (its design solved
    as ONE wave, where the reference solves it point by point), and the
    two PDE levels behind one `EvaluationFabric`."""
    model = TsunamiModel(device=device)
    rng = np.random.default_rng(seed)
    data = np.asarray(model([list(TRUE_THETA)], {"level": 1})[0])
    data = data + rng.standard_normal(4) * NOISE_SD * 0.5

    u = sobol(n_gp_train, 2, scramble_seed=seed)
    X = np.stack(
        [PRIOR[0][0] + u[:, 0] * (PRIOR[0][1] - PRIOR[0][0]),
         PRIOR[1][0] + u[:, 1] * (PRIOR[1][1] - PRIOR[1][0])], axis=1
    )
    t0 = time.monotonic()
    Y = model.evaluate_batch(X, {"level": 0})
    t_train_evals = time.monotonic() - t0
    gps = [GP.fit(X, Y[:, j], n_iters=250, device=model.device) for j in range(4)]
    t_gp = time.monotonic() - t0 - t_train_evals

    def in_prior(theta) -> bool:
        x0, A = float(theta[0]), float(theta[1])
        return PRIOR[0][0] <= x0 <= PRIOR[0][1] and PRIOR[1][0] <= A <= PRIOR[1][1]

    def gp_logpost(theta):
        if not in_prior(theta):
            return -np.inf
        obs = np.array([float(g.predict(np.array([[float(theta[0]), float(theta[1])]]))[0])
                        for g in gps])
        return float(-0.5 * np.sum(((obs - data) / NOISE_SD) ** 2))

    def gp_logpost_batch(thetas):
        return np.asarray([gp_logpost(t) for t in np.atleast_2d(thetas)])

    fabric = EvaluationFabric(ModelBackend(model), cache_size=8192)

    def logprior(theta):
        return 0.0 if in_prior(theta) else -np.inf

    def loglik(obs):
        return float(-0.5 * np.sum(((np.asarray(obs) - data) / NOISE_SD) ** 2))

    pde_logposts = fabric_logposts(fabric, loglik, [{"level": 0}, {"level": 1}],
                                   logprior=logprior)
    print(f"GP training: {n_gp_train} smoothed-model evals in {t_train_evals:.1f}s "
          f"(one wave on {model.device}), 4 GP fits in {t_gp:.1f}s")
    return {"model": model, "logposts": [gp_logpost, *pde_logposts],
            "gp_logpost_batch": gp_logpost_batch, "data": data, "fabric": fabric,
            "loglik": loglik, "logprior": logprior}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    # the PDE levels arrive already routed through ONE EvaluationFabric:
    # parallel chains coalesce into dispatch waves and repeated coarse
    # states are served from its result cache
    h = build_hierarchy(n_gp_train=64, device=args.device)
    logposts, data, fabric = h["logposts"], h["data"], h["fabric"]
    print("observed data (arrival_1, height_1, arrival_2, height_2):", np.round(data, 3))

    prop_cov = np.diag([8.0**2, 0.25**2])

    def chain(i):
        rng = np.random.default_rng(100 + i)
        x0 = np.array([rng.uniform(*PRIOR[0]), rng.uniform(*PRIOR[1])])
        return mlda(logposts, x0, 5, [10, 2], prop_cov, rng)

    results = run_chains(chain, n_chains=4)
    samples = np.concatenate([r.samples for r in results])
    evals = np.sum([r.evals_per_level for r in results], axis=0)
    t = fabric.telemetry()
    print(f"posterior mean: x0={samples[:,0].mean():.1f} km (true {TRUE_THETA[0]}), "
          f"A={samples[:,1].mean():.2f} m (true {TRUE_THETA[1]})")
    print(f"model evaluations per level (GP, smoothed, fine): {evals.tolist()}")
    print(f"fabric cache served {t['cache_hits']} of "
          f"{t['cache_hits'] + t['cache_misses']} PDE requests "
          f"({t['cache_hit_rate']:.0%})")
    print("the GP absorbs the sampling burden; the fine solver runs",
          f"only {evals[2]} times — the paper's multilevel economics")

    # --- ensemble MLDA quickstart: K lockstep chains, one wave per step ----
    rng = np.random.default_rng(7)
    x0s = np.stack(
        [rng.uniform(*PRIOR[0], 8), rng.uniform(*PRIOR[1], 8)], axis=1
    )
    lp_batches = [
        h["gp_logpost_batch"],
        *batched_level_logposts(fabric, h["loglik"],
                                [{"level": 0}, {"level": 1}], h["logprior"]),
    ]
    res = ensemble_mlda(
        lp_batches, x0s, n_samples=5, subsampling=[10, 2],
        prop_cov=prop_cov, rng=rng,
    )
    pooled = res.samples_flat
    print(f"ensemble MLDA: 8 lockstep chains x 5 fine samples in "
          f"{res.n_waves} waves (vs ~{int(np.sum(res.evals_per_level))} "
          f"per-point round-trips); pooled mean "
          f"x0={pooled[:, 0].mean():.1f} km, A={pooled[:, 1].mean():.2f} m")
    fabric.shutdown()


if __name__ == "__main__":
    main()
