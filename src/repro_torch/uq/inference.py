"""Second-order posterior previews over batched waves (ROADMAP item 5).

Gaussian-likelihood inverse problems (y_obs ~ N(F(theta), Gamma), Gaussian
prior N(mu0, Sigma0)) get two fast "preview" estimators of the posterior
long before an MCMC campaign is affordable:

* `laplace_preview` — ensemble Gauss-Newton/Newton MAP search with a
  Laplace (Gaussian) approximation at the optimum. K candidates advance in
  LOCKSTEP; each iterate costs one fused value-and-gradient wave (misfits +
  gradients for the whole ensemble) plus one batched curvature-probe wave
  set: a `[K*d]`-lane JVP wave assembling the Jacobians and — with
  `curvature="full"` — a `[K*d]`-lane Hessian-apply wave riding the new
  `/ApplyHessianBatch` route for the exact second-order correction. No
  per-point model calls anywhere.

* `ensemble_kalman_inversion` (EKI) — derivative-free fallback for
  evaluate-only backends: a tempered ensemble Kalman update with perturbed
  observations, one `evaluate_batch` wave per tempering step. Exact in the
  linear-Gaussian large-ensemble limit; a controlled preview otherwise.

`posterior_preview` negotiates between them on the evaluator's capability
surface: it tries the second-order path and degrades to EKI when the
fabric/model raises `UnsupportedCapability` (e.g. an evaluate-only HTTP
cluster).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.interface import UnsupportedCapability


@dataclass
class LaplaceResult:
    """MAP point + Laplace (Gaussian) posterior approximation."""

    mean: np.ndarray  # [d] MAP estimate
    cov: np.ndarray  # [d, d] inverse curvature at the MAP
    neg_logpost: float  # U(mean) = misfit + prior potential (up to consts)
    thetas: np.ndarray  # [K, d] final ensemble (all local optima found)
    neg_logposts: np.ndarray  # [K]
    n_iters: int
    waves: int
    converged: bool
    method: str = "laplace"
    history: list = field(default_factory=list)  # per-iterate min U


@dataclass
class EKIResult:
    """Tempered ensemble Kalman inversion posterior preview."""

    mean: np.ndarray  # [d] ensemble mean
    cov: np.ndarray  # [d, d] ensemble covariance
    thetas: np.ndarray  # [J, d] final ensemble
    n_iters: int
    waves: int
    misfit_history: list = field(default_factory=list)
    method: str = "eki"


def _spd_cov(cov, d: int) -> np.ndarray:
    """Accept a scalar variance, a [d] diagonal or a full [d, d] matrix."""
    cov = np.asarray(cov, float)
    if cov.ndim == 0:
        return np.eye(d) * float(cov)
    if cov.ndim == 1:
        return np.diag(cov)
    return np.atleast_2d(cov)


def _chol_solve(H: np.ndarray, b: np.ndarray) -> np.ndarray | None:
    """H^{-1} b via Cholesky; None when H is not positive definite."""
    try:
        L = np.linalg.cholesky(H)
    except np.linalg.LinAlgError:
        return None
    z = np.linalg.solve(L, b)
    return np.linalg.solve(L.T, z)


def laplace_preview(
    evaluator,
    y_obs,
    noise_cov,
    prior_mean,
    prior_cov,
    *,
    n_ensemble: int = 4,
    n_iters: int = 12,
    curvature: str = "full",
    grad_tol: float = 1e-6,
    damping: float = 1e-6,
    rng: np.random.Generator | None = None,
    config: dict | None = None,
) -> LaplaceResult:
    """Ensemble Newton MAP search + Laplace approximation, in batched waves.

    Minimizes U(theta) = 0.5 ||Gamma^{-1/2} (F(theta) - y_obs)||^2
    + 0.5 (theta - mu0)^T Sigma0^{-1} (theta - mu0) from `n_ensemble`
    lockstep starts (the prior mean plus prior draws). Per iterate:

    * ONE fused value-and-gradient wave over the `[K, d]` ensemble block
      (`sens_fn = Gamma^{-1}(y_obs - y)`, so AD backends fuse the primal
      and the VJP into a single dispatch);
    * ONE `[K*d]`-lane JVP wave probing the Jacobians column by column
      (J_k e_j for every member and every basis vector), giving the exact
      Gauss-Newton curvature J^T Gamma^{-1} J;
    * with `curvature="full"`, ONE `[K*d]`-lane Hessian-apply wave
      (`apply_hessian_batch` with sens = Gamma^{-1}(F - y_obs)) adding the
      exact second-order term sum_i s_i grad^2 F_i — the batched HVP rides
      `/ApplyHessianBatch` end to end on HTTP backends.

    The Newton system uses the prior precision as exact regularization, so
    on a LINEAR model the first undamped step lands on the exact posterior
    mean and `cov` equals the exact posterior covariance. When the full
    Hessian is indefinite the member falls back to its Gauss-Newton matrix
    (plus `damping` I as a last resort) — curvature corrections can only
    sharpen the preview, never break descent. Per-member backtracking
    reuses the NEXT iterate's value wave, so rejected steps cost no extra
    dispatches.
    """
    if curvature not in ("full", "gn"):
        raise ValueError(f"curvature must be 'full' or 'gn', got {curvature!r}")
    rng = np.random.default_rng(0) if rng is None else rng
    mu0 = np.asarray(prior_mean, float).ravel()
    d = mu0.size
    Sigma0 = _spd_cov(prior_cov, d)
    P0 = np.linalg.inv(Sigma0)  # prior precision
    y_obs = np.asarray(y_obs, float).ravel()
    m = y_obs.size
    Gamma = _spd_cov(noise_cov, m)
    Ginv = np.linalg.inv(Gamma)

    K = max(1, int(n_ensemble))
    thetas = np.vstack([mu0, rng.multivariate_normal(mu0, Sigma0, size=K - 1)]) \
        if K > 1 else mu0[None, :]
    waves = 0

    def sens_fn(y):
        # dloglik/dy at one output row (host numpy: a torch model serves it
        # through the two-wave route, an evaluate wave then a gradient wave)
        return Ginv @ (y_obs - y)

    def value_grad(block):
        """(U [K], grad_U [K, d], residuals [K, m]) in one fused wave."""
        ys, glik = evaluator.value_and_gradient_batch(block, sens_fn, config)
        ys = np.atleast_2d(np.asarray(ys, float))
        r = ys - y_obs  # [K, m]
        dtheta = block - mu0
        U = 0.5 * np.einsum("ki,ij,kj->k", r, Ginv, r) \
            + 0.5 * np.einsum("ki,ij,kj->k", dtheta, P0, dtheta)
        grad = -np.atleast_2d(np.asarray(glik, float)) + dtheta @ P0.T
        return U, grad, r

    def curvatures(block, residuals):
        """Exact per-member Hessians of U via batched probe waves: the
        ensemble x basis-vector grid flattens into single [K*d]-lane
        dispatches (never K*d round-trips)."""
        Kb = len(block)
        rep = np.repeat(block, d, axis=0)  # [K*d, d]
        probes = np.tile(np.eye(d), (Kb, 1))  # [K*d, d]
        jcols = np.atleast_2d(np.asarray(
            evaluator.apply_jacobian_batch(rep, probes, config), float
        )).reshape(Kb, d, m)  # [K, d(cols), m]
        H = np.einsum("kim,mn,kjn->kij", jcols, Ginv, jcols)  # J^T Ginv J
        M = None
        if curvature == "full":
            senss = np.repeat(residuals @ Ginv.T, d, axis=0)  # Ginv (F - y)
            M = np.atleast_2d(np.asarray(
                evaluator.apply_hessian_batch(rep, senss, probes, config), float
            )).reshape(Kb, d, d)
            M = 0.5 * (M + np.transpose(M, (0, 2, 1)))
        return H, M

    U, grad, resid = value_grad(thetas)
    waves += 1
    alphas = np.ones(K)
    history = [float(np.nanmin(U))]
    H_members = np.tile(P0, (K, 1, 1))
    it = 0
    for it in range(1, n_iters + 1):
        Hgn, M = curvatures(thetas, resid)
        waves += 2 if M is not None else 1
        steps = np.zeros_like(thetas)
        for k in range(K):  # host-side linear algebra only, no model calls
            Hk = Hgn[k] + P0
            p = None
            if M is not None:
                p = _chol_solve(Hk + M[k], grad[k])
                if p is not None:
                    Hk = Hk + M[k]
            if p is None:
                p = _chol_solve(Hk, grad[k])
            if p is None:
                Hk = Hk + damping * np.eye(d)
                p = _chol_solve(Hk, grad[k])
            steps[k] = -p if p is not None else -grad[k]
            H_members[k] = Hk
        gnorm = np.linalg.norm(grad, axis=1)
        if np.all(gnorm < grad_tol):
            break
        props = thetas + alphas[:, None] * steps
        U_new, grad_new, resid_new = value_grad(props)
        waves += 1
        better = np.isfinite(U_new) & (U_new <= U + 1e-12)
        # per-member backtracking against the wave just paid: rejected
        # members revert and halve their step for the next iterate
        alphas = np.where(better, np.minimum(1.0, alphas * 2.0), alphas * 0.5)
        thetas = np.where(better[:, None], props, thetas)
        grad = np.where(better[:, None], grad_new, grad)
        resid = np.where(better[:, None], resid_new, resid)
        U = np.where(better, U_new, U)
        history.append(float(np.nanmin(U)))
    best = int(np.nanargmin(U))
    # Laplace covariance at the winner, from its LAST assembled curvature
    Hgn, M = curvatures(thetas[best][None, :], resid[best][None, :])
    waves += 2 if M is not None else 1
    Hbest = Hgn[0] + P0 + (M[0] if M is not None else 0.0)
    cov = _chol_solve(Hbest, np.eye(d))
    if cov is None:  # indefinite full Hessian at a shoulder: GN fallback
        cov = _chol_solve(Hgn[0] + P0, np.eye(d))
    return LaplaceResult(
        mean=thetas[best].copy(),
        cov=np.asarray(cov),
        neg_logpost=float(U[best]),
        thetas=thetas,
        neg_logposts=U,
        n_iters=it,
        waves=waves,
        converged=bool(np.all(np.linalg.norm(grad, axis=1) < max(grad_tol, 1e-4))),
        history=history,
    )


def ensemble_kalman_inversion(
    evaluator,
    y_obs,
    noise_cov,
    prior_mean,
    prior_cov,
    *,
    n_ensemble: int = 256,
    n_iters: int = 1,
    rng: np.random.Generator | None = None,
    config: dict | None = None,
) -> EKIResult:
    """Tempered EKI with perturbed observations: one `evaluate_batch` wave
    per tempering step, NO derivatives — the preview for evaluate-only
    backends. Uniform tempering (each of the `n_iters` steps uses inflated
    noise Gamma/alpha with alpha = 1/n_iters, summing to one full Bayes
    update), so `n_iters=1` is the classic single Kalman update: exact
    posterior moments for linear-Gaussian problems as the ensemble grows.
    """
    rng = np.random.default_rng(0) if rng is None else rng
    mu0 = np.asarray(prior_mean, float).ravel()
    d = mu0.size
    Sigma0 = _spd_cov(prior_cov, d)
    y_obs = np.asarray(y_obs, float).ravel()
    m = y_obs.size
    Gamma = _spd_cov(noise_cov, m)

    J = max(int(n_ensemble), d + 2)
    thetas = rng.multivariate_normal(mu0, Sigma0, size=J)
    waves = 0
    alpha = 1.0 / max(1, int(n_iters))
    misfits = []
    for _ in range(max(1, int(n_iters))):
        ys = np.atleast_2d(np.asarray(
            evaluator.evaluate_batch(thetas, config), float
        ))
        waves += 1
        misfits.append(float(np.mean(
            np.einsum("ki,ij,kj->k", ys - y_obs, np.linalg.inv(Gamma), ys - y_obs)
        )) * 0.5)
        t_c = thetas - thetas.mean(0)
        y_c = ys - ys.mean(0)
        C_ty = t_c.T @ y_c / (J - 1)  # [d, m]
        C_yy = y_c.T @ y_c / (J - 1)  # [m, m]
        gain = C_ty @ np.linalg.inv(C_yy + Gamma / alpha)
        noise = rng.multivariate_normal(np.zeros(m), Gamma / alpha, size=J)
        thetas = thetas + (y_obs + noise - ys) @ gain.T
    return EKIResult(
        mean=thetas.mean(0),
        cov=np.cov(thetas.T).reshape(d, d),
        thetas=thetas,
        n_iters=max(1, int(n_iters)),
        waves=waves,
        misfit_history=misfits,
    )


def posterior_preview(
    evaluator,
    y_obs,
    noise_cov,
    prior_mean,
    prior_cov,
    *,
    rng: np.random.Generator | None = None,
    config: dict | None = None,
    **kwargs,
) -> LaplaceResult | EKIResult:
    """Capability-negotiated preview: second-order Laplace when the
    evaluator serves derivative waves, tempered EKI when it is
    evaluate-only (`UnsupportedCapability` from any derivative dispatch
    downgrades — mirrors the client/fabric negotiation ladder). The result
    carries `method` ("laplace" or "eki")."""
    lap_keys = ("n_ensemble", "n_iters", "curvature", "grad_tol", "damping")
    try:
        return laplace_preview(
            evaluator, y_obs, noise_cov, prior_mean, prior_cov,
            rng=rng, config=config,
            **{k: v for k, v in kwargs.items() if k in lap_keys},
        )
    except (UnsupportedCapability, AttributeError, TypeError):
        pass
    eki_keys = ("n_iters",)
    eki_kwargs = {k: v for k, v in kwargs.items() if k in eki_keys}
    eki_kwargs.setdefault("n_ensemble", kwargs.get("eki_ensemble", 256))
    return ensemble_kalman_inversion(
        evaluator, y_obs, noise_cov, prior_mean, prior_cov,
        rng=rng, config=config, **eki_kwargs,
    )
