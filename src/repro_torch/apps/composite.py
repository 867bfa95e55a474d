"""Composite aero-structure defect UQ (paper §4.2), in PyTorch.

Port of `repro.apps.composite`. The original: MS-GFEM reduced-order model
of a laminated C-spar (DUNE/C++, 2M dof -> 32,721 ROM dof, reduction ~58x),
QMC over a 3-d defect parameter theta = (position_width, position_length,
diameter) ~ N((77.5,210,10), diag(8000,4800,2)) [mm], output = strain
energy.

This analogue keeps the paper's *computational structure* exactly:
  * full model: anisotropic 6-ply laminate (alternating orientation) with a
    resin interlayer, scalar elasticity proxy (diffusion), solved matrix-free
    with CG on a 48x96 grid under compression BCs;
  * OFFLINE: per-subdomain spectral bases (lowest eigenvectors of the local
    pristine operator, MS-GFEM-style) + a global coarse space;
  * ONLINE: a defect only re-computes the bases of subdomains it intersects
    (paper: "only the eigenproblems on subdomains intersecting local defects
    are recomputed"); Galerkin-project, dense-solve the ROM, report energy.

Reduction factor here: 4416 dof -> 171 ROM dof (43 coarse functions and
16 subdomains x 8 local modes; ~26x; paper: 58x).

Layout: lanes first. A field is `[..., NX, NY]`, an interior vector
`[..., NX-2, NY]`, and every grid function takes any leading lane dims, so
one call runs a whole wave. The CG runs every lane until its own test
stops it (`cg`), as the JAX package's vmapped `jax.scipy.sparse.linalg.cg`
does, and its gradient is an implicit adjoint (`_Solve`). `CompositeModel`
runs on the GPU unless `device="cpu"` is passed, in `DTYPE`.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.analysis.races import named_lock
from repro_torch.core.device import CAPTURE_LOCK, resolve_device
from repro_torch.core.interface import Capabilities, Model

# grid: nx cells across the width (plies), ny along the length
NX, NY = 48, 96
WIDTH_MM, LENGTH_MM = 155.0, 420.0
N_PLIES = 6
SUB = (4, 4)  # subdomain tiling of the interior
Q_LOCAL = 8  # local eigenvectors per subdomain
DEFECT_SOFTENING = 0.01

# Compression is applied ACROSS the ply stack (x), so the load path crosses
# every ply and the resin interlayer in series — a delamination then blocks
# the columns it intersects. Dirichlet at x=0 and x=NX-1 eliminated.
_INTERIOR = (NX - 2, NY)

#: the full solve's CG, as the JAX package calls `jax.scipy.sparse.linalg.cg`
CG_TOL, CG_MAXITER = 1e-10, 4000
#: CG iterations between two host reads of "every lane has stopped". A lane
#: that stops is frozen, so the result does not depend on this; on the card
#: these iterations are one CUDA-graph replay
CG_CHECK_EVERY = 16


def coefficient_field(theta: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(kx, ky) cell conductivities [NX, NY]; theta = (pos_w, pos_l, diam) mm."""
    x = (np.arange(NX) + 0.5) * WIDTH_MM / NX
    y = (np.arange(NY) + 0.5) * LENGTH_MM / NY
    ply = (np.arange(NX) * N_PLIES // NX) % 2  # alternating orientation
    kx = np.where(ply == 0, 10.0, 1.0)[:, None] * np.ones((1, NY))
    ky = np.where(ply == 0, 1.0, 10.0)[:, None] * np.ones((1, NY))
    # resin interlayer between central plies: thin isotropic soft strip
    inter = slice(NX // 2 - 1, NX // 2 + 1)
    kx[inter] = 0.5
    ky[inter] = 0.5
    # delamination defect: softening of the interlayer inside the ellipse
    pw, pl, diam = float(theta[0]), float(theta[1]), max(float(theta[2]), 1e-3)
    r2 = ((x[:, None] - pw) / (diam / 2)) ** 2 + ((y[None, :] - pl) / (diam / 2)) ** 2
    mask = np.zeros((NX, NY), bool)
    mask[inter] = r2[inter] <= 1.0
    kx = np.where(mask, kx * DEFECT_SOFTENING, kx)
    ky = np.where(mask, ky * DEFECT_SOFTENING, ky)
    return kx, ky


@lru_cache(maxsize=1)
def _pristine_field() -> tuple[np.ndarray, np.ndarray]:
    """Pristine (defect off-domain) conductivities, computed once."""
    return coefficient_field(np.array([0.0, 0.0, 0.0]))


#: default smoothing width (in the ellipse's normalized r^2 units) for the
#: differentiable defect indicator; config key "defect_softness" overrides
DEFECT_SOFTNESS = 1.0


def coefficient_field_smooth(thetas: torch.Tensor, softness: float):
    """Differentiable (kx, ky) [K, NX, NY] of thetas [K, 3], in their dtype
    and on their device: the hard ellipse indicator `r2 <= 1` of
    `coefficient_field` is replaced by sigmoid((1 - r2)/softness), so the
    strain energy becomes smooth in theta and reverse-mode AD yields useful
    defect-placement gradients. As softness -> 0 the field converges to the
    hard one."""
    dt, dev = thetas.dtype, thetas.device
    x = torch.as_tensor((np.arange(NX) + 0.5) * WIDTH_MM / NX, dtype=dt, device=dev)
    y = torch.as_tensor((np.arange(NY) + 0.5) * LENGTH_MM / NY, dtype=dt, device=dev)
    kx0, ky0 = (torch.as_tensor(k, dtype=dt, device=dev) for k in _pristine_field())
    pw, pl = thetas[:, 0, None, None], thetas[:, 1, None, None]
    half = (torch.clamp_min(thetas[:, 2], 1e-3) / 2)[:, None, None]
    r2 = ((x[None, :, None] - pw) / half) ** 2 + ((y[None, None, :] - pl) / half) ** 2
    m = torch.sigmoid((1.0 - r2) / softness)
    inter = np.zeros((NX, 1))
    inter[NX // 2 - 1: NX // 2 + 1] = 1.0  # resin interlayer rows
    factor = 1.0 - (1.0 - DEFECT_SOFTENING) * m * torch.as_tensor(inter, dtype=dt, device=dev)
    return kx0 * factor, ky0 * factor


def _harmonic(a, b):
    return 2.0 * a * b / (a + b + 1e-30)


def _face_coeffs(kx: torch.Tensor, ky: torch.Tensor):
    fx = _harmonic(kx[..., 1:, :], kx[..., :-1, :])  # [..., NX-1, NY] x-faces
    fy = _harmonic(ky[..., :, 1:], ky[..., :, :-1])  # [..., NX, NY-1] y-faces
    return fx, fy


def _divergence(fx, fy, full):
    """The four scatter-adds of the stencil on a full-grid u [..., NX, NY],
    in the JAX package's order: x-fluxes out, in, then y-fluxes out, in."""
    flux_x = fx * (full[..., 1:, :] - full[..., :-1, :])
    flux_y = fy * (full[..., :, 1:] - full[..., :, :-1])
    div = flux_x.new_zeros(flux_x.shape[:-2] + full.shape[-2:])
    div[..., :-1, :] += flux_x
    div[..., 1:, :] += -flux_x
    div[..., :, :-1] += flux_y
    div[..., :, 1:] += -flux_y
    return div


def _apply_K(fx, fy, u):
    """5-point stencil on interior u [..., NX-2, NY]; zero-Dirichlet at the
    two x-boundaries (lifting handled separately), zero-Neumann in y."""
    full = F.pad(u, (0, 0, 1, 1))  # add Dirichlet rows as zeros
    return -_divergence(fx, fy, full)[..., 1:-1, :]


def _lifting(dtype, device) -> torch.Tensor:
    """u0 [NX, NY]: linear compression profile between the Dirichlet edges
    (x), as XLA computes `jnp.linspace(0, 1, NX)`: i * (1 / (NX - 1)) in
    `dtype`, with the endpoint exact."""
    one = torch.ones(1, dtype=dtype, device=device)
    prof = torch.cat([torch.arange(NX - 1, dtype=dtype, device=device) * (one / (NX - 1)), one])
    return prof[:, None].expand(NX, NY)


def _rhs_from_lifting(fx, fy, u0):
    return _divergence(fx, fy, u0)[..., 1:-1, :]


def _with_interior(u0, w):
    """u0 [NX, NY] with w [..., NX-2, NY] added to its interior rows."""
    lanes = w.shape[:-2]
    return torch.cat([u0[:1].expand(*lanes, 1, NY), u0[1:-1] + w,
                      u0[-1:].expand(*lanes, 1, NY)], dim=-2)


def _energy(fx, fy, u):
    """Strain energy 0.5 * sum k |grad u|^2 over faces, per lane."""
    ey = 0.5 * (fy * (u[..., :, 1:] - u[..., :, :-1]) ** 2).sum((-2, -1))
    ex = 0.5 * (fx * (u[..., 1:, :] - u[..., :-1, :]) ** 2).sum((-2, -1))
    return ex + ey


# ---------------------------------------------------------------------------
# The full solve: per-lane CG and its implicit adjoint
# ---------------------------------------------------------------------------


def _dot(a, b):
    return (a * b).sum((-2, -1))


class _CG:
    """CG on K(fx, fy) x = b for every lane of b [..., NX-2, NY] at once,
    with the semantics of `jax.scipy.sparse.linalg.cg` under `vmap`: x0 = 0,
    and a lane iterates while gamma > tol^2 (b.b) and k < maxiter, its own
    test; a lane whose test fails is frozen (`torch.where`) while the others
    go on. State lives in fixed buffers, allocated for one (fx, fy, b)
    shape and loaded anew for each system (`load`), so a run of iterations
    is captured once as a CUDA graph and replayed for every later system of
    that shape (`cg`'s cache)."""

    def __init__(self, fx, fy, b):
        self.fx, self.fy = torch.empty_like(fx), torch.empty_like(fy)
        self.x, self.r, self.p = (torch.empty_like(b) for _ in range(3))
        lanes = b.shape[:-2]
        self.atol2, self.gamma = b.new_empty(lanes), b.new_empty(lanes)
        self.k = torch.empty(lanes, dtype=torch.int32, device=b.device)
        self.running = torch.empty((), dtype=torch.bool, device=b.device)
        self.graph = None
        # one system at a time in the buffers; `done` marks the last one's
        # results copied out, on whatever stream its caller used
        self.lock = named_lock("composite.cg")
        self.done = torch.cuda.Event() if b.is_cuda else None

    def load(self, fx, fy, b) -> None:
        """Start a solve of K(fx, fy) x = b in the buffers."""
        if self.done is not None:
            torch.cuda.current_stream().wait_event(self.done)
        self.fx.copy_(fx)
        self.fy.copy_(fy)
        tol = torch.tensor(CG_TOL, dtype=b.dtype, device=b.device)
        self.atol2.copy_(torch.clamp_min(tol * tol * _dot(b, b), 0.0))
        self.x.zero_()
        self.r.copy_(b - _apply_K(self.fx, self.fy, self.x))
        self.p.copy_(self.r)
        self.gamma.copy_(_dot(self.r, self.r))
        self.k.zero_()
        self.running.copy_(self.live().any())

    def live(self) -> torch.Tensor:
        return (self.gamma > self.atol2) & (self.k < CG_MAXITER)

    def state(self) -> list:
        return [self.x, self.r, self.p, self.gamma, self.k, self.running]

    def step(self) -> None:
        live = self.live()
        Ap = _apply_K(self.fx, self.fy, self.p)
        alpha = (self.gamma / _dot(self.p, Ap))[..., None, None]
        x = self.x + alpha * self.p
        r = self.r - alpha * Ap
        gamma = _dot(r, r)
        p = r + (gamma / self.gamma)[..., None, None] * self.p
        grid = live[..., None, None]
        self.x.copy_(torch.where(grid, x, self.x))
        self.r.copy_(torch.where(grid, r, self.r))
        self.p.copy_(torch.where(grid, p, self.p))
        self.gamma.copy_(torch.where(live, gamma, self.gamma))
        self.k.add_(live.to(self.k.dtype))

    def steps(self, n: int) -> None:
        for _ in range(n):
            self.step()
        self.running.copy_(self.live().any())

    def run(self, check_every: int) -> None:
        """Iterate until every lane has stopped, reading that on the host
        once every `check_every` iterations. On a CUDA device (and
        check_every > 1) those iterations are one CUDA graph, captured at
        the first run on the work's own stream after a warm-up step (whose
        changes are put back), both under `CAPTURE_LOCK`, and replayed."""
        if not (self.x.is_cuda and check_every > 1):
            while bool(self.running):
                self.steps(check_every)
            return
        if not bool(self.running):
            return
        if self.graph is None:
            graph = torch.cuda.CUDAGraph()
            with CAPTURE_LOCK:
                before = [t.clone() for t in self.state()]
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    self.steps(1)
                torch.cuda.current_stream().wait_stream(side)
                for t, b in zip(self.state(), before):
                    t.copy_(b)
                with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                    self.steps(check_every)
            self.graph = graph
        while True:
            self.graph.replay()
            if not bool(self.running):
                return


#: `_CG`s with their captured graphs, one a (shapes, dtype, device,
#: check_every, maxiter): a chunk of a wave, a point call and an adjoint
#: solve of a shape seen before replay its graph without capturing again
_SOLVERS: dict = {}
_SOLVERS_LOCK = named_lock("composite.cg_cache")


@torch.no_grad()
def cg(fx, fy, b, check_every: int = CG_CHECK_EVERY) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve K(fx, fy) x = b lane by lane (`_CG`): -> (x, k), with k [...]
    each lane's iteration count. `check_every=1` checks after every
    iteration, eagerly: the reference the chunked loop equals bit for bit."""
    if not (b.is_cuda and check_every > 1):
        solver = _CG(fx, fy, b)
        solver.load(fx, fy, b)
        solver.run(check_every)
        return solver.x, solver.k
    key = (fx.shape, fy.shape, b.shape, b.dtype, b.device, check_every, CG_MAXITER)
    with _SOLVERS_LOCK:
        solver = _SOLVERS.get(key) or _SOLVERS.setdefault(key, _CG(fx, fy, b))
    with solver.lock:
        solver.load(fx, fy, b)
        solver.run(check_every)
        x, k = solver.x.clone(), solver.k.clone()
        solver.done.record()
    return x, k


class _Solve(torch.autograd.Function):
    """w = K(fx, fy)^-1 rhs through `cg`, with the implicit adjoint of
    `lax.custom_linear_solve(..., symmetric=True)`, which JAX's `cg` is:
    the backward solves lambda = K^-1 w_bar with the same CG and returns
    rhs_bar = lambda and (fx, fy)_bar = -d(lambda . K(fx, fy) w)/d(fx, fy),
    the matvec's linearisation in the face coefficients."""

    @staticmethod
    def forward(ctx, fx, fy, rhs):
        w, _ = cg(fx, fy, rhs)
        ctx.save_for_backward(fx, fy, w)
        return w

    @staticmethod
    def backward(ctx, w_bar):
        fx, fy, w = ctx.saved_tensors
        lam, _ = cg(fx, fy, w_bar.contiguous())
        with torch.enable_grad():
            fx_, fy_ = fx.detach().requires_grad_(), fy.detach().requires_grad_()
            g_fx, g_fy = torch.autograd.grad(_apply_K(fx_, fy_, w), (fx_, fy_), lam)
        return -g_fx, -g_fy, lam


def solve_full(kx: torch.Tensor, ky: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Full CG solve of fields [..., NX, NY]; returns (strain_energy [...],
    u_full [..., NX, NY])."""
    fx, fy = _face_coeffs(kx, ky)
    u0 = _lifting(fx.dtype, fx.device)
    # differentiable in (fx, fy) through the implicit adjoint
    u = _with_interior(u0, _Solve.apply(fx, fy, _rhs_from_lifting(fx, fy, u0)))
    return _energy(fx, fy, u), u


def _smooth_energy_batch(thetas: torch.Tensor, softness: float) -> torch.Tensor:
    """[K, 3] -> [K]: FULL solves on the smooth defect field — the
    differentiable end-to-end program (gradients flow through `_Solve`'s
    implicit adjoint)."""
    return solve_full(*coefficient_field_smooth(thetas, softness))[0]


def _smooth_vjp_batch(thetas: torch.Tensor, senss: torch.Tensor, softness: float):
    """[K, 3] x [K, 1] -> ([K], [K, 3]): primal and VJP of the smooth full
    model in one program: the forward CG, then the adjoint CG."""
    with torch.enable_grad():
        th = thetas.detach().requires_grad_()
        y = _smooth_energy_batch(th, softness)
        (g,) = torch.autograd.grad(y, th, senss.to(y.dtype).reshape(-1))
    return y.detach(), g


@torch.no_grad()
def _full_energy_batch(kx: torch.Tensor, ky: torch.Tensor) -> torch.Tensor:
    """Batched FULL solve: [K] coefficient fields -> [K] strain energies
    (every lane's CG runs until its own test stops it)."""
    return solve_full(kx, ky)[0]


# ---------------------------------------------------------------------------
# MS-GFEM-style ROM
# ---------------------------------------------------------------------------


def _subdomain_slices():
    sx, sy = SUB
    nx, ny = _INTERIOR
    xs = np.linspace(0, nx, sx + 1, dtype=int)
    ys = np.linspace(0, ny, sy + 1, dtype=int)
    out = []
    for i in range(sx):
        for j in range(sy):
            out.append((slice(xs[i], xs[i + 1]), slice(ys[j], ys[j + 1])))
    return out


@torch.no_grad()
def _local_operator_dense(fx, fy, slc) -> np.ndarray:
    """Dense local stiffness: columns = K applied to local unit vectors
    (zero-extended), restricted back to the subdomain — one stencil call
    over all of them, on fx's device."""
    nxl = slc[0].stop - slc[0].start
    nyl = slc[1].stop - slc[1].start
    nloc = nxl * nyl
    i = torch.arange(nloc, device=fx.device)
    e = fx.new_zeros((nloc, *_INTERIOR))
    e[i, slc[0].start + i // nyl, slc[1].start + i % nyl] = 1.0
    cols = _apply_K(fx, fy, e)[:, slc[0], slc[1]].reshape(nloc, nloc)
    return cols.cpu().numpy().T  # [nloc, nloc]


def _local_basis(fx, fy, slc, q=Q_LOCAL) -> np.ndarray:
    Kloc = _local_operator_dense(fx, fy, slc)
    Kloc = 0.5 * (Kloc + Kloc.T)
    vals, vecs = np.linalg.eigh(Kloc)
    return vecs[:, :q]  # lowest-energy local modes (MS-GFEM spectral space)


def _coarse_space(w_pristine: np.ndarray) -> np.ndarray:
    """GFEM-style multiscale coarse space:
      * the pristine interior solution itself (the 'particular' function),
      * its through-stack profile p(x) modulated by hats in y — spans
        y-local variations of the laminate response (what a defect causes),
      * bilinear hats for the remaining smooth component."""
    nx, ny = _INTERIOR
    X, Y = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    bases = [w_pristine.ravel()]
    # profile x y-hats (17 nodes)
    prof = w_pristine.mean(axis=1)
    n_hat = 17
    cy = np.linspace(0, ny - 1, n_hat)
    for j, cyj in enumerate(cy):
        wy = np.clip(1 - np.abs(np.arange(ny) - cyj) / (cy[1] - cy[0]), 0, 1)
        bases.append((prof[:, None] * wy[None, :]).ravel())
    # bilinear hats
    cx = np.linspace(0, nx - 1, SUB[0] + 1)
    cyb = np.linspace(0, ny - 1, SUB[1] + 1)
    for i, cxi in enumerate(cx):
        wx = np.clip(1 - np.abs(X - cxi) / (cx[1] - cx[0]), 0, 1)
        for j, cyj in enumerate(cyb):
            wy = np.clip(1 - np.abs(Y - cyj) / (cyb[1] - cyb[0]), 0, 1)
            bases.append((wx * wy).ravel())
    return np.stack(bases, axis=1)


def _project(fx, fy, B):
    """Galerkin matrix Khat = B^T K B [..., nred, nred] of bases B
    [..., ndof, nred]: K applied to every column of B in one stencil call."""
    nred = B.shape[-1]
    cols = B.transpose(-2, -1).reshape(*B.shape[:-2], nred, *_INTERIOR)
    KB = _apply_K(fx[..., None, :, :], fy[..., None, :, :], cols)
    return B.transpose(-2, -1) @ KB.reshape(*B.shape[:-2], nred, -1).transpose(-2, -1)


@dataclass
class CompositeROM:
    """Offline/online MS-GFEM-style reduced model; its face coefficients
    (and so its online work) live on `fx0`'s device, in its dtype."""

    fx0: torch.Tensor  # pristine face coefficients
    fy0: torch.Tensor
    local_bases: list  # per-subdomain [nloc, q]
    slices: list
    coarse: np.ndarray

    @classmethod
    def offline(cls, device=None, dtype=torch.float32) -> "CompositeROM":
        device = resolve_device(device)
        kx, ky = (torch.as_tensor(k, dtype=dtype, device=device) for k in _pristine_field())
        fx, fy = _face_coeffs(kx, ky)
        slcs = _subdomain_slices()
        bases = [_local_basis(fx, fy, s) for s in slcs]
        # pristine interior correction = the GFEM particular function
        w, _ = cg(fx, fy, _rhs_from_lifting(fx, fy, _lifting(dtype, device)))
        return cls(fx, fy, bases, slcs, _coarse_space(w.cpu().numpy()))

    def _assemble_B(self, bases) -> np.ndarray:
        """[ndof, n_red]: the coarse space, then each subdomain's basis
        zero-extended to the interior grid."""
        ndof = _INTERIOR[0] * _INTERIOR[1]
        n_red = self.coarse.shape[1] + sum(b.shape[1] for b in bases)
        B = np.zeros((ndof, n_red))
        B[:, : self.coarse.shape[1]] = self.coarse
        lo = self.coarse.shape[1]
        for slc, basis in zip(self.slices, bases):
            q = basis.shape[1]
            block = B[:, lo: lo + q].reshape(*_INTERIOR, q)  # a view of B
            block[slc] = basis.reshape(slc[0].stop - slc[0].start,
                                       slc[1].stop - slc[1].start, q)
            lo += q
        return B

    def _defect_system(self, theta: np.ndarray):
        """Per-theta ONLINE prep (host side): face coefficients for the
        defected laminate and the reduced basis B, rebuilding the spectral
        basis only on subdomains the defect intersects. Returns
        (fx, fy, B, updated_subdomain_ids)."""
        kx, ky = coefficient_field(theta)
        fx, fy = _face_coeffs(*(torch.as_tensor(k, dtype=self.fx0.dtype, device=self.fx0.device)
                                for k in (kx, ky)))
        kx0, ky0 = _pristine_field()
        changed_cells = np.argwhere((kx != kx0) | (ky != ky0))
        updated = []
        bases = list(self.local_bases)
        for si, slc in enumerate(self.slices):
            if len(changed_cells) == 0:
                break
            inx = (
                (changed_cells[:, 0] - 1 >= slc[0].start)
                & (changed_cells[:, 0] - 1 < slc[0].stop)
                & (changed_cells[:, 1] >= slc[1].start)
                & (changed_cells[:, 1] < slc[1].stop)
            )
            if inx.any():
                bases[si] = _local_basis(fx, fy, slc)
                updated.append(si)
        return fx, fy, self._assemble_B(bases), updated

    @torch.no_grad()
    def online(self, theta: np.ndarray) -> tuple[float, dict]:
        """Returns (strain_energy, info). Only subdomains intersecting the
        defect rebuild their spectral basis. The Galerkin matrix is formed
        on the device in the model's dtype; the ROM is solved on the host in
        float64, as the JAX package's point call solves it."""
        fx, fy, B, updated = self._defect_system(theta)
        nred = B.shape[1]
        Khat = _project(fx, fy, torch.as_tensor(B, dtype=fx.dtype, device=fx.device))
        u0 = _lifting(fx.dtype, fx.device)
        rhs = _rhs_from_lifting(fx, fy, u0).cpu().numpy().ravel()
        fhat = B.T @ rhs
        c = np.linalg.solve(Khat.cpu().numpy() + 1e-10 * np.eye(nred), fhat)
        w = (B @ c).reshape(_INTERIOR)
        u = np.array(u0.cpu())
        u[1:-1, :] += w
        e = _energy(fx, fy, torch.as_tensor(u, device=fx.device))
        return float(e), {"updated_subdomains": updated, "n_red": nred}


@torch.no_grad()
def _rom_energy_batch(fx: torch.Tensor, fy: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched ONLINE solve: [K, ...] face coefficients + [K, ndof, nred]
    reduced bases -> [K] strain energies in one device program: the
    Galerkin projection (one stencil call over every column), the dense ROM
    solve (`torch.linalg.solve`, in the bases' dtype) and the energy."""
    Khat = _project(fx, fy, B)
    u0 = _lifting(fx.dtype, fx.device)
    rhs = _rhs_from_lifting(fx, fy, u0).reshape(len(B), -1, 1)
    fhat = B.transpose(-2, -1) @ rhs
    eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    c = torch.linalg.solve(Khat + 1e-10 * eye, fhat)
    w = (B @ c).reshape(len(B), *_INTERIOR)
    return _energy(fx, fy, _with_interior(u0, w))


class CompositeModel(Model):
    """UM-Bridge model: theta (3) -> strain energy (1).
    config: {"mode": "rom" (default) | "full",
             "defect_softness": 0 (hard ellipse indicator, default) | s > 0
             (smooth sigmoid indicator of width s — the differentiable
             variant; full mode only)}.

    Gradients are advertised for both modes — full mode differentiates the
    smooth defect field end to end through the CG solve (its implicit
    adjoint), ROM mode falls back to the base class's relative-step finite
    differences over one batched evaluate wave (the online basis rebuild is
    host-side and non-differentiable). Runs on `device` (default: the GPU;
    raises if there is none) in `DTYPE`; a wave solves exactly its N lanes,
    in chunks of `BATCH_CHUNK`."""

    #: chunk width for `evaluate_batch` — bounds the [K, ndof, nred] basis
    #: stack (~3 MB/theta) while keeping the batched matmuls wide
    BATCH_CHUNK = 16
    DTYPE = torch.float32

    def __init__(self, device=None):
        super().__init__("forward")
        self.device = resolve_device(device)
        self.rom = CompositeROM.offline(self.device, self.DTYPE)
        # waves arrive from fabric collector / server handler threads
        self._lock = named_lock("composite.stats")
        self.stats = {"rom": 0, "full": 0}

    def get_input_sizes(self, config=None):
        return [3]

    def get_output_sizes(self, config=None):
        return [1]

    def capabilities(self, config=None) -> Capabilities:
        return Capabilities(
            evaluate=True, evaluate_batch=True,
            gradient=True, gradient_batch=True,
        )

    @staticmethod
    def _softness(config) -> float:
        return float((config or {}).get("defect_softness", 0.0))

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.DTYPE, device=self.device)

    @torch.no_grad()
    def __call__(self, parameters, config=None):
        theta = np.asarray(parameters[0], float)
        mode = (config or {}).get("mode", "rom")
        if mode == "full":
            soft = self._softness(config)
            with self._lock:
                self.stats["full"] += 1
            if soft > 0.0:
                return [[float(_smooth_energy_batch(self._t(theta[None, :]), soft)[0])]]
            kx, ky = coefficient_field(theta)
            return [[float(solve_full(self._t(kx), self._t(ky))[0])]]
        e, _ = self.rom.online(theta)
        with self._lock:
            self.stats["rom"] += 1
        return [[e]]

    @torch.no_grad()
    def evaluate_batch(self, thetas, config=None) -> np.ndarray:
        """[N, 3] -> [N, 1] in chunks of `BATCH_CHUNK` lanes, unpadded. ROM
        mode: the per-theta spectral-basis updates stay host-side (they
        touch only defect-intersecting subdomains), while the Galerkin
        projections, ROM solves and energy reductions of a whole chunk run
        as one device program. Full mode: one CG over the chunk's lanes."""
        mode = (config or {}).get("mode", "rom")
        thetas = np.atleast_2d(np.asarray(thetas, float))
        N = len(thetas)
        with self._lock:
            self.stats[mode] += N
        energies = np.empty(N)
        soft = self._softness(config)
        for lo in range(0, N, self.BATCH_CHUNK):
            part = thetas[lo: lo + self.BATCH_CHUNK]
            if mode == "full" and soft > 0.0:
                e = _smooth_energy_batch(self._t(part), soft)
            elif mode == "full":
                ks = [coefficient_field(t) for t in part]
                e = _full_energy_batch(self._t(np.stack([k[0] for k in ks])),
                                       self._t(np.stack([k[1] for k in ks])))
            else:
                sys = [self.rom._defect_system(t) for t in part]
                B = np.stack([s[2] for s in sys]).astype(np.float32)
                e = _rom_energy_batch(torch.stack([s[0] for s in sys]),
                                      torch.stack([s[1] for s in sys]), self._t(B))
            energies[lo: lo + len(part)] = e.cpu().numpy()
        return energies[:, None]

    # -- batched derivative surface -----------------------------------------
    def gradient(self, out_wrt, in_wrt, parameters, sens, config=None):
        theta = np.asarray(parameters[in_wrt], float)
        return self.gradient_batch(
            theta[None, :], np.asarray(sens, float)[None, :], config
        )[0].tolist()

    def gradient_batch(self, thetas, senss, config=None) -> np.ndarray:
        """[N, 3] x [N, 1] -> [N, 3]. Full mode: reverse mode through the
        SMOOTH defect field and the CG solve's implicit adjoint, one fused
        primal + VJP program a chunk (softness defaults to `DEFECT_SOFTNESS`
        when the config carries the hard indicator — gradients of a
        piecewise-constant map are zero a.e. and useless, so the smooth
        surrogate defines them). ROM mode: the base class's relative-step
        FD fallback over one evaluate wave."""
        mode = (config or {}).get("mode", "rom")
        thetas = np.atleast_2d(np.asarray(thetas, float))
        senss = np.atleast_2d(np.asarray(senss, float))
        if mode != "full":
            return self._fd_gradient_batch(thetas, senss, config)
        soft = self._softness(config) or DEFECT_SOFTNESS
        N = len(thetas)
        with self._lock:
            self.stats["full"] += N
        grads = np.empty((N, 3))
        for lo in range(0, N, self.BATCH_CHUNK):
            part = thetas[lo: lo + self.BATCH_CHUNK]
            spart = senss[lo: lo + self.BATCH_CHUNK]
            _, g = _smooth_vjp_batch(self._t(part), self._t(spart), soft)
            grads[lo: lo + len(part)] = g.cpu().numpy()
        return grads
