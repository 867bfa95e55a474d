"""LM-as-UQ-model bridge (counterpart of `repro.apps.lm_model`): an
architecture of the LM zoo as an UM-Bridge model.

The expensive "numerical model" behind the UM-Bridge interface is an LM
forward pass. theta parameterizes a model perturbation:

    theta = (embedding_scale, logit_temperature)
    F(theta) = mean eval NLL on a fixed batch under the perturbed model

F is smooth in theta, so the whole UM-Bridge surface is served, as the JAX
package's `JAXModel` serves it by AD: evaluate, gradient, Jacobian and
Hessian actions, each per point and batched. A wave of K points is one
forward over the K points' K·B sequences; a derivative wave adds one
reverse pass of the stack (`_reverse_wave`). Which path each takes:

* evaluate and the first derivatives (gradient, Jacobian action, fused
  value-and-gradient) run `cfg.attn_impl`: on the kernel path the flash
  kernels, forward and backward (`kernels/flash_attention/ops.py::
  FlashAttention`), the forward twice a layer under `cfg.remat="full"`
  (forward and recompute);
* the ssm and hybrid families take their first derivatives on the plain SSD
  (`attn_impl="plain"`, as `launch/train.py` trains them): the SSD kernel
  has no backward yet (ROADMAP queue 2, item 13e) and raises under autograd;
* the Hessian action runs reverse-over-reverse on `attn_impl="plain"` for
  every family: no kernel has a second derivative (the flash backward is
  once-differentiable and raises if differentiated again), and the JAX
  package's own Hessian differentiates its XLA attention twice.

On a device mesh (`ctx=`, a `distributed.sharding.ShardingCtx`, the model
built on every rank with the same weights) the weights are DTensors placed
by `models.model.param_specs`: FSDP over 'data', TP and EP over 'model'
(`models.model.shard_params`; each rank keeps its shards). Every wave is
then one program over the mesh, the kernels on each rank's local shards
(`models/attention.py::_attend_local`):

* an evaluate wave of K points is split over the batch axes: padded to a
  multiple of `ctx.n_data` (the last point repeated), its sequences placed
  so that each rank's rows are its contiguous points, one forward of the
  stack, then point by point each rank's j-th point's head and NLL (the
  vocabulary over 'model'; the scaled tied head, the padded-vocab mask and
  the temperature on local shards, `_mesh_logits`), and the NLLs gathered
  to every rank on the host;
* the derivative operations take the whole wave on every rank and return
  the whole wave's results on every rank, as the JAX package's
  `SPMDBackend` runs derivative waves: the stack runs as any step on the
  mesh, its hidden states are gathered, and the reverse pass is DTensor's
  autograd through the sharded weights (the flash backward kernel on local
  shards). The Hessian action runs reverse over reverse the same way, on
  the mesh layer's own DTensor rules (`distributed.sharding.redistribute`
  and `ShardingCtx.local_map`), whose backward stays on the autograd
  graph: DTensor's own build some gradients off it, and the second
  backward lost those paths.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.core.interface import Capabilities, Model, pad_to_bucket
from repro_torch.distributed.sharding import P, on_mesh, reduce_partial
from repro_torch.models import model as M
from repro_torch.models import transformer
from repro_torch.models.layers import lm_head
from repro_torch.types import dtype_of


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A small result (a value, theta's gradient) as a plain tensor on this
    rank. On a mesh theta is a plain tensor that meets the DTensors as
    replicated, so its gradient comes back a DTensor: its full value."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


class LMUQModel(Model):
    """theta = (embedding scale, logit temperature) -> [mean NLL].

    `batch` is the number of sequences of a synthetic batch drawn from
    `seed + 1` (as the JAX package draws it), or the batch itself: a mapping
    with numpy ``tokens`` and ``targets`` [B, S] and, for the vlm family,
    float ``ctx_embed [B, n_ctx_tokens, d_ctx]``. `params` replaces the
    weights drawn from `seed` (e.g. weights carried across from the JAX
    package by `repro_torch.convert.lm_params_from_numpy`). `n_layers` cuts
    the architecture's depth (widths kept; a vlm model's must be a multiple
    of its cross-attention period). Runs on `device` (default: the GPU;
    raises if there is none; on a mesh, the rank's current card). `ctx`
    shards the weights over a mesh and runs every wave on it (module
    docstring)."""

    # one forward per wave of N points, over N·B sequences. No `batch_bucket`:
    # the JAX package pads waves to powers of two to bound its jit trace
    # cache; the port runs eagerly and has no such cache, so padding would
    # only add thrown-away forwards (41 points as a 64-point wave)

    def __init__(self, arch: str, reduced: bool = True, batch=2, seq: int = 64,
                 seed: int = 0, device=None, params=None, n_layers: int | None = None,
                 ctx=None):
        super().__init__(f"lm-{arch}")
        self.ctx = ctx
        self.cfg = get_config(arch, reduced=reduced)
        if n_layers is not None:
            self.cfg = self.cfg.replace(n_layers=int(n_layers))
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = M.init_params(self.cfg, gen)
        self.params = params if ctx is None else M.shard_params(self.cfg, params, ctx)
        if isinstance(batch, Mapping):
            self.batch = {k: torch.as_tensor(np.array(batch[k]), dtype=torch.long,
                                             device=self.device)
                          for k in ("tokens", "targets")}
            if batch.get("ctx_embed") is not None:
                self.batch["ctx_embed"] = torch.as_tensor(
                    np.array(batch["ctx_embed"], np.float32), device=self.device
                ).to(dtype_of(self.cfg.act_dtype))
        else:
            gen = torch.Generator(device=self.device).manual_seed(seed + 1)
            self.batch = M.make_synth_batch(self.cfg, int(batch), seq, gen)

    def get_input_sizes(self, config=None):
        return [2]

    def get_output_sizes(self, config=None):
        return [1]

    def capabilities(self, config=None) -> Capabilities:
        return Capabilities(
            evaluate=True, gradient=True, apply_jacobian=True, apply_hessian=True,
            evaluate_batch=True, gradient_batch=True,
            apply_jacobian_batch=True, apply_hessian_batch=True,
        )

    def __call__(self, parameters, config=None):
        theta = np.asarray(parameters[0], float)
        return [[float(self.evaluate_batch(theta[None, :], config)[0, 0])]]

    def evaluate_batch(self, thetas, config=None) -> np.ndarray:
        """[K, 2] -> [K, 1]: one forward over the wave (`_evaluate_wave`); on
        a mesh, one forward of the padded wave over the mesh, each rank's
        points' NLLs gathered to every rank (`_evaluate_wave_on_mesh`)."""
        thetas = np.atleast_2d(np.asarray(thetas, float))
        if self.ctx is None:
            return self._evaluate_wave(thetas)
        K = len(thetas)
        wave, _ = pad_to_bucket(thetas, K + (-K) % self.ctx.n_data)
        return self.ctx.gather_rows(self._evaluate_wave_on_mesh(wave))[:K]

    @torch.inference_mode()
    def _evaluate_wave(self, thetas) -> np.ndarray:
        """[K, 2] -> [K, 1]: ONE forward over the K points' [K*B, S] tokens
        (point k's copy of the batch has its embedding rows scaled by
        theta_k[0]; a vlm batch's context embeddings ride along unscaled;
        a MoE routes each point's B sequences on their own, as the JAX
        package's vmap does); then per point the head, the padded-vocab
        mask and the log-softmax over its [B*S, V] logits at temperature
        theta_k[1], so the wave's logits are never held at once. A tied head
        reads point k's table scaled by theta_k[0], as the JAX package's
        does."""
        theta = self._theta(thetas)
        hidden = self._hidden(self.cfg, theta)
        out = torch.empty(len(theta), dtype=torch.float32, device=self.device)
        for k in range(len(theta)):
            out[k] = self._nll(self.cfg, self._rows(hidden, k), theta[k])
        return out.cpu().numpy().astype(float)[:, None]

    @torch.no_grad()  # DTensor's views fail on inference tensors
    def _evaluate_wave_on_mesh(self, wave) -> np.ndarray:
        """This rank's points of the padded wave [K, 2] -> [K / n_data, 1]:
        ONE forward of the whole wave over the mesh, its sequences placed
        over the batch axes so that each rank's rows are its own points
        (`ctx.rows`), then for j = 0, 1, ... the NLLs of every rank's j-th
        point at once (`_mesh_nlls`), of which each rank keeps its own."""
        ctx = self.ctx
        theta = self._theta(wave)
        per = len(theta) // ctx.n_data
        with on_mesh(ctx):
            hidden = self._hidden(self.cfg, theta)
            out = np.empty((per, 1))
            for j in range(per):
                nll = self._mesh_nlls(self.cfg, hidden, theta[j::per], j)
                out[j, 0] = float(nll.to_local()[0])
        return out

    def _mesh_nlls(self, cfg, hidden, theta_j: torch.Tensor, j: int):
        """The NLLs ``[n_data]`` (a DTensor over the batch axes) of each batch
        rank's j-th point: its B rows of the wave's hidden states (picked on
        each rank's local shard), the logits over the vocabulary sharded
        over 'model' (`_mesh_logits`), then DTensor's log-softmax and the
        mean of each point's rows on its rank. `theta_j` ``[n_data, 2]``:
        those points' thetas in batch-rank order."""
        ctx = self.ctx
        B = self.batch["tokens"].shape[0]
        bat = ctx.batch_axes
        rows = P(bat, None, None)
        h = ctx.local_map(lambda hl: hl[j * B:(j + 1) * B], rows, (rows,))(hidden)
        logits = self._mesh_logits(cfg, h, ctx.put(theta_j, "batch", None))
        targets = ctx.put(self.batch["targets"].repeat(ctx.n_data, 1), "batch", None)
        logz = M.logsumexp(logits)
        tgt = reduce_partial(torch.gather(logits, -1, targets[..., None]))[..., 0]
        return ctx.local_map(lambda d: torch.mean(d).reshape(1), P(bat), (P(bat, None),))(
            logz - tgt)

    def _mesh_logits(self, cfg, h, theta):
        """``[n_data*B, S, V]`` float32 logits of each batch rank's point,
        the vocabulary over 'model' where it divides: on each rank's local
        shards, its point's head (a tied head reads the table scaled by the
        point's theta[0], gathered over 'data', the FSDP all-gather), the
        padded-vocab mask (its local columns) and the temperature, the
        operations `_nll` runs on one device."""
        ctx = self.ctx
        V = cfg.padded_vocab
        vocab = "model" if V % ctx.n_model == 0 else None
        c0 = ctx.coordinate["model"] * (V // ctx.n_model) if vocab else 0
        embed = ctx.gather_fsdp(self.params["embed"])
        name = "head" if "head" in embed else "embedding"
        w_spec = P(None, vocab) if name == "head" else P(vocab, None)
        bat = ctx.batch_axes

        def local(x, w, th):
            logits = lm_head({name: w}, x, th[0, 0]).float()
            if cfg.padded_vocab != cfg.vocab_size:
                cols = c0 + torch.arange(logits.shape[-1], device=logits.device)
                logits = logits.masked_fill(cols >= cfg.vocab_size, -1e9)
            return logits / th[0, 1]

        return ctx.local_map(local, P(bat, None, vocab),
                             (P(bat, None, None), w_spec, P(bat, None)))(h, embed[name], theta)

    # -- the derivative surface ---------------------------------------------
    def gradient(self, out_wrt, in_wrt, parameters, sens, config=None):
        """sens^T J at one point: a wave of one (`gradient_batch`)."""
        theta = np.asarray(parameters[in_wrt], float)
        return self.gradient_batch(theta[None, :], np.asarray(sens, float).reshape(1, 1),
                                   config)[0].tolist()

    def gradient_batch(self, thetas, senss, config=None) -> np.ndarray:
        """[K, 2] x [K, 1] -> [K, 2], row k = senss[k] * dF/dtheta at
        thetas[k]: ONE forward over the K·B sequences with theta a leaf that
        requires grad, then ONE reverse pass of the stack (`_reverse_wave`)
        to theta alone (no weight-gradient product runs, whether or not the
        weights require grad)."""
        senss = np.atleast_2d(np.asarray(senss, np.float32))
        return self._reverse_wave(thetas, lambda k, _y: float(senss[k, 0]))[1]

    def value_and_gradient_batch(self, thetas, sens_fn, config=None):
        """(ys [K, 1], grads [K, 2]) with grads[k] = sens_fn(ys[k]) *
        dF/dtheta at thetas[k], in the one forward and the one reverse pass
        of `gradient_batch`: each point's NLL comes from that forward, and
        `sens_fn` (a row [1] of numpy -> a row [1]) sees it before the
        point's head is differentiated."""
        def sens(_k, y):
            return float(np.asarray(sens_fn(np.array([y])), float).ravel()[0])

        return self._reverse_wave(thetas, sens)

    def apply_jacobian(self, out_wrt, in_wrt, parameters, vec, config=None):
        """J vec at one point: a wave of one (`apply_jacobian_batch`)."""
        theta = np.asarray(parameters[in_wrt], float)
        return self.apply_jacobian_batch(theta[None, :], np.asarray(vec, float)[None, :],
                                         config)[0].tolist()

    def apply_jacobian_batch(self, thetas, vecs, config=None) -> np.ndarray:
        """[K, 2] x [K, 2] -> [K, 1], row k = J(thetas[k]) vecs[k]. F has one
        output, so J is one row, the gradient at sens = 1: the same reverse
        wave as `gradient_batch`, then a dot product with each vec. Forward
        mode (`torch.func.jvp`) cannot cross the flash kernels' autograd
        Function, which has no `jvp`."""
        vecs = np.atleast_2d(np.asarray(vecs, float))
        grads = self._reverse_wave(thetas, lambda _k, _y: 1.0)[1]
        return np.sum(grads * vecs, axis=1, keepdims=True)

    def apply_hessian(self, out_wrt, in_wrt1, in_wrt2, parameters, sens, vec, config=None):
        """d/de [J(theta + e vec)^T sens] at one point: a wave of one
        (`apply_hessian_batch`)."""
        theta = np.asarray(parameters[in_wrt1], float)
        return self.apply_hessian_batch(theta[None, :], np.asarray(sens, float).reshape(1, 1),
                                        np.asarray(vec, float)[None, :], config)[0].tolist()

    def apply_hessian_batch(self, thetas, senss, vecs, config=None) -> np.ndarray:
        """[K, 2] x [K, 1] x [K, 2] -> [K, 2], row k = senss[k] * H(thetas[k])
        vecs[k]: reverse over reverse, on `attn_impl="plain"` for every
        family (no kernel has a second derivative: the flash backward is
        once-differentiable, the SSD kernel raises under autograd). One
        forward over the K·B sequences, the per-point heads kept in the
        graph, a first backward that keeps its own graph, and a second
        backward of its dot product with the vecs (the points are
        independent, so row k is point k's Hessian action)."""
        cfg = self.cfg.replace(attn_impl="plain")
        K = len(np.atleast_2d(thetas))
        senss = torch.as_tensor(self._even_wave(np.asarray(senss, np.float32)),
                                device=self.device)
        vecs = torch.as_tensor(self._even_wave(np.asarray(vecs, np.float32)), device=self.device)
        theta = self._theta(self._even_wave(thetas)).requires_grad_()
        with torch.enable_grad(), on_mesh(self.ctx):
            hidden = self._whole_wave(self._hidden(cfg, theta))
            total = sum(senss[k, 0] * self._nll(cfg, self._rows(hidden, k), theta[k])
                        for k in range(len(theta)))
            (grad,) = torch.autograd.grad(total, theta, create_graph=True)
            (hvp,) = torch.autograd.grad(torch.sum(_plain(grad) * vecs), theta)
        return _plain(hvp).cpu().numpy().astype(float)[:K]

    # -- machinery ----------------------------------------------------------
    def _theta(self, thetas) -> torch.Tensor:
        thetas = np.atleast_2d(np.asarray(thetas, np.float32))
        return torch.as_tensor(thetas, device=self.device)

    def _rows(self, hidden: torch.Tensor, k: int) -> torch.Tensor:
        """Point k's B sequences of the wave's hidden states."""
        B = self.batch["tokens"].shape[0]
        return hidden[k * B:(k + 1) * B]

    def _hidden(self, cfg, theta: torch.Tensor) -> torch.Tensor:
        """The stack's final hidden states of the wave ``[K*B, S, d]``: ONE
        forward over the K points' copies of the batch, point k's embedding
        rows scaled by theta[k, 0]."""
        tokens = self.batch["tokens"]
        B, K = tokens.shape[0], len(theta)
        ctx_embed = self.batch.get("ctx_embed")
        hidden, _, _ = transformer.forward(
            cfg, self.params, tokens.repeat(K, 1), mode="train", skip_head=True,
            embed_scale=theta[:, 0].repeat_interleave(B), points=K,
            ctx_embed=None if ctx_embed is None else ctx_embed.repeat(K, 1, 1), ctx=self.ctx,
        )
        return hidden

    def _even_wave(self, rows):
        """A derivative wave's rows (thetas, senss or vecs), on a mesh
        padded (the last row repeated) to a multiple of the mesh's ranks;
        as they are without one. DTensor's propagation may shard the points
        (and their K·B sequences) over every mesh axis, and the backward of
        a view fails on ragged shards. The points are independent, so the
        padding leaves the real points' results as they are."""
        rows = np.atleast_2d(np.asarray(rows))
        if self.ctx is None:
            return rows
        K, n = len(rows), self.ctx.mesh.size()
        return pad_to_bucket(rows, K + (-K) % n)[0]

    def _whole_wave(self, hidden):
        """A derivative wave's hidden states on every rank: on a mesh, the
        stack's DTensor gathered over the batch axes (each point's head
        then runs on every rank; its vocabulary stays over 'model')."""
        return hidden if self.ctx is None else self.ctx.constrain(hidden, None, None, None)

    def _nll(self, cfg, hidden: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
        """One point's mean NLL from its B sequences' hidden states: the head
        (tied: the table scaled by theta[0]; on a mesh gathered over 'data'),
        the padded-vocab mask and the log-softmax at temperature theta[1],
        in float32."""
        embed = self.params["embed"] if self.ctx is None else self.ctx.gather_fsdp(
            self.params["embed"])
        logits = lm_head(embed, hidden, theta[0])
        logits = M.mask_padded_logits(cfg, logits.float()) / theta[1]
        logz = M.logsumexp(logits)
        tgt = reduce_partial(torch.gather(logits, -1, self.batch["targets"][..., None]))[..., 0]
        return torch.mean(logz - tgt)

    def _derivative_cfg(self):
        """The config of a first-derivative wave: `self.cfg`, but the ssm and
        hybrid families on the plain SSD (ROADMAP queue 2, item 13e)."""
        if self.cfg.family in ("ssm", "hybrid"):
            return self.cfg.replace(attn_impl="plain")
        return self.cfg

    def _reverse_wave(self, thetas, sens) -> tuple[np.ndarray, np.ndarray]:
        """(values [K, 1], grads [K, 2]) of one wave, grads[k] = sens(k,
        values[k]) * dF/dtheta at thetas[k]. ONE forward of the stack with
        theta a leaf that requires grad; then per point, on a detached
        leaf of its hidden states, its NLL and the gradient of sens * NLL
        with respect to those hidden states and to its theta (the head's
        part: the tied table's scale, the temperature), so that at most one
        point's [B, S, V] float32 logits are alive at a time; then ONE
        backward of the stack with the stacked hidden-state gradients,
        which adds the embedding scale's part into theta's gradient."""
        cfg = self._derivative_cfg()
        K = len(np.atleast_2d(thetas))
        theta = self._theta(self._even_wave(thetas)).requires_grad_()
        n = len(theta)
        values = np.empty((n, 1))
        head_grad = torch.empty_like(theta)
        with torch.enable_grad(), on_mesh(self.ctx):
            hidden = self._whole_wave(self._hidden(cfg, theta))
            hidden_grads = []
            for k in range(n):
                h = self._rows(hidden, k).detach().requires_grad_()
                t = theta[k].detach().requires_grad_()
                nll = self._nll(cfg, h, t)
                values[k, 0] = float(_plain(nll.detach()))
                s = torch.tensor(sens(min(k, K - 1), values[k, 0]), dtype=nll.dtype,
                                 device=self.device)
                g_h, g_t = torch.autograd.grad(nll * s, (h, t))
                hidden_grads.append(g_h)
                head_grad[k] = _plain(g_t)
            torch.autograd.backward(hidden, torch.cat(hidden_grads), inputs=[theta])
        grads = (_plain(theta.grad) + head_grad).cpu().numpy().astype(float)
        return values[:K], grads[:K]
