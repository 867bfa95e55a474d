"""PyTorch port: the optimizer (`repro_torch.optim`) against the JAX
package's (`repro.optim`), on the same numpy trees.

`adamw_update` over three steps (one clipped, with weight decay on the
leaves the mask picks), with float32 and bfloat16 moments and a bfloat16
parameter leaf: every parameter, moment, step, the global norm and the
learning rate within 1e-6 relative of the reference's (each leaf's largest
error over its largest element; printed with -s). Both compute the same
IEEE float32 operations, so the measured errors are 0 or a float32 ulp.
`lr_schedule` over warmup, cosine and past the end; the decay mask leaf for
leaf; int8 error-feedback compression bit for bit (`torch.round` and
`jnp.round` both round half to even; ties are in the inputs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jax_adamw
from repro.optim import compression as jax_comp
from repro.types import TrainConfig as JaxTrainConfig
from repro_torch.models.params import tree_leaves, tree_leaves_with_path, tree_map
from repro_torch.optim import adamw, compression
from repro_torch.types import TrainConfig

RTOL = 1e-6


def _tree(rng, bf16_leaf: bool = True) -> dict:
    """A parameter-like tree: stacked groups, norms, a bias, an embedding."""
    tree = {
        "embed": {"embedding": rng.standard_normal((16, 8))},
        "groups": [{"attn": {"wq": rng.standard_normal((2, 8, 2, 4)),
                             "q_norm": rng.standard_normal((2, 4))},
                    "ln1": {"scale": rng.standard_normal((2, 8))},
                    "mlp": {"w_up": rng.standard_normal((2, 8, 12)),
                            "b": rng.standard_normal((2, 12))}}],
        "final_norm": {"scale": rng.standard_normal((8,))},
        "bias": rng.standard_normal((5,)),
    }
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    if bf16_leaf:
        tree["head"] = rng.standard_normal((8, 16)).astype(np.float32)
    return tree


def _jax(tree, bf16_head: bool):
    out = jax.tree.map(jnp.asarray, tree)
    if bf16_head and "head" in out:
        out["head"] = out["head"].astype(jnp.bfloat16)
    return out


def _torch(tree, bf16_head: bool):
    out = tree_map(lambda a: torch.tensor(np.array(a)), tree)
    if bf16_head and "head" in out:
        out["head"] = out["head"].to(torch.bfloat16)
    return out


def _rel(got: torch.Tensor, want) -> float:
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max() / scale)


def _assert_trees(got, want, what: str) -> float:
    leaves, jleaves = tree_leaves(got), jax.tree.leaves(want)
    assert len(leaves) == len(jleaves)
    worst = 0.0
    for (path, t), j in zip(tree_leaves_with_path(got), jleaves):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype), (path, t.dtype, j.dtype)
        err = _rel(t, j)
        assert err <= RTOL, f"{what} {path}: {err:.3g}"
        worst = max(worst, err)
    return worst


@pytest.mark.parametrize("opt_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(opt_dtype):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1, grad_clip=1.0,
              opt_state_dtype=opt_dtype)
    jtc, tc = JaxTrainConfig(**kw), TrainConfig(**kw)
    jp, tp = _jax(params, True), _torch(params, True)
    jopt, topt = jax_adamw.adamw_init(jp, jtc), adamw.adamw_init(tp, tc)
    assert topt["step"].dtype == torch.int32 and topt["step"].dim() == 0
    worst = 0.0
    for step, gscale in enumerate((0.05, 3.0, 0.5)):  # the second is clipped
        grads = jax.tree.map(lambda a: a * np.float32(gscale), _tree(rng))
        jp, jopt, jstats = jax_adamw.adamw_update(jp, _jax(grads, True), jopt, jtc)
        tp_in = tp
        tp, topt, stats = adamw.adamw_update(tp, _torch(grads, True), topt, tc)
        assert tp is tp_in  # updated in place, the same tree
        assert int(topt["step"]) == int(jopt["step"]) == step + 1
        assert topt["step"].dtype == torch.int32
        for name in ("grad_norm", "lr"):
            assert _rel(stats[name], jstats[name]) <= RTOL, name
        worst = max(worst, _assert_trees(tp, jp, f"params, step {step}"),
                    _assert_trees(topt["mu"], jopt["mu"], f"mu, step {step}"),
                    _assert_trees(topt["nu"], jopt["nu"], f"nu, step {step}"))
    print(f"adamw {opt_dtype}: worst leaf {worst:.3g}")


def test_clipping_and_global_norm():
    rng = np.random.default_rng(1)
    grads = jax.tree.map(lambda a: a * np.float32(10.0), _tree(rng, bf16_leaf=False))
    want = jax_adamw.global_norm(_jax(grads, False))
    got = adamw.global_norm(_torch(grads, False))
    assert got.dtype == torch.float32 and _rel(got, want) <= RTOL
    assert float(got) > 1.0  # grad_clip 1: the update is clipped
    # a clipped step moves the first moment by (1 - b1) * g / |g|
    tc = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=4, grad_clip=1.0)
    params = _torch(_tree(rng, bf16_leaf=False), False)
    opt = adamw.adamw_init(params, tc)
    g = _torch(grads, False)
    adamw.adamw_update(params, g, opt, tc)
    for mu, gl in zip(tree_leaves(opt["mu"]), tree_leaves(g)):
        torch.testing.assert_close(mu, (1 - tc.beta1) * gl / got, rtol=1e-6, atol=1e-9)


def test_lr_schedule_matches_jax():
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100)
    jtc, tc = JaxTrainConfig(**kw), TrainConfig(**kw)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        want = jax_adamw.lr_schedule(jtc, jnp.asarray(step, jnp.int32))
        got = adamw.lr_schedule(tc, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert _rel(got, want) <= RTOL or float(want) == float(got) == 0.0, step


def test_decay_mask_matches_jax():
    tree = _jax(_tree(np.random.default_rng(2)), True)
    want = [jax_adamw._decay_mask(path, leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]
    got = [adamw._decay_mask(path, leaf)
           for path, leaf in tree_leaves_with_path(_torch(_tree(np.random.default_rng(2)),
                                                                True))]
    assert got == want
    assert True in got and False in got  # norms, scales and 1-d leaves are not decayed


def test_int8_quantize_bit_for_bit():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 33)).astype(np.float32)
    x[0, :4] = [127.0, -127.0, 0.5, -0.5]  # scale 1 (+1e-12/127): ties at +-0.5
    x[1, :3] = [2.5, -1.5, 0.0]
    for arr in (x, x * 1e-3, np.zeros((4, 4), np.float32)):
        jq, js = jax_comp.quantize_int8(jnp.asarray(arr))
        q, s = compression.quantize_int8(torch.tensor(arr))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        np.testing.assert_array_equal(compression.dequantize_int8(q, s).numpy(),
                                      np.asarray(jax_comp.dequantize_int8(jq, js)))


def test_error_feedback_bit_for_bit():
    rng = np.random.default_rng(4)
    params = _tree(rng, bf16_leaf=False)
    jerr = jax_comp.init_error_state(_jax(params, False))
    err = compression.init_error_state(_torch(params, False))
    for _ in range(3):
        grads = _tree(rng, bf16_leaf=False)
        jg, jerr = jax_comp.compress_with_feedback(_jax(grads, False), jerr)
        g, err = compression.compress_with_feedback(_torch(grads, False), err)
        for t, j in zip(tree_leaves(g), jax.tree.leaves(jg)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        for t, j in zip(tree_leaves(err), jax.tree.leaves(jerr)):
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
