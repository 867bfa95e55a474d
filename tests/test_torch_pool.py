"""PyTorch port: the device pool (`core/pool.py::ModelPool`), its fabric
backend (`core/fabric.py::SPMDBackend`) and `core/scheduler.py::
BatchingExecutor` — tests/test_core.py's pool and executor tests,
test_fabric.py's coercion and dtype tests, test_system.py's oblivious UQ
loop and test_batch_native.py's bucketing test re-pointed at a
`TorchModel` (no padding: a wave runs at its own width), the derivative
ops against the model's own batched ops bit for bit, the reduced
qwen3-0.6b `LMUQModel` grid through `ModelPool` against `ModelBackend`,
and the pool against the JAX package's on the same function."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.fabric as jax_fabric
import repro.core.pool as jax_pool
from repro.core.interface import JAXModel
from _torch_mesh import one_rank_mesh
from repro_torch.core.fabric import (
    CallableBackend,
    EvaluationFabric,
    FabricRouter,
    ModelBackend,
    SPMDBackend,
    ThreadedBackend,
    as_backend,
)
from repro_torch.core.interface import TorchModel
from repro_torch.core.pool import ModelPool, ThreadedPool
from repro_torch.core.scheduler import BatchingExecutor

torch.set_num_threads(1)


def quad(th):
    return torch.stack([torch.sum(th ** 2), th[0] * th[1]])


def elementwise(th):
    return torch.stack([th[0] ** 2 + th[1] * th[2], torch.sin(th[0]) * th[1]])


class _TorchModel64(TorchModel):
    DTYPE = torch.float64


@pytest.fixture(scope="module")
def quad_model():
    return TorchModel(quad, 2, 2, device="cpu")


# -- tests/test_core.py ---------------------------------------------------------


def test_pool_order_and_no_padding(quad_model):
    pool = ModelPool(quad_model)
    thetas = np.random.default_rng(0).standard_normal((7, 2))  # not a power of 2
    out = pool.evaluate(thetas)
    assert out.shape == (7, 2)
    np.testing.assert_allclose(out[:, 0], np.sum(thetas**2, axis=1), rtol=1e-5)
    assert pool.stats == {"batches": 1, "evaluations": 7, "padded": 0, "bucket_shapes": 1}


def test_batching_executor_is_transparent(quad_model):
    pool = ModelPool(quad_model)
    with BatchingExecutor(pool, linger_s=0.005) as ex:
        futs = [ex.submit([i * 0.1, 1.0]) for i in range(17)]
        for i, f in enumerate(futs):
            np.testing.assert_allclose(
                f.result(), [(i * 0.1) ** 2 + 1.0, i * 0.1], rtol=1e-4, atol=1e-5
            )
    assert ex.stats["waves"] <= 17  # batching actually batched something
    assert ex.max_batch == 4 * pool.n_instances and ex.cache_size == 0


def test_batching_executor_blocking_evaluate(quad_model):
    with BatchingExecutor(ModelPool(quad_model)) as ex:
        np.testing.assert_allclose(ex([1.0, 2.0]), [5.0, 2.0], rtol=1e-6)
        np.testing.assert_allclose(ex.evaluate([0.5, 2.0]), [4.25, 1.0], rtol=1e-6)


# -- tests/test_fabric.py -------------------------------------------------------


def test_as_backend_coercion(quad_model):
    assert isinstance(as_backend(ModelPool(quad_model)), SPMDBackend)
    backend = as_backend(quad_model)
    assert isinstance(backend, SPMDBackend) and backend.pool.model is quad_model
    tp = ThreadedPool([quad_model], n_instances=None)
    assert isinstance(as_backend(tp), ThreadedBackend)
    assert isinstance(as_backend(lambda X: X), CallableBackend)
    # a list holding a pool is a router over independent backends
    router = as_backend([ModelPool(quad_model), tp])
    assert isinstance(router, FabricRouter)
    assert [b.name for b in router.backends] == ["spmd", "threaded"]
    tp.shutdown()
    with pytest.raises(TypeError):
        as_backend(42)


def test_model_pool_honors_the_model_dtype():
    """The counterpart of test_model_pool_honors_x64: a float64 TorchModel's
    pool returns float64, equal to the point call."""
    m = _TorchModel64(lambda th: th * 1.0, 1, 1, device="cpu")
    out = ModelPool(m).evaluate(np.array([[1.0 + 1e-12]]))
    direct = np.asarray(m([[1.0 + 1e-12]])[0])
    assert out.dtype == np.float64
    np.testing.assert_array_equal(out.ravel(), direct.ravel())
    out32 = ModelPool(TorchModel(lambda th: th * 1.0, 1, 1, device="cpu")).evaluate(
        np.array([[1.0 + 1e-12]]))
    assert out32.dtype == np.float32


# -- tests/test_system.py -------------------------------------------------------


def test_uq_drives_pool_obliviously():
    """A 'prototype-grade' sequential UQ loop (MC mean) drives the device
    pool through per-point submits — the §3.1 separation-of-concerns
    invariant."""
    pool = ModelPool(TorchModel(lambda th: torch.atleast_1d(torch.sum(th**2)), 3, 1,
                                device="cpu"))
    with BatchingExecutor(pool, linger_s=0.01) as ex:
        rng = np.random.default_rng(0)
        thetas = rng.standard_normal((64, 3))
        futs = [ex.submit(t) for t in thetas]
        vals = np.array([float(fu.result()[0]) for fu in futs])
    assert np.allclose(vals, np.sum(thetas**2, axis=1), rtol=1e-5)
    assert pool.stats["evaluations"] >= 64


def test_submits_equal_the_models_batched_program_bit_for_bit():
    """64 per-point submits arrive in fewer than 64 waves, each row equal
    to the model's own `evaluate_batch` over all 64 points."""
    tm = TorchModel(elementwise, 3, 2, device="cpu")
    pool = ModelPool(tm)
    thetas = np.random.default_rng(1).standard_normal((64, 3))
    with BatchingExecutor(pool, linger_s=0.01) as ex:
        got = np.stack([f.result() for f in [ex.submit(t) for t in thetas]])
        waves = ex.telemetry()["waves"]
    assert waves < 64 and pool.stats["evaluations"] == 64
    np.testing.assert_array_equal(got, tm.evaluate_batch(thetas))


# -- tests/test_batch_native.py -------------------------------------------------


def test_model_pool_never_pads():
    pool = ModelPool(TorchModel(lambda th: th * 2.0, 2, 2, device="cpu"))
    out = pool.evaluate(np.ones((5, 2)))
    assert out.shape == (5, 2)
    assert pool.stats["padded"] == 0
    pool.evaluate(np.ones((6, 2)))  # another width: no trace cache to bound
    pool.evaluate(np.ones((5, 2)))
    assert pool.stats["bucket_shapes"] == 2 and pool.stats["padded"] == 0


# -- the backend ----------------------------------------------------------------


def test_spmd_dispatch_is_the_models_batched_ops_bit_for_bit():
    tm = TorchModel(elementwise, 3, 2, device="cpu")
    backend = SPMDBackend(ModelPool(tm))
    rng = np.random.default_rng(2)
    X, S, V = rng.standard_normal((6, 3)), rng.standard_normal((6, 2)), rng.standard_normal((6, 3))
    np.testing.assert_array_equal(backend.dispatch("evaluate", X, None, None),
                                  tm.evaluate_batch(X))
    np.testing.assert_array_equal(backend.dispatch("gradient", X, S, None),
                                  tm.gradient_batch(X, S))
    np.testing.assert_array_equal(backend.dispatch("apply_jacobian", X, V, None),
                                  tm.apply_jacobian_batch(X, V))
    np.testing.assert_array_equal(backend.dispatch("apply_hessian", X, (S, V), None),
                                  tm.apply_hessian_batch(X, S, V))

    def sens_fn(y):
        return torch.ones_like(y) - y

    ys, gs = backend.dispatch("value_and_gradient", X, sens_fn, None)
    wys, wgs = tm.value_and_gradient_batch(X, sens_fn)
    np.testing.assert_array_equal(ys, wys)
    np.testing.assert_array_equal(gs, wgs)
    assert backend.fused_value_grad
    s = backend.stats()
    assert s["kind"] == "spmd" and s["batches"] == 1
    assert s["derivative_waves"] == {"gradient": 1, "apply_jacobian": 1, "apply_hessian": 1,
                                     "value_and_gradient": 1}


def test_spmd_backend_refuses_what_the_model_does_not_advertise():
    from repro_torch.core.interface import Model, UnsupportedCapability

    class _EvalOnly(Model):
        def get_input_sizes(self, config=None):
            return [1]

        def get_output_sizes(self, config=None):
            return [1]

        def evaluate_batch(self, thetas, config=None):
            return np.asarray(thetas) * 2.0

    backend = SPMDBackend(ModelPool(_EvalOnly()))
    np.testing.assert_array_equal(backend.evaluate(np.ones((3, 1)), None), 2.0 * np.ones((3, 1)))
    with pytest.raises(UnsupportedCapability):
        backend.dispatch("gradient", np.ones((1, 1)), np.ones((1, 1)), None)


def test_pool_on_the_cpu_is_one_instance_and_ctx_raises(quad_model):
    """One instance on the CPU; on a mesh (`ctx=`, here the 1x1 CPU mesh of
    this process) n_instances = ctx.n_data, and a one-rank wave is the
    unsharded wave, unpadded (across ranks: tests/test_torch_mesh.py)."""
    assert ModelPool(quad_model).n_instances == 1
    thetas = np.random.default_rng(4).standard_normal((5, 2))
    with one_rank_mesh() as ctx:
        pool = ModelPool(quad_model, ctx=ctx)
        assert pool.n_instances == ctx.n_data == 1
        np.testing.assert_array_equal(pool.evaluate(thetas), quad_model.evaluate_batch(thetas))
    assert pool.stats["padded"] == 0 and pool.stats["evaluations"] == 5


def test_pool_config_is_the_default_of_a_wave():
    tm = TorchModel(lambda th, scale=1.0: scale * th, 2, 2, config_keys=("scale",),
                    device="cpu")
    pool = ModelPool(tm, config={"scale": 3.0})
    np.testing.assert_allclose(pool(np.ones((2, 2))), 3.0 * np.ones((2, 2)))
    np.testing.assert_allclose(pool(np.ones((2, 2)), {"scale": 0.5}), 0.5 * np.ones((2, 2)))


# -- across packages ------------------------------------------------------------


def test_pool_and_fabric_match_the_jax_package():
    tm = TorchModel(quad, 2, 2, device="cpu")
    jm = JAXModel(lambda th: jnp.array([jnp.sum(th**2), th[0] * th[1]]), 2, 2)
    X = np.random.default_rng(3).standard_normal((9, 2))
    np.testing.assert_allclose(ModelPool(tm).evaluate(X), jax_pool.ModelPool(jm).evaluate(X),
                               rtol=1e-6, atol=1e-7)
    with EvaluationFabric(ModelPool(tm), cache_size=0) as fab, \
            jax_fabric.EvaluationFabric(jax_pool.ModelPool(jm), cache_size=0) as jfab:
        np.testing.assert_allclose(fab.evaluate_batch(X), jfab.evaluate_batch(X),
                                   rtol=1e-6, atol=1e-7)
        assert fab.telemetry()["backend"]["kind"] == jfab.telemetry()["backend"]["kind"] == "spmd"


def test_lm_grid_through_the_pool_equals_the_model_backend():
    """examples/serve_uq.py serves its LMUQModel through
    `EvaluationFabric(ModelPool(lm))`: the reduced qwen3-0.6b level-2 grid
    through the pool equals the `ModelBackend` path bit for bit, in the
    same number of waves, unpadded."""
    from repro_torch.apps.lm_model import LMUQModel
    from repro_torch.uq import sparse_grid as sg

    lm = LMUQModel("qwen3-0.6b", reduced=True, batch=2, seq=16, device="cpu")
    reduced = sg.reduce_sparse_grid(
        sg.smolyak_grid(2, 2, [sg.knots_uniform_leja(0.7, 1.3)] * 2))
    out, tel = [], []
    for backend in (ModelPool(lm), ModelBackend(lm)):
        with EvaluationFabric(backend) as fab:
            out.append(sg.evaluate_on_sparse_grid(fab, reduced))
            tel.append(fab.telemetry())
    np.testing.assert_array_equal(out[0], out[1])
    assert tel[0]["waves"] == tel[1]["waves"] and tel[0]["backend"]["kind"] == "spmd"
    assert tel[0]["backend"]["padded"] == 0 and tel[0]["backend"]["batches"] == tel[0]["waves"]
