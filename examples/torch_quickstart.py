"""Quickstart on the PyTorch port — the paper's §2.4 minimal client/server
example (examples/quickstart.py on `repro_torch`).

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] [--port 0]
(on the card unless --device says otherwise; --port 0 takes a free port)
"""
import argparse

import numpy as np
import torch

from repro_torch.core.client import HTTPModel, supported_models
from repro_torch.core.fabric import EvaluationFabric
from repro_torch.core.interface import Model, TorchModel
from repro_torch.core.pool import ModelPool
from repro_torch.core.server import serve_models


# --- a model server (paper §2.4.2: multiply the single input by two) -------
class TestModel(Model):
    def __init__(self):
        super().__init__("forward")

    def get_input_sizes(self, config=None):
        return [1]

    def get_output_sizes(self, config=None):
        return [1]

    def supports_evaluate(self):
        return True

    def __call__(self, parameters, config=None):
        return [[parameters[0][0] * 2]]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--port", type=int, default=4242, help="0 takes a free port")
    args = ap.parse_args(argv)

    # 1) serve it over the UM-Bridge HTTP protocol (paper §2.4.2)
    server, _ = serve_models([TestModel()], args.port, background=True)

    # 2) call it like the paper's §2.4.1 client
    url = f"http://127.0.0.1:{server.server_address[1]}"
    print("models:", supported_models(url))
    model = HTTPModel(url, "forward")
    print("F([10]) =", model([[10.0]]))

    # 3) the PyTorch-native path: ONE pure function gives the whole UM-Bridge
    #    surface (evaluate/gradient/Jacobian/Hessian) via torch.func...
    tm = TorchModel(lambda th: torch.stack([th[0] ** 3 + th[1]]), 2, 1, device=args.device)
    print(f"TorchModel on {tm.device}")
    print("F(2,1)    =", tm([[2.0, 1.0]]))
    print("grad      =", tm.gradient(0, 0, [[2.0, 1.0]], [1.0]))
    print("J [1,0]^T =", tm.apply_jacobian(0, 0, [[2.0, 1.0]], [1.0, 0.0]))
    print("H action  =", tm.apply_hessian(0, 0, 0, [[2.0, 1.0]], [1.0], [1.0, 0.0]))

    # 4) ...and scales out through the device pool (the paper's k8s cluster)
    pool = ModelPool(tm)
    thetas = np.random.default_rng(0).standard_normal((10, 2))
    print("pool(10 points) ->", pool.evaluate(thetas).ravel().round(2))

    # 5) the EvaluationFabric is the one dispatch layer UQ drivers talk to:
    #    per-point submits batch into waves, duplicates hit the LRU cache,
    #    and the SAME API fans out over HTTP servers or thread pools
    with EvaluationFabric(pool) as fabric:
        futs = [fabric.submit(t) for t in thetas] + [fabric.submit(thetas[0])]
        print("fabric(11 submits) ->", np.round([f.result()[0] for f in futs], 2))
        t = fabric.telemetry()
        print(f"fabric telemetry: {t['waves']} waves, {t['points']} evals, "
              f"{t['cache_hits'] + t['coalesced']} deduped")

    server.shutdown()
    server.server_close()


if __name__ == "__main__":
    main()
