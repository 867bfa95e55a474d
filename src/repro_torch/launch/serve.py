"""UQ serving driver (counterpart of `repro.launch.serve`): the paper's
deployment shape, one model behind an UM-Bridge HTTP server.

Serves one of the built-in models (the L2-Sea analogue, the composite
ROM, the tsunami, or an LM of the zoo wrapped as a UQ model) on the card,
or on the device `--device` names:

    PYTHONPATH=src python -m repro_torch.launch.serve --model l2sea --port 4242
    PYTHONPATH=src python -m repro_torch.launch.serve --model lm --arch qwen3-0.6b
    PYTHONPATH=src python -m repro_torch.launch.serve --model lm --reduced --device cpu

then from any UM-Bridge client (Python/MATLAB/R/...):

    model = HTTPModel("http://127.0.0.1:4242", "forward")
    model([[0.3, -6.0, 0, ..., 0]])

The server binds 127.0.0.1 (`core/server.py::serve_models`); `--port 0`
takes a free port. The line it prints names the address it really bound,
the torch device and the device's name. The model answers each request
itself: the port's batched operations run a wave as one program, so no
pool is put in front of it (the reference imports its pool and mesh here
and uses neither).
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.server import serve_models

MODELS = ("l2sea", "composite", "tsunami", "lm")


def build_model(name: str, arch: str, reduced: bool, device=None):
    """The model `name` serves, on `device` (default: the card; raises if
    there is none). `arch` and `reduced` pick the LM (`LMUQModel`)."""
    if name == "l2sea":
        from repro_torch.apps.l2sea import L2SeaModel

        return L2SeaModel(device=device)
    if name == "composite":
        from repro_torch.apps.composite import CompositeModel

        return CompositeModel(device=device)
    if name == "tsunami":
        from repro_torch.apps.tsunami import TsunamiModel

        return TsunamiModel(device=device)
    if name == "lm":
        from repro_torch.apps.lm_model import LMUQModel

        return LMUQModel(arch, reduced=reduced, device=device)
    raise ValueError(f"unknown model {name!r}; choose one of {MODELS}")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Serve one model over the UM-Bridge protocol.")
    ap.add_argument("--model", default="l2sea", choices=MODELS)
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--port", type=int, default=4242, help="0 takes a free port")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    model = build_model(args.model, args.arch, args.reduced, device)
    server, thread = serve_models([model], args.port, background=True)
    host, port = server.server_address[:2]
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    print(f"serving '{model.name}' on http://{host}:{port} (device: {device}, {name})",
          flush=True)
    try:
        thread.join()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()


_ADDRESS = re.compile(r"^serving '.*' on (http://\S+) ")


def start(argv: list[str], timeout_s: float, env: dict | None = None):
    """Start this driver in a subprocess with the arguments `argv` (e.g.
    ``["--model", "lm", "--port", "0"]``) and wait, at most `timeout_s`
    seconds, for the line that names its address. Returns (the process,
    its URL); the caller stops the process (`stop`). Raises, with the
    process stopped and its output in the message, if it exits or stays
    silent that long."""
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (src, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve", *argv],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=env)
    lines: list[str] = []
    found = threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line)
            if _ADDRESS.match(line):
                found.set()
        found.set()  # the process ended

    threading.Thread(target=read, daemon=True).start()
    found.wait(timeout_s)
    url = next((m.group(1) for m in map(_ADDRESS.match, lines) if m), None)
    if url is None:
        stop(proc)
        raise RuntimeError(f"the serving driver {argv} named no address in {timeout_s} s "
                           f"(exit code {proc.returncode}): {''.join(lines)[-4000:]}")
    return proc, url


def stop(proc: subprocess.Popen, timeout_s: float = 30.0) -> int:
    """Stop a driver `start` started (SIGTERM, then SIGKILL); its exit code."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return proc.returncode


if __name__ == "__main__":
    main()
