"""UM-Bridge HTTP/JSON protocol schema (paper §2.2-§2.4).

Endpoints (protocol version 1.0):
  GET  /Info                 -> {"protocolVersion": 1.0, "models": [names]}
  POST /InputSizes           {"name", "config"}        -> {"inputSizes": [..]}
  POST /OutputSizes          {"name", "config"}        -> {"outputSizes": [..]}
  POST /ModelInfo            {"name"}                  -> {"support": {...}}
                             ("support" is the full `Capabilities` wire doc:
                             Evaluate/Gradient/ApplyJacobian/ApplyHessian plus
                             the batched variants — clients negotiate on it
                             and never probe endpoints)
  POST /Evaluate             {"name", "input", "config"} -> {"output": [[..]]}
  POST /EvaluateBatch        {"name", "inputs": [[..], ..], "config"}
                             -> {"outputs": [[..], ..]}
                             (batched extension: each entry of "inputs" is ONE
                             evaluation point, its blocks flattened; N points
                             per round-trip instead of one)
  POST /Gradient             {"name", "outWrt", "inWrt", "input", "sens", "config"}
  POST /GradientBatch        {"name", "inputs": [[..], ..], "senss": [[..], ..],
                             "config"} -> {"outputs": [[..], ..]}
                             (batched extension: row k of "outputs" is
                             senss[k]^T J_F(inputs[k]) in the flattened
                             single-block layout — one VJP wave per round-trip)
  POST /ApplyJacobian        {"name", "outWrt", "inWrt", "input", "vec", "config"}
  POST /ApplyJacobianBatch   {"name", "inputs": [[..], ..], "vecs": [[..], ..],
                             "config"} -> {"outputs": [[..], ..]}
                             (batched JVP wave)
  POST /ApplyHessian         {"name", "outWrt", "inWrt1", "inWrt2", "input", "sens", "vec", "config"}
  POST /ApplyHessianBatch    {"name", "inputs": [[..], ..], "senss": [[..], ..],
                             "vecs": [[..], ..], "config"}
                             -> {"outputs": [[..], ..]}
                             (batched HVP wave: row k of "outputs" is
                             d/de [J_F(inputs[k] + e vecs[k])^T senss[k]] —
                             one Hessian-apply wave per round-trip, the
                             second-order analogue of /GradientBatch)

Errors: {"error": {"type": ..., "message": ...}} with HTTP 400.
"""
from __future__ import annotations

from repro_torch.core.interface import Capabilities

PROTOCOL_VERSION = 1.0

#: DEPRECATED alias — the typed `Capabilities` descriptor replaced the v1
#: ModelSupport dataclass; `from_json` accepts both the old five-key wire doc
#: and the full capability set (missing keys default to False).
ModelSupport = Capabilities


def config_key(config: dict | None) -> tuple:
    """Canonical hashable view of an UM-Bridge config dict (shared by the
    fabric result cache and the pool jit cache — the two must agree on what
    makes two configs 'the same')."""
    return tuple(sorted((k, repr(v)) for k, v in (config or {}).items()))


def error_body(kind: str, message: str) -> dict:
    return {"error": {"type": kind, "message": message}}


def split_blocks(vec, input_sizes: list[int]) -> list[list[float]]:
    """Un-flatten one evaluation point into the model's input blocks (the
    layout contract shared by /EvaluateBatch server, client fallback and
    ModelBackend fallback)."""
    blocks, ofs = [], 0
    for n in input_sizes:
        blocks.append([float(v) for v in vec[ofs : ofs + n]])
        ofs += n
    return blocks


def validate_evaluate_batch_request(body: dict, input_sizes: list[int]) -> str | None:
    inputs = body.get("inputs")
    if not isinstance(inputs, list) or not inputs:
        return "expected a nonempty 'inputs' list of evaluation points"
    n = sum(input_sizes)
    for i, vec in enumerate(inputs):
        if not isinstance(vec, list) or len(vec) != n:
            got = len(vec) if isinstance(vec, list) else type(vec).__name__
            return f"inputs[{i}]: got {got}, want {n} values (flattened blocks)"
    return None


def validate_batched_pair_request(
    body: dict,
    input_sizes: list[int],
    extra_field: str,
    extra_len: int,
) -> str | None:
    """Validate a batched two-array request (`/GradientBatch` inputs+senss,
    `/ApplyJacobianBatch` inputs+vecs): both lists present, same length, and
    every row the declared flat width."""
    err = validate_evaluate_batch_request(body, input_sizes)
    if err:
        return err
    extras = body.get(extra_field)
    inputs = body["inputs"]
    if not isinstance(extras, list) or len(extras) != len(inputs):
        return f"expected '{extra_field}' to be a list of {len(inputs)} rows"
    for i, row in enumerate(extras):
        if not isinstance(row, list) or len(row) != extra_len:
            got = len(row) if isinstance(row, list) else type(row).__name__
            return f"{extra_field}[{i}]: got {got}, want {extra_len} values"
    return None


def validate_evaluate_request(body: dict, input_sizes: list[int]) -> str | None:
    inp = body.get("input")
    if not isinstance(inp, list) or len(inp) != len(input_sizes):
        return f"expected {len(input_sizes)} input vectors"
    for vec, n in zip(inp, input_sizes):
        if len(vec) != n:
            return f"input vector size mismatch: got {len(vec)}, want {n}"
    return None
