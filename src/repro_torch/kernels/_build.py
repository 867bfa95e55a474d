"""Build the port's hand-written CUDA kernels and load them with ctypes.

Every `csrc/*.cu` under `repro_torch/kernels/` is compiled by `nvcc` into
its own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), for Hopper only:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 [per-source flags]
         -shared -Xcompiler -fPIC -o lib<stem>_<hash>.so <stem>.cu

The per-source flags are `SOURCE_FLAGS`. `swe_step.cu`, `swe_solve.cu` and
`swe_solve_vjp.cu` are built with `-fmad=false`: every multiply and add
stays separately rounded, as in the eager plain PyTorch version, which is
what the first two's bit-equality with that version rests on, and what
makes the adjoint's recomputed states the solve's own (the adjoint is
built with `-Xptxas -v` too). `ssd.cu` lets the compiler
contract multiply-adds: its products sum in another order than the plain
version's, so they cannot be bit-equal anyway. It, `flash_attention.cu`
(both mma.sync in 3xTF32), `flash_attention_bwd_wgmma.cu` and
`flash_attention_bwd_3xbf16.cu` (wgmma, TMA; the second in 3xBF16) are
built with `-Xptxas -v`, and each build's compiler output (registers,
spills) is kept beside its library as `lib<stem>_<hash>.log`. The three
wgmma libraries (`flash_attention_wgmma.cu`, `flash_attention_bwd_wgmma.cu`,
`flash_attention_bwd_3xbf16.cu`: wgmma, TMA, `setmaxnreg`, sm_90a only)
need no library beyond the runtime: they look up `cuTensorMapEncodeTiled`
at run time through `cudaGetDriverEntryPoint`, so nothing links `-lcuda`,
and they use no CUTLASS header; they share the header
`flash_attention/csrc/wgmma_tma.cuh`. Libraries land in
`build/repro_torch_kernels/` at the root of the checkout, named by a hash of
the source, the headers its `#include "..."` lines name and its flags, so
an edited source or header is rebuilt and an unchanged one is reused. Each build
writes a temporary file and renames it into place, so a cut build never
leaves a half-written library behind. Nothing is built or loaded at import time: the
first launch of a kernel builds (or finds) its library. A machine with a
GPU but no `nvcc` raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from repro_torch.analysis.races import named_lock

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
#: flags of one source on top of NVCC_FLAGS, by stem
SOURCE_FLAGS = {"swe_step": ("-fmad=false",), "swe_solve": ("-fmad=false",),
                "swe_solve_vjp": ("-fmad=false", "-Xptxas", "-v"),
                "ssd": ("-Xptxas", "-v"), "flash_attention": ("-Xptxas", "-v"),
                "flash_attention_bwd_wgmma": ("-Xptxas", "-v"),
                "flash_attention_bwd_3xbf16": ("-Xptxas", "-v")}

_lock = named_lock("kernels.build")
_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> dict[str, Path]:
    """Every kernel source of the port, by stem (`swe_step`, ...)."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def nvcc() -> str:
    """Path of `nvcc`: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's CUDA "
        "kernels are built from source at first use and have no fallback"
    )


def flags(stem: str) -> tuple[str, ...]:
    """The nvcc flags of one kernel source."""
    return (*NVCC_FLAGS, *SOURCE_FLAGS.get(stem, ()))


def local_headers(src: Path) -> list[Path]:
    """The headers a source names in its own `#include "..."` lines, beside
    it (the port's headers include no other)."""
    names = [line.split('"')[1] for line in src.read_text().splitlines()
             if line.startswith('#include "')]
    return [src.parent / name for name in names]


def library_path(stem: str) -> Path:
    src = sources()[stem]
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags(stem)).encode())
    for header in local_headers(src):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"


def build(stems=None) -> dict[str, Path]:
    """Compile the named kernel sources (default: all) that have no library
    yet, one `nvcc` process per source, all started together. Returns each
    stem's library path; raises with the compiler's output on failure."""
    srcs = sources()
    stems = list(srcs) if stems is None else list(stems)
    paths = {s: library_path(s) for s in stems}
    todo = [s for s in stems if not paths[s].is_file()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    for s in todo:
        tmp = paths[s].with_suffix(f".tmp{os.getpid()}.so")
        cmd = [compiler, *flags(s), "-o", str(tmp), str(srcs[s])]
        procs[s] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for s, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{s}: nvcc exited {proc.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, paths[s])
        paths[s].with_suffix(".log").write_text(out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, building it if needed."""
    with _lock:
        lib = _loaded.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build([stem])[stem]))
            _loaded[stem] = lib
        return lib
