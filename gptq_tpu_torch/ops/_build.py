"""Build and load the package's CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), loaded
with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

Libraries land in `gptq_tpu_torch/build/` (ignored by git) at first use,
named by a hash of their source and every csrc/ header it includes
(`#include "..."`, followed recursively), so an edited source or header
rebuilds and an unchanged one loads as it is. `build_all()` starts one nvcc per source at
once and waits for all of them. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD = os.path.join(PKG_DIR, "build")
SOURCES = ("qmatmul", "ffn", "bcq_matmul", "qstream", "qexpert",
           "layer_fused", "attention_partial", "qmma", "qexpert_mma",
           "ffn_rows")
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _sources(name: str) -> list:
    """csrc/<name>.cu and every csrc/ file it includes, recursively."""
    todo, seen = [f"{name}.cu"], []
    while todo:
        rel = todo.pop()
        if rel in seen:
            continue
        seen.append(rel)
        with open(os.path.join(CSRC, rel), "rb") as f:
            todo.extend(m.decode() for m in _INCLUDE.findall(f.read()))
    return seen


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for rel in sorted(_sources(name)):
        with open(os.path.join(CSRC, rel), "rb") as f:
            digest.update(rel.encode() + b"\0" + f.read())
    return os.path.join(BUILD, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_all(names=SOURCES) -> dict:
    """Compile every source whose library is missing, all nvcc processes
    at once. Returns {name: {"seconds": s, "log": ptxas output}}."""
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = out + f".tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        with open(out[:-3] + ".log", "w") as f:
            f.write(log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu (building it first if needed)."""
    path = _lib_path(name)
    if not os.path.exists(path):
        build_all((name,))
    return ctypes.CDLL(path)


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (the wrappers size their
    grids by it)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
