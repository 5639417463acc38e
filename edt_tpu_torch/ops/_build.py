"""Build the CUDA sources under ``csrc/`` with ``nvcc`` on first use.

Each ``csrc/<name>.cu`` becomes ``_build/<name>-<hash>.so``: a shared
library with a plain C interface, loaded with ctypes. The hash covers the
sources and the flags, so an edited source rebuilds and an unchanged one
is reused. All sources build in parallel, one ``nvcc`` each.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

# -fmad=false: the kernels must round f + w2 * k^2 twice, like the JAX
# reference, never as one fused multiply-add.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # .cu and the shared .cuh
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Build every ``csrc/*.cu`` not yet built. Returns
    {name: {"seconds": s, "log": compiler output}} for what it built."""
    BUILD_DIR.mkdir(exist_ok=True)
    todo = {}
    for src in sorted(CSRC.glob("*.cu")):
        out = _target(src.stem)
        if not out.exists():
            todo[src.stem] = (src, out)
    if not todo:
        return {}
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, (src, out) in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return report


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    out = _target(name)
    if not out.exists():
        build_all()
    return ctypes.CDLL(str(out))
