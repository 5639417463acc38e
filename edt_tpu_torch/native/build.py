"""Build the native RLE kit: ``python -m edt_tpu_torch.native.build``.

``rle.cpp`` becomes ``edt_tpu_torch/_build/rle-<hash>.so``, the hash over
the source and the flags, so an edited source rebuilds and an unchanged
one is reused. ``rle_native`` calls ``build()`` at first use.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "rle.cpp"
BUILD_DIR = HERE.parent / "_build"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]


def compiler() -> str | None:
    """The C++ compiler the kit builds with, or None where there is none."""
    return shutil.which("g++")


def target() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"rle-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The built kit, compiling it first if this source was not built."""
    out = target()
    if out.exists():
        return out
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("g++ not found: the native RLE kit cannot be built")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SRC)], check=True)
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(build())
