"""Build a CUDA source of ``csrc/`` into a shared library and load it.

The sources have a plain ``extern "C"`` interface and include no PyTorch
header (only ``csrc/*.cuh``), so ``nvcc`` builds one in seconds.  The build
happens at first use, on the machine with the card, into ``_build/`` inside
the package (listed in ``.gitignore``), keyed by a hash of the source, the
headers and the ``-D`` definitions the wrapper passes (each kernel's shape
limits live in its Python wrapper and reach the source this way); the
library is loaded with ``ctypes``.  ``ptxas`` reports each kernel's
registers, shared memory and spills; the report is kept beside the library
as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

Defines = Tuple[Tuple[str, int], ...]  # ((name, value), ...) for nvcc -D

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine that has the GPU")


def _define_flags(defines: Defines) -> list:
    return [f"-D{k}={v}" for k, v in defines]


def library_path(source: str, defines: Defines = ()) -> Path:
    """Where the library built from ``csrc/<source>`` with ``defines``
    lives."""
    src = CSRC_DIR / source
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(_define_flags(defines)).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build(source: str, defines: Defines = ()) -> Path:
    """Compile ``csrc/<source>`` unless a build of this exact source, these
    headers and these definitions exists."""
    out = library_path(source, defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC_DIR}", *_define_flags(defines),
           "-o", str(tmp), str(CSRC_DIR / source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{res.stderr}")
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


@functools.cache
def load(source: str, defines: Defines = ()) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(source, defines)))
