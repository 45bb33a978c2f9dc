"""Build a CUDA source of ``csrc/`` into a shared library and load it.

The sources have a plain ``extern "C"`` interface and include no PyTorch
header, so ``nvcc`` builds one in seconds.  The build happens at first use,
on the machine with the card, into ``_build/`` inside the package (listed in
``.gitignore``), keyed by a hash of the source; the library is loaded with
``ctypes``.  ``ptxas`` reports each kernel's registers, shared memory and
spills; the report is kept beside the library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

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


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless a build of this exact source exists."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{res.stderr}")
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


@functools.cache
def load(source: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(source)))
