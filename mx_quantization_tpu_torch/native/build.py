"""Build a C++ source of ``native/`` with g++ into a shared library and
load it with ctypes.

The build happens at first use into ``_build/`` inside the package (listed
in ``.gitignore``), keyed by a hash of the source and the flags, so that
an edited source builds anew and processes that build at once never see a
partial file.  It needs g++ and the headers of the libraries it links
(the decoder: libjpeg's ``jpeglib.h``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Sequence

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path(name: str, source: str, libs: Sequence[str] = ()) -> Path:
    """Where lib<name> built from ``native/<source>`` lives."""
    h = hashlib.sha256((NATIVE_DIR / source).read_bytes())
    h.update(" ".join((*CXX_FLAGS, *libs)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


@functools.cache
def build_and_load(name: str, source: str,
                   libs: Sequence[str] = ()) -> ctypes.CDLL:
    """Compile ``native/<source>`` into lib<name> unless that build exists,
    and load it; raises where g++ or a library's headers are missing."""
    out = library_path(name, source, libs)
    if not out.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = ["g++", *CXX_FLAGS, str(NATIVE_DIR / source), "-o", str(tmp),
               "-lpthread", *(f"-l{lib}" for lib in libs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {source}:\n{res.stderr}")
        os.replace(tmp, out)  # atomic
    return ctypes.CDLL(str(out))
