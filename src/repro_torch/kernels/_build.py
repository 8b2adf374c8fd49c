"""Build and load the port's CUDA kernels at first use.

Each source under ``csrc/`` has a plain C interface.  It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``kernels/build/``
(listed in ``.gitignore``) and bound with ``ctypes``: no PyTorch headers, so
a build takes seconds, not minutes.  The library's file name carries a hash
of its source and flags, so an edited source is never served by a stale
build.  Nothing here runs at import time, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}      # source name -> nvcc's ptxas report


def nvcc_path() -> str:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else the one on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if no build of this exact source exists,
    then load it (once per process).  Raises RuntimeError with nvcc's
    output when the build fails."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"{name}-{digest[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                               str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        build_logs[name] = proc.stderr
        os.replace(tmp, so)          # atomic: concurrent builders agree
    lib = ctypes.CDLL(str(so))
    _loaded[name] = lib
    return lib
