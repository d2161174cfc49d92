"""The build of the hand-written CUDA kernels: nvcc compiles a csrc/ source
for sm_90a into a shared library under `_build/`, named by a hash of the
source and the flags, once per source and flags. The ops bind the library
with ctypes. Imports nothing of the port, so every op can import it."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


def build(source: Path, stem: str, info: Dict[str, object]) -> Path:
    """Compile `source` into the shared library `_build/lib<stem>_<hash>.so`
    (once per source and flags; the hash is of both) and return its path.
    Fills `info` with the seconds taken and ptxas's report."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{stem}_{digest}.so"
    if out.exists():
        info.update(path=str(out), seconds=0.0, cached=True)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    info.update(path=str(out), seconds=time.perf_counter() - t0, cached=False,
                ptxas=proc.stderr.strip())
    return out
