"""Build the package's native sources and load them with ``ctypes``.

Sources live in ``dmf_tpu_torch/csrc/`` and expose a plain C interface.  A
library is compiled on first use into ``dmf_tpu_torch/_build/<name>-<hash>/``,
keyed by a hash of its sources, of every shared header (``csrc/*.cuh``) and of
the flags, so a fresh checkout builds itself and an edited source or header
rebuilds.  Each process compiles to a file of its own and renames it into
place, so processes that build at once never load a half-written library.
The CUDA kernels are compiled by ``nvcc`` for ``sm_90a``, with the
``-Xptxas -v`` report (registers, shared memory, spills) kept beside the
library as ``build.log``; the host library (``utils/native.py``) by ``g++``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "build on the machine with the card")


def source_digest(sources: Sequence[str], csrc: Path = CSRC_DIR,
                  flags: Sequence[str] = NVCC_FLAGS) -> str:
    """Hash of the flags, the listed sources and every header under ``csrc``."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for p in [csrc / s for s in sources] + sorted(csrc.glob("*.cuh")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    return digest.hexdigest()[:16]


def build_library(name: str, sources: Sequence[str], compiler: Optional[str] = None,
                  flags: Sequence[str] = NVCC_FLAGS) -> Path:
    """Compile ``csrc/<sources>`` into ``lib<name>.so`` with ``compiler``
    (default ``nvcc``) and ``flags``; returns its path.  Raises
    ``RuntimeError`` with the compiler's output if it fails."""
    paths = [CSRC_DIR / s for s in sources]
    out_dir = BUILD_DIR / f"{name}-{source_digest(sources, flags=flags)}"
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
    cmd = [compiler or find_nvcc(), *flags, "-o", str(tmp), *map(str, paths)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed for {name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Build (if needed) and load a CUDA library."""
    return ctypes.CDLL(str(build_library(name, sources)))
