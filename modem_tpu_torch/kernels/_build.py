"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own into ``build/modem_tpu_torch/lib<name>_<hash>.so`` at the root of
the checkout, keyed by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads the existing library.  The
build runs at first use, never at import: machines without ``nvcc``
(and without a GPU) import every module of the package.  ``nvcc``'s own
report (registers, shared memory and spills per kernel, from
``-Xptxas -v``) is kept beside the library as ``.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[2] / "build"
             / "modem_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin):"
                           " the CUDA kernels cannot be built here")
    return path


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build csrc/<name>.cu if its library is missing, then load it."""
    lib = library_path(name)
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n"
                               f"{proc.stdout}{proc.stderr}")
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))
