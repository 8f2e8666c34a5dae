"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own into ``build/modem_tpu_torch/lib<name>_<hash>.so`` at the root of
the checkout, keyed by a hash of the source and the flags (macros given
with ``defines`` included, so one source can build several libraries),
so an edited source rebuilds and an unchanged one loads the existing
library.  Generated sources (kernels/unroll.py) are written beside their
library, keyed the same way.  The build runs at first use, never at
import: machines without ``nvcc`` (and without a GPU) import every module
of the package.  ``nvcc``'s own report (registers, shared memory and
spills per kernel, from ``-Xptxas -v``) is kept beside the library as
``.log``.
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


def _flags(defines) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def _keyed(stem: str, src: bytes, defines) -> pathlib.Path:
    digest = hashlib.sha256(src + " ".join(_flags(defines)).encode())
    return BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"


def library_path(name: str, defines: tuple = ()) -> pathlib.Path:
    return _keyed(name, (CSRC / f"{name}.cu").read_bytes(), defines)


def _compile(lib: pathlib.Path, source: pathlib.Path, defines) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *_flags(defines), "-o", str(tmp), str(source)],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {source.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)


@functools.lru_cache(maxsize=None)
def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """Build csrc/<name>.cu (with -D for each of ``defines``) if its
    library is missing, then load it."""
    lib = library_path(name, defines)
    if not lib.exists():
        _compile(lib, CSRC / f"{name}.cu", defines)
    return ctypes.CDLL(str(lib))


def generated_path(stem: str, text: str) -> pathlib.Path:
    return _keyed(stem, text.encode(), ())


def load_generated(stem: str, text: str) -> ctypes.CDLL:
    """Write a generated CUDA source into the build directory, build it if
    its library is missing, and load it."""
    lib = generated_path(stem, text)
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = lib.with_name(lib.stem[3:] + ".cu")
        src.write_text(text)
        _compile(lib, src, ())
    return ctypes.CDLL(str(lib))
