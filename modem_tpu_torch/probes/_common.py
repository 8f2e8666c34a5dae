"""What the probes share: loading a probe library and checking a
launch."""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels import _build


@functools.lru_cache(maxsize=None)
def library(name: str, argtypes: tuple) -> ctypes.CDLL:
    """csrc/<name>.cu built and loaded, ``<name>_launch`` declared with
    ``argtypes`` (``"p"`` a pointer, ``"i"`` an int) returning an int.
    Each probe calls it with its one signature, from its own
    ``library()``."""
    lib = _build.load(name)
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int}
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [kinds[a] for a in argtypes]
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def check_rc(lib: ctypes.CDLL, name: str, rc: int) -> None:
    if rc:
        err = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {err}")


def on_card(x: torch.Tensor, name: str) -> bool:
    """Whether x lies on the card (the kernel launches) or on the CPU (the
    plain twin runs); raise on another device or a tensor the kernels do
    not take."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name} takes contiguous float32")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    return x.device.type == "cuda"
