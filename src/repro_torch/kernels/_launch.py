"""Shared checks and ctypes plumbing of the CUDA kernel wrappers."""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_int64
F = ctypes.c_float


def bind(lib_name: str, fn_name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    fn = getattr(build.load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def check_cuda_operand(name: str, t: torch.Tensor,
                       device: torch.device) -> None:
    """Raise unless ``t`` lies on ``device`` in a kernel dtype with a unit
    last stride and 16-byte aligned rows (the kernels load 4 elements at
    a time)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in DTYPE_CODE:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                        f"{[str(d) for d in DTYPE_CODE]}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} needs a unit stride on its last axis")
    if any(s % 4 for s in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(f"{name} rows must be 16-byte aligned")


def check_index(name: str, t: torch.Tensor, device: torch.device
                ) -> torch.Tensor:
    """int32, contiguous, on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    return t.to(torch.int32).contiguous()


def raise_on_error(kernel: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with cudaError_t {err}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
