"""Shared checks and ctypes plumbing of the CUDA kernel wrappers."""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
              torch.float8_e4m3fn: 3}
# cache dtypes stored narrow, with one f32 scale per (row, head)
NARROW = (torch.int8, torch.float8_e4m3fn)

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


def needs_grad(*tensors) -> bool:
    """Whether autograd would take a gradient through an op on
    ``tensors``: gradients enabled and one of them requiring grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise when autograd would need a gradient through ``kernel``: it
    has no backward, nor does the reference's Pallas kernel define a VJP,
    and a kernel output without one would cut the gradient silently.  The
    plain version on a CPU tensor refuses too, so that card and CPU train
    alike.  Under ``torch.no_grad()`` or ``inference_mode`` it passes."""
    if needs_grad(*tensors):
        raise NotImplementedError(
            f"{kernel} has no backward (the reference's Pallas kernel "
            f"defines no VJP either): call it without gradients, or train "
            f"through the plain model path (dsa_mode 'block', 'faithful' "
            f"or 'off')")


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


def check_copy_rows(name: str, t: torch.Tensor) -> None:
    """Raise unless every row of ``t`` starts on a 16-byte boundary: the
    attention kernels copy cache rows into shared memory 16 bytes at a
    time (``cp.async``)."""
    if any(s * t.element_size() % 16 for s in t.stride()[:-1]):
        raise ValueError(f"{name} rows must start on 16-byte boundaries; "
                         f"strides {t.stride()} of {t.dtype}")


def check_scales(cache: torch.Tensor, k_scale, v_scale,
                 device: torch.device):
    """The scale pointers and their strides but the unit head stride, for
    the C interfaces: none (null pointers) for a full-width cache; for an
    int8/fp8 cache, f32 k/v scales shaped as the cache without its last
    axis, sharing strides.  Returns ([k_ptr, v_ptr], strides)."""
    narrow = cache.dtype in NARROW
    if (k_scale is None) != (v_scale is None) or narrow != (
            k_scale is not None):
        raise ValueError(f"a {cache.dtype} cache takes "
                         f"{'k_scale and v_scale' if narrow else 'no scales'}")
    if k_scale is None:
        return [None, None], (0,) * (cache.dim() - 2)
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        if sc.device != device:
            raise ValueError(f"{name} is on {sc.device}, expected {device}")
        if sc.dtype != torch.float32 or sc.shape != cache.shape[:-1]:
            raise ValueError(f"{name} must be f32 of shape "
                             f"{tuple(cache.shape[:-1])}; got {sc.dtype} "
                             f"{tuple(sc.shape)}")
        if sc.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit stride on its last axis")
    if k_scale.stride() != v_scale.stride():
        raise ValueError("k_scale and v_scale must share strides")
    return [k_scale.data_ptr(), v_scale.data_ptr()], k_scale.stride()[:-1]


# every launch counter of the kernel wrappers, as (wrapper, attribute).  A
# wrapper counts the launches its Python call makes; a CUDA graph replay
# makes no call, so inference/graphs.py adds each replay's captured
# launches to these counters itself.
COUNTERS: list = []


def counters(fn, *names: str) -> None:
    """Give the wrapper ``fn`` the launch counters ``names``, at 0."""
    for name in names:
        setattr(fn, name, 0)
        COUNTERS.append((fn, name))


def read_counts() -> list:
    """Every counter's value, in ``COUNTERS`` order."""
    return [getattr(fn, name) for fn, name in COUNTERS]


def add_counts(delta) -> None:
    """Add ``delta`` (values in ``COUNTERS`` order) to the counters."""
    for (fn, name), d in zip(COUNTERS, delta):
        setattr(fn, name, getattr(fn, name) + d)


def count(fn, k_scale) -> None:
    """One launch more on the wrapper ``fn``'s counter of the variant that
    ran: ``launches`` (full-width cache) or ``launches_quant``."""
    if k_scale is None:
        fn.launches += 1
    else:
        fn.launches_quant += 1


def check_index(name: str, t: torch.Tensor, device: torch.device,
                dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """``dtype`` (int32, or bool for a validity stream read as bytes),
    contiguous, on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    return t.to(dtype).contiguous()


def raise_on_error(kernel: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with cudaError_t {err}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
