"""K7 — chunked RWKV6 (wkv) linear attention: CUDA kernel, wrapper and
plain version.

Replaces the Pallas TPU kernel ``src/repro/kernels/wkv6.py::wkv6_chunked``
(body ``_kernel``).  The CUDA source is ``csrc/wkv6.cu``; its header note
says what bounds the kernel on the H100 (the chain of dependent chunks)
and what the design does about it (the chain cut into segments run in
parallel, the state carried across them by a short second pass; the
products on the tensor cores as 3xTF32, except the f32 instance's y
products).

  r, k, v, w: (B, H, S, hd)   u: (H, hd)   s0: (B, H, hd, hd) f32 or None
  -> y (B, H, S, hd) in r's dtype, s_last (B, H, hd, hd) f32

Per chunk of C tokens, in f32 and in the Pallas body's order::

  logw = log(max(w, 1e-38));  cum = cumsum(logw);  cum_c = clip(cum, -30, 0)
  rr = r * exp(cum_c - logw);  kk = k * exp(-cum_c)
  y  = rr @ S + tril_strict(rr @ kk^T) @ v + (r * u * k).sum(-1) * v
  S  = exp(clip(cum_last))^T * S + (k * exp(clip(cum_last - cum)))^T @ v

With ``s0=None`` the state starts at zero and ``y`` is the Pallas
kernel's; with a state, ``(y, s_last)`` is the reference model's
``ssm._wkv_chunked``.  The kernel's products sum in another order (3xTF32
on the tensor cores, the state re-associated across segments), so it
holds f32's tolerance on ``s_last`` and the dtype's on ``y`` rather than
matching the plain version bit for bit.  Any strides with a unit hd
stride and 16-byte aligned rows are taken (the ops transposes are
views); the wrapper writes ``y`` in (B, S, H, hd) memory, so the
transpose back to model layout is free.  On a CPU tensor the wrapper
runs the plain version; on a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _launch as LN

CLAMP = -30.0
WMIN = 1e-38
SEGMENTS_PER_SM = 6


def wkv6_chunked_plain(r, k, v, w, u, s0=None, *, chunk: int = 32):
    """The Pallas body's arithmetic in plain PyTorch, f32 throughout, one
    chunk after another.  Returns (y, s_last)."""
    b, h, s, hd = r.shape
    if s % chunk:
        raise ValueError(f"S={s} is not a multiple of chunk={chunk}")
    n = s // chunk
    st = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
          if s0 is None else s0.float())
    uu = u.float()[None, :, None, :]
    rf, kf, vf, wf = (t.float().reshape(b, h, n, chunk, hd)
                      for t in (r, k, v, w))
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=r.device).tril(-1)
    ys = []
    for c in range(n):
        rc, kc, vc, wc = rf[:, :, c], kf[:, :, c], vf[:, :, c], wf[:, :, c]
        logw = torch.log(torch.clamp(wc, min=WMIN))
        cum = torch.cumsum(logw, dim=2)
        cum_c = cum.clamp(CLAMP, 0.0)
        rr = rc * torch.exp(cum_c - logw)              # r_t * A_{t-1}
        kk = kc * torch.exp(-cum_c)                    # k_s / A_s
        y = rr @ st
        sc = torch.where(tri, rr @ kk.transpose(-1, -2), 0.0)
        y = y + sc @ vc
        diag = (rc * uu * kc).sum(-1)
        y = y + diag[..., None] * vc
        cum_last = cum[:, :, -1:, :]
        k_hat = kc * torch.exp((cum_last - cum).clamp(CLAMP, 0.0))
        st = (torch.exp(cum_last[:, :, 0].clamp(CLAMP, 0.0))[..., :, None]
              * st + k_hat.transpose(-1, -2) @ vc)
        ys.append(y)
    y = torch.stack(ys, 2).reshape(b, h, s, hd)
    return y.to(r.dtype), st


def wkv6_chunked(r, k, v, w, u, s0=None, *, chunk: int = 32):
    """r, k, v, w: (B,H,S,hd); u: (H,hd); s0: (B,H,hd,hd) f32 or None.
    Returns (y (B,H,S,hd), s_last (B,H,hd,hd) f32)."""
    LN.refuse_grad("K7 (wkv6_chunked)", r, k, v, w, u, s0)
    if r.device.type == "cpu":
        return wkv6_chunked_plain(r, k, v, w, u, s0, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"no kernel for device {r.device}")
    dev = r.device
    b, h, s, hd = r.shape
    if (hd % 16 or hd > 64 or chunk % 8 or chunk > 32 or s % chunk
            or u.shape != (h, hd)):
        raise ValueError(f"unsupported shape r={tuple(r.shape)} "
                         f"u={tuple(u.shape)} chunk={chunk}: the kernel "
                         f"takes hd <= 64 (a multiple of 16: the state is "
                         f"held in 16-row tiles) and a chunk that is a "
                         f"multiple of 8 up to 32 dividing S")
    if r.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != r.dtype for t in (k, v, w)):
        raise TypeError("r, k, v and w must share one dtype, f32 or bf16")
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"u must be f32 or bf16, got {u.dtype}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        LN.check_cuda_operand(name, t, dev)
        if t.shape != r.shape or t.stride() != r.stride():
            raise ValueError(f"{name} must share r's shape and strides")
    if u.device != dev or u.stride(-1) != 1:
        raise ValueError("u must lie on the card with a unit hd stride")
    if s0 is not None and (s0.device != dev or s0.dtype != torch.float32
                           or s0.shape != (b, h, hd, hd)
                           or not s0.is_contiguous()):
        raise ValueError(f"s0 must be a contiguous f32 (B,H,hd,hd) tensor "
                         f"on {dev}")
    LN.check_copy_rows("r", r)
    y = torch.empty((b, s, h, hd), dtype=r.dtype, device=dev).transpose(1, 2)
    s_last = torch.empty((b, h, hd, hd), dtype=torch.float32, device=dev)
    # segments of the chunk chain: about SEGMENTS_PER_SM CTAs of work an SM
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = max(1, min(s // chunk, int(SEGMENTS_PER_SM * sms) // (b * h)))
    floats = LN.bind("wkv6", "wkv6_scratch_floats", [LN.I] * 4)
    floats.restype = LN.L
    scratch = torch.empty((floats(b, h, hd, g),), dtype=torch.float32,
                          device=dev)
    fn = LN.bind("wkv6", "wkv6_chunked_launch",
                 [LN.I, LN.I, LN.P, LN.P, LN.P, LN.P, LN.L, LN.L, LN.L,
                  LN.P, LN.L, LN.P, LN.P, LN.P, LN.L, LN.L, LN.L]
                 + [LN.I] * 6 + [LN.P, LN.P])
    xs, ys = r.stride(), y.stride()
    err = fn(LN.DTYPE_CODE[r.dtype], LN.DTYPE_CODE[u.dtype],
             r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             xs[0], xs[1], xs[2], u.data_ptr(), u.stride(0),
             None if s0 is None else s0.data_ptr(), s_last.data_ptr(),
             y.data_ptr(), ys[0], ys[1], ys[2], b, h, s, hd, chunk, g,
             scratch.data_ptr() if scratch.numel() else None,
             LN.stream_handle(dev))
    LN.raise_on_error("wkv6_chunked", err)
    wkv6_chunked.launches += 1
    return y, s_last


LN.counters(wkv6_chunked, "launches")
