"""The gradient codec's hand-written CUDA kernels and their plain versions —
the port's counterpart of ``ddlpc_tpu/ops/pallas_quantize.py``.

Each wrapper takes one flat, contiguous fp32 buffer (the whole gradient
tree, see ``parallel/train_step.FlatParams``) and dispatches on where the
tensor lies:

- a CUDA tensor launches the kernel from ``kernels/csrc/quantize.cu`` on
  PyTorch's current stream, or raises — never a silent plain-PyTorch path;
- a CPU tensor takes the plain version beside it (``ops/quantize.py``),
  which is what the CPU tests run and what ``chip_smoke.py`` holds each
  kernel against on the card.

Every wrapper counts its kernel launches in ``LAUNCHES`` (a count is added
only where the kernel is launched), so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from ddlpc_tpu_torch.config import CompressionConfig
from ddlpc_tpu_torch.ops import quantize as plain

LAUNCHES = {"encode_to_wire": 0, "decode_from_wire": 0, "fake_quantize_fused": 0}

_WIRE_SUFFIX = {torch.int8: "i8", torch.int16: "i16", torch.float16: "f16"}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_flat(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    """What every kernel takes, checked on every device so that the CPU
    path refuses what the card would."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_aligned(name: str, t: torch.Tensor) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (the kernels move float4s)")


def _check_scalar(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.numel() != 1 or t.dtype != torch.float32 or t.device != like.device:
        raise ValueError(
            f"{name} must be a 1-element float32 tensor on {like.device}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device}"
        )


def _kernel_device(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (the
    plain version); any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {x.device}")


def _raise_on(status: int, kernel: str) -> None:
    if status != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch (cudaError {status})")


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def encode_to_wire(
    x: torch.Tensor,
    safe_scale: torch.Tensor,
    cfg: CompressionConfig,
    wire: torch.dtype,
) -> torch.Tensor:
    """Snap ``x`` to ``cfg``'s lattice against the caller-shared
    (zero-guarded) scale and store it in the wire dtype (int8, int16 or
    fp16).  Replaces ``_encode_kernel`` (pallas_quantize.py:142), nearest
    rounding; a stochastic config raises (not ported yet)."""
    plain.check_rounding(cfg)
    levels = float(plain.levels_for(cfg))
    if wire not in _WIRE_SUFFIX:
        raise TypeError(f"unsupported wire dtype {wire}")
    _check_flat("x", x, torch.float32)
    _check_scalar("safe_scale", safe_scale, x)
    if not _kernel_device(x):
        return plain.encode_with_scale(x, safe_scale, levels, wire)
    _check_aligned("x", x)
    from ddlpc_tpu_torch.kernels.build import load_library

    q = torch.empty(x.shape, dtype=wire, device=x.device)
    name = f"ddlpc_encode_{_WIRE_SUFFIX[wire]}"
    status = getattr(load_library(), name)(
        x.data_ptr(), q.data_ptr(), x.numel(), safe_scale.data_ptr(),
        levels, _stream(x),
    )
    _raise_on(status, name)
    LAUNCHES["encode_to_wire"] += 1
    return q


def decode_from_wire(
    q: torch.Tensor, inv: torch.Tensor, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``float(q) · inv`` into ``out`` (a new fp32 tensor when None), where
    ``inv = scale / (levels · world_size)`` folds the mean into the one
    multiply.  Replaces ``_decode_kernel`` (pallas_quantize.py:170)."""
    if q.dtype not in _WIRE_SUFFIX:
        raise TypeError(f"unsupported wire dtype {q.dtype}")
    _check_flat("q", q, q.dtype)
    _check_scalar("inv", inv, q)
    if out is None:
        out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _check_flat("out", out, torch.float32)
    if out.shape != q.shape or out.device != q.device:
        raise ValueError(f"out must have shape {tuple(q.shape)} on {q.device}")
    if not _kernel_device(q):
        return plain.decode_with_inv(q, inv, out=out)
    _check_aligned("q", q)
    _check_aligned("out", out)
    from ddlpc_tpu_torch.kernels.build import load_library

    name = f"ddlpc_decode_{_WIRE_SUFFIX[q.dtype]}"
    status = getattr(load_library(), name)(
        q.data_ptr(), out.data_ptr(), q.numel(), inv.data_ptr(), _stream(q)
    )
    _raise_on(status, name)
    LAUNCHES["decode_from_wire"] += 1
    return out


def fake_quantize_plain(x: torch.Tensor, cfg: CompressionConfig) -> torch.Tensor:
    """Plain version of :func:`fake_quantize_fused`: the codec's
    encode→decode round trip on one buffer."""
    return plain.fake_quantize([x], cfg)[0]


def fake_quantize_fused(
    x: torch.Tensor, cfg: CompressionConfig, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Quantize→dequantize ``x`` against its own max-abs in one pass;
    bit-identical to ``ops.quantize.fake_quantize`` on the one-leaf tree.
    ``out`` may be ``x`` itself (in place).

    Replaces ``_fq_kernel`` (pallas_quantize.py:50), nearest rounding.  The
    max-abs stays a ``torch.amax`` reduction outside the kernel, as it is
    an XLA reduction outside the Pallas call in the JAX package."""
    if cfg.mode == "none":
        return x
    plain.check_rounding(cfg)
    levels = float(plain.levels_for(cfg))
    _check_flat("x", x, torch.float32)
    if out is None:
        out = torch.empty_like(x)
    _check_flat("out", out, torch.float32)
    if out.shape != x.shape or out.device != x.device:
        raise ValueError(f"out must have shape {tuple(x.shape)} on {x.device}")
    if not _kernel_device(x):
        return out.copy_(fake_quantize_plain(x, cfg))
    _check_aligned("x", x)
    _check_aligned("out", out)
    scale = x.abs().amax().reshape(1) if x.numel() else x.new_zeros(1)
    safe = plain.safe_divisor(scale)
    step = plain.true_div(scale, levels)
    from ddlpc_tpu_torch.kernels.build import load_library

    status = load_library().ddlpc_fake_quantize(
        x.data_ptr(), out.data_ptr(), x.numel(), safe.data_ptr(),
        step.data_ptr(), levels, int(cfg.mode == "float16"), _stream(x),
    )
    _raise_on(status, "ddlpc_fake_quantize")
    LAUNCHES["fake_quantize_fused"] += 1
    return out
