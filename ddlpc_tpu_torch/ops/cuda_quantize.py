"""The gradient codec's hand-written CUDA kernels and their plain versions —
the port's counterpart of ``ddlpc_tpu/ops/pallas_quantize.py``.

Each wrapper takes one flat, contiguous fp32 buffer (the whole gradient
tree, see ``parallel/train_step.FlatParams``) and dispatches on where the
tensor lies:

- a CUDA tensor launches a kernel from ``kernels/csrc/`` on PyTorch's
  current stream, or raises — never a silent plain-PyTorch path;
- a CPU tensor takes the plain version beside it (``ops/quantize.py``),
  which is what the CPU tests run and what ``chip_smoke.py`` holds each
  kernel against on the card.

Rounding follows the config: nearest (``quantize.cu``), or stochastic
(``stochastic.cu``) with either a Philox ``key`` and an element ``offset``
into its stream, drawn in the kernel, or a given U[0,1) ``noise`` field of
``x``'s shape.

Fake-quantize is two launches and nothing between them: :func:`absmax`
(``absmax.cu``), whose raw max-abs the fake-quantize kernel reads by
pointer.  The fused all-reduce takes its shared scale from the same pass.

Every wrapper counts its kernel launches in ``LAUNCHES`` (a count is added
only where a kernel is launched), so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from ddlpc_tpu_torch.config import CompressionConfig
from ddlpc_tpu_torch.ops import philox
from ddlpc_tpu_torch.ops import quantize as plain
from ddlpc_tpu_torch.ops.philox import PhiloxKey

LAUNCHES = {
    "encode_to_wire": 0, "decode_from_wire": 0, "fake_quantize_fused": 0,
    "encode_sr": 0, "fake_quantize_sr": 0, "encode_noise": 0, "fake_quantize_noise": 0,
    "absmax": 0,
}
# ddlpc_absmax's scratch: one word per block for its partial maximum and a
# last word for the counter that picks the block finishing them.  Zeroed
# once; every launch leaves the counter at 0 again.  Kept per device and
# stream: two launches in flight at once must not share a counter.
_ABSMAX_SCRATCH_WORDS = 1025
_ABSMAX_SCRATCH: dict = {}

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


def _check_draw(
    x: torch.Tensor, key: Optional[PhiloxKey], offset: int, noise: Optional[torch.Tensor]
) -> None:
    if key is not None:
        philox.check_key(key, offset)
    elif offset != 0:
        raise ValueError("offset is an index into a key's stream; no key was given")
    if noise is not None:
        _check_flat("noise", noise, torch.float32)
        if noise.shape != x.shape or noise.device != x.device:
            raise ValueError(
                f"noise must have shape {tuple(x.shape)} on {x.device}, got "
                f"{tuple(noise.shape)} on {noise.device}"
            )


def _absmax_scratch(x: torch.Tensor, stream: int) -> torch.Tensor:
    key = (x.device, stream)
    if key not in _ABSMAX_SCRATCH:
        _ABSMAX_SCRATCH[key] = torch.zeros(
            _ABSMAX_SCRATCH_WORDS, dtype=torch.int32, device=x.device
        )
    return _ABSMAX_SCRATCH[key]


def _launch(name: str, counter: str, *args) -> None:
    from ddlpc_tpu_torch.kernels.build import load_library

    _raise_on(getattr(load_library(), name)(*args), name)
    LAUNCHES[counter] += 1


def absmax(x: torch.Tensor) -> torch.Tensor:
    """``max |x|`` of a flat fp32 buffer as a 1-element fp32 tensor on
    ``x``'s device, in one pass (``ddlpc_absmax``) with no temporary and no
    host sync: 0 for an empty ``x``; NaN where any element is NaN.  Equal
    to ``x.abs().amax()`` bit for bit except in a NaN's payload.  In the
    JAX package this is ``global_absmax`` (``ddlpc_tpu/ops/quantize.py:119``),
    an XLA reduction outside the Pallas calls."""
    _check_flat("x", x, torch.float32)
    if not _kernel_device(x):
        return plain.global_absmax([x] if x.numel() else []).reshape(1)
    out = torch.empty(1, dtype=torch.float32, device=x.device)
    stream = _stream(x)
    scratch = _absmax_scratch(x, stream)
    _launch("ddlpc_absmax", "absmax", x.data_ptr(), x.numel(), out.data_ptr(),
            scratch.data_ptr(), scratch.numel(), stream)
    return out


def encode_to_wire(
    x: torch.Tensor,
    safe_scale: torch.Tensor,
    cfg: CompressionConfig,
    wire: torch.dtype,
    key: Optional[PhiloxKey] = None,
    offset: int = 0,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Snap ``x`` to ``cfg``'s lattice against the caller-shared
    (zero-guarded) scale and store it in the wire dtype (int8, int16 or
    fp16).  Replaces ``_encode_kernel`` (pallas_quantize.py:142): nearest
    (``ddlpc_encode_*``) or its stochastic branch with ``key``
    (``ddlpc_encode_sr_*``); and ``_encode_kernel_hostnoise`` (:163) with
    ``noise`` (``ddlpc_encode_noise_*``)."""
    levels = float(plain.levels_for(cfg))
    key, noise = plain.rounding_key(cfg, key, noise)
    if wire not in _WIRE_SUFFIX:
        raise TypeError(f"unsupported wire dtype {wire}")
    _check_flat("x", x, torch.float32)
    _check_scalar("safe_scale", safe_scale, x)
    _check_draw(x, key, offset, noise)
    if not _kernel_device(x):
        return plain.encode_with_scale(
            x, safe_scale, levels, wire, key=key, offset=offset, noise=noise
        )
    q = torch.empty(x.shape, dtype=wire, device=x.device)
    sfx = _WIRE_SUFFIX[wire]
    n, s = x.numel(), safe_scale.data_ptr()
    if key is not None:  # any offset and alignment: the kernel picks its loads
        _launch(f"ddlpc_encode_sr_{sfx}", "encode_sr", x.data_ptr(), q.data_ptr(),
                n, s, levels, *key, offset, _stream(x))
        return q
    _check_aligned("x", x)
    if noise is None:
        _launch(f"ddlpc_encode_{sfx}", "encode_to_wire", x.data_ptr(), q.data_ptr(),
                n, s, levels, _stream(x))
    else:
        _check_aligned("noise", noise)
        _launch(f"ddlpc_encode_noise_{sfx}", "encode_noise", x.data_ptr(),
                noise.data_ptr(), q.data_ptr(), n, s, levels, _stream(x))
    return q


def decode_from_wire(
    q: torch.Tensor, inv: torch.Tensor, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``float(q) · inv`` into ``out`` (a new fp32 tensor when None), where
    ``inv = scale / (levels · world_size)`` folds the mean into the one
    multiply.  ``q`` and ``out`` may be slices at any alignment (the kernel
    takes a scalar path where either is not 16-byte aligned).  Replaces
    ``_decode_kernel`` (pallas_quantize.py:170)."""
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
    _launch(f"ddlpc_decode_{_WIRE_SUFFIX[q.dtype]}", "decode_from_wire",
            q.data_ptr(), out.data_ptr(), q.numel(), inv.data_ptr(), _stream(q))
    return out


def fake_quantize_plain(
    x: torch.Tensor,
    cfg: CompressionConfig,
    key: Optional[PhiloxKey] = None,
    offset: int = 0,
    noise: Optional[torch.Tensor] = None,
    amax: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of :func:`fake_quantize_fused`: the codec's
    encode→decode round trip on one buffer, against ``amax`` where given."""
    return plain.fake_quantize(
        [x], cfg, key=key, offset=offset, noise=None if noise is None else [noise],
        scale=None if amax is None else amax.reshape(()),
    )[0]


def fake_quantize_fused(
    x: torch.Tensor,
    cfg: CompressionConfig,
    out: Optional[torch.Tensor] = None,
    key: Optional[PhiloxKey] = None,
    offset: int = 0,
    noise: Optional[torch.Tensor] = None,
    amax: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Quantize→dequantize ``x`` against its own max-abs, or against
    ``amax`` (a 1-element fp32 tensor on ``x``'s device) where the caller
    has reduced it already (a shard of the mean against the whole model's
    max); bit-identical to ``ops.quantize.fake_quantize`` on the one-leaf
    tree.  ``out`` may be ``x`` itself (in place).

    Replaces ``_fq_kernel`` (pallas_quantize.py:50): nearest
    (``ddlpc_fake_quantize``) or its stochastic branch with ``key``
    (``ddlpc_fake_quantize_sr``); and ``_fq_kernel_hostnoise`` (:71) with
    ``noise`` (``ddlpc_fake_quantize_noise``).  On the card it is two
    launches, :func:`absmax` (none when ``amax`` is given), then the
    kernel, which reads the raw max-abs by pointer and derives the
    zero-guarded divisor and the step itself."""
    if cfg.mode == "none":
        return x
    levels = float(plain.levels_for(cfg))
    key, noise = plain.rounding_key(cfg, key, noise)
    _check_flat("x", x, torch.float32)
    _check_draw(x, key, offset, noise)
    if amax is not None:
        _check_scalar("amax", amax, x)
    if out is None:
        out = torch.empty_like(x)
    _check_flat("out", out, torch.float32)
    if out.shape != x.shape or out.device != x.device:
        raise ValueError(f"out must have shape {tuple(x.shape)} on {x.device}")
    if not _kernel_device(x):
        return out.copy_(
            fake_quantize_plain(x, cfg, key=key, offset=offset, noise=noise, amax=amax)
        )
    if noise is not None:  # nearest and _sr take any alignment; _noise moves float4s
        _check_aligned("x", x)
        _check_aligned("out", out)
        _check_aligned("noise", noise)
    # The max-abs pass reads x whole before the kernel, the next launch on
    # the stream, writes out: so out may be x.
    if amax is None:
        amax = absmax(x)
    common = (x.numel(), amax.data_ptr(), levels, int(cfg.mode == "float16"))
    if key is not None:
        _launch("ddlpc_fake_quantize_sr", "fake_quantize_sr", x.data_ptr(),
                out.data_ptr(), *common, *key, offset, _stream(x))
    elif noise is None:
        _launch("ddlpc_fake_quantize", "fake_quantize_fused", x.data_ptr(),
                out.data_ptr(), *common, _stream(x))
    else:
        _launch("ddlpc_fake_quantize_noise", "fake_quantize_noise", x.data_ptr(),
                noise.data_ptr(), out.data_ptr(), *common, _stream(x))
    return out
