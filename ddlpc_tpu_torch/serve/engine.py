"""Inference engine: restore once, one forward a shape bucket, serve
forever — the port of ``ddlpc_tpu/serve/engine.py``.

Owns what every inference caller needs and no caller should rebuild per
request:

- the restored weights (restored ONCE; ``reload()`` hot-swaps them from a
  newer checkpoint without dropping in-flight work — a forward snapshots
  the state reference once, so requests that already hold the old state
  finish on it and later ones see the new one; the swap is a single
  lock-guarded reference assignment, and no tensor a forward may read is
  ever written in place);
- a shape-bucketed cache of forward callables: batch sizes round up to the
  next power of two, so an arbitrary mix of request sizes runs at most
  ``log2(max_bucket)+1`` shapes per tile geometry.  Eager PyTorch compiles
  nothing, so the cache keeps the JAX engine's contract and its counters
  without a compile behind them: one callable a (bucket, th, tw, c) key,
  ``compiled_shapes`` counts the keys, and a "miss" is the first forward
  of a shape — where cuDNN picks its algorithms;
- the overlap-blended sliding-window tiler that turns an arbitrary-size
  scene into fixed-tile model calls, shared by the predict CLI and the
  server.

The model runs through ``torch.func.functional_call`` on a parameter-free
skeleton (its tensors on the ``meta`` device), one skeleton a thread, so
concurrent forwards on the batcher's slot threads never share a module
whose attributes a call swaps; each forward enters
``torch.inference_mode()`` itself (grad mode is per thread) and the
skeleton is in eval mode (BatchNorm on its running statistics, flax's
``train=False``).
"""

from __future__ import annotations

import copy
import os
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ddlpc_tpu_torch.resilience import chaos as _chaos_mod
from ddlpc_tpu_torch.serve import quantized as _quantized


class ServeState(NamedTuple):
    """The fp32 inference state: the model's parameters and its BatchNorm
    running statistics, by name."""

    params: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]


def _blend_window(tile: Tuple[int, int]) -> np.ndarray:
    """[th, tw] separable triangular weights, strictly positive, peaked at
    the window center — overlapping windows cross-fade instead of seaming."""

    def ramp(n: int) -> np.ndarray:
        x = np.arange(n, dtype=np.float32)
        return np.minimum(x + 1.0, n - x) / ((n + 1) / 2)

    return np.outer(ramp(tile[0]), ramp(tile[1])).astype(np.float32)


def window_plan(
    image: np.ndarray, tile: Tuple[int, int], overlap: float
) -> Tuple[np.ndarray, List[Tuple[int, int]], Tuple[int, int]]:
    """(padded image, window origins, original (h, w)) for a tiling pass.

    Covers the scene with ``tile``-sized windows at stride
    ``tile·(1-overlap)`` (the last row/column snaps flush to the edge, so
    coverage is exact without padding unless the scene is smaller than one
    tile).
    """
    if not 0.0 <= overlap < 1.0:
        # A negative overlap would stride past the tile, leaving wsum==0
        # gaps whose 0/0 logits silently argmax to class 0.
        raise ValueError(f"overlap must be in [0, 1), got {overlap}")
    th, tw = tile
    h, w = image.shape[:2]
    pad_h, pad_w = max(th - h, 0), max(tw - w, 0)
    if pad_h or pad_w:
        image = np.pad(image, ((0, pad_h), (0, pad_w), (0, 0)))
    H, W = image.shape[:2]

    def starts(extent: int, size: int, stride: int) -> List[int]:
        out = list(range(0, extent - size + 1, stride))
        if out[-1] != extent - size:
            out.append(extent - size)
        return out

    sh = max(int(th * (1.0 - overlap)), 1)
    sw = max(int(tw * (1.0 - overlap)), 1)
    origins = [(y, x) for y in starts(H, th, sh) for x in starts(W, tw, sw)]
    return image, origins, (h, w)


class Stitcher:
    """Incremental overlap-blend accumulator: feed per-window logits as they
    arrive, hold only the [H, W, C] accumulator — never the full set of
    window logits."""

    def __init__(
        self,
        tile: Tuple[int, int],
        padded_shape: Tuple[int, int],
        out_shape: Tuple[int, int],
    ):
        self.tile = tile
        self.padded_shape = padded_shape
        self.out_shape = out_shape
        self._weight = _blend_window(tile)
        self._acc: Optional[np.ndarray] = None
        self._wsum = np.zeros((*padded_shape, 1), np.float32)

    def add(self, origin: Tuple[int, int], tile_logits: np.ndarray) -> None:
        th, tw = self.tile
        y, x = origin
        if self._acc is None:
            self._acc = np.zeros(
                (*self.padded_shape, tile_logits.shape[-1]), np.float32
            )
        self._acc[y : y + th, x : x + tw] += np.asarray(
            tile_logits, np.float32
        ) * self._weight[..., None]
        self._wsum[y : y + th, x : x + tw, 0] += self._weight

    def finish(self) -> np.ndarray:
        assert self._acc is not None, "no windows were added"
        h, w = self.out_shape
        return (self._acc / self._wsum)[:h, :w]


def stitch_windows(
    origins: Sequence[Tuple[int, int]],
    window_logits: Sequence[np.ndarray],
    tile: Tuple[int, int],
    padded_shape: Tuple[int, int],
    out_shape: Tuple[int, int],
) -> np.ndarray:
    """Blend per-window logits back into full-scene logits [h, w, C]."""
    st = Stitcher(tile, padded_shape, out_shape)
    for origin, tile_logits in zip(origins, window_logits):
        st.add(origin, tile_logits)
    return st.finish()


def sliding_window_logits(
    logits_fn: Callable[..., np.ndarray],
    state,
    image: np.ndarray,
    tile: Tuple[int, int],
    overlap: float = 0.25,
    batch: int = 8,
) -> np.ndarray:
    """Full-scene logits [H, W, C] for an arbitrary-size image [H, W, c].

    Runs ``logits_fn(state, windows)`` on fixed-size window batches (the
    ragged tail padded to ``batch``) and blends overlaps with triangular
    weights; the serving engine runs the same plan/stitch with windows
    routed through its batcher instead.
    """
    padded, origins, (h, w) = window_plan(image, tile, overlap)
    th, tw = tile
    st = Stitcher(tile, padded.shape[:2], (h, w))
    for i in range(0, len(origins), batch):
        chunk = origins[i : i + batch]
        windows = np.stack([padded[y : y + th, x : x + tw] for y, x in chunk])
        valid = len(chunk)
        if valid < batch:
            windows = np.concatenate(
                [windows, np.repeat(windows[-1:], batch - valid, axis=0)]
            )
        logits = np.asarray(logits_fn(state, windows), np.float32)[:valid]
        for origin, tile_logits in zip(chunk, logits):
            st.add(origin, tile_logits)
    return st.finish()


def _bucket(n: int, cap: int) -> int:
    """Smallest power of two >= n, clipped to cap (callers split above it).

    Non-power-of-two caps get the bucket set {1, 2, 4, ..., cap}: the clip
    guarantees no forward ever exceeds the operator's batch cap."""
    b = 1
    while b < n:
        b <<= 1
    return min(b, cap)


def split_state_dict(model: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> ServeState:
    """A model's ``state_dict`` (``convert.torch_state_from_flax``) split
    into its parameters and its buffers; raises on a missing or unknown
    name."""
    pnames = [n for n, _ in model.named_parameters()]
    bnames = [n for n, _ in model.named_buffers()]
    missing = sorted(set(pnames + bnames) - set(sd))
    extra = sorted(set(sd) - set(pnames + bnames))
    if missing or extra:
        raise KeyError(
            f"checkpoint does not fit the model: missing {missing[:5]}, "
            f"unexpected {extra[:5]}"
        )
    return ServeState({n: sd[n] for n in pnames}, {n: sd[n] for n in bnames})


def _to_device(tree: Dict[str, torch.Tensor], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device=device, dtype=torch.float32).contiguous() for k, v in tree.items()}


class InferenceEngine:
    """Restored checkpoint + shape-bucketed forwards + hot reload.

    Thread-safe: ``forward_windows`` snapshots the state reference once per
    call, so a concurrent ``reload()`` never mixes parameter versions within
    one forward; the forward cache is dict-per-key under the same lock.

    ``state`` is a :class:`ServeState` of fp32 tensors.  With quantization
    off it is what the forwards read, on ``device``; with ``int8``/``bf16``
    the quantized state is computed from it on ``device`` and the fp32
    tensors stay on the host.
    """

    def __init__(
        self,
        cfg,
        model: torch.nn.Module,
        state: ServeState,
        channels: int,
        workdir: Optional[str] = None,
        max_bucket: int = 8,
        quantize: str = "off",
        quantize_activations: bool = False,
        device=None,
    ):
        from ddlpc_tpu_torch import resolve_device

        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # fp32 convolutions and matmuls in true fp32, not TF32, as the
            # trainer runs them.
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        # A parameter-free skeleton in eval mode; each thread runs its own
        # copy (functional_call swaps a module's attributes for a call).
        self.model = model.to("meta").eval()
        self._local = threading.local()
        self.channels = channels
        self.workdir = workdir
        self.tile: Tuple[int, int] = tuple(cfg.data.image_size)
        self.max_bucket = max(1, int(max_bucket))
        self.version = 0
        self.checkpoint_step: Optional[int] = None
        # Lineage of the serving checkpoint: set by from_workdir and
        # swapped with the weights on reload, so healthz and the
        # X-DDLPC-Model-Step header always describe the weights answering.
        self.lineage: Optional[dict] = None
        self.last_restore_s: Optional[float] = None
        self._lock = threading.Lock()
        self.quantize_mode = _quantized.check_mode(quantize)
        self.quantize_activations = bool(quantize_activations)
        self._state, self._qstate = self._resident(state)
        # (batch_bucket, th, tw, c) -> forward callable.
        self._jit_cache: Dict[Tuple[int, int, int, int], Callable] = {}
        self.forward_calls = 0
        self._cache_hits = None
        self._cache_misses = None

    def _resident(self, state: ServeState):
        """(fp32 state, quantized state or None) for a restored state: with
        quantization off the fp32 tensors move to the device; otherwise they
        stay on the host and the quantized state is computed on the device.
        Runs off-lock; the scales are computed here and only here."""
        if self.quantize_mode == "off":
            return ServeState(_to_device(state.params, self.device),
                              _to_device(state.batch_stats, self.device)), None
        host = ServeState(_to_device(state.params, torch.device("cpu")),
                          _to_device(state.batch_stats, torch.device("cpu")))
        return host, _quantized.quantize_state(
            host.params, host.batch_stats, self.quantize_mode, self.device
        )

    def hbm_bytes(self) -> Dict[str, int]:
        """Resident inference-state bytes by kind, for the state the
        forwards read (the quantized one when quantization is on) — what
        ``ddlpc_hbm_bytes{kind}`` reports on /metrics."""
        with self._lock:
            tree = self._qstate if self._qstate is not None else self._state
        return _quantized.state_nbytes(tree)

    def attach_registry(self, registry) -> None:
        """Publish ``ddlpc_serve_jit_cache_{hits,misses}_total{bucket}``
        and the ``ddlpc_hbm_bytes{kind}`` gauges into a MetricsRegistry."""
        self._cache_hits = registry.counter(
            "ddlpc_serve_jit_cache_hits_total",
            "forward_windows calls served by an existing executable, by "
            "batch bucket.",
            labelnames=("bucket",),
        )
        self._cache_misses = registry.counter(
            "ddlpc_serve_jit_cache_misses_total",
            "forward_windows calls that created a new jit wrapper "
            "(compile on first execution), by batch bucket.",
            labelnames=("bucket",),
        )
        self._hbm_gauge = registry.gauge(
            "ddlpc_hbm_bytes",
            "Resident inference-state bytes (the quantized tree when "
            "weight quantization is on), by kind.",
            labelnames=("kind",),
        )
        self._publish_hbm()

    def _publish_hbm(self) -> None:
        gauge = getattr(self, "_hbm_gauge", None)
        if gauge is None:
            return
        for kind, nbytes in self.hbm_bytes().items():
            gauge.set(float(nbytes), kind=kind)

    # ---- construction ------------------------------------------------------

    @classmethod
    def from_workdir(
        cls,
        workdir: str,
        max_bucket: int = 8,
        echo: bool = True,
        quantize: str = "off",
        quantize_activations: bool = False,
        device="cuda",
    ) -> "InferenceEngine":
        """Restore a training run's newest checkpoint into an engine on
        ``device`` (``cuda`` unless ``cpu`` is asked for; raises without
        CUDA).  The input channel count comes from the checkpoint metadata,
        as the trainer recorded it."""
        from ddlpc_tpu_torch import resolve_device
        from ddlpc_tpu_torch.config import ExperimentConfig
        from ddlpc_tpu_torch.convert import torch_state_from_flax
        from ddlpc_tpu_torch.models import build_model
        from ddlpc_tpu_torch.train import checkpoint as ckpt

        dev = resolve_device(device)
        with open(os.path.join(workdir, "config.json")) as f:
            cfg = ExperimentConfig.from_json(f.read())
        ckpt_dir = os.path.join(workdir, "checkpoints")
        tree, meta = ckpt.restore_checkpoint(ckpt_dir)
        channels = int(meta.get("input_channels", 3))
        model = build_model(cfg.model, in_channels=channels, seed=cfg.train.seed)
        sd, _ = torch_state_from_flax(tree["params"], tree["batch_stats"])
        state = split_state_dict(model, sd)
        if echo:
            print(f"restored step {meta.get('step')} (epoch {meta.get('epoch')})")
        eng = cls(cfg, model, state, channels, workdir=workdir,
                  max_bucket=max_bucket, quantize=quantize,
                  quantize_activations=quantize_activations, device=dev)
        eng.checkpoint_step = meta.get("step")
        eng.lineage = meta.get("lineage")
        return eng

    # ---- state management --------------------------------------------------

    @property
    def state(self) -> ServeState:
        with self._lock:
            return self._state

    @property
    def qstate(self):
        with self._lock:
            return self._qstate

    def reload(self, workdir: Optional[str] = None, step=None) -> dict:
        """Hot-swap the weights from the newest checkpoint in ``workdir``
        (or ``step``).

        The restore, the move to the device and the quantization run
        OFF-lock into new tensors; only the final reference swap takes the
        lock, so in-flight forwards (which snapshotted the old reference)
        are never torn mid-call.  The returned metadata gains
        ``restore_seconds``/``restore_format``."""
        from ddlpc_tpu_torch.convert import torch_state_from_flax
        from ddlpc_tpu_torch.train import checkpoint as ckpt

        workdir = workdir or self.workdir
        if workdir is None:
            raise ValueError("no workdir to reload from")
        ckpt_dir = os.path.join(workdir, "checkpoints")
        monkey = _chaos_mod.active()
        if monkey is not None:
            # reload_corrupt@K: flip a byte of the newest blob before the
            # Kth reload — the reader quarantines and falls back.
            monkey.on_serve_reload(ckpt_dir)
        t0 = time.perf_counter()
        tree, meta = ckpt.restore_checkpoint(ckpt_dir, step=step)
        sd, _ = torch_state_from_flax(tree["params"], tree["batch_stats"])
        # Re-quantize BEFORE the swap: in-flight forwards must never see new
        # fp32 state paired with old int8 weights.
        state, qstate = self._resident(split_state_dict(self.model, sd))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        restore_s = time.perf_counter() - t0
        resolved = meta.get("step") if meta.get("step") is not None else step
        fmt = None
        if resolved is not None:
            try:
                _, fmt = ckpt.checkpoint_path(ckpt_dir, int(resolved))
            except FileNotFoundError:
                pass  # pruned between restore and stat — timing still valid
        with self._lock:
            # (state, qstate, lineage) swap as ONE unit.
            self._state = state
            self._qstate = qstate
            self.version += 1
            self.checkpoint_step = meta.get("step")
            self.lineage = meta.get("lineage")
            self.last_restore_s = restore_s
        self._publish_hbm()
        meta = dict(meta, restore_seconds=round(restore_s, 4))
        if self.quantize_mode != "off":
            meta["quantize"] = self.quantize_mode
        if fmt is not None:
            meta["restore_format"] = fmt
        return meta

    # ---- the forward -------------------------------------------------------

    def _skeleton(self) -> torch.nn.Module:
        m = getattr(self._local, "model", None)
        if m is None:
            m = self._local.model = copy.deepcopy(self.model)
        return m

    def device_logits(self, state, x: torch.Tensor) -> torch.Tensor:
        """The model's logits for windows ``x`` already on the device, in
        the head's dtype: dequantization (int8: one decode launch a leaf),
        the activation cast and the forward — the device work of one
        forward.  ``state`` is a snapshot (``qstate`` or ``state``); call
        under ``torch.inference_mode()``."""
        if self.quantize_mode == "off":
            tensors = {**state.params, **state.batch_stats}
        else:
            tensors = {**_quantized.dequantize_params(state, self.quantize_mode),
                       **state.batch_stats}
        if self.quantize_activations:
            x = x.to(torch.bfloat16)
        return torch.func.functional_call(self._skeleton(), tensors, (x,))

    def _run(self, state, images: np.ndarray) -> np.ndarray:
        """Logits of one bucket-sized batch as fp32 numpy; ``state`` is the
        snapshot forward_windows took."""
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        return self.device_logits(state, x).to(torch.float32).cpu().numpy()

    def _logits_fn(self, key: Tuple[int, int, int, int]) -> Callable:
        with self._lock:
            self.forward_calls += 1
            fn = self._jit_cache.get(key)
            hit = fn is not None
            if fn is None:
                fn = self._jit_cache[key] = self._run
        counter = self._cache_hits if hit else self._cache_misses
        if counter is not None:
            counter.inc(bucket=str(key[0]))
        return fn

    @property
    def compiled_shapes(self) -> int:
        with self._lock:
            return len(self._jit_cache)

    def forward_windows(self, windows) -> np.ndarray:
        """Logits [N, th, tw, C] for N fixed-size windows [N, th, tw, c].

        N is padded up to the next power-of-two bucket (repeating the last
        window) so ragged request mixes reuse a handful of shapes; batches
        above ``max_bucket`` split into bucket-size chunks.  Runs under
        ``torch.inference_mode()`` on whichever thread calls it.
        """
        windows = np.asarray(windows, np.float32)
        if windows.ndim == 3:
            windows = windows[None]
        n = len(windows)
        if n == 0:
            raise ValueError("forward_windows needs at least one window")
        monkey = _chaos_mod.active()
        if monkey is not None:
            # Serve-side fault injection (resilience/chaos.py): kill, stall,
            # or raise here so the injected failure rides the REAL error
            # path — batcher fails the batch, frontend answers 500.
            monkey.on_serve_forward()
        # One snapshot: never mixes reload versions.
        with self._lock:
            state = self._qstate if self._qstate is not None else self._state
        outs = []
        with torch.inference_mode():
            for i in range(0, n, self.max_bucket):
                chunk = windows[i : i + self.max_bucket]
                b = _bucket(len(chunk), self.max_bucket)
                if b > len(chunk):
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[-1:], b - len(chunk), axis=0)]
                    )
                key = (b, *chunk.shape[1:])
                fn = self._logits_fn(key)
                outs.append(fn(state, chunk)[: min(self.max_bucket, n - i)])
        return np.concatenate(outs) if len(outs) > 1 else outs[0]

    def warmup(self, up_to: Optional[int] = None) -> int:
        """Run every power-of-two bucket ≤ ``up_to`` (default: all) once
        for the configured tile geometry, so the first real traffic never
        pays cuDNN's algorithm choice.  Returns the number of cached
        shapes."""
        up_to = self.max_bucket if up_to is None else min(up_to, self.max_bucket)
        th, tw = self.tile
        b = 1
        while True:
            self.forward_windows(np.zeros((b, th, tw, self.channels), np.float32))
            if b >= up_to:
                break
            b <<= 1
        return self.compiled_shapes

    # ---- full-scene prediction --------------------------------------------

    def predict_logits(
        self, image: np.ndarray, overlap: float = 0.25, batch: int = 8
    ) -> np.ndarray:
        """Synchronous full-scene logits through the engine's bucket cache:
        the ragged tail goes to ``forward_windows`` unpadded and takes the
        smallest adequate bucket."""
        padded, origins, (h, w) = window_plan(image, self.tile, overlap)
        th, tw = self.tile
        st = Stitcher(self.tile, padded.shape[:2], (h, w))
        for i in range(0, len(origins), batch):
            chunk = origins[i : i + batch]
            windows = np.stack(
                [padded[y : y + th, x : x + tw] for y, x in chunk]
            )
            for origin, tile_logits in zip(chunk, self.forward_windows(windows)):
                st.add(origin, tile_logits)
        return st.finish()

    def predict_classes(
        self, image: np.ndarray, overlap: float = 0.25, batch: int = 8
    ) -> np.ndarray:
        return np.argmax(
            self.predict_logits(image, overlap=overlap, batch=batch), axis=-1
        ).astype(np.int32)
