"""Serving front end: stdlib HTTP over the engine + batcher + metrics —
the port of ``ddlpc_tpu/serve/server.py``, with the same wire protocol
(the same routes, bodies, status codes, ``/healthz`` keys and metric
family names), so a client of the JAX server talks to this one unchanged.

Two layers so the protocol stays swappable:

- :class:`ServingFrontend` — protocol-agnostic: full-scene predict (plan →
  batched windows → stitch), health/metrics readouts, hot-reload, graceful
  drain.  Tests and the load generator drive this directly.
- ``http.server`` handler — ``GET /healthz``, ``GET /metrics``,
  ``POST /predict`` (npy image body → npy class-map body),
  ``POST /reload``.  A deliberately boring stdlib front end: the workload
  is compute-bound on the accelerator, so a threading HTTP server whose
  request threads block on batcher futures is enough — the batcher is the
  throughput engine, not the socket layer.

Overload semantics on the wire: ``Overloaded`` → 503 + Retry-After,
``DeadlineExceeded`` → 504, draining → 503.  Clients get a fast typed
rejection, never an unbounded queue wait.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import io
import json
import os
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import TYPE_CHECKING, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from ddlpc_tpu_torch.config import ServeConfig
from ddlpc_tpu_torch.obs import lineage as obs_lineage
from ddlpc_tpu_torch.obs import profiling as _profiling
from ddlpc_tpu_torch.obs.health import Alert as HealthAlert
from ddlpc_tpu_torch.obs.health import HealthMonitor
from ddlpc_tpu_torch.obs.http import render_metrics
from ddlpc_tpu_torch.obs.registry import MetricsRegistry
from ddlpc_tpu_torch.obs.tracing import (
    TRACEPARENT_HEADER,
    Tracer,
    parse_traceparent,
)
from ddlpc_tpu_torch.serve.batching import (
    DeadlineExceeded,
    EngineClosed,
    MicroBatcher,
    Overloaded,
)
from ddlpc_tpu_torch.serve.cbatch import ContinuousBatcher, check_priority
from ddlpc_tpu_torch.serve.metrics import ServeMetrics

if TYPE_CHECKING:
    from ddlpc_tpu_torch.serve.engine import InferenceEngine


class ServingFrontend:
    """Engine + batcher + metrics behind one protocol-agnostic API."""

    def __init__(
        self,
        engine: InferenceEngine,
        cfg: Optional[ServeConfig] = None,
        logger=None,
    ):
        self.engine = engine
        self.cfg = cfg or ServeConfig()
        # Unified telemetry (ddlpc_tpu/obs): a Prometheus-style registry
        # every metrics hook publishes into (GET /metrics negotiates text
        # exposition vs the legacy JSON snapshot), a span tracer for the
        # request path, and health detectors for queue saturation.
        self.registry = MetricsRegistry()
        # Traces land next to the metrics stream: metrics_dir when set (the
        # fleet gives each replica its own — N replicas must never
        # interleave one serve_spans.jsonl), else the workdir as before.
        trace_dir = self.cfg.metrics_dir or self.cfg.workdir
        self.tracer = Tracer(
            enabled=self.cfg.trace,
            service="serve",
            jsonl_path=os.path.join(trace_dir, "serve_spans.jsonl"),
            chrome_path=os.path.join(trace_dir, "serve_trace.json"),
        )
        self.metrics = ServeMetrics(
            window=self.cfg.metrics_window, registry=self.registry
        )
        # Shape-bucketed forward cache visibility (getattr: tests drive the
        # frontend with minimal fake engines).
        attach = getattr(engine, "attach_registry", None)
        if attach is not None:
            attach(self.registry)
        # Admission loop: 'continuous' (serve/cbatch.py — slot-based
        # refill, priority classes) or the coalesce-and-wait
        # MicroBatcher.  Both expose the same submit/drain/typed-error
        # surface; everything below is batcher-agnostic.
        if self.cfg.batcher == "continuous":
            self.batcher = ContinuousBatcher(
                engine.forward_windows,
                max_batch=self.cfg.max_batch,
                queue_limit=self.cfg.queue_limit,
                batch_queue_limit=self.cfg.batch_queue_limit,
                slots=self.cfg.slots,
                starvation_every=self.cfg.starvation_every,
                metrics=self.metrics,
                tracer=self.tracer,
            )
        elif self.cfg.batcher == "coalesce":
            self.batcher = MicroBatcher(
                engine.forward_windows,
                max_batch=self.cfg.max_batch,
                max_wait_ms=self.cfg.max_wait_ms,
                queue_limit=self.cfg.queue_limit,
                metrics=self.metrics,
                tracer=self.tracer,
            )
        else:
            raise ValueError(
                f"unknown batcher {self.cfg.batcher!r} "
                f"(expected 'continuous' or 'coalesce')"
            )
        self.logger = logger
        if logger is not None and getattr(logger, "registry", None) is None:
            # The serve CLI builds its logger before this frontend (and its
            # registry) exists — wire it here so the periodic snapshot
            # records (p50/p95/p99 quantiles) reach the Prometheus
            # exposition as ddlpc_serve_* gauges too.
            logger.attach_registry(self.registry)
        self.health = HealthMonitor(
            logger=logger, registry=self.registry, service="serve"
        )
        self.draining = False
        # Failed hot-reloads (corrupt/truncated/missing checkpoints): the
        # engine keeps serving the CURRENT params; the failure is counted,
        # alerted, and surfaced on /healthz — never raised into a handler.
        self._reload_errors = self.registry.counter(
            "ddlpc_serve_reload_errors_total",
            "Hot-reload attempts that failed (engine kept serving the "
            "previous weights), by error type.",
            labelnames=("error",),
        )
        self.last_reload_error: Optional[str] = None
        self._profile_lock = threading.Lock()
        self._profile_n = 0
        # Quantized deploys leave an audit record of what is resident:
        # mode + actual byte footprint, once at start and per reload.
        self._log_quant()
        self._emit_stop = threading.Event()
        self._emitter: Optional[threading.Thread] = None
        if logger is not None and self.cfg.metrics_every_s > 0:
            self._emitter = threading.Thread(
                target=self._emit_loop, name="serve-metrics", daemon=True
            )
            self._emitter.start()

    def _log_quant(self) -> None:
        """kind="serve_quant" audit record: which weight-quant mode is
        live and what the resident inference state actually weighs."""
        mode = getattr(self.engine, "quantize_mode", "off")
        if self.logger is None or mode == "off":
            return
        rec = {
            "kind": "serve_quant",
            "mode": mode,
            "quantize_activations": bool(
                getattr(self.engine, "quantize_activations", False)
            ),
            "checkpoint_step": self.engine.checkpoint_step,
        }
        hbm = getattr(self.engine, "hbm_bytes", None)
        if hbm is not None:
            rec.update({f"{k}_bytes": int(v) for k, v in hbm().items()})
        self.logger.log(rec, echo=False)

    def _emit_loop(self) -> None:
        while not self._emit_stop.wait(self.cfg.metrics_every_s):
            self.metrics.emit(self.logger)
            # Queue-saturation detection rides the emit cadence: a single
            # full sample is a burst, N consecutive saturated samples at
            # this cadence mean shedding is imminent (obs/health.py).
            self.health.observe_queue(
                self.batcher.queue_depth, self.cfg.queue_limit
            )
            self._publish_slot_busy()

    def _publish_slot_busy(self) -> None:
        """Per-slot busy fractions over the emit window →
        ``ddlpc_serve_slot_busy_fraction{slot}`` (continuous batcher only;
        getattr-guarded like every other optional batcher surface)."""
        fractions_fn = getattr(self.batcher, "slot_busy_fractions", None)
        if fractions_fn is not None:
            self.metrics.set_slot_busy(fractions_fn())

    # ---- request paths -----------------------------------------------------

    def predict_logits(
        self,
        image: np.ndarray,
        overlap: Optional[float] = None,
        priority: str = "interactive",
    ) -> np.ndarray:
        """Full-scene logits with every window routed through the batcher —
        windows from concurrent scenes coalesce into shared forwards.
        ``priority='batch'`` files the scene's windows into the bulk
        admission queue (continuous batcher; the coalesce batcher has one
        queue and the class is accounting-only)."""
        image = np.asarray(image, np.float32)
        check_priority(priority)
        if image.ndim != 3:
            raise ValueError(f"expected [H, W, C] image, got {image.shape}")
        if image.shape[-1] != self.engine.channels:
            raise ValueError(
                f"expected {self.engine.channels} channels, got "
                f"{image.shape[-1]}"
            )
        overlap = self.cfg.overlap if overlap is None else overlap
        th, tw = self.engine.tile
        t0 = time.monotonic()
        # Root span per scene request; window_plan/enqueue/stitch nest
        # under it on this thread (the batcher's coalesce/execute spans are
        # cross-thread and stand alone on the worker's track).
        with self.tracer.span("serve_request") as req_span:
            out, n_tiles = self._predict_logits_inner(
                image, overlap, th, tw, req_span, priority
            )
        self.metrics.record_request(
            time.monotonic() - t0, tiles=n_tiles, priority=priority
        )
        return out

    def _predict_logits_inner(self, image, overlap, th, tw, req_span,
                              priority="interactive"):
        # The engine module (and torch with it) loads where a frontend
        # plans windows, never at import: the fleet's front end reuses
        # this module's HTTP server class without an engine.
        from ddlpc_tpu_torch.serve.engine import Stitcher, window_plan

        with self.tracer.span("window_plan"):
            padded, origins, (h, w) = window_plan(
                image, self.engine.tile, overlap
            )
        # Chunked admission: each chunk is admitted all-or-nothing (a shed
        # chunk never half-occupies the queue), but a scene that tiles into
        # more windows than the queue holds is NOT permanently rejected —
        # it streams through in chunks of at most half the queue, which
        # also stops one huge scene from monopolizing admission.  Blending
        # happens as futures resolve, so peak memory is the accumulator +
        # one in-flight chunk.  result() gets a margin on top of the queue
        # deadline so a wedged worker surfaces as an error, not a hang.
        st = Stitcher(self.engine.tile, padded.shape[:2], (h, w))
        chunk_size = max(1, self.cfg.queue_limit // 2)
        timeout = (
            self.cfg.deadline_ms / 1000.0 + 60.0
            if self.cfg.deadline_ms
            else None
        )
        submit_kwargs = (
            {"priority": priority}
            if isinstance(self.batcher, ContinuousBatcher)
            else {}
        )
        for i in range(0, len(origins), chunk_size):
            chunk = origins[i : i + chunk_size]
            windows = [padded[y : y + th, x : x + tw] for y, x in chunk]
            with self.tracer.span("enqueue", windows=len(windows)):
                futures = self.batcher.submit_many(
                    windows, deadline_ms=self.cfg.deadline_ms or None,
                    **submit_kwargs,
                )
            try:
                with self.tracer.span("stitch", windows=len(windows)):
                    for origin, fut in zip(chunk, futures):
                        st.add(origin, fut.result(timeout=timeout))
            except BaseException:
                # The scene already failed: cancel still-queued sibling
                # windows so the batcher stops burning capacity on a
                # request that got its error response.
                for fut in futures:
                    fut.cancel()
                raise
        out = st.finish()
        req_span.set(tiles=len(origins))
        return out, len(origins)

    def predict_classes(
        self,
        image: np.ndarray,
        overlap: Optional[float] = None,
        priority: str = "interactive",
    ) -> np.ndarray:
        return np.argmax(
            self.predict_logits(image, overlap, priority=priority), axis=-1
        ).astype(np.int32)

    def reload(self, workdir: Optional[str] = None, step=None) -> dict:
        """Hot-reload; NEVER raises.

        ``step`` pins an explicit checkpoint step (the fleet's rolling-
        reload rollback uses it to push every replica back to the old
        weights); default is the newest.

        The checkpoint reader already quarantines a corrupt newest blob and
        falls back to the next-newest (train/checkpoint.py); this catch is
        the last line — no checkpoints left, unreadable disk, anything —
        and its contract is: keep serving the current weights, return a
        structured ``{"error": ...}`` the HTTP layer maps to a non-200,
        count it, and alert.  The engine's state is untouched on failure
        (the restore runs off-lock BEFORE the reference swap).
        """
        try:
            meta = self.engine.reload(workdir, step=step)
        except Exception as e:
            err = f"{type(e).__name__}: {e}"
            self.last_reload_error = err
            self._reload_errors.inc(error=type(e).__name__)
            self.health.emit(
                HealthAlert(
                    alert="reload_failed",
                    severity="warn",
                    message=f"hot-reload failed, serving previous weights: {err}",
                    value=float(self.engine.version),
                    threshold=0.0,
                )
            )
            return {
                "error": err,
                "error_type": type(e).__name__,
                # What we are STILL serving — the caller's recovery signal.
                "version": self.engine.version,
                "checkpoint_step": self.engine.checkpoint_step,
            }
        self.last_reload_error = None
        if meta.get("quarantined_steps"):
            # The reader fell back past corrupt blob(s): serving continues
            # on an older checkpoint — loud, but not an error.
            self.health.emit(
                HealthAlert(
                    alert="checkpoint_quarantined",
                    severity="warn",
                    message=(
                        f"reload quarantined corrupt checkpoint step(s) "
                        f"{meta['quarantined_steps']}, restored step "
                        f"{meta.get('step')}"
                    ),
                    value=float(meta.get("step") or 0),
                    threshold=0.0,
                )
            )
        if self.logger is not None:
            self.logger.log(
                {
                    "kind": "serve_reload",
                    "version": self.engine.version,
                    "step": meta.get("step"),
                    "restore_seconds": meta.get("restore_seconds"),
                    "restore_format": meta.get("restore_format"),
                    # Flat lineage join key (the record itself stays flat
                    # per obs/schema.py) — how obs/merge.py ties this
                    # reload to the checkpoint save span that produced it.
                    **obs_lineage.flatten(meta.get("lineage")),
                },
                echo=False,
            )
        self._log_quant()  # fresh scales/footprint after the swap
        return meta

    def healthz(self) -> dict:
        # Queue depth, limit, and windowed batch occupancy ride along so
        # the fleet router's occupancy-aware dispatch has ONE cheap scrape
        # endpoint instead of parsing the full /metrics exposition; the
        # per-priority depths and quant mode keep that one-scrape contract
        # sufficient for priority-aware dispatch and quantized rollouts.
        slot_busy = self.metrics.slot_busy  # replaced atomically on emit
        depths_fn = getattr(self.batcher, "queue_depths", None)
        depths = (
            depths_fn()
            if depths_fn is not None
            else {"interactive": self.batcher.queue_depth, "batch": 0}
        )
        return {
            "status": "draining" if self.draining else "ok",
            "version": self.engine.version,
            # queue_depth derives from the SAME read as the per-class
            # depths — one scrape must never contradict itself (the
            # router ranks on the total and sheds on the classes).
            "checkpoint_step": self.engine.checkpoint_step,
            "tile": list(self.engine.tile),
            "channels": self.engine.channels,
            "queue_depth": sum(depths.values()),
            "queue_depth_interactive": depths.get("interactive", 0),
            "queue_depth_batch": depths.get("batch", 0),
            "queue_limit": self.cfg.queue_limit,
            "quant_mode": getattr(self.engine, "quantize_mode", "off"),
            "batch_occupancy": self.metrics.occupancy(),
            # Mean of the LAST PUBLISHED per-slot busy fractions (emit
            # cadence) — reading the batcher here would consume its
            # readout window out from under the metrics emitter.  None
            # until the first emit, or without a continuous batcher; the
            # autoscaler treats None as "no signal".
            "slot_busy_fraction": (
                sum(slot_busy.values()) / len(slot_busy)
                if slot_busy
                else None
            ),
            "compiled_shapes": self.engine.compiled_shapes,
            "last_reload_error": self.last_reload_error,
            "alerts": list(self.health.alerts),
            # Lineage of the serving weights, FLAT (the router scrapes
            # these fields into its freshness gauges; pre-lineage
            # checkpoints surface the explicit unknown marker).
            **obs_lineage.flatten(getattr(self.engine, "lineage", None)),
        }

    def debug_trace(self, steps: Optional[int] = None, timeout_s: float = 30.0) -> dict:
        """On-demand profiler capture over the next ``steps`` batched
        forwards: torch.profiler capture → per-op self-time aggregation → the
        committed top-ops format, written as ``serve_top_ops_<n>.json`` in
        the workdir.  Returns the report (an ``error`` field instead of an
        exception for every failure mode — a second concurrent capture, a
        backend that cannot trace, no traffic within the timeout)."""
        steps = int(steps) if steps else self.cfg.profile_steps
        with self._profile_lock:
            self._profile_n += 1
            n = self._profile_n
        trace_dir = os.path.join(self.cfg.workdir, f"serve_profile_{n:03d}")
        target = self.batcher.forward_count + steps
        try:
            res = _profiling.capture(
                trace_dir,
                until=lambda: self.batcher.forward_count >= target,
                timeout_s=timeout_s,
            )
        except _profiling.CaptureBusy as e:
            return {"error": str(e)}
        if "error" in res:
            return res
        captured = steps if not res.get("timed_out") else max(
            self.batcher.forward_count - (target - steps), 1
        )
        report = _profiling.aggregate(
            trace_dir, steps=captured, tag=f"serve_ondemand_{n:03d}"
        )
        report["timed_out"] = res.get("timed_out", False)
        report["wall_s"] = res.get("seconds")
        path = os.path.join(self.cfg.workdir, f"serve_top_ops_{n:03d}.json")
        try:
            from ddlpc_tpu_torch.utils.fsio import atomic_write_json

            atomic_write_json(path, report)
            report["report_path"] = path
        except OSError as e:
            report.setdefault("error", f"report not written: {e}")
        if self.logger is not None:
            self.logger.log(
                {
                    "kind": "profile",
                    "report_path": report.get("report_path"),
                    "steps_traced": captured,
                    "per_step_ms": report.get("per_step_ms"),
                    "error": report.get("error"),
                },
                echo=False,
            )
        return report

    def close(self, drain: bool = True) -> None:
        """Stop admission, finish queued work (drain=True), stop emitting."""
        self.draining = True
        self.batcher.close(drain=drain)
        self._emit_stop.set()
        if self._emitter is not None:
            self._emitter.join(timeout=5.0)
        if self.logger is not None:
            self.metrics.emit(self.logger)
        # Traced deploys drop serve_trace.json on shutdown (flush-and-close
        # is a no-op for a disabled tracer).
        self.tracer.close()


# ---- HTTP layer -------------------------------------------------------------


def _load_npy(body: bytes) -> np.ndarray:
    return np.load(io.BytesIO(body), allow_pickle=False)


def _dump_npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


class ServeHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that counts in-flight requests.

    Idle keep-alive connections hold no count — only a request actually
    being handled does — so the graceful SIGTERM drain can wait for real
    work without being wedged by a client that simply left its connection
    open.  Handler threads stay daemonic; the drain waits on THIS counter,
    not thread joins."""

    daemon_threads = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._inflight = 0
        self._inflight_cond = threading.Condition()

    def request_began(self) -> None:
        with self._inflight_cond:
            self._inflight += 1

    def request_finished(self) -> None:
        with self._inflight_cond:
            self._inflight -= 1
            self._inflight_cond.notify_all()

    @property
    def inflight(self) -> int:
        with self._inflight_cond:
            return self._inflight

    def handle_error(self, request, client_address) -> None:
        """A peer that hung up — the fleet router closes a hedge loser's
        connection under it, a client gives up — is routine, not a fault:
        the connection ends without a traceback (its request's work is
        done and its in-flight count released by the handler).  Anything
        else is reported as before."""
        if isinstance(sys.exc_info()[1], ConnectionError):
            return
        super().handle_error(request, client_address)

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until no request is being handled (True) or ``timeout``
        expires with work still in flight (False)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._inflight_cond:
            while self._inflight > 0:
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    return False
                self._inflight_cond.wait(remaining)
            return True


class _Handler(BaseHTTPRequestHandler):
    server_version = "ddlpc-serve/1"
    protocol_version = "HTTP/1.1"

    @property
    def frontend(self) -> ServingFrontend:
        return self.server.frontend  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # quiet by default; metrics cover it
        pass

    def do_GET(self) -> None:
        # In-flight accounting wraps the dispatch (handler → response
        # write), NOT the connection: an idle keep-alive socket blocked in
        # readline() between requests holds no count, so the graceful
        # drain waits for real work only.
        began = getattr(self.server, "request_began", None)
        if began is None:
            self._dispatch_get()
            return
        began()
        try:
            self._dispatch_get()
        finally:
            self.server.request_finished()

    def do_POST(self) -> None:
        began = getattr(self.server, "request_began", None)
        if began is None:
            self._dispatch_post()
            return
        began()
        try:
            self._dispatch_post()
        finally:
            self.server.request_finished()

    def _send_json(self, code: int, obj: dict, extra=()) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in extra:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_npy(self, arr: np.ndarray, extra=()) -> None:
        body = _dump_npy(arr)
        self.send_response(200)
        self.send_header("Content-Type", "application/x-npy")
        self.send_header("Content-Length", str(len(body)))
        for k, v in extra:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _dispatch_get(self) -> None:
        parsed = urlparse(self.path)
        path = parsed.path
        if path == "/healthz":
            h = self.frontend.healthz()
            self._send_json(200 if h["status"] == "ok" else 503, h)
        elif path == "/metrics":
            # Content-negotiated (obs/http.py): JSON snapshot stays the
            # default (existing tooling and the bench parse it); an Accept
            # header naming text/plain or openmetrics — what Prometheus'
            # scraper sends — selects the text exposition.  advance=False:
            # a scrape must not reset the rate interval the periodic JSONL
            # emitter (and the bench) measure over.
            ctype, body = render_metrics(
                self.frontend.registry,
                self.headers.get("Accept"),
                json_fallback=lambda: self.frontend.metrics.snapshot(
                    advance=False
                ),
            )
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif path == "/debug/trace":
            q = parse_qs(parsed.query)
            try:
                steps = int(q["steps"][0]) if "steps" in q else 0
                timeout_s = (
                    float(q["timeout_s"][0]) if "timeout_s" in q else 30.0
                )
            except ValueError:
                self._send_json(
                    400, {"error": "steps/timeout_s must be numeric"}
                )
                return
            # Runs the capture on THIS handler thread (the server is
            # threading; other requests keep flowing — they are the very
            # traffic being profiled).
            self._send_json(200, self.frontend.debug_trace(steps, timeout_s))
        else:
            self._send_json(404, {"error": f"no route {path}"})

    def _dispatch_post(self) -> None:
        parsed = urlparse(self.path)
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length) if length else b""
            if parsed.path == "/predict":
                self._predict(parsed, body)
            elif parsed.path == "/reload":
                self._reload(body)
            else:
                self._send_json(404, {"error": f"no route {parsed.path}"})
        except BrokenPipeError:
            pass

    def _predict(self, parsed, body: bytes) -> None:
        try:
            image = _load_npy(body)
        except Exception as e:
            self._send_json(400, {"error": f"body is not a valid .npy: {e}"})
            return
        q = parse_qs(parsed.query)
        # Cross-process trace context: a traceparent header from
        # the fleet router binds this handler thread to the REQUEST's
        # trace id, so serve_request and its children join the router's
        # timeline.  Malformed/absent headers degrade to a local trace.
        ctx = parse_traceparent(self.headers.get(TRACEPARENT_HEADER))
        trace_id, parent_hex = ctx if ctx is not None else (None, None)
        try:
            overlap = float(q["overlap"][0]) if "overlap" in q else None
            priority = q["priority"][0] if "priority" in q else "interactive"
            with self.frontend.tracer.bind(trace_id, parent_hex):
                pred = self.frontend.predict_classes(
                    image, overlap=overlap, priority=priority
                )
        except Overloaded as e:
            self._send_json(503, {"error": str(e)}, extra=[("Retry-After", "1")])
        except (DeadlineExceeded, TimeoutError,
                concurrent.futures.TimeoutError) as e:
            # futures.TimeoutError is NOT the builtin before 3.11; both mean
            # the same here — the worker didn't produce a result in time.
            self._send_json(504, {"error": str(e) or "timed out"})
        except EngineClosed as e:
            self._send_json(503, {"error": str(e)})
        except ValueError as e:
            self._send_json(400, {"error": str(e)})
        except Exception as e:  # engine/CUDA failure: a 500, not a dropped
            # connection (socketserver would close the socket replyless and
            # lose any pipelined keep-alive request with it)
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
        else:
            # Provenance header: every prediction names the
            # training step that produced it; pre-lineage checkpoints get
            # the explicit unknown marker, never a missing header.
            step = getattr(self.frontend.engine, "checkpoint_step", None)
            self._send_npy(
                pred,
                extra=[(
                    obs_lineage.MODEL_STEP_HEADER,
                    str(step) if step is not None
                    else obs_lineage.LINEAGE_UNKNOWN,
                )],
            )

    def _reload(self, body: bytes) -> None:
        try:
            req = json.loads(body) if body else {}
        except ValueError as e:
            self._send_json(400, {"error": f"body is not valid JSON: {e}"})
            return
        # frontend.reload catches restore failures into a structured
        # {"error": ...} while the engine keeps serving the old weights —
        # mapped to a non-200 here so callers see the failure, but the
        # serving process never dies over a bad blob.  The outer guard is
        # the last resort for its SUCCESS path (metrics log, alert emit —
        # e.g. ENOSPC mid-write): a JSON 500 beats a dropped socket.
        try:
            meta = self.frontend.reload(req.get("workdir"), step=req.get("step"))
        except Exception as e:
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        if "error" in meta:
            code = 404 if meta.get("error_type") == "FileNotFoundError" else 503
            self._send_json(code, meta)
            return
        resp = {
            "version": self.frontend.engine.version,
            "step": meta.get("step"),
            # What the swap cost and which on-disk format served it
            # (train/checkpoint.py dispatching reader).
            "restore_seconds": meta.get("restore_seconds"),
            "restore_format": meta.get("restore_format"),
        }
        if isinstance(meta.get("lineage"), dict):
            # Nested is fine in HTTP JSON (the flat contract binds JSONL
            # streams only): the fleet's rolling reload reads saved_at
            # from here to measure checkpoint-durable → fleet-serving.
            resp["lineage"] = meta["lineage"]
        if meta.get("quantize"):
            # A quantized engine's reload answer says what is now
            # resident (scales were recomputed from the new checkpoint).
            resp["quantize"] = meta["quantize"]
        if meta.get("quarantined_steps"):
            # Succeeded via fallback: corrupt newer blob(s) were renamed
            # *.bad and an older checkpoint restored.
            resp["quarantined_steps"] = meta["quarantined_steps"]
        self._send_json(200, resp)


def make_server(
    frontend: ServingFrontend, host: str = "127.0.0.1", port: int = 0
) -> ServeHTTPServer:
    """Bind a threading HTTP server over ``frontend`` (port 0 = ephemeral)."""
    server = ServeHTTPServer((host, port), _Handler)
    server.frontend = frontend  # type: ignore[attr-defined]
    return server


def drain_and_close(
    server: ServeHTTPServer,
    frontend: ServingFrontend,
    timeout_s: float = 30.0,
) -> bool:
    """Graceful shutdown after the accept loop has stopped: mark draining
    (``/healthz`` flips to 503 for anything that still scrapes), let in-flight HTTP requests finish writing their
    responses, drain the batcher's queued work, flush the final metrics
    snapshot, release the socket.  Returns False if ``timeout_s`` expired
    with requests still in flight (the process exits anyway — a wedged
    client must not hold shutdown hostage)."""
    frontend.draining = True
    clean = server.wait_idle(timeout=timeout_s)
    # Everything admitted before the accept loop stopped is now either
    # answered or queued in the batcher; close(drain=True) finishes the
    # queue and flushes the final snapshot to serve_metrics.jsonl.
    frontend.close(drain=True)
    server.server_close()
    return clean


def main(argv=None) -> int:
    from ddlpc_tpu_torch import device_arg

    p = argparse.ArgumentParser(prog="python -m ddlpc_tpu_torch.serve.server")
    p.add_argument("--config", help="ServeConfig JSON (configs/serve_*.json)")
    p.add_argument("--workdir", help="training run to serve (overrides config)")
    p.add_argument("--host")
    p.add_argument("--port", type=int)
    p.add_argument(
        "--port-file",
        help="write the bound port here once ready (how a supervisor "
        "learns an ephemeral --port 0 assignment)",
    )
    p.add_argument("--device", type=device_arg, default="cuda",
                   help="cuda, cuda:N or cpu (never a config key)")
    args = p.parse_args(argv)

    cfg = ServeConfig()
    if args.config:
        with open(args.config) as f:
            cfg = ServeConfig.from_json(f.read())
    overrides = {
        k: v
        for k, v in
        (("workdir", args.workdir), ("host", args.host), ("port", args.port))
        if v is not None
    }
    if overrides:
        cfg = cfg.replace(**overrides)

    from ddlpc_tpu_torch.serve.engine import InferenceEngine
    from ddlpc_tpu_torch.train.observability import MetricsLogger

    engine = InferenceEngine.from_workdir(
        cfg.workdir,
        max_bucket=cfg.max_batch,
        quantize=cfg.quantize,
        quantize_activations=cfg.quantize_activations,
        device=args.device,
    )
    engine.warmup()  # run every bucket once before declaring ready
    metrics_dir = cfg.metrics_dir or cfg.workdir
    os.makedirs(metrics_dir, exist_ok=True)
    logger = MetricsLogger(metrics_dir, basename="serve_metrics")
    frontend = ServingFrontend(engine, cfg, logger=logger)
    server = make_server(frontend, cfg.host, cfg.port)
    if args.port_file:
        # Written AFTER warmup + bind: the file's existence means "this
        # port answers", and first contact never pays a first-shape cost.
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(server.server_address[1]))
        os.replace(tmp, args.port_file)

    stopper: list = []

    def _shutdown(signum, frame):
        # Stop accepting; the post-loop drain below finishes in-flight
        # work, flushes metrics, and exits 0 — never a dropped request.
        frontend.draining = True
        if not stopper:
            t = threading.Thread(target=server.shutdown, name="serve-stop")
            stopper.append(t)
            t.start()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)
    print(
        f"serving {cfg.workdir} on http://{cfg.host}:{server.server_address[1]}"
        f" (tile {engine.tile}, max_batch {cfg.max_batch}, "
        f"quantize {cfg.quantize}, device {engine.device})",
        flush=True,
    )
    try:
        server.serve_forever()
    finally:
        drain_and_close(server, frontend, timeout_s=cfg.drain_timeout_s)
        # Every thread this process started is joined before the
        # interpreter exits: the batcher's slots and the metrics emitter
        # (frontend.close), and the accept loop's stopper.  Handler threads
        # left are idle keep-alive readers (daemonic, holding no work).
        for t in stopper:
            t.join()
        if engine.device.type == "cuda":
            import torch

            torch.cuda.synchronize(engine.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
