"""On-card smoke test of the PyTorch/CUDA port (``ddlpc_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:

1. the card's name and power limit (``nvidia-smi``), then the kernels'
   build from ``ddlpc_tpu_torch/kernels/csrc`` with its time;
2. each gradient-codec kernel at the flagship U-Net's flat gradient size,
   held against its plain PyTorch version on the same inputs with
   ``torch.equal`` (bit-identical), and timed with CUDA events beside its
   bound, the plain version and, where one exists, a single PyTorch call
   computing the same function;
3. a small-input reference check: the tiny U-Net trains two optimizer
   steps with the fp16 codec on the card and on the CPU from the same
   weights and data, and the losses must agree;
4. the main path: ``configs/vaihingen_unet_tpu_flagship.json`` through the
   CLI's own entry (``parse_args`` → ``Trainer.fit``) at full width and
   512² tiles for three optimizer steps, with the kernels' launch counts
   read from that run alone.  Every loss must be finite.

With ``--profile`` it then runs one more optimizer step of the flagship
under ``torch.profiler`` and prints the device time by kernel, the device's
idle share over that step and the step's FLOPs against the card's bf16
peak (this phase is for measurement, not part of the plain smoke run).

It prints one JSON line with every kernel's numbers, then the card's
``nvidia-smi`` line, then the contract line
``{"ok": true, "device": {...}}`` last.  Without CUDA, or without the rest
of the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(REPO, "configs", "vaihingen_unet_tpu_flagship.json")
WORKDIR = os.path.join(REPO, "runs", "chip_smoke")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores, published
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores, published
EPOCHS = 3  # one optimizer step per epoch on the flagship (97 tiles, super-batch 512)
MICRO_BATCH = 128  # the flagship's own
# Every setting the slice does not implement, switched off for the run.
OFF = (
    "train.checkpoint_every_epochs=0",
    "train.dump_images_per_epoch=0",
    "train.stall_timeout_s=0.0",
    "train.perf_accounting=False",
    "data.device_cache=False",
    "data.native_gather=False",
)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 25) -> float:
    """Median device time of ``fn()`` with the 50 MB L2 flushed before each
    launch (the codec meets its gradients cold after a backward pass)."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def codec_inputs(n: int, levels: float) -> torch.Tensor:
    """Gradient-like values: a normal body, a zero tail, and a block placed
    on half-lattice points of the pinned scale 1.0 (ties for rintf)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(n, generator=g, device="cuda") * 0.05
    x.clamp_(-0.9, 0.9)
    x[0] = 1.0
    x[n - 4096 :] = 0.0
    k = torch.arange(-levels, levels, device="cuda")[: min(4096, n // 4)]
    x[1 : 1 + k.numel()] = (k + 0.5) / levels
    return x


def kernel_phase(n: int) -> list:
    from ddlpc_tpu_torch.config import CompressionConfig
    from ddlpc_tpu_torch.ops import cuda_quantize as cq
    from ddlpc_tpu_torch.ops import quantize as plain

    cfg = CompressionConfig(mode="float16")  # the flagship's codec
    levels = float(plain.levels_for(cfg))
    x = codec_inputs(n, levels)
    scale = x.abs().amax().reshape(1)
    safe = plain.safe_divisor(scale)
    inv = plain.true_div(scale, levels)
    ties = int(((x / safe * levels) % 1 == 0.5).sum())
    log(f"codec inputs: n={n} zero tail 4096, exact half-lattice ties {ties}")

    # Bit-identity on every wire the encode/decode kernels are built for.
    for mode, wire in (("float16", torch.float16), ("int8", torch.int8), ("int8", torch.int16)):
        c = CompressionConfig(mode=mode)
        lv = float(plain.levels_for(c))
        q_k = cq.encode_to_wire(x, safe, c, wire)
        q_p = plain.encode_with_scale(x, safe, lv, wire)
        d_k = cq.decode_from_wire(q_k, inv)
        d_p = plain.decode_with_inv(q_p, inv)
        f_k = cq.fake_quantize_fused(x, c)
        f_p = cq.fake_quantize_plain(x, c)
        torch.cuda.synchronize()
        for what, a, b in (("encode", q_k, q_p), ("decode", d_k, d_p), ("fake_quantize", f_k, f_p)):
            if not torch.equal(a, b):
                bad = int((a != b).sum())
                fail(f"{what} kernel ({mode}, {wire}) differs from its plain version at {bad} elements")
        log(f"kernels == plain versions, bit for bit: {mode} codec, {wire} wire")

    wire = torch.float16
    q = cq.encode_to_wire(x, safe, cfg, wire)
    out = torch.empty_like(x)
    fq_out = torch.empty_like(x)
    results = []
    specs = [
        dict(
            name="encode_to_wire",
            replaces="ddlpc_tpu/ops/pallas_quantize.py:142",
            kernel=lambda: cq.encode_to_wire(x, safe, cfg, wire),
            plain=lambda: plain.encode_with_scale(x, safe, levels, wire),
            library=None,
            bytes=4 * n + 2 * n + 4,
            ops=5 * n,
            err=lambda: (cq.encode_to_wire(x, safe, cfg, wire).float()
                         - plain.encode_with_scale(x, safe, levels, wire).float()).abs().max(),
        ),
        dict(
            name="decode_from_wire",
            replaces="ddlpc_tpu/ops/pallas_quantize.py:170",
            kernel=lambda: cq.decode_from_wire(q, inv, out=out),
            plain=lambda: plain.decode_with_inv(q, inv),
            library=lambda: torch.mul(q, inv),
            bytes=2 * n + 4 * n + 4,
            ops=n,
            err=lambda: (cq.decode_from_wire(q, inv) - plain.decode_with_inv(q, inv)).abs().max(),
        ),
        dict(
            name="fake_quantize_fused",
            replaces="ddlpc_tpu/ops/pallas_quantize.py:50",
            kernel=lambda: cq.fake_quantize_fused(x, cfg, out=fq_out),
            plain=lambda: cq.fake_quantize_plain(x, cfg),
            library=lambda: torch.fake_quantize_per_tensor_affine(
                x, plain.true_div(x.abs().amax().reshape(1), levels),
                torch.zeros(1, dtype=torch.int32, device="cuda"),
                -int(levels), int(levels),
            ),
            bytes=4 * n + 4 * n + 4,
            ops=6 * n,
            err=lambda: (cq.fake_quantize_fused(x, cfg) - cq.fake_quantize_plain(x, cfg)).abs().max(),
        ),
    ]
    for s in specs:
        bound_bytes_ms = s["bytes"] / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = s["ops"] / FP32_OPS_PER_S * 1e3
        row = {
            "name": s["name"],
            "route": "cuda",
            "source": "ddlpc_tpu_torch/kernels/csrc/quantize.cu",
            "replaces": s["replaces"],
            "launches": 0,
            "max_abs_err": float(s["err"]()),
            "ms": time_ms(s["kernel"]),
            "plain_ms": time_ms(s["plain"]),
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
            "library_ms": None if s["library"] is None else time_ms(s["library"]),
        }
        log(
            f"{row['name']}: {row['ms']:.4f} ms (bound {row['bound_ms']:.4f} ms by "
            f"{row['bound_by']}, plain {row['plain_ms']:.4f} ms, library "
            f"{row['library_ms']} ms), max_abs_err {row['max_abs_err']}"
        )
        results.append(row)
    # fake_quantize_fused's time includes the max-abs reduction it runs
    # before its kernel (as the Pallas path runs one outside its kernel).
    log(f"fake_quantize_fused: its max-abs reduction alone "
        f"{time_ms(lambda: x.abs().amax()):.4f} ms")
    return results


def reference_phase() -> None:
    """Tiny U-Net, fp16 codec, two steps on the card and on the CPU from the
    same weights and data; losses must agree (fp32 compute, TF32 off, so
    only summation order differs between the two devices)."""
    from ddlpc_tpu_torch.config import ExperimentConfig
    from ddlpc_tpu_torch.data.datasets import SyntheticTiles
    from ddlpc_tpu_torch.models import build_model
    from ddlpc_tpu_torch.parallel.train_step import create_train_state, make_train_step
    from ddlpc_tpu_torch.train.optim import Adam

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ExperimentConfig.from_dict({
        "model": {"features": [8, 16], "bottleneck_features": 16, "stem": "s2d",
                  "stem_factor": 2, "detail_head": True, "compute_dtype": "float32",
                  "head_dtype": "float32"},
        "compression": {"mode": "float16"},
    })
    ds = SyntheticTiles(num_tiles=8, image_size=(32, 32), seed=0)
    images = torch.from_numpy(ds.images.reshape(2, 4, 32, 32, 3))
    labels = torch.from_numpy(ds.labels.reshape(2, 4, 32, 32).astype("int64"))
    losses = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg.model, seed=0).to(dev)
        tx = Adam(2e-3)
        state = create_train_state(model, tx)
        step = make_train_step(tx, cfg.compression)
        losses[dev] = [
            float(step(state, images.to(dev), labels.to(dev))["loss"]) for _ in range(2)
        ]
    for a, b in zip(losses["cpu"], losses["cuda"]):
        if not (math.isfinite(b) and abs(a - b) <= 1e-4 * abs(a)):
            fail(f"tiny U-Net losses on the card {losses['cuda']} != CPU {losses['cpu']}")
    log(f"tiny U-Net 2 steps, card vs CPU losses: {losses['cuda']} vs {losses['cpu']}")


def main_path_phase() -> dict:
    from ddlpc_tpu_torch.ops import cuda_quantize as cq
    from ddlpc_tpu_torch.train.__main__ import parse_args
    from ddlpc_tpu_torch.train.trainer import Trainer

    argv = ["--config", FLAGSHIP, "--device", "cuda", "--no-resume",
            "--workdir", WORKDIR, "--set", f"train.epochs={EPOCHS}",
            "--set", f"train.micro_batch_size={MICRO_BATCH}"]
    for o in OFF:
        argv += ["--set", o]
    log("main path: python -m ddlpc_tpu_torch.train " + " ".join(argv))
    metrics_path = os.path.join(WORKDIR, "metrics.jsonl")
    if os.path.exists(metrics_path):
        os.remove(metrics_path)
    cfg, resume, device = parse_args(argv)
    trainer = Trainer(cfg, resume=resume, device=device)
    n_params = trainer.state.params.numel
    log(f"flagship U-Net: {n_params} parameters in one flat buffer, "
        f"{len(trainer.state.params.names)} leaves")
    torch.cuda.reset_peak_memory_stats()
    cq.reset_launch_counts()
    trainer.fit()
    torch.cuda.synchronize()
    launches = dict(cq.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    with open(metrics_path) as f:
        records = [json.loads(line) for line in f]
    for r in records:
        log(f"step {r['epoch'] + 1}: loss {r['loss']} step_time_s {r['step_time_s']} "
            f"grad_norm {r['grad_norm']} val_miou {r.get('val_miou')}")
        if not math.isfinite(r["loss"]) or not math.isfinite(r["grad_norm"]):
            fail(f"non-finite training metrics {r}")
    if len(records) != EPOCHS:
        fail(f"expected {EPOCHS} epoch records, got {len(records)}")
    log(f"max_memory_allocated {peak} bytes ({peak / 2**30:.2f} GiB)")
    log("kernels " + json.dumps(launches))
    for name, count in launches.items():
        if count < EPOCHS:
            fail(f"kernel {name} launched {count} times in {EPOCHS} steps")
    return {"launches": launches, "n_params": n_params, "trainer": trainer}


def profile_phase(trainer) -> None:
    """One more flagship optimizer step under ``torch.profiler``: device
    time by kernel, the device's idle share over the step (1 − summed
    kernel time / wall time; one stream, so kernels do not overlap), and
    the step's FLOPs — counted with ``FlopCounterMode`` on one tile's
    forward and backward, times the super-batch — against the bf16 peak."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from ddlpc_tpu_torch.parallel.train_step import loss_from_logits

    images, labels = next(iter(trainer.loader))
    model = trainer.state.model
    model.train()
    with FlopCounterMode(display=False) as counter:
        loss, _ = loss_from_logits(model(images[0, :1]), labels[0, :1])
        loss.backward()
    step_flops = counter.get_total_flops() * trainer.loader.super_batch
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(trainer.state, images, labels)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        fail("the profiler recorded no device kernels")
    busy_s = sum(e.time_range.elapsed_us() for e in kernels) * 1e-6
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-3
    log(f"profiled step: wall {wall_s * 1e3:.3f} ms, device busy {busy_s * 1e3:.3f} ms, "
        f"idle share {1.0 - busy_s / wall_s:.4f}, {len(kernels)} kernel launches")
    log(f"profiled step: {step_flops:.6e} FLOP (one tile x {trainer.loader.super_batch}), "
        f"{step_flops / wall_s / 1e12:.2f} TFLOP/s = "
        f"{step_flops / wall_s / BF16_FLOPS_PER_S:.4f} of the bf16 peak")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:20]:
        log(f"  {ms:10.3f} ms  {ms / (busy_s * 1e3):.4f}  {name[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    sys.path.insert(0, REPO)
    try:
        import ddlpc_tpu_torch  # noqa: F401
        from ddlpc_tpu_torch.kernels import build as kbuild
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    smi = smi_line()
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    path = kbuild.build(verbose=True)
    kbuild.load_library()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s: {path}")

    from ddlpc_tpu_torch.config import ExperimentConfig
    from ddlpc_tpu_torch.models import build_model

    with open(FLAGSHIP) as f:
        flagship = ExperimentConfig.from_json(f.read())
    n = sum(p.numel() for p in build_model(flagship.model).parameters())
    rows = kernel_phase(n)
    reference_phase()
    main = main_path_phase()
    if main["n_params"] != n:
        fail(f"main path flat gradient {main['n_params']} != kernel phase size {n}")
    for row in rows:
        row["launches"] = main["launches"][row["name"]]
    if "--profile" in sys.argv[1:]:
        profile_phase(main["trainer"])
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
