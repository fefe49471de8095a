"""The hard task's convergence runs, the port's counterpart of the committed
JAX curves in ``docs/flagship_recipe/``.

    python -m ddlpc_tpu_torch.train.hard_task --out docs/port_hard_task

Six runs of the trainer's CLI entry point on
``configs/vaihingen_unet_tpu_flagship.json`` (micro 128 × sync 4, Adam
2e-3, the fp16 codec at 100 levels) with ``data.dataset=synthetic_hard``
and ``data.seed=1`` (the ``HardTiles`` seed of the JAX recipe,
``scripts/convergence_ab.py:run_variant``), ``train.epochs=400`` and an
eval every 5 epochs, the config's own settings otherwise (the device
cache, checkpoints, the stall watchdog, perf accounting) but no image
dumps, which the JAX recipe does not write:

- ``fp16_seed0``, ``fp16_seed1``, ``fp16_seed2``: ``train.seed`` 0, 1, 2;
- ``int8_stochastic_seed0``, ``int8_sr_seed1``, ``int8_sr_seed2``:
  ``compression.mode=int8``, ``compression.rounding=stochastic``,
  ``train.seed`` 0, 1, 2.

The runs named by ``--runs`` (all by default) run at once, one process
each on the one card (``--device cuda:0``; ``--config``, ``--device`` and
``--set`` exist for a smaller trial run).  Once ``fp16_seed2``, where it
runs, has logged epoch ``--preempt-at`` it is sent SIGTERM; it must exit
43 (``resilience/protocol.py``), and the same command then resumes it
from its emergency checkpoint.  Each run's epoch records go to
``<out>/<run>.jsonl`` (the process's metrics stream, with ``kind``
records left out); the files of runs left out of ``--runs`` are kept, and
so are their rows of an existing ``<out>/summary.json``.  The summary
holds the final-epoch row of each run, the preemption, the card, and the
comparison with JAX's curves (:func:`compare`): the fp16 seeds' mean
final val mIoU against ``flagship_b128x4_lr0.002`` within max(0.02, 2 ×
their standard deviation), the stochastic arm against
``flagship_b128x4_lr0.002_int8_stochastic`` by the same rule, per class
(each run's, and the small discs' class on its own), and the loss at
epochs 0, 50, 100, 200 and 399.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional

from ddlpc_tpu_torch.resilience.protocol import EXIT_PREEMPTED
from ddlpc_tpu_torch.utils.fsio import atomic_write_json, atomic_write_text

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FLAGSHIP = os.path.join(REPO, "configs", "vaihingen_unet_tpu_flagship.json")
JAX_CURVES = os.path.join(REPO, "docs", "flagship_recipe")
# What JAX's recipe leaves out (scripts/convergence_ab.py:run_variant
# trains in a loop of its own, which writes no images); the rest is the
# flagship config's own, the device-resident tile cache among it.
RECIPE = ("train.dump_images_per_epoch=0",)
RUNS = {
    "fp16_seed0": ("train.seed=0",),
    "fp16_seed1": ("train.seed=1",),
    "fp16_seed2": ("train.seed=2",),
    **{name: (f"train.seed={seed}", "compression.mode=int8", "compression.rounding=stochastic")
       for name, seed in (("int8_stochastic_seed0", 0), ("int8_sr_seed1", 1),
                          ("int8_sr_seed2", 2))},
}
PREEMPTED = "fp16_seed2"
ARMS = {  # arm: (port runs, the JAX curve it is held against)
    "fp16": (("fp16_seed0", "fp16_seed1", "fp16_seed2"), "flagship_b128x4_lr0.002"),
    "int8_stochastic": (("int8_stochastic_seed0", "int8_sr_seed1", "int8_sr_seed2"),
                        "flagship_b128x4_lr0.002_int8_stochastic"),
}
LOSS_EPOCHS = (0, 50, 100, 200, 399)
SMALL_DISC_CLASS = 4  # HardTiles' small discs, radius 2-6 px (data/datasets.py)


def command(name: str, workdir: str, args: argparse.Namespace) -> List[str]:
    argv = [sys.executable, "-m", "ddlpc_tpu_torch.train", "--config", args.config,
            "--device", args.device, "--workdir", workdir]
    sets = ("data.dataset=synthetic_hard", "data.seed=1", f"train.epochs={args.epochs}",
            f"train.eval_every_epochs={args.eval_every}", *RECIPE, *RUNS[name], *args.set)
    for s in sets:
        argv += ["--set", s]
    return argv


def epoch_records(workdir: str) -> List[dict]:
    path = os.path.join(workdir, "metrics.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [r for r in map(json.loads, f) if "kind" not in r]


def read_curve(path: str) -> Dict[int, dict]:
    with open(path) as f:
        return {r["epoch"]: r for r in map(json.loads, f)}


def _arm_stats(finals: List[dict], jax_final: dict, curves: List[Dict[int, dict]],
               jax_curve: Dict[int, dict]) -> dict:
    mious = [r["val_miou"] for r in finals]
    mean = statistics.fmean(mious)
    std = statistics.stdev(mious) if len(mious) > 1 else None
    limit = max(0.02, 2 * std) if std is not None else 0.02
    per_class = [statistics.fmean(c) for c in zip(*(r["val_iou_per_class"] for r in finals))]
    return {
        "port_final_val_miou": mious,
        "port_mean": mean,
        "port_std": std,
        "jax_final_val_miou": jax_final["val_miou"],
        "gap": mean - jax_final["val_miou"],
        "limit": limit,
        "within": abs(mean - jax_final["val_miou"]) <= limit,
        "port_iou_per_class_mean": per_class,
        "port_iou_per_class": [r["val_iou_per_class"] for r in finals],
        "jax_iou_per_class": jax_final["val_iou_per_class"],
        "small_disc_iou": {
            "class": SMALL_DISC_CLASS,
            "port": [r["val_iou_per_class"][SMALL_DISC_CLASS] for r in finals],
            "port_mean": per_class[SMALL_DISC_CLASS],
            "jax": jax_final["val_iou_per_class"][SMALL_DISC_CLASS],
        },
        "loss_at": {
            str(e): {"port": [c[e]["loss"] if e in c else None for c in curves],
                     "jax": jax_curve[e]["loss"] if e in jax_curve else None}
            for e in LOSS_EPOCHS
        },
    }


def compare(out: str, jax_dir: str = JAX_CURVES) -> dict:
    """The port's curves in ``out`` against JAX's in ``jax_dir``, arm by arm."""
    result = {}
    for arm, (names, tag) in ARMS.items():
        curves = [read_curve(os.path.join(out, f"{n}.jsonl")) for n in names]
        jax_curve = read_curve(os.path.join(jax_dir, f"{tag}.jsonl"))
        finals = [c[max(c)] for c in curves]
        result[arm] = dict(_arm_stats(finals, jax_curve[max(jax_curve)], curves, jax_curve),
                           port_runs=list(names), jax_tag=tag)
    return result


def _smi() -> Optional[str]:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
    except OSError:
        return None
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else None


def run_all(args: argparse.Namespace) -> dict:
    """Start the runs of ``args.runs``, preempt ``PREEMPTED`` (where it is
    one of them) once it logged ``--preempt-at``, resume it, wait for all;
    returns what happened to each."""
    out, root, runs = args.out, args.root, args.runs
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    # The runs share the host's cores: a share each, not all of them each.
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // len(runs))))
    procs, logs, started, report = {}, {}, {}, {}

    def start(name: str) -> None:
        workdir = os.path.join(root, name)
        logs[name] = open(os.path.join(root, f"{name}.log"), "a")
        procs[name] = subprocess.Popen(command(name, workdir, args), cwd=REPO,
                                       env=env, stdout=logs[name], stderr=subprocess.STDOUT)
        started.setdefault(name, time.time())

    for name in runs:
        shutil.rmtree(os.path.join(root, name), ignore_errors=True)
        start(name)
    preempt = {"run": PREEMPTED, "sigterm_after_epoch": None, "exit": None,
               "resumed_at_epoch": None}
    preempting = PREEMPTED in runs
    last_export = time.time()
    try:
        while procs:
            time.sleep(2.0)
            if time.time() - last_export > 60:  # what a cut-off call still returns
                export(out, root, runs)
                last_export = time.time()
            if preempting and preempt["sigterm_after_epoch"] is None:
                recs = epoch_records(os.path.join(root, PREEMPTED))
                if recs and recs[-1]["epoch"] >= args.preempt_at:
                    preempt["sigterm_after_epoch"] = recs[-1]["epoch"]
                    procs[PREEMPTED].send_signal(signal.SIGTERM)
            for name, p in list(procs.items()):
                rc = p.poll()
                if rc is None:
                    continue
                del procs[name]
                logs[name].close()
                if name == PREEMPTED and preempt["exit"] is None and preempt["sigterm_after_epoch"] is not None:
                    preempt["exit"] = rc
                    if rc != EXIT_PREEMPTED:
                        raise RuntimeError(f"{name} exited {rc} after SIGTERM, expected {EXIT_PREEMPTED}")
                    start(name)  # the same command resumes it
                    continue
                report[name] = {"exit": rc, "wall_s": time.time() - started[name]}
                if rc != 0:
                    raise RuntimeError(f"{name} exited {rc}; see {os.path.join(root, name + '.log')}")
    finally:
        for p in procs.values():
            p.kill()
            p.wait()
        for f in logs.values():
            f.close()
    if preempting:
        recs = epoch_records(os.path.join(root, PREEMPTED))
        resumed = [r["epoch"] for r in recs if r["epoch"] > (preempt["sigterm_after_epoch"] or 0)]
        preempt["resumed_at_epoch"] = resumed[0] if resumed else None
        report[PREEMPTED]["preemption"] = preempt
    export(out, root, runs)
    for name in runs:
        ckpt_dir = os.path.join(root, name, "checkpoints")
        report[name]["checkpoint_disk_bytes"] = {
            f: os.path.getsize(os.path.join(ckpt_dir, f))
            for f in sorted(os.listdir(ckpt_dir)) if f.endswith(".dwc")}
    return report


def export(out: str, root: str, runs) -> None:
    """Each of ``runs``' epoch records so far into ``<out>/<run>.jsonl``."""
    for name in runs:
        text = "".join(json.dumps(r) + "\n" for r in epoch_records(os.path.join(root, name)))
        atomic_write_text(os.path.join(out, f"{name}.jsonl"), text, durable=False)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m ddlpc_tpu_torch.train.hard_task",
                                description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True, help="directory for <run>.jsonl and summary.json")
    p.add_argument("--root", default=os.path.join(REPO, "runs", "port_hard_task"),
                   help="the runs' workdirs (checkpoints, logs)")
    p.add_argument("--config", default=FLAGSHIP)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="a further override for every run")
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--eval-every", type=int, default=5)
    p.add_argument("--preempt-at", type=int, default=200)
    p.add_argument("--runs", type=lambda v: v.split(","), default=list(RUNS),
                   help="comma-separated runs to train (default: all of them); the "
                        "others' files in --out are kept")
    args = p.parse_args(argv)
    unknown = sorted(set(args.runs) - set(RUNS))
    if unknown:
        p.error(f"unknown runs {unknown} (known: {', '.join(RUNS)})")
    os.makedirs(args.out, exist_ok=True)
    os.makedirs(args.root, exist_ok=True)
    t0 = time.time()
    report = run_all(args)
    path = os.path.join(args.out, "summary.json")
    earlier = {}
    if os.path.exists(path):
        with open(path) as f:
            earlier = json.load(f)
    card = _smi()
    summary = {"card": card, "epochs": args.epochs, "wall_s": time.time() - t0,
               "runs": {**{n: {"card": earlier.get("card"), **r}
                           for n, r in earlier.get("runs", {}).items()},
                        **{n: dict(report[n], card=card,
                                   final=epoch_records(os.path.join(args.root, n))[-1])
                           for n in args.runs}}}
    if args.epochs == 400 and all(
            os.path.exists(os.path.join(args.out, f"{n}.jsonl")) for n in RUNS):
        summary["comparison"] = compare(args.out)
    atomic_write_json(path, summary)
    print(json.dumps(summary.get("comparison", summary["runs"]), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
