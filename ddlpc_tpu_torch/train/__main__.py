"""CLI: ``python -m ddlpc_tpu_torch.train --config cfg.json --set train.epochs=3``.

The same flags as ``python -m ddlpc_tpu.train`` (``--config``, ``--set``,
``--workdir``, ``--no-resume``) and the same JSON configs, plus the knobs
only the port has:

- ``--device cuda|cuda:N|cpu`` (default ``cuda``; without CUDA the run
  raises unless ``--device cpu`` is given).  In a world of several
  processes ``cuda`` is ``cuda:{LOCAL_RANK}`` and raises where the host
  has no such card; ``cuda:N`` puts every rank on card N;
- ``--dist-backend nccl|gloo`` (default ``nccl`` on a card, ``gloo`` on
  the CPU).  Several ranks on one card need ``gloo``: NCCL refuses them.

A data-parallel world is started by torchrun, one process per replica::

    torchrun --nproc-per-node 4 -m ddlpc_tpu_torch.train --config cfg.json \
        --set parallel.data_axis_size=4

The committed configs run as written, with no ``--set``: the host
libraries of the loader and the checkpoint wire build with ``g++`` at
first use, the codec kernels with ``nvcc``.

The same command on the same ``--workdir`` resumes from the newest
checkpoint (``--no-resume`` starts afresh).  Exit status
(``resilience/protocol.py``):

- 0: every epoch ran;
- 42: the stall watchdog aborted a run whose data fetch, step or eval
  batch made no progress for ``train.stall_timeout_s`` seconds under
  ``train.stall_action=abort`` (the diagnosis is in
  ``<workdir>/stall.log``, the breadcrumb says ``stalled``); running the
  command again resumes from the newest checkpoint;
- 43: a SIGTERM preempted the run after an emergency checkpoint, and
  running the command again carries on from it.

Rank 0 writes ``<workdir>/metrics.jsonl`` (one record an epoch, and with
``train.perf_accounting`` one ``kind="perf"`` and one ``kind="comm"``
record each epoch after it), the PNGs of ``train.dump_images_per_epoch``
under ``<workdir>/images/epoch_XXXX/``, and ``<workdir>/checkpoints/``.

Observability: ``--set train.trace=True`` writes ``spans.jsonl`` and
``trace.json``; ``--set train.telemetry_port=0`` serves ``/metrics``,
``/healthz`` and ``/debug/trace?steps=N`` on an ephemeral port, which
rank 0 prints as a ``[telemetry] http://127.0.0.1:<port>`` line;
``kill -USR2 <pid>`` captures the next
``train.profile_steps`` steps into ``profile_<n>/`` and
``top_ops_<n>.json``; ``--set train.profile_epoch=N`` captures epoch N
into ``profile/``.  ``python scripts/check_metrics_schema.py <workdir>``
lints the streams.
"""

from __future__ import annotations

import argparse
import ast
import sys
from typing import Optional

from ddlpc_tpu_torch import device_arg
from ddlpc_tpu_torch.config import ExperimentConfig


def apply_override(d: dict, dotted: str, value: str) -> None:
    keys = dotted.split(".")
    cur = d
    for k in keys[:-1]:
        if k not in cur or not isinstance(cur[k], dict):
            raise KeyError(f"unknown config section {dotted!r}")
        cur = cur[k]
    if keys[-1] not in cur:
        raise KeyError(f"unknown config key {dotted!r}")
    try:
        cur[keys[-1]] = ast.literal_eval(value)
    except (ValueError, SyntaxError):
        cur[keys[-1]] = value  # bare string


def parse_args(argv=None) -> tuple[ExperimentConfig, bool, str, Optional[str]]:
    """(config, resume, device, dist_backend) from the command line."""
    p = argparse.ArgumentParser(prog="python -m ddlpc_tpu_torch.train", description=__doc__)
    p.add_argument("--config", help="JSON config file, e.g. configs/vaihingen_unet_tpu_flagship.json")
    p.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="dotted override, e.g. train.epochs=3",
    )
    p.add_argument("--workdir", help="run directory (metrics.jsonl)")
    p.add_argument("--no-resume", action="store_true", help="ignore existing checkpoints")
    p.add_argument("--device", type=device_arg, default="cuda",
                   help="cuda (cuda:LOCAL_RANK in a world), cuda:N or cpu")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="default: nccl on a card, gloo on the CPU")
    args = p.parse_args(argv)
    if args.config:
        with open(args.config) as f:
            cfg = ExperimentConfig.from_json(f.read())
    else:
        cfg = ExperimentConfig()
    d = cfg.to_dict()
    for item in args.set:
        if "=" not in item:
            p.error(f"--set expects KEY=VALUE, got {item!r}")
        key, value = item.split("=", 1)
        apply_override(d, key, value)
    cfg = ExperimentConfig.from_dict(d)
    if args.workdir:
        cfg = cfg.replace(workdir=args.workdir)
    return cfg, not args.no_resume, args.device, args.dist_backend


def main(argv=None) -> int:
    cfg, resume, device, backend = parse_args(argv)
    from ddlpc_tpu_torch.parallel.mesh import destroy_distributed
    from ddlpc_tpu_torch.resilience.protocol import EXIT_PREEMPTED
    from ddlpc_tpu_torch.train.trainer import Trainer

    trainer = None
    try:
        trainer = Trainer(cfg, resume=resume, device=device, dist_backend=backend)
        record = trainer.fit()
    finally:
        if trainer is not None:
            trainer.close()
        destroy_distributed()
    if trainer.rank == 0:
        print({k: round(v, 4) if isinstance(v, float) else v for k, v in record.items()})
    return EXIT_PREEMPTED if trainer.preempted else 0


if __name__ == "__main__":
    sys.exit(main())
