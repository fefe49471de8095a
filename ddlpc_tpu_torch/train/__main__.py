"""CLI: ``python -m ddlpc_tpu_torch.train --config cfg.json --set train.epochs=3``.

The same flags as ``python -m ddlpc_tpu.train`` (``--config``, ``--set``,
``--workdir``, ``--no-resume``) and the same JSON configs, plus the one
knob only the port has: ``--device cuda|cpu`` (default ``cuda``; without
CUDA the run raises unless ``--device cpu`` is given).
"""

from __future__ import annotations

import argparse
import ast
import sys

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


def parse_args(argv=None) -> tuple[ExperimentConfig, bool, str]:
    """(config, resume, device) from the command line."""
    p = argparse.ArgumentParser(prog="python -m ddlpc_tpu_torch.train", description=__doc__)
    p.add_argument("--config", help="JSON config file, e.g. configs/vaihingen_unet_tpu_flagship.json")
    p.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="dotted override, e.g. train.epochs=3",
    )
    p.add_argument("--workdir", help="run directory (metrics.jsonl)")
    p.add_argument("--no-resume", action="store_true", help="ignore existing checkpoints")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
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
    return cfg, not args.no_resume, args.device


def main(argv=None) -> int:
    cfg, resume, device = parse_args(argv)
    from ddlpc_tpu_torch.train.trainer import Trainer

    record = Trainer(cfg, resume=resume, device=device).fit()
    print({k: round(v, 4) if isinstance(v, float) else v for k, v in record.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
