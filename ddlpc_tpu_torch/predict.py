"""Inference CLI: ``python -m ddlpc_tpu_torch.predict --workdir runs/x
--input dir`` — the port of ``ddlpc_tpu/predict.py``.

Restores a trained checkpoint and predicts each input image at its
NATIVE size via overlap-blended sliding windows, writing a color-mapped
class-map PNG per input (``<stem>_pred.png``).  A thin client of
:mod:`ddlpc_tpu_torch.serve.engine`: the tiler and the restore live
there, shared with the server.  Images are read by the port's readers
(``data/datasets.load_image_file``) and the PNGs written by its stdlib
encoder (``data/png.py``), so no image library is needed.  Runs on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ddlpc_tpu_torch.serve.engine import (  # noqa: F401  (public re-exports)
    InferenceEngine,
    _blend_window,
    sliding_window_logits,
)


def load_run(workdir: str, device="cuda"):
    """(cfg, state, logits_fn, channels) restored from a training run:
    ``logits_fn(state, windows)`` gives fp32 numpy logits."""
    eng = InferenceEngine.from_workdir(workdir, device=device)
    return eng.cfg, eng.state, eng._run, eng.channels


def main(argv=None) -> int:
    from ddlpc_tpu_torch import device_arg

    p = argparse.ArgumentParser(prog="python -m ddlpc_tpu_torch.predict")
    p.add_argument("--workdir", required=True, help="training run directory")
    p.add_argument("--input", required=True, help="directory of images")
    p.add_argument("--output", help="output directory (default <workdir>/predictions)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument(
        "--overlap",
        type=float,
        default=0.25,
        help="sliding-window overlap fraction (0 = edge-to-edge tiling)",
    )
    p.add_argument("--device", type=device_arg, default="cuda",
                   help="cuda, cuda:N or cpu")
    args = p.parse_args(argv)

    from ddlpc_tpu_torch.data.datasets import load_image_file
    from ddlpc_tpu_torch.data.png import write_png
    from ddlpc_tpu_torch.train.observability import class_palette

    engine = InferenceEngine.from_workdir(
        args.workdir, max_bucket=args.batch, device=args.device
    )
    cfg = engine.cfg

    out_dir = args.output or os.path.join(args.workdir, "predictions")
    os.makedirs(out_dir, exist_ok=True)
    pal = class_palette(cfg.model.num_classes)

    names = sorted(
        n
        for n in os.listdir(args.input)
        if not n.endswith(".npy") and os.path.isfile(os.path.join(args.input, n))
    )
    if not names:
        print(f"no images found in {args.input}", file=sys.stderr)
        return 1
    for n in names:
        # Native size (image_size=None): the sliding window handles any
        # geometry; preprocessing stays shared with the training readers.
        image = load_image_file(
            os.path.join(args.input, n), None, channels=engine.channels
        )
        pred = engine.predict_classes(
            image, overlap=args.overlap, batch=args.batch
        )
        stem = n.rsplit(".", 1)[0]
        write_png(
            os.path.join(out_dir, f"{stem}_pred.png"),
            pal[np.clip(pred, 0, cfg.model.num_classes - 1)],
        )
    print(f"wrote {len(names)} predictions to {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
