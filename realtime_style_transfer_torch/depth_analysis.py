"""Visual check of the depth network against the SceneDepth G-buffer channel.

Twin of the repository's ``depth_analysis.py``: the same flags, plus
``--device``.  It runs MidasLite on the screenshot's RGB at 384x384, reads
the sibling ``_SceneDepth.exr``, writes ``rgb.png``, ``predicted_depth.png``
and ``scene_depth.png``, and prints the statistics of the normalised
prediction beside the scene depth resized to it (bilinear with
``jax.image.resize``'s antialiasing when it shrinks,
:func:`.models.depth.resize_bilinear`).  ``--depth_weights`` is ``bundled``
(the repository's synthetic-pretrained weights) or an ``.npz``; an Orbax
directory is refused; without it a seeded random MidasLite runs (a
structure check).

    python -m realtime_style_transfer_torch.depth_analysis --screenshot shot.png \\
        [--depth_weights bundled] -o out/depth_analysis [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

from . import cli
from .tracing import logsetup

log = logging.getLogger("depth_analysis")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--screenshot", type=Path, required=True,
                   help="PNG with a sibling _SceneDepth.exr")
    p.add_argument("--depth_weights", type=Path, default=None,
                   help="optional MidasLite checkpoint (.npz; 'bundled' = the "
                        "committed synthetic-pretrained one)")
    p.add_argument("-o", "--output", type=Path, default=Path("out/depth_analysis"))
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: CUDA, and an error without it)")
    return p.parse_args(argv)


def normalize01(x: np.ndarray) -> np.ndarray:
    lo, hi = np.percentile(x, 2), np.percentile(x, 98)
    return np.clip((x - lo) / max(hi - lo, 1e-8), 0.0, 1.0)


def main(argv=None) -> str:
    """Returns the printed table."""
    args = parse_args(argv)
    logsetup.setup()

    import torch

    from . import resolve_device
    from .data.imaging import load_image
    from .data.native import read_exr
    from .depth_pretrain import load_depth_checkpoint
    from .models.depth import (
        BUNDLED_DEPTH_CHECKPOINT, DEPTH_RESOLUTION, MidasLite, make_midas, resize_bilinear)
    from .utils.stats import comparison_table

    device = resolve_device(args.device)
    rgb = load_image(args.screenshot, (DEPTH_RESOLUTION, DEPTH_RESOLUTION, 3))
    if args.depth_weights is not None:
        ckpt = args.depth_weights
        if str(ckpt) == "bundled":
            ckpt = BUNDLED_DEPTH_CHECKPOINT
        model = make_midas(load_depth_checkpoint(ckpt))
    else:
        log.warning("no --depth_weights given: using random-init MidasLite "
                    "(structure check only)")
        model = MidasLite()
    model = model.to(device).eval()
    with torch.no_grad():
        predicted = model(torch.as_tensor(rgb[None], device=device))[0].cpu().numpy()

    depth_path = args.screenshot.parent / f"{args.screenshot.stem}_SceneDepth.exr"
    scene_depth = read_exr(depth_path)["R"]

    args.output.mkdir(parents=True, exist_ok=True)
    cli.save_image(rgb, args.output / "rgb.png")
    cli.save_image(normalize01(predicted)[..., None], args.output / "predicted_depth.png")
    cli.save_image(normalize01(scene_depth)[..., None], args.output / "scene_depth.png")

    resized = resize_bilinear(torch.as_tensor(scene_depth)[None, ..., None],
                              predicted.shape)[0, ..., 0].numpy()
    table = comparison_table({
        "predicted": normalize01(predicted),
        "scene_depth_norm": normalize01(resized),
    })
    print(table)
    log.info("images in %s", args.output)
    return table


if __name__ == "__main__":
    main()
