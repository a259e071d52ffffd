"""Stylize a single image from a training checkpoint.

Twin of the repository's ``predict_using_checkpoint.py``: the same flags,
plus ``--device``.  One style, or several blended by a per-pixel weight map
(``-w``; without one the weights are zeros, as in the JAX CLI).  The eager
net runs in eval mode in the ``--dtype`` compute dtype; ``-p`` also writes
the preprocessed content's RGB beside the output.

    python -m realtime_style_transfer_torch.predict_using_checkpoint -C logs/<run> \\
        -c content.png -s style_a.jpg [-s style_b.jpg -w weightmap.png] -o out.png \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

from . import cli
from .tracing import logsetup

log = logging.getLogger("predict")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    cli.add_config_args(p)
    p.add_argument("-C", "--checkpoint_path", type=Path, required=True,
                   help="checkpoint file (.npz) or the port's training run directory")
    p.add_argument("-s", "--style", type=Path, action="append", required=True,
                   help="style image (repeat for dual-style blending)")
    p.add_argument("-w", "--style_weights", type=Path, default=None,
                   help="grayscale weight-map image for style 2")
    p.add_argument("-c", "--content", type=Path, required=True,
                   help="content image (PNG; with sibling _<Channel>.exr for HDR)")
    p.add_argument("-o", "--output", type=Path, default=Path("out/prediction.png"))
    p.add_argument("-p", "--save_content_preview", action="store_true",
                   help="also save the preprocessed content RGB")
    return p.parse_args(argv)


def main(argv=None) -> Path:
    args = parse_args(argv)
    logsetup.setup()

    import torch

    from . import resolve_device
    from .data.imaging import load_image

    device = resolve_device(args.device)
    config = cli.config_from_args(args, num_styles=len(args.style))
    model = cli.build_inference(config, dtype=cli.compute_dtype(args), device=device)
    cli.load_variables(args.checkpoint_path, model)

    content = cli.load_content(args.content, config)[None]
    styles = cli.load_styles(args.style, config)[None]  # (1, S, H, W, 3)

    weights = None
    if config.num_styles > 1:
        if args.style_weights is not None:
            wm = load_image(args.style_weights,
                            config.output_dimensions + (config.num_styles - 1,))
        else:
            wm = np.zeros(config.style_weights_shape, np.float32)
        weights = torch.as_tensor(wm[None], device=device)

    with torch.no_grad():
        prediction = model(torch.as_tensor(content, device=device),
                           torch.as_tensor(styles, device=device), weights, train=False)
    out = cli.save_image(prediction[0].float().cpu().numpy(), args.output)
    if args.save_content_preview:
        cli.save_image(content[0][..., :3],
                       args.output.with_name(args.output.stem + "_content.png"))
    return out


if __name__ == "__main__":
    main()
