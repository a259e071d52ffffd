"""Channel-swap images: stylize with one channel group taken from another frame.

Twin of the repository's ``generate_feature_permutation_visualization.py``:
the same flags, plus ``--device``.  For each G-buffer channel group it
replaces that group of the first content sample with the second sample's,
stylizes, and writes ``swap_<group>.png`` beside ``unperturbed.png``.

    python -m realtime_style_transfer_torch.generate_feature_permutation_visualization \\
        -C logs/<run> --network_spec rst-960-120-128-17 --content_dir data/.../validation \\
        -s style.jpg -o out/permutation_viz [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

from . import cli
from .tracing import logsetup

log = logging.getLogger("permutation_viz")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    cli.add_config_args(p)
    p.add_argument("-C", "--checkpoint_path", type=Path, required=True)
    p.add_argument("--content_dir", type=Path, required=True,
                   help="needs at least two content samples")
    p.add_argument("-s", "--style", type=Path, required=True)
    p.add_argument("-o", "--output", type=Path, default=Path("out/permutation_viz"))
    return p.parse_args(argv)


def main(argv=None) -> list:
    """Returns the paths of the written images."""
    args = parse_args(argv)
    logsetup.setup()

    import torch

    from . import resolve_device
    from .compute_permutation_feature_importance import channel_slices
    from .data.hdr_screenshots import find_screenshots, iter_hdr_screenshots
    from .data.imaging import list_image_paths, load_image

    device = resolve_device(args.device)
    config = cli.config_from_args(args, num_styles=1)
    model = cli.build_inference(config, dtype=cli.compute_dtype(args), device=device)
    cli.load_variables(args.checkpoint_path, model)

    if config.hdr and config.total_channels > 3:
        pngs = find_screenshots(args.content_dir)
        frames = list(iter_hdr_screenshots(pngs[:2], config.channels, config.content_shape))
    else:
        paths = list_image_paths(args.content_dir)[:2]
        frames = [load_image(p, config.content_shape) for p in paths]
    if len(frames) < 2:
        raise SystemExit("need at least two content samples in --content_dir")
    base, donor = np.asarray(frames[0]), np.asarray(frames[1])

    style = cli.load_styles([args.style], config)[None]

    def stylize(content: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            out = model.stylize(torch.as_tensor(content[None], device=device), style_params)
        return out[0].float().cpu().numpy()

    with torch.no_grad():
        style_params = model.predict_style_params(torch.as_tensor(style, device=device))
    args.output.mkdir(parents=True, exist_ok=True)
    written = [cli.save_image(stylize(base), args.output / "unperturbed.png")]
    for name, c0, c1 in channel_slices(config):
        swapped = base.copy()
        swapped[..., c0:c1] = donor[..., c0:c1]
        written.append(cli.save_image(stylize(swapped), args.output / f"swap_{name}.png"))
    log.info("grid images in %s", args.output)
    return written


if __name__ == "__main__":
    main()
