"""Show a raw tensor buffer dumped by the Unreal plugin as an image.

Twin of the repository's ``show_unreal_tensor_buffer.py``, with the same
flags.  It does no device work, so unlike the port's other CLIs it has no
``--device`` and runs where there is no GPU.  The raw f32 stream is read as an ``(H, W, C)`` image, its statistics printed, and it is
written as a PNG (``-o``) or shown in a matplotlib window.

    python -m realtime_style_transfer_torch.show_unreal_tensor_buffer buffer.bin \\
        --shape 960 1920 3 -o out/buf.png
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

from . import cli
from .tracing import logsetup

log = logging.getLogger("show_tensor_buffer")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("buffer", type=Path)
    p.add_argument("--shape", type=int, nargs=3, default=(960, 1920, 3),
                   metavar=("H", "W", "C"))
    p.add_argument("-o", "--output", type=Path, default=None,
                   help="write a PNG instead of showing a window")
    return p.parse_args(argv)


def main(argv=None) -> np.ndarray:
    args = parse_args(argv)
    logsetup.setup()

    from .data.native import read_tensor_buffer
    from .utils.stats import comparison_table

    tensor = read_tensor_buffer(args.buffer, tuple(args.shape))
    print(comparison_table({"buffer": tensor}))
    if args.output is not None:
        cli.save_image(np.clip(tensor, 0.0, 1.0), args.output)
    else:
        import matplotlib.pyplot as plt

        plt.imshow(np.clip(tensor, 0.0, 1.0))
        plt.title(str(args.buffer))
        plt.show()
    return tensor


if __name__ == "__main__":
    main()
