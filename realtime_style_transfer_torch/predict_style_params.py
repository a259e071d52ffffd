"""Predict the style params of a style image and write them as a raw f32
buffer, the engine's style-param buffer.

Twin of the repository's ``predict_style_params.py``: the same flags, plus
``--device``.  The ``(P,)`` vector (2662 floats at rst-960-120-128-17, in
the slice order the Unreal plugin reads) goes through
:func:`.data.native.write_tensor_buffer`; its statistics are printed.

    python -m realtime_style_transfer_torch.predict_style_params -C logs/<run> \\
        -s style.jpg -o style_params.bin [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

from . import cli
from .tracing import logsetup

log = logging.getLogger("predict_style_params")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    cli.add_config_args(p)
    p.add_argument("-C", "--checkpoint_path", type=Path, required=True)
    p.add_argument("-s", "--style", type=Path, required=True)
    p.add_argument("-o", "--output", type=Path, default=Path("out/style_params.bin"))
    return p.parse_args(argv)


def style_params_of(args, config, device) -> np.ndarray:
    """The ``(P,)`` style vector of ``args.style`` from ``args``'s checkpoint."""
    import torch

    model = cli.build_inference(config, dtype=cli.compute_dtype(args), device=device)
    cli.load_variables(args.checkpoint_path, model)
    style = cli.load_styles([args.style], config)[None]
    with torch.no_grad():
        params = model.predict_style_params(torch.as_tensor(style, device=device))
    return params[0, 0].float().cpu().numpy()


def main(argv=None) -> np.ndarray:
    args = parse_args(argv)
    logsetup.setup()

    from . import resolve_device
    from .data.native import write_tensor_buffer
    from .utils.stats import comparison_table

    config = cli.config_from_args(args, num_styles=1)
    params = style_params_of(args, config, resolve_device(args.device))
    write_tensor_buffer(args.output, params)
    log.info("wrote %d style params to %s", params.size, args.output)
    print(comparison_table({"style_params": params}))
    return params


if __name__ == "__main__":
    main()
