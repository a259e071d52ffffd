"""Diff engine-computed style params against the port's predictor.

Twin of the repository's ``compare_unreal_style_params.py``: the same flags,
plus ``--device``.  It reads a raw f32 buffer dumped by the Unreal plugin,
warns when its element count is not the config's, recomputes the params
with the predictor and prints a statistics table of both and their
difference.

    python -m realtime_style_transfer_torch.compare_unreal_style_params -C logs/<run> \\
        -s style.jpg -b unreal_style_params.bin [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from . import cli
from .tracing import logsetup

log = logging.getLogger("compare_style_params")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    cli.add_config_args(p)
    p.add_argument("-C", "--checkpoint_path", type=Path, required=True)
    p.add_argument("-s", "--style", type=Path, required=True)
    p.add_argument("-b", "--buffer", type=Path, required=True,
                   help="raw float32 style-param buffer from the engine")
    return p.parse_args(argv)


def main(argv=None) -> str:
    args = parse_args(argv)
    logsetup.setup()

    from . import resolve_device
    from .data.native import get_lib, read_tensor_buffer
    from .models.inference import plan_from_config
    from .predict_style_params import style_params_of
    from .utils.stats import comparison_table

    device = resolve_device(args.device)
    config = cli.config_from_args(args, num_styles=1)
    plan = plan_from_config(config)
    n = get_lib().tensorbuffer_num_elements(str(args.buffer).encode())
    if n != plan.num_style_parameters:
        log.warning(
            "buffer has %d floats but config %s expects %d — check --network_spec",
            n, config.to_spec(), plan.num_style_parameters,
        )
    unreal = read_tensor_buffer(args.buffer, (n,))
    ours = style_params_of(args, config, device)
    table = comparison_table({"unreal": unreal, "python": ours[: unreal.size]})
    print(table)
    return table


if __name__ == "__main__":
    main()
