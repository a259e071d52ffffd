"""Stylize an image from exported artifacts, without building a model.

Twin of the repository's ``predict_using_saved_models.py``: the same flags,
plus ``--device``.  It loads ``inference.pt2`` (written by
:mod:`.save_using_checkpoint`) with ``torch.export.load``, reads the shapes
from ``config.json``, loads the content and the styles, runs the program and
writes the PNG.  No module of :mod:`.models` is imported.

A program runs on the device it was exported on: a ``--device`` of another
type is refused (export again on that device).

    python -m realtime_style_transfer_torch.predict_using_saved_models \\
        -m out/export -c content.png -s style.jpg -o out/styled.png [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

from . import cli
from .tracing import logsetup

log = logging.getLogger("predict_saved")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-m", "--model_dir", type=Path, required=True,
                   help="export dir from save_using_checkpoint")
    p.add_argument("-c", "--content", type=Path, required=True)
    p.add_argument("-s", "--style", type=Path, action="append", required=True)
    p.add_argument("-o", "--output", type=Path, default=Path("out/styled.png"))
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: CUDA, and an error without it); must "
                        "be the device the artifacts were exported on")
    return p.parse_args(argv)


def load_exported(model_dir: Path, name: str, device):
    """``<name>.pt2`` as an ``ExportedProgram``; raises ``ValueError`` when
    its weights lie on another type of device than ``device``."""
    import torch

    program = torch.export.load(Path(model_dir) / f"{name}.pt2")
    on = {t.device.type for t in (*program.state_dict.values(), *program.constants.values())
          if isinstance(t, torch.Tensor)}
    if on != {torch.device(device).type}:
        raise ValueError(f"{name}.pt2 was exported on {sorted(on)}, not {device}: run it "
                         "there or export it again with --device "
                         f"{torch.device(device).type}")
    return program


def main(argv=None) -> Path:
    args = parse_args(argv)
    logsetup.setup()

    import torch

    from . import resolve_device
    from .config import ShapeConfig

    device = resolve_device(args.device)
    saved_config = json.loads((args.model_dir / "config.json").read_text())
    config = ShapeConfig(**{k: v for k, v in saved_config.items() if k != "derived"})

    inference = load_exported(args.model_dir, "inference", device).module()
    content = cli.load_content(args.content, config)[None]
    styles = cli.load_styles(args.style, config)[None]

    with torch.no_grad():
        out = inference(torch.as_tensor(content, device=device),
                        torch.as_tensor(styles, device=device))
    return cli.save_image(out[0].float().cpu().numpy(), args.output)


if __name__ == "__main__":
    main()
