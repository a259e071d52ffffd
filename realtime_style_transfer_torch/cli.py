"""Shared CLI plumbing: config flags, model construction, weight loading, image IO.

Port of ``realtime_style_transfer_tpu/cli.py``.  A checkpoint is one ``.npz``
file keyed by ``/``-joined flax paths (``params/transfer/contract_0_conv/
kernel``, ...), the flat form that :mod:`.weights` reads; an Orbax run
directory of the JAX package is converted to one where JAX runs (README,
"Converting a JAX checkpoint").  Entry points run on ``--device`` (default
CUDA; raises when CUDA is missing).
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch

from .weights import from_flax

log = logging.getLogger(__name__)


def add_config_args(parser: argparse.ArgumentParser, *, default_styles: int = 1):
    parser.add_argument(
        "--network_spec", type=str, default=None,
        help="rst-<res_x>-<bottleneck_y>-<filters>-<channels>, e.g. rst-960-120-128-17",
    )
    parser.add_argument("--num_styles", type=int, default=default_styles)
    parser.add_argument("--sdr", action="store_true", help="RGB-only content input")
    parser.add_argument(
        "--dtype", choices=["float32", "bfloat16"], default="bfloat16",
        help="compute dtype for the network",
    )
    parser.add_argument(
        "--device", type=str, default=None,
        help="torch device to run on (default: CUDA, and an error without it; "
             "'cpu' runs the kernels' plain versions)",
    )


def config_from_args(args, *, num_styles: Optional[int] = None):
    from .config import ShapeConfig

    n = num_styles if num_styles is not None else getattr(args, "num_styles", 1)
    hdr = not getattr(args, "sdr", False)
    if args.network_spec:
        return ShapeConfig.from_spec(args.network_spec, num_styles=n, hdr=hdr)
    return ShapeConfig(num_styles=n, hdr=hdr)


def compute_dtype(args) -> torch.dtype:
    return torch.bfloat16 if getattr(args, "dtype", "bfloat16") == "bfloat16" else torch.float32


def build_inference(config, *, dtype: Optional[torch.dtype] = None, rng_seed: int = 0,
                    device=None):
    """The inference model with weights drawn from a ``torch.Generator``
    seeded with ``rng_seed``, in eval mode on ``device`` (default CUDA)."""
    from .models.inference import make_inference_model

    return make_inference_model(config, dtype=dtype or torch.float32, device=device,
                                seed=rng_seed)


def save_variables(path, variables: Mapping) -> Path:
    """Write a flax tree as a checkpoint file (``.npz``, ``/``-joined keys)."""
    from .tracing.checkpoint import write_tree

    return write_tree(path, variables)


def load_variables(checkpoint_path, model: torch.nn.Module) -> dict:
    """Load a checkpoint into ``model`` (every leaf must match: a missing or
    extra leaf raises) and return its flax tree of numpy arrays, which the
    fused and packed engines and the int8 scales fingerprint take.  The
    checkpoint is an ``.npz`` file, or a training run directory of the port
    (its ``weights/latest_epoch_weights.npz``); any other directory, such as
    the JAX package's Orbax run, is refused."""
    from .tracing.checkpoint import load_weights, weights_file

    variables = load_weights(checkpoint_path)
    model.load_state_dict(from_flax(variables, expected=model), strict=True)
    log.info("loaded %s", weights_file(checkpoint_path))
    return variables


def load_content(path: Path, config) -> np.ndarray:
    """Load content input: HDR G-buffer set (PNG+EXRs) or plain RGB image."""
    from .data.hdr_screenshots import load_unreal_hdr_screenshot
    from .data.imaging import load_image, preprocess_numpy_image

    path = Path(path)
    if config.hdr and config.total_channels > 3:
        stacked = load_unreal_hdr_screenshot(path, config.channels)
        return preprocess_numpy_image(stacked, config.content_shape)
    return load_image(path, config.content_shape)


def load_styles(style_paths, config) -> np.ndarray:
    from .data.imaging import load_image

    styles = [load_image(p, config.output_shape) for p in style_paths]
    return np.stack(styles, axis=0)  # (num_styles, H, W, 3)


def save_image(tensor01, out_path: Path) -> Path:
    from .data.imaging import tensor_to_image

    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    tensor_to_image(np.asarray(tensor01)).save(out_path)
    log.info("wrote %s", out_path)
    return out_path


def default_log_dir(base: str = "logs") -> Path:
    import datetime

    stamp = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
    return Path(base) / stamp
