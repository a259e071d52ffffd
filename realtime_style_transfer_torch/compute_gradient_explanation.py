"""Gradient attribution: mean |d loss / d content| per G-buffer channel group.

Twin of the repository's ``compute_gradient_explanation.py``: the same
flags, plus ``--device``.  The loss of the training model (as
:mod:`.compute_permutation_feature_importance` builds it) is differentiated
with respect to the content by ``torch.autograd.grad``; the mean absolute
gradient per channel, over each batch's pixels and then over the batches,
is averaged per channel group.  The table, sorted by attribution, goes to
stdout and ``gradient_attribution.csv``.

    python -m realtime_style_transfer_torch.compute_gradient_explanation -C logs/<run> \\
        --network_spec rst-960-120-128-17 --content_dir data/.../validation \\
        --style_dir data/wikiart/debug_images/validation [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

from . import cli
from .models.losses import LOSS_EXTRACTORS
from .tracing import logsetup

log = logging.getLogger("gradient_explanation")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    cli.add_config_args(p)
    p.add_argument("-C", "--checkpoint_path", type=Path, required=True)
    p.add_argument("--content_dir", type=Path, required=True)
    p.add_argument("--style_dir", type=Path, required=True)
    p.add_argument("--loss", choices=sorted(LOSS_EXTRACTORS), default="vgg")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--max_batches", type=int, default=8)
    p.add_argument("-o", "--output", type=Path, default=Path("out/grad_explanation"))
    return p.parse_args(argv)


def main(argv=None) -> list:
    """Returns the table's rows."""
    args = parse_args(argv)
    logsetup.setup()

    import torch

    from . import resolve_device
    from .compute_permutation_feature_importance import (
        analysis_batches, channel_slices, load_training_state)
    from .utils import table

    device = resolve_device(args.device)
    config = cli.config_from_args(args, num_styles=1)
    tm, state = load_training_state(args, config, device)

    def content_grads(batch) -> np.ndarray:
        inputs, gt = batch
        content = inputs["content"].detach().requires_grad_(True)
        loss, _ = tm.loss_and_metrics(state.params, state.batch_stats,
                                      ({**inputs, "content": content}, gt), train=False)
        (grad,) = torch.autograd.grad(loss, content)
        return torch.mean(torch.abs(grad), dim=(0, 1, 2)).float().cpu().numpy()  # (C,)

    per_channel = []
    for bi, batch in enumerate(analysis_batches(args, config, device)):
        if bi >= args.max_batches:
            break
        per_channel.append(content_grads(batch))
        log.info("batch %d done", bi)
    if not per_channel:
        raise SystemExit("no batches produced — check --content_dir/--style_dir")
    mean_abs = np.mean(per_channel, axis=0)

    rows = [{"channel": name, "mean_abs_gradient": float(mean_abs[c0:c1].mean())}
            for name, c0, c1 in channel_slices(config)]
    rows = table.sort_rows(rows, "mean_abs_gradient")
    print(table.to_string(rows))
    args.output.mkdir(parents=True, exist_ok=True)
    (args.output / "gradient_attribution.csv").write_text(table.to_csv(rows))
    return rows


if __name__ == "__main__":
    main()
