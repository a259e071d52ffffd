"""Permutation feature importance per G-buffer channel group.

Twin of the repository's ``compute_permutation_feature_importance.py``: the
same flags, plus ``--device``.  For each batch it evaluates the loss of the
training model (``with_depth_loss=False``, the ``--loss`` tower, the eager
net in torch ops as the JAX CLI's default ``use_pallas=False``) once
unperturbed and once with each channel group rolled by one along the batch
axis, and reports each group's mean loss increase over the batches.  Every
value is cached in ``<output>/progress.pkl`` under the JAX CLI's keys,
``(batch_index, name) -> float`` (``"__baseline__"`` for the unperturbed
loss), so a second run resumes from it.  The table, sorted by importance,
goes to stdout, ``importance.csv`` and ``importance.tex``
(:mod:`.utils.table`).

    python -m realtime_style_transfer_torch.compute_permutation_feature_importance \\
        -C logs/<run> --network_spec rst-960-120-128-17 \\
        --content_dir data/.../validation --style_dir data/wikiart/debug_images/validation \\
        -o out/importance [--device cpu]

:func:`channel_slices`, :func:`load_training_state` and
:func:`analysis_batches` are shared with :mod:`.compute_gradient_explanation`
and :mod:`.generate_feature_permutation_visualization`.
"""

from __future__ import annotations

import argparse
import logging
import pickle
from pathlib import Path

import numpy as np

from . import cli
from .models.losses import LOSS_EXTRACTORS
from .tracing import logsetup

log = logging.getLogger("feature_importance")

BASELINE = "__baseline__"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    cli.add_config_args(p)
    p.add_argument("-C", "--checkpoint_path", type=Path, required=True)
    p.add_argument("--content_dir", type=Path, required=True)
    p.add_argument("--style_dir", type=Path, required=True)
    p.add_argument("--loss", choices=sorted(LOSS_EXTRACTORS), default="vgg")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("-o", "--output", type=Path, default=Path("out/importance"))
    return p.parse_args(argv)


def channel_slices(config):
    """(name, start, end) per configured channel group."""
    out = []
    offset = 0
    for name, n in config.channels:
        out.append((name, offset, offset + n))
        offset += n
    return out


def load_training_state(args, config, device):
    """The training model of ``args`` and its state with the checkpoint's
    weights."""
    from .models.training import make_style_transfer_training_model

    tm = make_style_transfer_training_model(
        config, loss_extractor=args.loss, with_depth_loss=False,
        dtype=cli.compute_dtype(args), device=device,
    )
    cli.load_variables(args.checkpoint_path, tm.model)
    return tm, tm.init_state()


def analysis_batches(args, config, device):
    """``(inputs, ground_truth)`` batches of ``args.batch_size`` from
    ``args.content_dir`` (G-buffer sets or images) paired with the images of
    ``args.style_dir``, as tensors on ``device``."""
    import torch

    from .data import pipeline
    from .data.hdr_screenshots import find_screenshots, iter_hdr_screenshots
    from .data.imaging import list_image_paths, load_image

    styles = (load_image(p, config.output_shape) for p in list_image_paths(args.style_dir))
    if config.hdr and config.total_channels > 3:
        content = iter_hdr_screenshots(
            find_screenshots(args.content_dir), config.channels, config.content_shape,
            output_shape=config.output_shape,
        )
    else:
        content = ((load_image(p, config.content_shape), load_image(p, config.output_shape))
                   for p in list_image_paths(args.content_dir))
    for inputs, gt in pipeline.batched(pipeline.pair_content_and_style(content, styles),
                                       args.batch_size):
        yield ({k: torch.as_tensor(v, device=device) for k, v in inputs.items()},
               {k: torch.as_tensor(v, device=device) for k, v in gt.items()})


def main(argv=None) -> dict:
    """Returns the table's rows and the number of losses this run evaluated."""
    args = parse_args(argv)
    logsetup.setup()

    import torch

    from . import resolve_device
    from .utils import table

    device = resolve_device(args.device)
    config = cli.config_from_args(args, num_styles=1)
    tm, state = load_training_state(args, config, device)

    def eval_loss(batch, c0: int, c1: int, permute: bool) -> float:
        inputs, gt = batch
        content = inputs["content"]
        if permute:
            perm = torch.roll(torch.arange(content.shape[0], device=device), 1)
            content = content.clone()
            content[..., c0:c1] = inputs["content"][perm, ..., c0:c1]
        with torch.no_grad():
            loss, _ = tm.loss_and_metrics(state.params, state.batch_stats,
                                          ({**inputs, "content": content}, gt), train=False)
        return float(loss)

    args.output.mkdir(parents=True, exist_ok=True)
    cache_path = args.output / "progress.pkl"
    results = pickle.loads(cache_path.read_bytes()) if cache_path.exists() else {}

    evaluated = 0
    for bi, batch in enumerate(analysis_batches(args, config, device)):
        if args.max_batches is not None and bi >= args.max_batches:
            break
        for name, c0, c1 in [(BASELINE, 0, 0)] + channel_slices(config):
            key = (bi, name)
            if key in results:
                continue
            results[key] = eval_loss(batch, c0, c1, permute=name != BASELINE)
            evaluated += 1
            cache_path.write_bytes(pickle.dumps(results))
        log.info("batch %d done", bi)

    rows = []
    batch_ids = sorted({b for b, _ in results})
    for name, _, _ in channel_slices(config):
        deltas = [results[(b, name)] - results[(b, BASELINE)]
                  for b in batch_ids if (b, name) in results]
        if deltas:
            rows.append({"channel": name, "importance": float(np.mean(deltas)),
                         "std": float(np.std(deltas)), "batches": len(deltas)})
    rows = table.sort_rows(rows, "importance")
    print(table.to_string(rows))
    (args.output / "importance.csv").write_text(table.to_csv(rows))
    (args.output / "importance.tex").write_text(table.to_latex(rows))
    log.info("wrote %s", args.output / "importance.csv")
    return {"rows": rows, "evaluated": evaluated}


if __name__ == "__main__":
    main()
