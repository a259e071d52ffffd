"""Train the style-transfer network on the card.

Twin of the repository's ``train_network.py``: the same flags, plus
``--device``, and the same run directory (``config.json``,
``metrics.jsonl``, a TensorBoard event file, ``images/*.png``,
``ckpt/``, ``latest_ckpt/``, ``weights/latest_epoch_weights.npz``,
``log.txt``), resumable with ``--continue_from``.  Examples::

    python -m realtime_style_transfer_torch.train_network --network_spec \\
        rst-960-120-128-17 --content_dir data/screenshots/hdr_images \\
        --style_dir data/styles --epochs 300 --batch_size 4
    python -m realtime_style_transfer_torch.train_network --device cpu \\
        --network_spec rst-120-15-4-3 --sdr --loss dummy --no_depth_loss \\
        --epochs 1 --batch_size 2 --content_dir ... --style_dir ...

The training model runs every CIN of 64 channels or more on the CUDA kernels
(``use_pallas=True``: ``csrc/cin.cu``, forward and backward); with
``--device cpu`` their plain versions run.  ``--mesh N[,S]`` trains over
an N x S mesh of N * S ranks, one a card (gloo ranks on the CPU with
``--device cpu``), as the JAX CLI builds ``make_mesh(N * S, spatial=S)``:
the batch (``--batch_size`` being the global batch) over the N data ranks,
each frame's rows over the S ranks of a spatial group (halo exchanges
around each conv, the CIN and batch norm moments all-reduced; the CINs of
64 channels or more in ``cin.cu``'s split mode, two launches a pass with an
all-reduce between them).  Launched under ``torchrun --nproc_per_node
N*S`` the command joins that group, otherwise it starts its ranks itself on
a free localhost port.  Rank 0 alone writes the run directory.
``--profile`` writes a ``torch.profiler`` trace under ``<log_dir>/profile``,
``--debug_nans`` turns on autograd's anomaly detection, and
``--disable_jit`` has no effect: the port is eager.
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import cli, resolve_device
from .models.losses import LOSS_EXTRACTORS, TOWER_MODES
from .tracing import logsetup

log = logging.getLogger("train_network")


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    cli.add_config_args(p)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--loss", choices=sorted(LOSS_EXTRACTORS), default="vgg")
    p.add_argument("--loss_tower", choices=TOWER_MODES, default="split",
                   help="schedule of the three loss-tower invocations (same values and "
                        "gradients)")
    p.add_argument("--no_depth_loss", action="store_true")
    p.add_argument("--depth_loss", action="store_true",
                   help="enable the depth-aware loss term (supply --depth_checkpoint)")
    p.add_argument("--depth_checkpoint", type=Path, default=None,
                   help="pretrained MidasLite weights (.npz of /-joined flax paths, as "
                        "depth_pretrain saves them); implies --depth_loss.  'bundled' "
                        "loads realtime_style_transfer_torch/assets/midas_lite_synthetic.npz")
    p.add_argument("--remat", action="store_true",
                   help="recompute the forward under grad (less memory, one more forward)")
    p.add_argument("--log_dir", type=Path, default=None)
    p.add_argument("--continue_from", type=Path, default=None,
                   help="previous run dir to resume from (restores its latest checkpoint)")
    p.add_argument("--content_dir", type=Path, default=None)
    p.add_argument("--style_dir", type=Path, default=None,
                   help="local style-image directory (bypasses the wikiart manifest)")
    p.add_argument("--cache_dir", type=Path, default=None)
    p.add_argument("--checkpoint_cadence", type=int, default=10)
    p.add_argument("--seed", type=int, default=36)
    p.add_argument("--debug", action="store_true", help="100-image debug dataset")
    p.add_argument("--mesh", type=str, default=None,
                   help="device mesh as data[,spatial], e.g. '4,2': data * spatial ranks, "
                        "the batch over data, each frame's rows over spatial; default "
                        "single device")
    p.add_argument("--profile", action="store_true",
                   help="torch.profiler trace under <log_dir>/profile")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd anomaly detection")
    p.add_argument("--disable_jit", action="store_true",
                   help="accepted for the JAX CLI's interface; no effect (the port is eager)")
    return p.parse_args(argv)


def _first_samples(make_iter):
    """The samples of the first batch, each without its batch axis."""
    from .data.pipeline import _tree_map

    for batch in make_iter():
        first = batch
        while isinstance(first, (dict, tuple, list)):
            first = next(iter(first.values())) if isinstance(first, dict) else first[0]
        for i in range(np.asarray(first).shape[0]):
            yield _tree_map(lambda x, i=i: x[i], batch)
        return


def mesh_ranks(spec: str) -> Tuple[int, int]:
    """(the rank count, the spatial axis) of ``--mesh data[,spatial]``."""
    parts = [int(x) for x in spec.split(",")]
    spatial = parts[1] if len(parts) > 1 else 1
    return parts[0] * spatial, spatial


def main(argv: Optional[Sequence[str]] = None, callbacks: Sequence = ()) -> Path:
    """Run the CLI with ``argv``; ``callbacks`` join the trainer's own (on
    every rank).  Returns the run directory."""
    args = parse_args(argv)
    resolve_device(args.device)
    log_dir = args.log_dir or cli.default_log_dir()
    ranks, spatial = mesh_ranks(args.mesh) if args.mesh else (None, 1)
    if ranks is None:
        _run(args, log_dir, callbacks)
        return log_dir
    import torch.distributed as dist

    from .parallel import distributed

    backend = "gloo" if args.device == "cpu" else "nccl"
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        distributed.initialize(backend=backend)    # under torchrun
    if dist.is_initialized() or ranks == 1:
        _run(args, log_dir, callbacks, ranks=ranks, spatial=spatial)
        return log_dir
    import torch.multiprocessing as mp

    address = f"tcp://127.0.0.1:{distributed.free_port()}"
    mp.spawn(_spawned_rank, args=(args, log_dir, callbacks, ranks, spatial, address, backend),
             nprocs=ranks, join=True)
    return log_dir


def _spawned_rank(rank: int, args, log_dir: Path, callbacks: Sequence, ranks: int,
                  spatial: int, address: str, backend: str) -> None:
    import torch.distributed as dist

    from .parallel import distributed

    distributed.initialize(address, ranks, rank, backend=backend)
    try:
        _run(args, log_dir, callbacks, ranks=ranks, spatial=spatial)
    finally:
        dist.destroy_process_group()


def _run(args, log_dir: Path, callbacks: Sequence, ranks: Optional[int] = None,
         spatial: int = 1) -> None:
    """Train in this process: alone, or as one rank of a ``ranks``-rank mesh
    with a ``spatial`` axis."""
    mesh = None
    if ranks is not None:
        from .parallel import make_mesh

        mesh = make_mesh(ranks, spatial=spatial, device=args.device)
    logsetup.setup()
    main_rank = mesh is None or mesh.is_main
    device = resolve_device(args.device) if mesh is None else mesh.device
    logfile = None
    if main_rank:
        log_dir.mkdir(parents=True, exist_ok=True)
        logfile = logsetup.enable_logfile(log_dir)
    anomaly = torch.is_anomaly_enabled()
    try:
        torch.autograd.set_detect_anomaly(args.debug_nans)
        _train(args, device, log_dir, callbacks, mesh)
    finally:
        torch.autograd.set_detect_anomaly(anomaly)
        if logfile is not None:
            logging.getLogger().removeHandler(logfile)
            logfile.close()


def _train(args, device: torch.device, log_dir: Path, extra_callbacks: Sequence,
           mesh=None) -> None:
    from .data import wikiart
    from .data.imaging import list_image_paths
    from .data.pipeline import get_single_sample
    from .models.training import make_style_transfer_training_model
    from .optim import RMSProp
    from .tracing.callbacks import (CheckpointCallback, GradientsCallback, HistogramCallback,
                                    MetricsCallback, SummaryImageCallback)
    from .tracing.checkpoint import CheckpointManager, orbax_refusal
    from .tracing.metrics import MetricsWriter
    from .tracing.profiler import trace
    from .tracing.textsummary import capture_model_summary
    from .trainer import Trainer

    main_rank = mesh is None or mesh.is_main
    config = cli.config_from_args(args)
    log.info("config: %s", config.to_spec())
    if main_rank:
        (log_dir / "config.json").write_text(config.to_json())

    depth_variables = None
    if args.depth_checkpoint is not None:
        from .models.depth import BUNDLED_DEPTH_CHECKPOINT, load_depth_checkpoint

        ckpt = args.depth_checkpoint
        if str(ckpt) == "bundled":
            ckpt = BUNDLED_DEPTH_CHECKPOINT
        if Path(ckpt).is_dir():
            raise orbax_refusal(ckpt)
        depth_variables = load_depth_checkpoint(ckpt)
    with_depth = (
        config.with_depth_loss or args.depth_loss or args.depth_checkpoint is not None
    ) and not args.no_depth_loss
    tm = make_style_transfer_training_model(
        config, loss_extractor=args.loss, tower_mode=args.loss_tower,
        with_depth_loss=with_depth, depth_variables=depth_variables,
        dtype=cli.compute_dtype(args), remat=args.remat, use_pallas=True,
        optimizer=RMSProp(args.learning_rate, decay=0.9, eps=1e-7),
        device=device, seed=args.seed)

    channels = list(config.channels) if config.hdr else None
    style_paths = None
    if args.style_dir is not None:
        style_paths = sorted(list_image_paths(args.style_dir))
    dataset_kwargs = dict(seed=args.seed, cache_dir=args.cache_dir, channels=channels,
                          content_dir=args.content_dir, style_paths=style_paths)
    if args.debug:
        make_train, make_val, n_train, n_val = wikiart.get_dataset_debug(
            config, args.batch_size, hdr=config.hdr,
            **{k: v for k, v in dataset_kwargs.items() if k != "content_dir"})
    else:
        make_train, make_val, n_train, n_val = wikiart.get_dataset(
            config, args.batch_size, **dataset_kwargs)
    log.info("dataset: %d training / %d validation samples", n_train, n_val)
    if n_train == 0:
        raise SystemExit(
            "no training samples found — check --content_dir/--style_dir "
            "(expected training/ and validation/ subdirectories)")

    if mesh is not None:
        log.info("mesh: %s, this rank %d on %s", mesh.shape, mesh.rank, mesh.device)
    # rank 0 alone writes the run directory: metrics, checkpoints, summaries
    writer, callbacks = None, []
    if main_rank:
        writer = MetricsWriter(log_dir)
        checkpoints = CheckpointManager(log_dir, cadence=args.checkpoint_cadence)
        val_batch = get_single_sample(_first_samples(make_val))
        train_batch = get_single_sample(_first_samples(make_train))
        callbacks = [
            MetricsCallback(writer),
            CheckpointCallback(checkpoints),
            HistogramCallback(writer, every=5),
        ]
        if val_batch is not None and train_batch is not None:
            callbacks.append(SummaryImageCallback(log_dir, tm, val_batch, train_batch))
            callbacks.append(GradientsCallback(writer, tm, val_batch, every=5))
    callbacks.extend(extra_callbacks)

    trainer = Trainer(tm, mesh=mesh, log_dir=log_dir, callbacks=callbacks,
                      metrics_writer=writer)
    state = trainer.init_state()
    if writer is not None:
        writer.write_text("model_summary", capture_model_summary(state.params))
        writer.write_text("config", config.to_json())

    initial_epoch = 0
    if args.continue_from:
        prev = CheckpointManager(args.continue_from, cadence=args.checkpoint_cadence)
        state, initial_epoch = trainer.resume(state, prev)

    try:
        with trace(str(log_dir / "profile") if args.profile and main_rank else None):
            trainer.fit(state, make_train, make_val, epochs=args.epochs,
                        initial_epoch=initial_epoch)
    finally:
        if writer is not None:
            writer.close()
    log.info("done; artifacts in %s", log_dir)


if __name__ == "__main__":
    main()
