"""The flagship forward step and example inputs, as one call; the multichip
dry run.

Port of ``__graft_entry__.py``.  ``entry()``: the single-style inference
model of ``spec`` (default ``rst-960-120-128-17``) in bf16 with seeded
weights, and zero content and style inputs.

    python -m realtime_style_transfer_torch.entry [--spec SPEC] [--device cpu]

prints the output's shape and dtype and whether every value is finite.

    python -m realtime_style_transfer_torch.entry multichip [N] [--device cpu]

is the twin of ``dryrun_multichip``: N ranks (default 8; gloo on the CPU,
NCCL on the cards, one a card; joined under ``torchrun``, else started here
on a free localhost port) run its four checks at tiny shapes:

1. two training steps (VGG loss, RMSprop) on a ``(data, spatial)`` mesh,
   spatial 2 when N is even and at least 4: finite metrics, a falling loss;
2. a batch-1 frame with the H axis sharded over all N ranks;
3. a two-style frame with a weight map on the first mesh;
4. ``FusedStreamStylizer`` over the data axis, bit-equal to one
   ``FusedTransfer``.

Rank 0 prints a line a check and ``dryrun_multichip ok: ...``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

SPEC = "rst-960-120-128-17"


def entry(spec: str = SPEC, device=None):
    """``(forward, args)``: ``forward(*args)`` runs the eager bf16 inference
    model of ``spec`` on ``device`` (default CUDA) on zero inputs."""
    from .config import ShapeConfig
    from .models.inference import make_inference_model

    config = ShapeConfig.from_spec(spec)
    model = make_inference_model(config, dtype=torch.bfloat16, device=device)
    dev = next(model.parameters()).device
    content = torch.zeros((1,) + config.content_shape, dtype=torch.float32, device=dev)
    style = torch.zeros((1,) + config.style_shape, dtype=torch.float32, device=dev)

    def forward(model, content, style):
        with torch.no_grad():
            return model(content, style)

    return forward, (model, content, style)


def dryrun_multichip(n: int, device=None) -> None:
    """The four checks of the multichip dry run on this rank of an
    ``n``-rank process group (see the module docstring); rank 0 prints."""
    import dataclasses

    from .config import ShapeConfig
    from .models.inference import make_inference_model, plan_from_config
    from .models.training import make_style_transfer_training_model
    from .models.transfer import StyleTransferNet
    from .ops.fused_transfer import FusedTransfer
    from .parallel import (DistributedStylizer, DistributedTrainer, FusedStreamStylizer,
                           distributed, make_mesh)
    from .weights import to_flax

    main_rank = distributed.process_index() == 0

    def say(line):
        if main_rank:
            print(line, flush=True)

    def finite(t):
        return bool(torch.isfinite(t).all())

    # tiny flagship-shaped config: 60x120 frames, 17 channels, 15-row bottleneck
    config = ShapeConfig(resolution_divider=16, bottleneck_res_y=15, bottleneck_num_filters=8,
                         num_channels=17, hdr=True, with_depth_loss=False)

    # --- check 1: two training steps on the mesh, loss decreasing ------------------
    spatial = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = make_mesh(n, spatial=spatial, device=device)
    tm = make_style_transfer_training_model(config, loss_extractor="vgg",
                                            with_depth_loss=False, device=mesh.device)
    trainer = DistributedTrainer(tm, mesh)
    state = trainer.init_state()
    rng = np.random.default_rng(0)
    batch_size = mesh.shape["data"]
    inputs = {"content": rng.random((batch_size,) + config.content_shape).astype(np.float32),
              "style": rng.random((batch_size,) + config.style_shape).astype(np.float32)}
    ground_truth = {"content": inputs["content"][..., :3], "style": inputs["style"]}
    batch = trainer.shard_batch((inputs, ground_truth))
    losses = []
    for _ in range(2):
        state, metrics = trainer.train_step(state, batch)
        assert all(finite(v) for v in metrics.values()), metrics
        losses.append(float(metrics["loss"]))
    assert losses[1] < losses[0], f"loss did not decrease: {losses}"
    shown = {k: float(v) for k, v in metrics.items()}
    say(f"train 2-step ok: mesh={mesh.shape} loss {losses[0]:.3f}->{losses[1]:.3f} "
        f"metrics={shown}")

    # --- check 2: batch-1 latency path, H sharded over all ranks -----------------
    latency_mesh = make_mesh(n, spatial=n, device=device)
    model = make_inference_model(config, device=mesh.device, seed=1)
    stylizer = DistributedStylizer(model, None, latency_mesh)
    style_params = stylizer.predict_style_params(
        rng.random((1,) + config.style_shape).astype(np.float32))
    frame = stylizer.stylize(torch.from_numpy(rng.random((1,) + config.content_shape).astype(
        np.float32)), style_params)
    assert tuple(frame.shape) == (1,) + config.output_shape, frame.shape
    assert finite(frame)
    say(f"latency batch-1 ok: mesh={latency_mesh.shape} out={tuple(frame.shape)} "
        f"mean={float(frame.mean()):.4f}")

    # --- check 3: dual-style inference with a weight map -----------------------
    dual_config = dataclasses.replace(config, num_styles=2)
    dual_model = make_inference_model(dual_config, device=mesh.device, seed=2)
    dual_batch = mesh.shape["data"]
    content = torch.from_numpy(rng.random((dual_batch,) + dual_config.content_shape).astype(
        np.float32))
    styles = torch.from_numpy(rng.random((dual_batch,) + dual_config.style_shape).astype(
        np.float32)).to(mesh.device)
    weights = torch.from_numpy(rng.random(
        (dual_batch,) + dual_config.style_weights_shape).astype(np.float32))
    dual_stylizer = DistributedStylizer(dual_model, None, mesh)
    dual_frame = dual_stylizer.stylize(content, dual_stylizer.predict_style_params(styles),
                                       weights)
    assert tuple(dual_frame.shape) == (dual_batch,) + dual_config.output_shape
    assert finite(dual_frame)
    say(f"dual-style ok: mesh={mesh.shape} out={tuple(dual_frame.shape)} "
        f"mean={float(dual_frame.mean()):.4f}")

    # --- check 4: the production stream, the fused engine on each rank ---------
    fused_config = ShapeConfig(resolution_divider=15, bottleneck_res_y=16,
                               bottleneck_num_filters=8, num_channels=17, hdr=True)
    fused_plan = plan_from_config(fused_config)
    fused_net = StyleTransferNet(fused_plan, generator=torch.Generator().manual_seed(3))
    fused_vars = to_flax(fused_net.state_dict())
    f_params = torch.from_numpy((rng.random((1, 1, fused_plan.num_style_parameters)) * 0.4
                                 + 0.8).astype(np.float32))
    data_mesh = make_mesh(n, spatial=1, device=device)
    streamer = FusedStreamStylizer(fused_vars, fused_plan, data_mesh, path="fused")
    assert streamer.path == "fused", streamer.path
    prepared = streamer.prepare_style(f_params)
    frames = rng.random((n,) + fused_config.content_shape).astype(np.float32)
    fused_out = streamer.stylize_batch(frames, prepared)
    assert tuple(fused_out.shape) == (n,) + fused_config.output_shape
    assert finite(fused_out)
    # each rank's engine == one FusedTransfer, bit for bit
    single = FusedTransfer(fused_vars, fused_plan, device=data_mesh.device)
    want0 = single.stylize_prepacked(single.pack_frame_np(frames[:1]),
                                     single.prepare_style(f_params.to(data_mesh.device)))
    assert torch.equal(fused_out[:1], want0), "sharded != single-engine fused"
    say(f"fused-per-chip ok: mesh={data_mesh.shape} out={tuple(fused_out.shape)} "
        "(bit-identical to single-chip kernel)")
    say(f"dryrun_multichip ok: mesh={mesh.shape} metrics={shown} (2-step train loss "
        f"{losses[0]:.3f}->{losses[1]:.3f}; latency spatial={n}; dual-style blended; fused "
        f"kernel sharded over {n} chips bit-identical)")


def _multichip_rank(rank: int, n: int, device, address: str, backend: str) -> None:
    import torch.distributed as dist

    from .parallel import distributed

    distributed.initialize(address, n, rank, backend=backend)
    try:
        dryrun_multichip(n, device)
    finally:
        dist.destroy_process_group()


def multichip(n: int, device=None) -> None:
    """Run :func:`dryrun_multichip` on ``n`` ranks: this process's group
    under ``torchrun``, else ranks started here (one for ``n`` = 1)."""
    import torch.distributed as dist

    from . import resolve_device
    from .parallel import distributed

    dev = resolve_device(device)
    backend = "gloo" if dev.type == "cpu" else "nccl"
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        distributed.initialize(backend=backend)    # under torchrun
    if dist.is_initialized():
        dryrun_multichip(n, device)
        return
    address = f"tcp://127.0.0.1:{distributed.free_port()}"
    if n == 1:
        _multichip_rank(0, 1, device, address, backend)
        return
    import torch.multiprocessing as mp

    mp.spawn(_multichip_rank, args=(n, device, address, backend), nprocs=n, join=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["multichip"]:
        p = argparse.ArgumentParser(prog="entry multichip")
        p.add_argument("n", type=int, nargs="?", default=8)
        p.add_argument("--device", default=None)
        args = p.parse_args(argv[1:])
        multichip(args.n, args.device)
        return 0
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--spec", default=SPEC)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    forward, example = entry(args.spec, args.device)
    out = forward(*example)
    finite = bool(torch.isfinite(out).all())
    print(f"entry {'ok' if finite else 'NOT FINITE'}: {tuple(out.shape)} {out.dtype}")
    return 0 if finite else 1


if __name__ == "__main__":
    sys.exit(main())
