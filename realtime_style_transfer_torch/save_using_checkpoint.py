"""Export a checkpoint as deployable artifacts.

Twin of the repository's ``save_using_checkpoint.py``: the same flags, plus
``--device``.  It writes, under ``-o``:

* ``config.json``: the ``ShapeConfig`` used;
* ``inference.pt2``: content + style images -> stylized image,
  ``predictor.pt2``: style images -> style-param vectors, and
  ``transfer.pt2``: content + style params -> stylized image, each a
  ``torch.export`` program written by ``torch.export.save`` with the weights
  inside (the JAX package's ``.stablehlo`` artifacts): f32 inputs, the
  compute dtype of ``--dtype``, the eager net in torch ops (the plain CIN;
  no kernel of the port is traced into a program).  A program keeps the
  device it was exported on; :mod:`.predict_using_saved_models` runs it
  there and refuses another;
* ``transfer.onnx`` and ``predictor.onnx`` for a single style (the engine's
  runtime; :mod:`.export.onnx`), with the JAX CLI's warnings for a
  multi-style config and for a predictor that is neither dummy nor
  MobileNet;
* ``checkpoint/``: a copy of the ``.npz`` that ``-C`` names, or of a run's
  ``weights/latest_epoch_weights.npz``.

    python -m realtime_style_transfer_torch.save_using_checkpoint -C logs/<run> \\
        --network_spec rst-960-120-128-17 -o out/export [--device cpu]

``main(argv)`` returns each artifact's size in bytes and each export's
seconds.
"""

from __future__ import annotations

import argparse
import logging
import shutil
import time
from pathlib import Path

from . import cli
from .tracing import logsetup

log = logging.getLogger("export")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    cli.add_config_args(p)
    p.add_argument("-C", "--checkpoint_path", type=Path, required=True)
    p.add_argument("-o", "--output", type=Path, default=Path("out/export"))
    return p.parse_args(argv)


def _entry(model, method: str, parts):
    """``model``'s ``method`` in eval mode as the forward of a module that
    holds only the submodules ``parts`` (a program keeps every parameter of
    the module it is exported from), the counterpart of ``model.apply(...,
    method=..., train=False)``."""
    import torch

    class Entry(type(model)):
        def __init__(self):
            torch.nn.Module.__init__(self)
            self.plan = model.plan
            for name in parts:
                self.add_module(name, getattr(model, name))

        def forward(self, *args):
            return getattr(super(), method)(*args, train=False)

    return Entry()


def check_aten_only(program) -> None:
    """Raise if ``program`` calls an operator outside ``aten`` (a custom op
    or a kernel wrapper of the port)."""
    for node in program.graph.nodes:
        namespace = getattr(node.target, "namespace", "aten")
        if node.op == "call_function" and namespace != "aten":
            raise ValueError(f"exported program calls {node.target}: only aten operators "
                             "may be exported")


def main(argv=None) -> dict:
    args = parse_args(argv)
    logsetup.setup()

    import torch

    from . import resolve_device
    from .export import export_predictor_onnx, export_transfer_onnx
    from .models.inference import plan_from_config
    from .tracing.checkpoint import weights_file

    device = resolve_device(args.device)
    config = cli.config_from_args(args)
    model = cli.build_inference(config, dtype=cli.compute_dtype(args), device=device)
    variables = cli.load_variables(args.checkpoint_path, model)
    plan = plan_from_config(config)

    out = args.output
    out.mkdir(parents=True, exist_ok=True)
    (out / "config.json").write_text(config.to_json())

    content = torch.zeros((1,) + config.content_shape, device=device)
    style = torch.zeros((1,) + config.style_shape, device=device)
    style_params = torch.zeros((1, config.num_styles, plan.num_style_parameters),
                               device=device)
    sizes, seconds = {}, {}

    def export_fn(name, method, parts, *example_args):
        t0 = time.perf_counter()
        program = torch.export.export(_entry(model, method, parts), example_args,
                                      strict=False)
        check_aten_only(program)
        program.example_inputs = None   # else the zero inputs are saved with it
        path = out / f"{name}.pt2"
        torch.export.save(program, path)
        seconds[name] = time.perf_counter() - t0
        sizes[path.name] = path.stat().st_size
        log.info("exported %s (%d bytes) in %.2f s", path, sizes[path.name], seconds[name])

    # the weights live in the programs' state
    export_fn("inference", "forward", ("style_predictor", "transfer"), content, style)
    export_fn("predictor", "predict_style_params", ("style_predictor",), style)
    export_fn("transfer", "stylize", ("transfer",), content, style_params)

    # ONNX for the engine runtime: single-style graphs; multi-style deploys
    # use the torch.export programs
    if config.num_styles == 1:
        transfer_bytes = export_transfer_onnx(variables, plan)
        (out / "transfer.onnx").write_bytes(transfer_bytes)
        sizes["transfer.onnx"] = len(transfer_bytes)
        log.info("exported %s (%d bytes)", out / "transfer.onnx", len(transfer_bytes))
        try:
            predictor_bytes = export_predictor_onnx(
                variables, style_shape=config.output_shape,
                num_top_parameters=plan.num_style_parameters,
                feature_extractor=config.feature_extractor,
            )
            (out / "predictor.onnx").write_bytes(predictor_bytes)
            sizes["predictor.onnx"] = len(predictor_bytes)
            log.info("exported %s (%d bytes)", out / "predictor.onnx", len(predictor_bytes))
        except ValueError as e:
            log.warning("predictor ONNX export skipped: %s", e)
    else:
        log.warning("ONNX export is single-style; use the torch.export artifacts "
                    "for multi-style deploys")

    src = weights_file(args.checkpoint_path)
    ckpt_dst = out / "checkpoint"
    if ckpt_dst.exists():
        shutil.rmtree(ckpt_dst)
    ckpt_dst.mkdir()
    shutil.copy2(src, ckpt_dst / src.name)
    sizes[f"checkpoint/{src.name}"] = (ckpt_dst / src.name).stat().st_size
    log.info("artifacts in %s", out)
    return {"sizes": sizes, "export_s": seconds}


if __name__ == "__main__":
    main()
