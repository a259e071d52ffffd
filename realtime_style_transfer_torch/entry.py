"""The flagship forward step and example inputs, as one call.

Port of ``entry()`` in ``__graft_entry__.py``: the single-style inference
model of ``spec`` (default ``rst-960-120-128-17``) in bf16 with seeded
weights, and zero content and style inputs.

    python -m realtime_style_transfer_torch.entry [--spec SPEC] [--device cpu]

prints the output's shape and dtype and whether every value is finite.
"""

from __future__ import annotations

import argparse
import sys

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


def main(argv=None) -> int:
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
