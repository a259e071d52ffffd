"""PyTorch / CUDA port of the real-time style-transfer system.

The JAX package ``realtime_style_transfer_tpu`` is the reference this package
is held against; nothing here imports it.  Public functions keep its layouts:
NHWC activations, flax parameter names (through :mod:`.weights`) and
``(B, S, P)`` style vectors.  Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; raise rather than fall back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
