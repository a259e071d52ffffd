"""Inference over the mesh: frames over the data axis, rows over the spatial axis.

Port of ``realtime_style_transfer_tpu/parallel/infer.py``.  Each rank holds
the whole model (or engine) and the prepared style, rank 0's by a broadcast;
the outputs are gathered in rank order, so that rank 0 (and every rank) gets
the step's frames for the caller.

* :class:`DistributedStylizer`: the eager inference net's ``stylize`` and
  ``predict_style_params`` on the mesh.  The batch is sharded over the data
  axis; with a spatial axis each rank of a spatial group runs the transfer
  net on its rows of its frames (the content's and the weight map's,
  :mod:`.spatial`), the frames are gathered along H in the group and then
  along the batch in the data group.  ``predict_style_params`` runs
  replicated.
* :class:`FusedStreamStylizer`: the production stream, on the data axis
  only (it refuses a spatial axis, as JAX's does).  The per-rank program
  is :class:`..ops.fused_transfer.FusedTransfer` (the ``conv_stage`` and
  ``finish`` kernels) where the plan qualifies, else
  :class:`..models.transfer_packed.PackedTransfer`; ``path="auto"`` picks by
  :func:`..video.choose_plan_path`, the rule of ``--path auto``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.inference import StyleTransferInference
from ..models.transfer import TransferPlan
from ..weights import from_flax
from .mesh import DATA_AXIS, SPATIAL_AXIS, Mesh, frame_rows, replicate


def _rank_slice(x: Optional[torch.Tensor], mesh: Mesh) -> Optional[torch.Tensor]:
    if x is None:
        return None
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"batch {n} not divisible by the {mesh.size} ranks of the mesh")
    per = n // mesh.size
    t = torch.as_tensor(x[mesh.rank * per:(mesh.rank + 1) * per])
    return t.to(mesh.device)


class DistributedStylizer:
    """The inference model's ``stylize`` with the batch over the ranks and
    ``predict_style_params`` replicated.  ``variables`` (a flax tree), when
    given, is loaded into ``model`` first; the weights are then rank 0's on
    every rank."""

    def __init__(self, model: StyleTransferInference, variables, mesh: Mesh):
        self.mesh = mesh
        self.model = model.to(mesh.device).eval()
        if variables is not None:
            self.model.load_state_dict(from_flax(variables, expected=self.model), strict=True)
        mesh.broadcast_module_(self.model)
        self.rows = frame_rows(mesh, self.model.plan)

    def predict_style_params(self, style_images) -> torch.Tensor:
        with torch.no_grad():
            out = self.model.predict_style_params(torch.as_tensor(style_images).to(
                self.mesh.device))
        return self.mesh.broadcast_(out.contiguous())

    def stylize(self, content, style_params, style_weights=None) -> torch.Tensor:
        """content (B, H, W, C), B divisible by the data-axis size, and style
        params (B, S, P) or (1, S, P); each rank stylizes its slice (its rows
        of it on a spatial axis), and every rank gets the (B, H, W, 3)
        result."""
        params = torch.as_tensor(style_params)
        if params.shape[0] == content.shape[0]:
            params = _rank_slice(params, self.mesh)   # a style vector a frame
        params = params.to(self.mesh.device)
        with torch.no_grad():
            out = self.model.stylize(_rank_slice(content, self.mesh), params,
                                     _rank_slice(style_weights, self.mesh), rows=self.rows)
        return self.mesh.all_gather(out.float())

    @property
    def batch_per_step(self) -> int:
        return self.mesh.shape[DATA_AXIS]


class FusedStreamStylizer:
    """Frames over the ``data`` axis, one a rank a step; the fused engine (or
    the packed path) as each rank's program.

    ``path`` is ``"auto"``, ``"fused"`` or ``"packed"``; ``"fused"`` raises
    where the plan does not qualify, ``"auto"`` falls back to the packed path
    there and off CUDA.  ``quant="int8"`` (with ``act_scales``) needs
    ``path="fused"``.  The style is prepared once (:meth:`prepare_style`)
    and replicated."""

    def __init__(self, variables, plan: TransferPlan, mesh: Mesh, *, num_styles: int = 1,
                 path: str = "auto", dtype=torch.bfloat16, quant=None, act_scales=None):
        from ..video import choose_plan_path

        if quant is not None and path != "fused":
            raise ValueError("quant engines exist only on the fused path; pass path='fused'")
        if mesh.shape[SPATIAL_AXIS] != 1:
            raise ValueError("FusedStreamStylizer shards whole frames over the data axis; "
                             "build the mesh with spatial=1")
        if path not in ("auto", "fused", "packed"):
            raise ValueError(f"path must be 'auto', 'fused' or 'packed', got {path!r}")
        self.mesh = mesh
        self.plan = plan
        self.num_styles = num_styles
        self.n_data = mesh.shape[DATA_AXIS]
        self._fused = None
        want_fused = path == "fused" or (
            path == "auto" and choose_plan_path(plan, num_styles, mesh.device) == "fused")
        if want_fused:
            from ..ops.fused_transfer import FusedTransfer

            try:
                self._fused = FusedTransfer(variables, plan, num_styles=num_styles,
                                            device=mesh.device, quant=quant,
                                            act_scales=act_scales)
            except ValueError:
                if path == "fused":
                    raise
        self.path = "fused" if self._fused is not None else "packed"
        self._packed = None
        if self._fused is None:
            from ..models.transfer_packed import PackedTransfer

            self._packed = PackedTransfer(variables, plan, num_styles=num_styles, dtype=dtype,
                                          device=mesh.device)

    def prepare_style(self, style_params, style_weights=None):
        """Replicated per-style constants for the frame stream: rank 0's
        style params (and weight map) on every rank."""
        if self.num_styles > 1 and style_weights is None:
            raise ValueError("style_weights required when num_styles > 1")
        params, weights = replicate((torch.as_tensor(style_params).float(), None if
                                     style_weights is None else
                                     torch.as_tensor(np.asarray(style_weights, np.float32))),
                                    self.mesh)
        if self._fused is not None:
            return self._fused.prepare_style(params, weights)
        return (params,) + (() if weights is None else (weights,))

    def _check_group(self, n: int) -> None:
        if n != self.n_data:
            raise ValueError(f"need exactly {self.n_data} frames per step (one per rank), "
                             f"got {n}")

    def stylize_local(self, content, prepared) -> torch.Tensor:
        """This rank's (1, H, W, C) frame -> the step's (n_data, H, W, 3)
        f32 frames of all ranks, in rank order."""
        content = torch.as_tensor(content).to(self.mesh.device)
        if self._fused is not None:
            out = self._fused.stylize_prepared(content, prepared)
        else:
            with torch.no_grad():
                out = self._packed(content, prepared[0],
                                   prepared[1] if len(prepared) > 1 else None)
        return self.mesh.all_gather(out.float())

    def stylize_batch(self, content, prepared) -> torch.Tensor:
        """content (n_data, H, W, C) -> (n_data, H, W, 3); rank r stylizes
        frame r."""
        self._check_group(content.shape[0])
        r = self.mesh.rank
        return self.stylize_local(content[r:r + 1], prepared)

    def pack_frames_np(self, frames) -> torch.Tensor:
        """Host-pack an (n, H, W, C) group for :meth:`stylize_batch_prepacked`
        (fused path only; safe in a prefetcher's worker)."""
        if self._fused is None:
            raise ValueError("pre-packed input is a fused-path contract")
        return torch.stack([self._fused.pack_frame_np(frames[i:i + 1])
                            for i in range(frames.shape[0])])

    def stylize_local_prepacked(self, packed, prepared) -> torch.Tensor:
        """This rank's frame pack -> the step's (n_data, H, W, 3) frames."""
        if self._fused is None:
            raise ValueError("pre-packed input is a fused-path contract")
        return self.mesh.all_gather(self._fused.stylize_prepacked(packed, prepared))

    def stylize_batch_prepacked(self, packed, prepared) -> torch.Tensor:
        """Pre-packed (n_data, hp, wp, Cp) group -> (n_data, H, W, 3)."""
        self._check_group(packed.shape[0])
        return self.stylize_local_prepacked(packed[self.mesh.rank], prepared)

    @property
    def batch_per_step(self) -> int:
        return self.n_data

    @property
    def fused_engine(self):
        """This rank's FusedTransfer (None on the packed path), for example
        for the int8 calibration whose scales every rank then deploys."""
        return self._fused
