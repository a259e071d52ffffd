"""Rendering helpers: tensor -> PIL images and the matplotlib summary figure.

Port of ``realtime_style_transfer_tpu/renderers.py``: ``tensor_to_image``
(re-exported from ``data.imaging``) and the 2x2 content / style / validation
prediction / training prediction figure.  matplotlib is imported when a
figure is drawn, not with the module.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .data.imaging import image_to_uint8, tensor_to_image  # noqa: F401


def imshow(ax, image, title: Optional[str] = None):
    arr = np.asarray(image)
    if arr.ndim == 4:
        arr = arr[0]
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    ax.imshow(np.clip(arr, 0.0, 1.0))
    ax.set_axis_off()
    if title:
        ax.set_title(title)


def predict_datapoint(training_model, state, validation_batch, training_batch,
                      save_path=None):
    """2x2 figure: content / style / validation prediction / training prediction."""
    import matplotlib

    if save_path is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    val_inputs, _ = validation_batch
    train_inputs, _ = training_batch
    val_pred = training_model.predict(state, val_inputs).float().cpu().numpy()
    train_pred = training_model.predict(state, train_inputs).float().cpu().numpy()

    fig, axes = plt.subplots(2, 2, figsize=(12, 7))
    imshow(axes[0, 0], np.asarray(val_inputs["content"])[0][..., :3], "content")
    imshow(axes[0, 1], np.asarray(val_inputs["style"])[0, 0], "style")
    imshow(axes[1, 0], val_pred[0], "validation prediction")
    imshow(axes[1, 1], train_pred[0], "training prediction")
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, dpi=100)
        plt.close(fig)
    else:
        plt.show()
    return fig
