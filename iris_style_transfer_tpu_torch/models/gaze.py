"""Gaze estimators.

Counterpart of ``iris_style_transfer_tpu/models/gaze.py`` (reference
``models/gaze_estimators/gaze_estimators.py``):

  * ``GazeEstimator1``: model-based; the 19-d landmark vector -> MLP (64)
    -> 3-d gaze, L2-normalized.  With ``extract_feature`` it takes (B, H,
    W) segmentation maps and extracts the landmarks batched on their
    device (``ops/ellipse.py``), where the reference loops over images in
    OpenCV on the host.
  * ``GazeEstimator2``: appearance-based; ResNet50 2048-d features -> MLP
    (64) -> normalized 3-d gaze.

The MLPs are ``fc0 -> ReLU -> Dropout(0.5) -> fc1 -> ReLU -> Dropout(0.5)
-> fc2``; ``train=True`` with a ``torch.Generator`` turns the dropout on
(``models/layers.py:dropout``), as ``workloads/gaze_estimation.py`` trains.
``GazeEstimator1Complicated`` is not ported yet: no script uses it.
"""

from __future__ import annotations

import torch

from ..ops.ellipse import extract_eye_landmarks
from . import layers as L
from .resnet import ResNet50


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def _mlp_init(gen, din, hidden, dout, device, dtype):
    return {
        "fc0": L.init_linear(gen, din, hidden, device, dtype),
        "fc1": L.init_linear(gen, hidden, hidden, device, dtype),
        "fc2": L.init_linear(gen, hidden, dout, device, dtype),
    }


def _mlp_apply(params, x, train: bool = False, gen: torch.Generator | None = None):
    x = L.dropout(torch.relu(L.linear(x, params["fc0"])), 0.5, gen, train)
    x = L.dropout(torch.relu(L.linear(x, params["fc1"])), 0.5, gen, train)
    return L.linear(x, params["fc2"])


class GazeEstimator1:
    LANDMARK_DIM = 19

    @staticmethod
    def init(gen: torch.Generator, landmark_dim: int = 19, hidden_dim: int = 64, device="cpu",
             dtype=torch.float32) -> dict:
        return _mlp_init(gen, landmark_dim, hidden_dim, 3, device, dtype)

    @staticmethod
    def apply(params: dict, x: torch.Tensor, extract_feature: bool = False, train: bool = False,
              gen: torch.Generator | None = None) -> torch.Tensor:
        """x: (B, 19) landmarks, or (B, H, W) segmentation maps when
        ``extract_feature``; returns (B, 3) unit gaze vectors."""
        if extract_feature:
            x = extract_eye_landmarks(x)
        return _normalize(_mlp_apply(params, x, train, gen))


class GazeEstimator2:
    @staticmethod
    def init(gen: torch.Generator, hidden_dim: int = 64, extract_feature: bool = False, device="cpu",
             dtype=torch.float32) -> dict:
        params = {"head": _mlp_init(gen, 2048, hidden_dim, 3, device, dtype)}
        if extract_feature:
            params["resnet"] = ResNet50.init(gen, device, dtype)
        return params

    @staticmethod
    def apply(params: dict, x: torch.Tensor, extract_feature: bool = False, train: bool = False,
              gen: torch.Generator | None = None, compute_dtype=torch.float32) -> torch.Tensor:
        """x: (B, 2048) features, or channel-last RGB images (B, H, W, 3)
        when ``extract_feature`` (the ResNet50 trunk runs in
        ``compute_dtype``, the head in float32); returns (B, 3) unit gaze
        vectors."""
        if extract_feature:
            x = ResNet50.apply(params["resnet"], x, compute_dtype=compute_dtype)
        return _normalize(_mlp_apply(params["head"], x, train, gen))
