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

  * ``GazeEstimator1Complicated``: a small CNN on the segmentation map
    fused with a landmark MLP; kept for API parity, no script uses it.
  * ``find_ellipse_features`` / ``find_eye_corners``: the reference's
    one-mask host helpers, returning Python numbers (or all ``None``).
"""

from __future__ import annotations

import torch

from ..ops.ellipse import extract_eye_landmarks, eye_corners, fit_ellipse_mask
from ..parallel.mesh import activation_block
from . import layers as L
from .resnet import ResNet50


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def find_ellipse_features(mask, select_largest: bool = True):
    """Fit an ellipse to one (H, W) mask (an array or a tensor on any
    device): ``(cx, cy, major_axis, minor_axis, angle)`` as floats, or five
    ``None`` when the fit is invalid; ``select_largest`` fits only the
    largest component, as the reference's largest OpenCV contour."""
    out = fit_ellipse_mask(torch.as_tensor(mask).bool()[None], select_largest)[0].tolist()
    cx, cy, major, minor, angle, valid = out
    if valid == 0.0:
        return None, None, None, None, None
    return cx, cy, major, minor, angle


def find_eye_corners(mask):
    """Extents of one (H, W) sclera mask: ``(left, right, bottom, top)`` as
    ints, or four ``None`` when the mask is empty."""
    left, right, bottom, top, valid = eye_corners(torch.as_tensor(mask).bool()[None])[0].tolist()
    if valid == 0.0:
        return None, None, None, None
    return int(left), int(right), int(bottom), int(top)


def _mlp_init(gen, din, hidden, dout, device, dtype):
    return {
        "fc0": L.init_linear(gen, din, hidden, device, dtype),
        "fc1": L.init_linear(gen, hidden, hidden, device, dtype),
        "fc2": L.init_linear(gen, hidden, dout, device, dtype),
    }


def _mlp_apply(params, x, train: bool = False, gen: torch.Generator | None = None, mesh=None):
    """With ``mesh``, ``x`` is this rank's block of the batch, and each
    dropout mask is the whole batch's, cut to the block."""
    x = torch.relu(L.linear(x, params["fc0"]))
    x = L.block_dropout(x, 0.5, gen, train, activation_block(mesh, x))
    x = torch.relu(L.linear(x, params["fc1"]))
    x = L.block_dropout(x, 0.5, gen, train, activation_block(mesh, x))
    return L.linear(x, params["fc2"])


class GazeEstimator1:
    LANDMARK_DIM = 19

    @staticmethod
    def init(gen: torch.Generator, landmark_dim: int = 19, hidden_dim: int = 64, device="cpu",
             dtype=torch.float32) -> dict:
        return _mlp_init(gen, landmark_dim, hidden_dim, 3, device, dtype)

    @staticmethod
    def apply(params: dict, x: torch.Tensor, extract_feature: bool = False, train: bool = False,
              gen: torch.Generator | None = None, mesh=None) -> torch.Tensor:
        """x: (B, 19) landmarks, or (B, H, W) segmentation maps when
        ``extract_feature``; returns (B, 3) unit gaze vectors."""
        if extract_feature:
            x = extract_eye_landmarks(x)
        return _normalize(_mlp_apply(params, x, train, gen, mesh))


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
              gen: torch.Generator | None = None, compute_dtype=torch.float32, mesh=None) -> torch.Tensor:
        """x: (B, 2048) features, or channel-last RGB images (B, H, W, 3)
        when ``extract_feature`` (the ResNet50 trunk runs in
        ``compute_dtype``, the head in float32); returns (B, 3) unit gaze
        vectors."""
        if extract_feature:
            x = ResNet50.apply(params["resnet"], x, compute_dtype=compute_dtype)
        return _normalize(_mlp_apply(params["head"], x, train, gen, mesh))


class GazeEstimator1Complicated:
    """CNN on the segmentation map + landmark MLP, fused (reference
    ``gaze_estimators.py:225-301``).  Kept for API parity; no script uses
    it.  The reference's ``conv2`` has kernel 1 with padding 1, so it grows
    the map by 2 in each direction before the global mean; batchnorm is in
    eval mode."""

    @staticmethod
    def init(gen: torch.Generator, landmark_dim: int = 19, hidden_dim: int = 64, device="cpu",
             dtype=torch.float32) -> dict:
        return {
            "conv0": L.init_conv(gen, 3, 3, 1, hidden_dim, device, dtype),
            "bn0": L.init_batchnorm(hidden_dim, device, dtype),
            "conv1": L.init_conv(gen, 3, 3, hidden_dim, hidden_dim, device, dtype),
            "bn1": L.init_batchnorm(hidden_dim, device, dtype),
            "conv2": L.init_conv(gen, 1, 1, hidden_dim, hidden_dim, device, dtype),
            "bn2": L.init_batchnorm(hidden_dim, device, dtype),
            "lm_fc0": L.init_linear(gen, landmark_dim, hidden_dim, device, dtype),
            "lm_fc1": L.init_linear(gen, hidden_dim, hidden_dim, device, dtype),
            "proj_fc0": L.init_linear(gen, 2 * hidden_dim, hidden_dim, device, dtype),
            "proj_fc1": L.init_linear(gen, hidden_dim, 3, device, dtype),
        }

    @staticmethod
    def apply(params: dict, segmap: torch.Tensor, landmarks: torch.Tensor | None = None,
              extract_feature: bool = False, train: bool = False,
              gen: torch.Generator | None = None) -> torch.Tensor:
        """(B, H, W) segmentation maps and (B, 19) landmarks (extracted from
        the maps when ``extract_feature``) -> (B, 3) unit gaze vectors."""
        if extract_feature:
            landmarks = extract_eye_landmarks(segmap)
        x1 = segmap.float()[:, None]  # (B, 1, H, W)
        x1 = torch.relu(L.batchnorm(L.conv2d(x1, params["conv0"], padding=1), params["bn0"]))
        x1 = L.max_pool(x1, 2, 2)
        x1 = torch.relu(L.batchnorm(L.conv2d(x1, params["conv1"], padding=1), params["bn1"]))
        x1 = L.max_pool(x1, 2, 2)
        x1 = torch.relu(L.batchnorm(L.conv2d(x1, params["conv2"], padding=1), params["bn2"]))
        x1 = x1.mean(dim=(2, 3))  # AdaptiveAvgPool (1, 1) + flatten

        x2 = L.dropout(torch.relu(L.linear(landmarks, params["lm_fc0"])), 0.5, gen, train)
        x2 = L.linear(x2, params["lm_fc1"])
        x = torch.cat([x1, x2], dim=1)
        x = L.dropout(torch.relu(L.linear(x, params["proj_fc0"])), 0.5, gen, train)
        return _normalize(L.linear(x, params["proj_fc1"]))
