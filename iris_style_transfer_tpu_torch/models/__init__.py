"""Functional models over explicit parameter dicts of torch tensors."""

from .classifiers import Classifier1, Classifier2
from .efficientnet import EfficientNet
from .gaze import (
    GazeEstimator1,
    GazeEstimator1Complicated,
    GazeEstimator2,
    find_ellipse_features,
    find_eye_corners,
)
from .port import from_jax, load_npz
from .pretrained import load_pretrained, pretrained_path
from .resnet import ResNet50
from .ritnet import RITnet
from .vgg import VGG19
from ..ops.ellipse import extract_eye_landmarks

# the reference's spelling (its models/__init__.py:6)
GazeEstimator1_complicated = GazeEstimator1Complicated
