"""Functional models over explicit parameter dicts of torch tensors."""

from .classifiers import Classifier1, Classifier2
from .efficientnet import EfficientNet
from .gaze import GazeEstimator1, GazeEstimator2
from .port import from_jax, load_npz
from .pretrained import load_pretrained, pretrained_path
from .resnet import ResNet50
from .ritnet import RITnet
from .vgg import VGG19
