"""Functional models over explicit parameter dicts of torch tensors."""

from .classifiers import Classifier1, Classifier2
from .port import from_jax, load_npz
from .pretrained import load_pretrained
from .ritnet import RITnet
from .vgg import VGG19
