"""Image ops, losses, metrics and the hand-written CUDA kernels (``csrc/``)."""

from .clahe import clahe
from .connected import area_opening, connected_components, largest_component
from .depthwise import dw_conv_bn_silu
from .ellipse import extract_eye_landmarks, eye_corners, fit_ellipse_mask
from .gram import gram_matrix
from .image import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    composite_iris,
    crop_and_resize,
    gamma_lut,
    gray_to_rgb,
    imagenet_normalize,
    nonzero_bbox,
    pad_height,
    paste_resized,
    resize_bilinear,
    rgb_to_grayscale,
)
from .losses import content_loss_l2, style_loss_bn, style_loss_bn_stats, style_loss_gram, style_stats
from .metrics import angular_distance, classification_metrics, iou_per_class
from .relu_pool import relu_max_pool
