"""Data: the synthetic OpenEDS twin, IST dataset construction, batching."""

from .openeds2019 import ISTDataset, build_ist_dataset, sample_other
from .prefetch import batch_iterator
from .synthetic import synthetic_eye_batch, synthetic_openeds2019
