"""Data: the synthetic OpenEDS twin, IST and classifier dataset
construction, batching and device staging."""

from .openeds2019 import ISTDataset, build_ir_dataset, build_ist_dataset, sample_other
from .prefetch import batch_iterator, prefetch_to_device
from .synthetic import synthetic_eye_batch, synthetic_openeds2019
