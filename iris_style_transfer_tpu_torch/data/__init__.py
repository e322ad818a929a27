"""Data: the OpenEDS2019/2020 loaders, the synthetic OpenEDS twin, IST and
classifier dataset construction, batching and device staging."""

from .native_loader import decode_gray_batch
from .openeds2019 import ISTDataset, build_ir_dataset, build_ist_dataset, load_data_openeds2019, sample_other
from .openeds2020 import load_data_openeds2020, load_labels_openeds2020, stream_openeds2020
from .prefetch import background, batch_iterator, prefetch_to_device
from .synthetic import synthetic_eye_batch, synthetic_openeds2019
