"""OpenEDS2020 gaze-subset loading: eager, or streamed in bounded memory.

Counterpart of ``iris_style_transfer_tpu/data/openeds2020.py`` (reference
``load_data_openeds2020``, ``data_preprocessing.py:349-419``).  A split is
``<data_path>/<postfix>/sequences/<sequence>/<frame>.png`` with one label
file per sequence, ``<postfix>/labels/<sequence>.txt``: comma-separated
rows of a frame index and the unit gaze vector.  Sequences and their
frames are walked sorted; the index column is dropped and the labels cast
to float32; a test-split label file may hold 5 rows more than its frames
(reference ``:399``).  The label files are parsed without pandas, with a
correctly rounded float parse (``np.loadtxt``).  Frames decode to uint8
through ``data/native_loader.py``, one sequence ahead of the consumer on a
background thread.

``load_data_openeds2020(extract_feature=True)`` runs the features on the
device in chunks: the B7 U-Net (``dw_conv_bn_silu`` kernel on a CUDA
device) then the 19 eye landmarks for estimator 1, or the ResNet50 trunk's
2048 features of the gray frame repeated to RGB for estimator 2.
:func:`stream_openeds2020` yields batches with the JAX function's order,
shuffle buffer and ``valid`` mask, holding a bounded number of frames.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.efficientnet import EfficientNet
from ..models.resnet import ResNet50
from ..ops.ellipse import extract_eye_landmarks
from ..ops.image import to_unit_float
from ..utils.decode import image_size
from .native_loader import decode_gray_batch
from .prefetch import background


def _sequence_index(data_path: str, postfix: str, max_sequences: int | None = None):
    """(per-sequence frame paths, per-sequence (n, 3) float32 labels),
    without decoding a frame."""
    seq_dir = os.path.join(data_path, postfix, "sequences")
    sequence_names = sorted(os.listdir(seq_dir))
    if max_sequences:
        sequence_names = sequence_names[:max_sequences]
    seq_paths, labels = [], []
    for name in sequence_names:
        img_names = sorted(os.listdir(os.path.join(seq_dir, name)))
        rows = np.loadtxt(os.path.join(data_path, postfix, "labels", name + ".txt"), delimiter=",",
                          dtype=np.float64, ndmin=2)
        label = rows[:, 1:].astype(np.float32)
        if len(img_names) not in (len(label), len(label) - 5):
            raise ValueError(f"sequence {name} of {postfix}: {len(img_names)} frames but {len(label)} label rows")
        labels.append(label[: len(img_names)])
        seq_paths.append([os.path.join(seq_dir, name, n) for n in img_names])
    return seq_paths, labels


def load_labels_openeds2020(data_path: str, postfix: str = "test/", max_sequences: int | None = None) -> np.ndarray:
    """All gaze labels of a split as one (N, 3) float32 array, no decode."""
    return np.concatenate(_sequence_index(data_path, postfix, max_sequences)[1])


def _extractor(estimator: int, efficientnet_params, resnet_params, compute_dtype):
    """The feature program on (B, H, W, 1) uint8 frames on the device."""
    if estimator == 1:
        if efficientnet_params is None:
            raise ValueError("estimator 1's features need efficientnet_params")
        return lambda b: extract_eye_landmarks(EfficientNet.apply(efficientnet_params, to_unit_float(b),
                                                                  compute_dtype=compute_dtype))
    if resnet_params is None:
        raise ValueError("estimator 2's features need resnet_params")
    return lambda b: ResNet50.apply(resnet_params, to_unit_float(b).repeat_interleave(3, dim=-1),
                                    compute_dtype=compute_dtype)


@torch.no_grad()
def load_data_openeds2020(
    extract_feature: bool,
    estimator: int = 1,
    data_path: str = "../data/openeds2020/openEDS2020-GazePrediction/",
    postfix: str = "test/",
    efficientnet_params: dict | None = None,
    resnet_params: dict | None = None,
    chunk: int = 32,
    max_sequences: int | None = None,
    compute_dtype=None,
    device="cpu",
) -> tuple[np.ndarray, np.ndarray]:
    """(frames or features, (N, 3) gaze labels): frames (N, H, W, 1)
    uint8, or features computed on ``device`` in chunks of ``chunk``
    frames, (N, 19) landmarks (estimator 1) or (N, 2048) ResNet50 features
    (estimator 2).  ``compute_dtype`` defaults to float32."""
    seq_paths, labels = _sequence_index(data_path, postfix, max_sequences)
    h, w = image_size(seq_paths[0][0])
    decoded = background((decode_gray_batch(p, h, w, dtype=np.uint8) for p in seq_paths), size=2)
    if not extract_feature:
        return np.concatenate(list(decoded)), np.concatenate(labels)

    extract = _extractor(estimator, efficientnet_params, resnet_params, compute_dtype or torch.float32)
    feats: list[torch.Tensor] = []
    pending: list[np.ndarray] = []

    def flush(final: bool) -> None:
        frames = np.concatenate(pending)
        n = len(frames) if final else len(frames) // chunk * chunk
        for i in range(0, n, chunk):
            feats.append(extract(torch.from_numpy(frames[i : i + chunk]).to(device)))
        pending[:] = [frames[n:]] if n < len(frames) else []

    for frames in decoded:
        pending.append(frames)
        if sum(len(p) for p in pending) >= 4 * chunk:
            flush(final=False)
    if pending:
        flush(final=True)
    return torch.cat(feats).float().cpu().numpy(), np.concatenate(labels)


def stream_openeds2020(
    data_path: str,
    postfix: str = "test/",
    batch_size: int = 128,
    max_sequences: int | None = None,
    shuffle_seed: int | None = None,
    drop_remainder: bool = False,
    buffer_batches: int = 4,
    stats: dict | None = None,
):
    """Yield a split as (frames (B, H, W, 1) uint8, labels (B, 3), valid
    (B,)) batches, holding at most ``buffer_batches`` batches plus a
    sequence in the shuffle buffer and one sequence decoded ahead.

    With ``shuffle_seed`` the sequences come in ``np.random.default_rng(
    shuffle_seed)`` order and each batch is a uniform draw without
    replacement from the buffer (pass ``seed + epoch`` per epoch); without
    it, in order (FIFO).  The last short batch is padded by repeating its
    last row, with ``valid`` marking the real rows, or dropped with
    ``drop_remainder``.  ``stats["peak_buffer_frames"]``, when ``stats``
    is given, records the buffer's largest size."""
    seq_paths, labels = _sequence_index(data_path, postfix, max_sequences)
    if not seq_paths:
        return
    rng = np.random.default_rng(shuffle_seed) if shuffle_seed is not None else None
    order = list(range(len(seq_paths)))
    if rng is not None:
        rng.shuffle(order)
    h, w = image_size(seq_paths[0][0])
    buf_imgs: list[np.ndarray] = []
    buf_labs: list[np.ndarray] = []
    hold = max(buffer_batches, 1) * batch_size

    def note_peak():
        if stats is not None:
            stats["peak_buffer_frames"] = max(stats.get("peak_buffer_frames", 0), len(buf_imgs))

    def take_batch():
        if rng is not None:
            picks = np.sort(rng.choice(len(buf_imgs), size=batch_size, replace=False))[::-1]
            imgs = np.stack([buf_imgs[i] for i in picks])
            labs = np.stack([buf_labs[i] for i in picks])
            for i in picks:  # descending, so the indices stay valid
                buf_imgs.pop(i)
                buf_labs.pop(i)
            return imgs, labs
        imgs, labs = np.stack(buf_imgs[:batch_size]), np.stack(buf_labs[:batch_size])
        del buf_imgs[:batch_size], buf_labs[:batch_size]
        return imgs, labs

    def drain(final: bool):
        floor = 0 if final else hold
        while len(buf_imgs) >= max(batch_size, floor + (0 if final else 1)):
            imgs, labs = take_batch()
            yield imgs, labs, np.ones(batch_size, bool)
        if final and buf_imgs and not drop_remainder:
            n, pad = len(buf_imgs), batch_size - len(buf_imgs)
            imgs = np.stack(buf_imgs + [buf_imgs[-1]] * pad)
            labs = np.stack(buf_labs + [buf_labs[-1]] * pad)
            valid = np.zeros(batch_size, bool)
            valid[:n] = True
            buf_imgs.clear()
            buf_labs.clear()
            yield imgs, labs, valid

    decoded = ((si, decode_gray_batch(seq_paths[si], h, w, dtype=np.uint8)) for si in order)
    for si, frames in background(decoded, size=1):
        buf_imgs.extend(frames)
        buf_labs.extend(labels[si])
        note_peak()
        yield from drain(final=False)
    note_peak()
    yield from drain(final=True)
