"""Datasets, the counterpart of ``dsml_tpu/utils/data.py``: MNIST IDX
parsing, host-side batch iterators and synthetic workloads, all numpy.

The repo's MNIST mirror lacks the 60k-image training blob, so
:func:`load_mnist` carves a train/test split out of the 10k test set (and
can augment it with pixel shifts); real train images are used when present
at ``data/mnist/train-images-idx3-ubyte.gz``. Batches are numpy arrays; a
trainer moves each one to its device.

The native C++ loader (``shard_batches(native=True)``) and the prose corpus
built from library docstrings are not ported yet.
"""

from __future__ import annotations

import gzip
import os
import queue
import struct
import threading
from dataclasses import dataclass

import numpy as np

from dsml_tpu_torch.utils.logging import get_logger

__all__ = [
    "Dataset", "load_mnist", "synthetic_classification", "prefetch_batches", "shard_batches",
    "lm_window_batches", "carve_lm_eval_split",
]

log = get_logger("data")

_IMAGES_MAGIC = 2051
_LABELS_MAGIC = 2049


def _read_idx(path: str) -> np.ndarray:
    """Parse one (gzipped) IDX file of images or labels."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        blob = f.read()
    magic, count = struct.unpack(">II", blob[:8])
    if magic == _IMAGES_MAGIC:
        rows, cols = struct.unpack(">II", blob[8:16])
        return np.frombuffer(blob, np.uint8, count * rows * cols, 16).reshape(count, rows, cols)
    if magic == _LABELS_MAGIC:
        return np.frombuffer(blob, np.uint8, count, 8)
    raise ValueError(f"{path}: unknown IDX magic {magic}")


@dataclass
class Dataset:
    train_x: np.ndarray  # [N, ...] float32 in [0, 1]
    train_y: np.ndarray  # [N] int32
    test_x: np.ndarray
    test_y: np.ndarray

    @property
    def n_train(self) -> int:
        return self.train_x.shape[0]


def load_mnist(
    data_dir: str = "data/mnist",
    flatten: bool = True,
    augment_fallback: bool = True,
    holdout: int = 2000,
) -> Dataset:
    """Load MNIST; without the 60k train images, split t10k into
    ``10000 - holdout`` train and ``holdout`` test images (see the module
    docstring)."""
    train_images = os.path.join(data_dir, "train-images-idx3-ubyte.gz")
    test_x = _read_idx(os.path.join(data_dir, "t10k-images-idx3-ubyte.gz"))
    test_y = _read_idx(os.path.join(data_dir, "t10k-labels-idx1-ubyte.gz"))
    if os.path.exists(train_images):
        train_x = _read_idx(train_images)
        train_y = _read_idx(os.path.join(data_dir, "train-labels-idx1-ubyte.gz"))
    else:
        log.warning(
            "train-images blob absent; splitting t10k %d/%d train/test%s",
            test_x.shape[0] - holdout, holdout, " with shift augmentation" if augment_fallback else "",
        )
        train_x, train_y = test_x[:-holdout], test_y[:-holdout]
        test_x, test_y = test_x[-holdout:], test_y[-holdout:]
        if augment_fallback:
            train_x, train_y = _augment_shifts(train_x, train_y)

    def prep(x):
        x = x.astype(np.float32) / 255.0
        return x.reshape(x.shape[0], -1) if flatten else x[..., None]

    return Dataset(prep(train_x), train_y.astype(np.int32), prep(test_x), test_y.astype(np.int32))


def _augment_shifts(x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """5× the data with ±1-pixel translations (label-preserving)."""
    shifted = [x]
    for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        s = np.roll(x, (dy, dx), axis=(1, 2))
        # zero the wrapped edge
        if dy == 1:
            s[:, 0, :] = 0
        elif dy == -1:
            s[:, -1, :] = 0
        if dx == 1:
            s[:, :, 0] = 0
        elif dx == -1:
            s[:, :, -1] = 0
        shifted.append(s)
    return np.concatenate(shifted), np.tile(y, len(shifted))


def synthetic_classification(
    n: int, features: int, classes: int = 10, seed: int = 0, image_shape: tuple | None = None
) -> Dataset:
    """Separable-ish synthetic data (class centres plus unit noise): the
    loss must drop fast on it, which makes it the trainer's canary."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((classes, features)).astype(np.float32) * 2.0
    y = rng.integers(0, classes, size=n).astype(np.int32)
    x = centers[y] + rng.standard_normal((n, features)).astype(np.float32)
    if image_shape is not None:
        x = x.reshape(n, *image_shape)
    split = max(1, int(n * 0.9))
    return Dataset(x[:split], y[:split], x[split:], y[split:])


def prefetch_batches(iterator, depth: int = 2):
    """Run ``iterator`` in a background thread, keeping up to ``depth``
    batches ready, so host-side batch assembly overlaps device compute. An
    exception in the iterator is raised on the consumer's side; a consumer
    that stops early stops the thread."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        # never block forever: a consumer that abandoned the generator must
        # not pin the thread and `depth` batches of host memory
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item):
                    return
            put(end)
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer side
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def shard_batches(
    x: np.ndarray,
    y: np.ndarray,
    batch_size: int,
    seed: int | None = None,
    drop_remainder: bool = True,
    native: bool | None = None,
):
    """Yield (x_batch, y_batch) host batches, shuffled per epoch by
    ``np.random.default_rng(seed)`` (the JAX package's order). The batch is
    the GLOBAL batch. ``native=True`` (the C++ loader) raises: it comes with
    the runtime slice; ``None`` and ``False`` take the numpy path."""
    if native:
        raise NotImplementedError(
            "the native C++ batch loader (runtime/native.py) comes with the "
            "control-plane and runtime slice"
        )
    n = x.shape[0]
    idx = np.arange(n)
    if seed is not None:
        np.random.default_rng(seed).shuffle(idx)
    end = (n // batch_size) * batch_size if drop_remainder else n
    for start in range(0, end, batch_size):
        sel = idx[start : start + batch_size]
        yield x[sel], y[sel]


def lm_window_batches(
    tokens: np.ndarray,
    seq_len: int,
    batch_size: int,
    seed: int = 0,
    steps: int | None = None,
):
    """Yield (x, y) next-token LM batches: ``batch_size`` random windows of
    ``seq_len`` tokens, y = x shifted one token left, int32. ``steps=None``
    streams forever."""
    tokens = np.asarray(tokens)
    if len(tokens) < seq_len + 1:
        raise ValueError(f"corpus of {len(tokens)} tokens too small for seq_len={seq_len}")
    rng = np.random.default_rng(seed)
    produced = 0
    while steps is None or produced < steps:
        # a start s is valid iff s + seq_len + 1 <= len, so the exclusive
        # high is len - seq_len: the corpus's last token is a target
        starts = rng.integers(0, len(tokens) - seq_len, size=batch_size)
        x = np.stack([tokens[s : s + seq_len] for s in starts])
        y = np.stack([tokens[s + 1 : s + seq_len + 1] for s in starts])
        yield x.astype(np.int32), y.astype(np.int32)
        produced += 1


def carve_lm_eval_split(
    tokens: np.ndarray, seq_len: int, batch_size: int, frac: float = 0.05
) -> tuple[np.ndarray, np.ndarray | None]:
    """Split a token stream into (train, eval) tails for held-out loss.
    Returns ``(tokens, None)`` when the corpus is too small to carve
    ``frac`` (or one batch of windows) without starving training."""
    tokens = np.asarray(tokens)
    carve = max((seq_len + 1) * batch_size, int(len(tokens) * frac), seq_len + 2)
    if carve > len(tokens) // 4 or len(tokens) - carve <= seq_len + 1:
        return tokens, None
    split = len(tokens) - carve
    return tokens[:split], tokens[split:]
