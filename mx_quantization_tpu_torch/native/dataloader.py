"""ctypes wrapper and double-buffered iterator of the native batch decoder
(``dataloader.cpp``): the JAX package's ``native/dataloader.py``, with its
signatures and values.

Each JPEG is decoded with libjpeg, its short side resized bilinearly to
img_size / 0.875, centre-cropped to img_size, normalized with the ImageNet
mean and std and laid out CHW, on a pool of C++ threads.  A file that does
not decode (not a JPEG, unreadable) gives zeros and ok = 0.
"""

from __future__ import annotations

import ctypes
import queue
import threading
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from .build import build_and_load

_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


def load():
    """The built decoder's C function, its argument types declared."""
    lib = build_and_load("mxdataloader", "dataloader.cpp", ("jpeg",))
    fn = lib.mx_decode_batch
    f32 = ctypes.POINTER(ctypes.c_float)
    fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                   ctypes.c_int, f32, f32, f32,
                   ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    fn.restype = None
    return fn


def decode_batch(paths: Sequence[str], img_size: int = 224,
                 threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Decode ``paths`` -> ((N, 3, S, S) float32, ok mask (N,) uint8);
    ``threads`` 0 takes the host's hardware concurrency."""
    fn = load()
    n = len(paths)
    out = np.empty((n, 3, img_size, img_size), np.float32)
    ok = np.empty((n,), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    f32 = ctypes.POINTER(ctypes.c_float)
    fn(arr, n, img_size, _MEAN.ctypes.data_as(f32), _STD.ctypes.data_as(f32),
       out.ctypes.data_as(f32),
       ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), threads)
    return out, ok


def iterate(paths: List[str], labels: List[int], batch_size: int,
            img_size: int, prefetch: int = 2
            ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Double-buffered batches (images, labels int64): a producer thread
    decodes batch i + 1 while the consumer computes on batch i."""
    load()  # build before the producer starts (raises early on failure)
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)

    def producer():
        try:
            for i in range(0, len(paths), batch_size):
                imgs, _ = decode_batch(paths[i:i + batch_size], img_size)
                q.put((imgs, np.asarray(labels[i:i + batch_size], np.int64)))
        finally:
            q.put(None)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is None:
            return
        yield item
