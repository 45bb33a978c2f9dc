"""Datasets (port of the JAX package's ``data/datasets.py``;
reference workloads/deit/datasets.py build_dataset): IMNET folder trees,
CIFAR-10/100 from the extracted python-version pickles (no torchvision
dependency), and latent-npz datasets for DiT training.  Host-side numpy;
the pickles and npz files are read only from paths the caller names.
"""

from __future__ import annotations

import os
import pickle
from typing import Iterator, Optional, Tuple

import numpy as np

CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)


def load_cifar(root: str, train: bool = False, cifar100: bool = False
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Load CIFAR from the extracted python-version directory
    (cifar-10-batches-py / cifar-100-python).  Returns (NCHW fp32
    normalized, labels)."""
    if cifar100:
        d = os.path.join(root, "cifar-100-python",
                         "train" if train else "test")
        with open(d, "rb") as f:
            batch = pickle.load(f, encoding="bytes")
        data = batch[b"data"]
        labels = np.asarray(batch[b"fine_labels"], np.int64)
    else:
        base = os.path.join(root, "cifar-10-batches-py")
        files = ([f"data_batch_{i}" for i in range(1, 6)] if train
                 else ["test_batch"])
        datas, labels_list = [], []
        for fn in files:
            with open(os.path.join(base, fn), "rb") as f:
                batch = pickle.load(f, encoding="bytes")
            datas.append(batch[b"data"])
            labels_list.extend(batch[b"labels"])
        data = np.concatenate(datas)
        labels = np.asarray(labels_list, np.int64)
    imgs = data.reshape(-1, 3, 32, 32).astype(np.float32) / 255.0
    imgs = (imgs - CIFAR_MEAN.reshape(1, 3, 1, 1)) / \
        CIFAR_STD.reshape(1, 3, 1, 1)
    return imgs, labels


def build_dataset(data_set: str, data_path: str, is_train: bool = False,
                  batch_size: int = 100, img_size: int = 224,
                  limit: Optional[int] = None
                  ) -> Tuple[Iterator, int]:
    """(batch iterator, num_classes) — reference build_dataset contract."""
    if data_set == "IMNET":
        from .imagenet import iterate_imagenet
        split = "train" if is_train else "val"
        path = os.path.join(data_path, split) \
            if os.path.isdir(os.path.join(data_path, split)) else data_path
        return iterate_imagenet(path, batch_size, img_size,
                                limit=limit), 1000
    if data_set in ("CIFAR", "CIFAR10", "CIFAR100"):
        imgs, labels = load_cifar(data_path, train=is_train,
                                  cifar100=data_set == "CIFAR100")
        if limit:
            imgs, labels = imgs[:limit], labels[:limit]

        def it():
            for i in range(0, len(imgs), batch_size):
                yield imgs[i:i + batch_size], labels[i:i + batch_size]
        return it(), (100 if data_set == "CIFAR100" else 10)
    raise ValueError(f"Unknown dataset {data_set}")


def latent_npz_dataset(path: str, batch_size: int) -> Iterator:
    """Iterate (latents, labels) from an npz holding "latents" and "labels"
    (DiT training on precomputed VAE latents), forever: each pass a
    permutation from numpy's global generator, in whole batches."""
    z = np.load(path)
    lat, lab = z["latents"], z["labels"]
    while True:
        perm = np.random.permutation(len(lat))
        for i in range(0, len(perm) - batch_size + 1, batch_size):
            sel = perm[i:i + batch_size]
            yield lat[sel], lab[sel]
