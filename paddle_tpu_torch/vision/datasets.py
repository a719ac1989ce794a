"""Vision datasets (``paddle_tpu/vision/datasets.py``).

They read files already on disk and never download: ``MNIST`` and
``FashionMNIST`` the gzipped IDX files, ``Cifar10`` and ``Cifar100`` the
python-pickle tarball (``cifar-10-python.tar.gz`` and its CIFAR-100
counterpart), ``DatasetFolder`` and ``ImageFolder`` a directory of
``.npy`` images (or whatever ``loader`` reads). Without a file, each of
the first four makes the JAX package's deterministic synthetic data of
the right shapes (numpy ``RandomState`` 0 for train, 1 for test), as
``Flowers`` always does. The JAX package's Cifar classes make that
synthetic data even when a file is given.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as np

from ..io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "Flowers", "ImageFolder", "DatasetFolder"]


class MNIST(Dataset):
    NUM_CLASSES = 10
    IMAGE_SHAPE = (1, 28, 28)

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.mode = mode
        self.transform = transform
        self.images, self.labels = self._load(image_path, label_path)

    def _load(self, image_path, label_path):
        if image_path and os.path.exists(image_path):
            with gzip.open(image_path, "rb") as f:
                magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
                images = np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows, cols)
            with gzip.open(label_path, "rb") as f:
                struct.unpack(">II", f.read(8))
                labels = np.frombuffer(f.read(), dtype=np.uint8)
            return images, labels.astype(np.int64)
        # synthetic fallback (deterministic)
        n = 60000 if self.mode == "train" else 10000
        rng = np.random.RandomState(0 if self.mode == "train" else 1)
        images = rng.randint(0, 256, size=(n, 28, 28), dtype=np.uint8)
        labels = rng.randint(0, 10, size=(n,)).astype(np.int64)
        return images, labels

    def __getitem__(self, idx):
        img = self.images[idx]
        label = self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32)[None, :, :] / 255.0
        return img, np.asarray([label], dtype=np.int64)

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    NUM_CLASSES = 10
    IMAGE_SHAPE = (3, 32, 32)
    # the tarball's members of each mode, and the label key of a batch
    _MEMBERS = {"train": "data_batch", "test": "test_batch"}
    _LABELS = b"labels"

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.mode = mode
        self.transform = transform
        if data_file and os.path.exists(data_file):
            self.images, self.labels = self._read(data_file)
            return
        n = 50000 if mode == "train" else 10000
        rng = np.random.RandomState(0 if mode == "train" else 1)
        self.images = rng.randint(0, 256, size=(n, 3, 32, 32), dtype=np.uint8)
        self.labels = rng.randint(0, self.NUM_CLASSES, size=(n,)).astype(np.int64)

    def _read(self, data_file):
        """The mode's pickled batches of the tarball, in name order."""
        images, labels = [], []
        with tarfile.open(data_file, mode="r") as tar:
            names = sorted(m.name for m in tar.getmembers()
                           if self._MEMBERS[self.mode] in m.name)
            for name in names:
                batch = pickle.load(tar.extractfile(name), encoding="bytes")
                images.append(np.asarray(batch[b"data"], np.uint8)
                              .reshape(-1, 3, 32, 32))
                labels.append(np.asarray(batch[self._LABELS], np.int64))
        return np.concatenate(images), np.concatenate(labels)

    def __getitem__(self, idx):
        img = self.images[idx]
        label = self.labels[idx]
        if self.transform is not None:
            img = self.transform(img.transpose(1, 2, 0))
        else:
            img = img.astype(np.float32) / 255.0
        return img, np.asarray([label], dtype=np.int64)

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    NUM_CLASSES = 100
    _MEMBERS = {"train": "train", "test": "test"}
    _LABELS = b"fine_labels"


class Flowers(Cifar10):
    NUM_CLASSES = 102


class DatasetFolder(Dataset):
    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.samples = []
        classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        exts = extensions or (".png", ".jpg", ".jpeg", ".bmp", ".npy")
        for c in classes:
            d = os.path.join(root, c)
            for fname in sorted(os.listdir(d)):
                if fname.lower().endswith(tuple(exts)):
                    self.samples.append((os.path.join(d, fname), self.class_to_idx[c]))
        self.loader = loader or self._default_loader

    @staticmethod
    def _default_loader(path):
        if path.endswith(".npy"):
            return np.load(path)
        raise RuntimeError("image decoding requires a loader (no PIL in env)")

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(DatasetFolder):
    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or DatasetFolder._default_loader
        exts = extensions or (".png", ".jpg", ".jpeg", ".bmp", ".npy")
        self.samples = [os.path.join(root, f) for f in sorted(os.listdir(root))
                        if f.lower().endswith(tuple(exts))]

    def __getitem__(self, idx):
        sample = self.loader(self.samples[idx])
        if self.transform is not None:
            sample = self.transform(sample)
        return [sample]

    def __len__(self):
        return len(self.samples)
