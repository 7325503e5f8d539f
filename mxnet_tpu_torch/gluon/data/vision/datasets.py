"""Vision datasets (counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``; the reference's
python/mxnet/gluon/data/vision/datasets.py).

Datasets read local files only: idx-ubyte for the MNIST family (the format
the reference's src/io/iter_mnist.cc parses) and the CIFAR binary batches.
``download()`` is unavailable; pass ``root`` to local copies, or use
``SyntheticImageDataset``. Items are host numpy (the DataLoader uploads
once per batch, and forked workers must not touch CUDA).
"""
from __future__ import annotations

import gzip
import os
import struct
from typing import Optional

import numpy as onp

from ....base import MXNetError
from ..dataset import ArrayDataset, Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "SyntheticImageDataset", "ImageRecordDataset",
           "ImageFolderDataset", "ImageListDataset"]


def _read_idx(path: str) -> onp.ndarray:
    """Parse idx-ubyte (reference iter_mnist.cc:257 ReadInt/magic logic)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        data = onp.frombuffer(f.read(), dtype=onp.uint8)
        return data.reshape(dims)


class MNIST(Dataset):
    """MNIST from local idx files (reference data.vision.MNIST)."""

    _files = {
        True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    }

    def __init__(self, root: str = "~/.mxnet/datasets/mnist", train: bool = True,
                 transform=None):
        root = os.path.expanduser(root)
        img_name, lbl_name = self._files[train]
        img_path = self._find(root, img_name)
        lbl_path = self._find(root, lbl_name)
        self._images = _read_idx(img_path).reshape(-1, 28, 28, 1)
        self._labels = _read_idx(lbl_path).astype(onp.int32)
        self._transform = transform

    @staticmethod
    def _find(root: str, name: str) -> str:
        for cand in (os.path.join(root, name), os.path.join(root, name + ".gz")):
            if os.path.exists(cand):
                return cand
        raise MXNetError(
            f"{name} not found under {root}. Datasets read local files only "
            "(download() is not available); place the idx files there (or use "
            "SyntheticImageDataset for smoke tests).")

    def __len__(self):
        return len(self._labels)

    def __getitem__(self, idx):
        # host numpy per sample: the DataLoader uploads once per BATCH, and
        # forked workers must not touch the device runtime
        img = self._images[idx]
        lbl = int(self._labels[idx])
        if self._transform is not None:
            return self._transform(img, lbl)
        return img, lbl


class FashionMNIST(MNIST):
    def __init__(self, root: str = "~/.mxnet/datasets/fashion-mnist",
                 train: bool = True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(Dataset):
    """CIFAR-10 from local binary batches (reference data.vision.CIFAR10)."""

    def __init__(self, root: str = "~/.mxnet/datasets/cifar10", train: bool = True,
                 transform=None):
        root = os.path.expanduser(root)
        files = [f"data_batch_{i}.bin" for i in range(1, 6)] if train \
            else ["test_batch.bin"]
        images, labels = [], []
        for name in files:
            path = os.path.join(root, name)
            if not os.path.exists(path):
                path2 = os.path.join(root, "cifar-10-batches-bin", name)
                if os.path.exists(path2):
                    path = path2
                else:
                    raise MXNetError(
                        f"{name} not found under {root} (local files only; "
                        "place files locally)")
            raw = onp.fromfile(path, dtype=onp.uint8).reshape(-1, 3073)
            labels.append(raw[:, 0].astype(onp.int32))
            images.append(raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        self._images = onp.concatenate(images)
        self._labels = onp.concatenate(labels)
        self._transform = transform

    def __len__(self):
        return len(self._labels)

    def __getitem__(self, idx):
        # host numpy per sample: the DataLoader uploads once per BATCH, and
        # forked workers must not touch the device runtime
        img = self._images[idx]
        lbl = int(self._labels[idx])
        if self._transform is not None:
            return self._transform(img, lbl)
        return img, lbl


class CIFAR100(CIFAR10):
    def __init__(self, root: str = "~/.mxnet/datasets/cifar100", train: bool = True,
                 fine_label: bool = True, transform=None):
        root = os.path.expanduser(root)
        name = "train.bin" if train else "test.bin"
        path = os.path.join(root, name)
        if not os.path.exists(path):
            raise MXNetError(f"{name} not found under {root}")
        raw = onp.fromfile(path, dtype=onp.uint8).reshape(-1, 3074)
        self._labels = raw[:, 1 if fine_label else 0].astype(onp.int32)
        self._images = raw[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self._transform = transform


class SyntheticImageDataset(Dataset):
    """Deterministic synthetic images for smoke tests and benchmarks
    (stands in for downloaded sets)."""

    def __init__(self, num_samples: int = 1024, shape=(28, 28, 1),
                 num_classes: int = 10, seed: int = 0, transform=None):
        rng = onp.random.RandomState(seed)
        self._images = rng.randint(0, 256, size=(num_samples,) + tuple(shape),
                                   ).astype(onp.uint8)
        self._labels = rng.randint(0, num_classes, size=(num_samples,)).astype(onp.int32)
        self._transform = transform

    def __len__(self):
        return len(self._labels)

    def __getitem__(self, idx):
        # host numpy per sample: the DataLoader uploads once per BATCH, and
        # forked workers must not touch the device runtime
        img = self._images[idx]
        lbl = int(self._labels[idx])
        if self._transform is not None:
            return self._transform(img, lbl)
        return img, lbl


class ImageRecordDataset(Dataset):
    """RecordIO-packed image dataset (reference ImageRecordDataset over
    src/io/iter_image_recordio_2.cc) over records ``io.recordio.pack_img``
    wrote (either package's). Each process reads through its own file
    handle, so forked DataLoader workers read their own records."""

    def __init__(self, filename: str, flag: int = 1, transform=None):
        from ....io.recordio import unpack_img
        self._filename = filename
        self._idx_path = os.path.splitext(filename)[0] + ".idx"
        self._record = None
        self._pid = -1
        self._keys = list(self._reader().keys)
        self._unpack = unpack_img
        self._transform = transform

    def _reader(self):
        """The index reader of this process: reopened after a fork, as
        ``RecordFileDataset`` does, since forked DataLoader workers would
        otherwise seek and read one shared file offset."""
        if self._record is None or self._pid != os.getpid():
            from ....io.recordio import IndexedRecordIO
            self._record = IndexedRecordIO(self._idx_path, self._filename, "r")
            self._pid = os.getpid()
        return self._record

    def __len__(self):
        return len(self._keys)

    def __getitem__(self, idx):
        record = self._reader().read_idx(self._keys[idx])
        header, img = self._unpack(record)
        if self._transform is not None:
            return self._transform(img, header.label)
        return img, header.label


class ImageFolderDataset(Dataset):
    """Images under class subdirectories (reference vision/datasets.py
    ImageFolderDataset). Decoding uses PIL when present; items are
    (host numpy HWC uint8 image, label int) — the DataLoader uploads per
    batch."""

    def __init__(self, root: str, flag: int = 1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fname in sorted(os.listdir(path)):
                if fname.lower().endswith(
                        (".jpg", ".jpeg", ".png", ".bmp")):
                    self.items.append((os.path.join(path, fname), label))

    def __len__(self):
        return len(self.items)

    def _decode(self, path: str):
        try:
            from PIL import Image
        except ImportError:
            raise MXNetError("ImageFolderDataset needs PIL (Pillow) to "
                             "decode images")
        im = Image.open(path)
        im = im.convert("RGB" if self._flag else "L")
        arr = onp.asarray(im)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr

    def __getitem__(self, idx):
        path, label = self.items[idx]
        img = self._decode(path)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageListDataset(ImageFolderDataset):
    """Images named by a .lst file / list of (index, label, relpath)
    entries (reference vision/datasets.py ImageListDataset)."""

    def __init__(self, root: str = ".", imglist=None, flag: int = 1):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = None
        self.items = []
        labels = set()
        if isinstance(imglist, str):
            entries = []
            with open(imglist) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) >= 3:
                        entries.append((float(parts[1]), parts[-1]))
        else:
            # list form: [label, relpath] per entry (reference
            # vision/datasets.py ImageListDataset)
            entries = [(e[0], e[-1]) for e in (imglist or [])]
        for label, rel in entries:
            labels.add(label)
            self.items.append((os.path.join(self._root, rel), int(label)))
        self.synsets = sorted(labels)
