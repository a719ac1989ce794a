"""``paddle_tpu_torch.vision.transforms`` and ``.datasets`` against
``paddle_tpu.vision``'s on the CPU.

Every transform and functional runs on the same seeded HWC uint8 image
in both packages, numpy's global generator seeded the same before each
(the random transforms draw from it): outputs equal exactly (the same
numpy code on the host), ``ToTensor`` / ``Normalize`` on Tensors within
1e-6 (f32). Every dataset class reads files the test writes (gzipped IDX
for MNIST, ``.npy`` folders for DatasetFolder / ImageFolder) or makes
the synthetic fallback, equal to the JAX package's. The port's Cifar10 /
Cifar100 also read a python-pickle tarball the test writes (the JAX
classes ignore the file), checked against what was written.
"""
import gzip
import io
import pickle
import struct
import tarfile

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.vision import datasets as jds
from paddle_tpu.vision import transforms as jtf
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.vision import datasets as tds
from paddle_tpu_torch.vision import transforms as ttf
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

IMG = np.random.default_rng(41).integers(0, 256, (20, 24, 3), dtype=np.uint8)
MEAN, STD = [123.7, 116.3, 103.5], [58.4, 57.1, 57.4]


@pytest.fixture(autouse=True)
def on_cpu():
    old = tdevice._current[0]
    paddle_tpu_torch.set_device("cpu")
    yield
    tdevice._current[0] = old


def _plain(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _both(make, img=IMG, seed=0):
    outs = []
    for mod in (jtf, ttf):
        np.random.seed(seed)
        outs.append(_plain(make(mod)(img)))
    return outs


def _same(outs, tol=0.0):
    a, b = outs
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    if tol:
        np.testing.assert_allclose(b, a, rtol=0, atol=tol)
    else:
        np.testing.assert_array_equal(a, b)


TRANSFORMS = {
    "Resize": lambda m: m.Resize((11, 13)),
    "Resize_short": lambda m: m.Resize(12, interpolation="nearest"),
    "CenterCrop": lambda m: m.CenterCrop(9),
    "RandomCrop": lambda m: m.RandomCrop(10, padding=2),
    "RandomHorizontalFlip": lambda m: m.RandomHorizontalFlip(0.7),
    "RandomVerticalFlip": lambda m: m.RandomVerticalFlip(0.7),
    "Transpose": lambda m: m.Transpose(),
    "Pad": lambda m: m.Pad([1, 2], fill=7),
    "RandomResizedCrop": lambda m: m.RandomResizedCrop(16),
    "BrightnessTransform": lambda m: m.BrightnessTransform(0.4),
    "ContrastTransform": lambda m: m.ContrastTransform(0.4),
    "SaturationTransform": lambda m: m.SaturationTransform(0.4),
    "HueTransform": lambda m: m.HueTransform(0.3),
    "ColorJitter": lambda m: m.ColorJitter(0.3, 0.3, 0.3, 0.1),
    "Grayscale": lambda m: m.Grayscale(3),
    "RandomRotation": lambda m: m.RandomRotation(30),
    "Compose": lambda m: m.Compose([m.RandomResizedCrop(14),
                                    m.RandomHorizontalFlip(),
                                    m.Normalize(MEAN, STD,
                                                data_format="HWC")]),
    "resize": lambda m: lambda x: m.resize(x, (7, 9)),
    "hflip": lambda m: m.hflip,
    "vflip": lambda m: m.vflip,
    "center_crop": lambda m: lambda x: m.center_crop(x, (8, 10)),
    "crop": lambda m: lambda x: m.crop(x, 2, 3, 9, 7),
    "adjust_brightness": lambda m: lambda x: m.adjust_brightness(x, 1.3),
    "adjust_contrast": lambda m: lambda x: m.adjust_contrast(x, 0.6),
    "adjust_hue": lambda m: lambda x: m.adjust_hue(x, -0.2),
    "pad_reflect": lambda m: lambda x: m.pad(x, (1, 2, 3, 4), 0, "reflect"),
    "pad_edge": lambda m: lambda x: m.pad(x, 2, 0, "edge"),
    "rotate": lambda m: lambda x: m.rotate(x, 17, "bilinear", expand=True),
    "to_grayscale": lambda m: m.to_grayscale,
    "normalize_hwc": lambda m: lambda x: m.normalize(
        x.astype("float32"), MEAN, STD, data_format="HWC"),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_equals_jax(name):
    _same(_both(TRANSFORMS[name]))


@pytest.mark.parametrize("fmt", ["CHW", "HWC"])
def test_to_tensor_and_normalize_tensor(fmt):
    outs = []
    for mod, pkg in ((jtf, paddle_tpu), (ttf, paddle_tpu_torch)):
        t = mod.ToTensor(data_format=fmt)(IMG)
        assert isinstance(t, pkg.Tensor)
        n = mod.Normalize(0.5, 0.25, data_format=fmt)(t)
        assert isinstance(n, pkg.Tensor)
        outs.append((_plain(t), _plain(n), _plain(mod.to_tensor(IMG[..., 0]))))
    for a, b in zip(*outs):
        _same((a, b), 1e-6)


def test_every_name_resolves():
    assert set(jtf.__all__) <= set(dir(ttf))
    assert set(jds.__all__) <= set(dir(tds))
    for name in ("MNIST", "FashionMNIST", "Cifar10", "Cifar100",
                 "set_image_backend", "get_image_backend", "ops",
                 "transforms", "datasets"):
        assert hasattr(paddle_tpu_torch.vision, name)
    assert paddle_tpu_torch.vision.get_image_backend() == \
        paddle_tpu.vision.get_image_backend()


def _write_idx(tmp_path, images, labels):
    ip, lp = tmp_path / "img.gz", tmp_path / "lab.gz"
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, *images.shape) + images.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, len(labels)) + labels.tobytes())
    return str(ip), str(lp)


def _items(ds, idx=(0, 3)):
    return [(np.asarray(ds[i][0]), np.asarray(ds[i][1])) for i in idx]


@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST"])
def test_mnist_reads_idx_files(tmp_path, cls):
    rng = np.random.default_rng(42)
    images = rng.integers(0, 256, (5, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, 5).astype(np.uint8)
    paths = _write_idx(tmp_path, images, labels)
    j, t = (getattr(m, cls)(*paths, mode="test") for m in (jds, tds))
    assert len(t) == len(j) == 5
    for (ja, jl), (ta, tl) in zip(_items(j), _items(t)):
        np.testing.assert_array_equal(ja, ta)
        np.testing.assert_array_equal(jl, tl)
    tt = getattr(tds, cls)(*paths, transform=ttf.ToTensor())
    assert tuple(tt[1][0].shape) == (1, 28, 28)


@pytest.mark.parametrize("cls", ["MNIST", "Cifar10", "Cifar100", "Flowers"])
def test_synthetic_fallback_equals_jax(cls):
    j, t = (getattr(m, cls)(mode="test") for m in (jds, tds))
    assert len(j) == len(t)
    for (ja, jl), (ta, tl) in zip(_items(j, (0, 9999)), _items(t, (0, 9999))):
        np.testing.assert_array_equal(ja, ta)
        np.testing.assert_array_equal(jl, tl)


@pytest.mark.parametrize("cls,members,key", [
    ("Cifar10", ("data_batch_1", "data_batch_2", "test_batch"), b"labels"),
    ("Cifar100", ("train", "test"), b"fine_labels")])
def test_cifar_reads_the_tarball(tmp_path, cls, members, key):
    rng = np.random.default_rng(43)
    path = tmp_path / "cifar.tar.gz"
    written = {}
    with tarfile.open(path, "w:gz") as tar:
        for name in members:
            data = rng.integers(0, 256, (3, 3072), dtype=np.uint8)
            labels = [int(v) for v in rng.integers(0, 10, 3)]
            written[name] = (data, labels)
            raw = pickle.dumps({b"data": data, key: labels})
            info = tarfile.TarInfo(f"cifar/{name}")
            info.size = len(raw)
            tar.addfile(info, io.BytesIO(raw))
    train = getattr(tds, cls)(str(path), mode="train")
    test = getattr(tds, cls)(str(path), mode="test",
                             transform=ttf.Normalize(0.0, 255.0, "HWC"))
    want = [written[m] for m in members if "test" not in m]
    assert len(train) == 3 * len(want) and len(test) == 3
    img, lab = train[3 if len(want) > 1 else 0]
    data, labels = want[1] if len(want) > 1 else want[0]
    np.testing.assert_allclose(img, data[0].reshape(3, 32, 32) / 255.0,
                               rtol=0, atol=1e-7)
    assert int(lab[0]) == labels[0]
    img_t, _ = test[2]
    tdata = written[[m for m in members if "test" in m][0]][0]
    np.testing.assert_allclose(
        img_t, tdata[2].reshape(3, 32, 32).transpose(1, 2, 0) / 255.0,
        rtol=0, atol=1e-6)


def test_dataset_and_image_folder(tmp_path):
    rng = np.random.default_rng(44)
    for c in ("cat", "dog"):
        (tmp_path / "tree" / c).mkdir(parents=True)
        for i in range(3):
            np.save(tmp_path / "tree" / c / f"{i}.npy",
                    rng.integers(0, 256, (6, 5, 3), dtype=np.uint8))
    (tmp_path / "flat").mkdir()
    for i in range(4):
        np.save(tmp_path / "flat" / f"{i}.npy",
                rng.integers(0, 256, (6, 5, 3), dtype=np.uint8))
    (tmp_path / "flat" / "skip.txt").write_text("x")
    tf = (lambda m: m.Compose([m.CenterCrop(4), m.ToTensor()]))
    for cls, root in (("DatasetFolder", "tree"), ("ImageFolder", "flat")):
        j = getattr(jds, cls)(str(tmp_path / root), transform=tf(jtf))
        t = getattr(tds, cls)(str(tmp_path / root), transform=tf(ttf))
        assert len(j) == len(t) > 0
        for i in range(len(j)):
            for a, b in zip(j[i], t[i]):
                np.testing.assert_allclose(_plain(b), _plain(a), rtol=0,
                                           atol=1e-7)
    assert tds.DatasetFolder(str(tmp_path / "tree")).class_to_idx == {
        "cat": 0, "dog": 1}
