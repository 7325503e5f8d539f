"""Port parity of ``mxnet_tpu_torch.gluon.data``, ``gluon.utils`` and
``image`` on the CPU against the JAX package, each fed the same numpy
inputs: the samplers' orders under one ``numpy.random`` seed, the batchify
functions, the ``DataLoader``'s batches with 0 workers, threads, forked
processes and ``pin_memory`` (shared-memory segments unlinked, worker
errors surfaced), the vision datasets from files the tests write (idx,
CIFAR binary, ``.npy`` RecordIO, image folders and lists through PIL),
every transform on host and CPU-tensor inputs against the JAX host and
device paths (``Resize`` up and down), ``image``'s functions and
augmenters, and ``split_data``/``split_and_load``/``clip_global_norm``.

Tolerance: exact everywhere except the resizes: bilinear within 1e-5 of
max(1, |JAX|) (XLA and torch sum the two taps in other orders), integer
images rounded from them within 1 of JAX's; ``clip_global_norm`` within
1e-6 relative."""
import gc
import glob
import hashlib
import os
import random
import struct

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import image as jimage
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon import utils as jutils
from mxnet_tpu.gluon.data.vision import datasets as jds
from mxnet_tpu.gluon.data.vision import transforms as jT
from mxnet_tpu.io import recordio as jrec

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import image as timage
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon import utils as tutils
from mxnet_tpu_torch.gluon.data import batchify as tbatchify
from mxnet_tpu_torch.gluon.data.vision import datasets as tds
from mxnet_tpu_torch.gluon.data.vision import transforms as tT
from mxnet_tpu_torch.io import recordio as trec

RESIZE_TOL = 1e-5


@pytest.fixture(autouse=True)
def on_cpu():
    with mx.cpu():
        yield


def host(x):
    """numpy of an NDArray of either package, a tensor or numpy."""
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return onp.asarray(x)


def same(a, b):
    a, b = host(a), host(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    assert onp.array_equal(a, b)


def same_tree(a, b):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            same_tree(x, y)
    else:
        same(a, b)


# ---------------------------------------------------------------- samplers
def test_samplers_match_jax():
    ds = list(range(23))
    for mod in (jdata, tdata):
        assert list(mod.SequentialSampler(5, start=3)) == [3, 4, 5, 6, 7]
    orders = []
    for mod in (jdata, tdata):
        onp.random.seed(11)
        orders.append([list(mod.RandomSampler(23)) for _ in range(2)]
                      + [list(mod.IntervalSampler(23, 5)), list(mod.IntervalSampler(23, 5, False)),
                         list(mod.FilterSampler(lambda v: v % 3 == 0, ds))])
    assert orders[0] == orders[1]
    for last in ("keep", "discard", "rollover"):
        got = []
        for mod in (jdata, tdata):
            bs = mod.BatchSampler(mod.SequentialSampler(23), 5, last)
            got.append([list(bs), len(bs), list(bs), len(bs)])
        assert got[0] == got[1], last
    with pytest.raises(MXNetError):
        tdata.BatchSampler(tdata.SequentialSampler(3), 2, "bad")


# ---------------------------------------------------------------- batchify
def test_batchify_matches_jax():
    rng = onp.random.RandomState(0)
    fixed = [rng.rand(3, 2).astype("float32") for _ in range(4)]
    ragged = [rng.randint(0, 9, size=(n, 2)).astype("int64") for n in (3, 1, 4, 2)]
    pairs = list(zip(fixed, [int(i) for i in range(4)]))
    for jb, tb in ((jdata.batchify, tbatchify),):
        same(jb.Stack()(fixed), tb.Stack()(fixed))
        for kw in (dict(), dict(axis=0, val=-1), dict(val=2, dtype="float32")):
            same(jb.Pad(**kw)(ragged), tb.Pad(**kw)(ragged))
        same(jb.Pad(axis=1)([a.T for a in ragged]), tb.Pad(axis=1)([a.T for a in ragged]))
        for kw in (dict(), dict(expand=False), dict(batch_axis=1)):
            same_tree(jb.Append(**kw)(ragged), tb.Append(**kw)(ragged))
        same_tree(jb.Group(jb.Stack(), jb.Stack())(pairs), tb.Group(tb.Stack(), tb.Stack())(pairs))
        same_tree(jb.Group([jb.Pad(), jb.AsList()])(list(zip(ragged, "abcd"))[:1])[0],
                  tb.Group([tb.Pad(), tb.AsList()])(list(zip(ragged, "abcd"))[:1])[0])
        assert tb.AsList()(["x", "y"]) == ["x", "y"]
    with pytest.raises(MXNetError, match="fields"):
        tbatchify.Group(tbatchify.Stack())(pairs)
    with pytest.raises(MXNetError, match="rank"):
        tbatchify.Pad()([onp.zeros(2), onp.zeros((2, 2))])
    assert tbatchify.Stack()(fixed)._data.device.type == "cpu"


# -------------------------------------------------------------- DataLoader
MODES = {"inline": dict(), "threads": dict(num_workers=2, prefetch=3),
         "processes": dict(num_workers=3, thread_pool=False),
         "processes_pin": dict(num_workers=2, thread_pool=False, pin_memory=True),
         "threads_pin": dict(num_workers=2, pin_memory=True)}


def _loader_data():
    rng = onp.random.RandomState(3)
    return (rng.rand(37, 3, 2).astype("float32"), rng.randint(0, 5, 37).astype("int32"),
            rng.rand(37).astype("float64"))


def _epochs(mod, ds_kw, kw, epochs=2):
    X, Y, Z = _loader_data()
    onp.random.seed(21)
    loader = mod.DataLoader(mod.ArrayDataset(X, Y, Z), **ds_kw, **kw)
    return [list(loader) for _ in range(epochs)], len(loader)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("ds_kw", [dict(batch_size=8, shuffle=True),
                                   dict(batch_size=8, last_batch="discard"),
                                   dict(batch_size=10, last_batch="rollover")],
                         ids=["shuffle", "discard", "rollover"])
def test_dataloader_batches_match_jax(mode, ds_kw):
    """Every worker mode gives the JAX package's inline batches: values,
    dtypes (float64 stays float64, as under JAX's x64) and order."""
    want, jlen = _epochs(jdata, ds_kw, {})
    got, tlen = _epochs(tdata, ds_kw, MODES[mode])
    assert jlen == tlen and len(got) == len(want)
    for ge, we in zip(got, want):
        assert len(ge) == len(we)
        for g, w in zip(ge, we):
            assert all(isinstance(a, mx.NDArray) and a._data.device.type == "cpu" for a in g)
            same_tree(g, w)


def _segments():
    return set(glob.glob("/dev/shm/mxtorch_*"))


def test_process_workers_unlink_every_segment():
    before = _segments()
    X, Y, _ = _loader_data()
    loader = tdata.DataLoader(tdata.ArrayDataset(X, Y), batch_size=4, num_workers=2,
                              thread_pool=False, prefetch=6)
    assert len(list(loader)) == 10
    it = iter(loader)
    next(it)
    it.close()                        # abandoned mid-epoch: in-flight segments too
    assert _segments() == before
    # a dict sample tree crosses the wire too
    dl = tdata.DataLoader(tdata.SimpleDataset([{"a": onp.full(2, i), "b": i} for i in range(6)]),
                          batch_size=3, num_workers=2, thread_pool=False,
                          batchify_fn=lambda s: {"a": onp.stack([d["a"] for d in s]),
                                                 "b": onp.array([d["b"] for d in s])})
    b = list(dl)
    assert [host(x["a"]).tolist() for x in b] == [[[0, 0], [1, 1], [2, 2]],
                                                  [[3, 3], [4, 4], [5, 5]]]
    assert _segments() == before


class _Marker:
    """Cyclic garbage whose collection leaves a file naming the process."""

    def __init__(self, d):
        self.d, self.me = d, self

    def __del__(self):
        with open(os.path.join(self.d, f"collected_in_{os.getpid()}"), "w"):
            pass


class _Collecting(tdata.Dataset):
    def __len__(self):
        return 4

    def __getitem__(self, i):
        gc.collect()
        return onp.zeros(2, onp.float32)


def test_process_workers_never_collect_inherited_garbage(tmp_path):
    """Cyclic garbage the parent holds when it forks (on the card it may
    hold CUDA tensors, whose release in a child aborts it) is left alone by
    the workers' collections, and collected by the parent afterwards."""
    gc.disable()
    try:
        _Marker(str(tmp_path))
        loader = tdata.DataLoader(_Collecting(), batch_size=2, num_workers=2, thread_pool=False)
        assert len(list(loader)) == 2
        assert os.listdir(tmp_path) == []
    finally:
        gc.enable()
    gc.collect()
    assert os.listdir(tmp_path) == [f"collected_in_{os.getpid()}"]


class _Bad(tdata.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise KeyError("sample 5 is broken")
        return onp.zeros(2, onp.float32)


@pytest.mark.parametrize("mode", ["inline", "threads", "processes"])
def test_worker_error_reaches_consumer(mode):
    """A failing sample's error reaches the consumer after the batches
    before it, in order, whichever worker finished first."""
    loader = tdata.DataLoader(_Bad(), batch_size=2, **MODES[mode])
    it = iter(loader)
    assert [host(next(it)).shape for _ in range(2)] == [(2, 2), (2, 2)]
    with pytest.raises((MXNetError, KeyError), match="sample 5 is broken"):
        list(it)


def test_dataloader_argument_checks():
    ds = tdata.ArrayDataset(onp.zeros(4))
    with pytest.raises(MXNetError, match="batch_size"):
        tdata.DataLoader(ds)
    with pytest.raises(MXNetError, match="shuffle"):
        tdata.DataLoader(ds, 2, shuffle=True, sampler=tdata.SequentialSampler(4))
    with pytest.raises(MXNetError, match="mutually exclusive"):
        tdata.DataLoader(ds, 2, batch_sampler=tdata.BatchSampler(tdata.SequentialSampler(4), 2))


def test_datasets_transform_filter_shard_match_jax():
    X, Y, _ = _loader_data()
    for lazy in (True, False):
        got, want = [], []
        for mod, out in ((jdata, want), (tdata, got)):
            ds = mod.ArrayDataset(X, Y)
            out.append([ds.transform(lambda x, y: (x * 2, y + 1), lazy)[i] for i in (0, 36)])
            out.append([ds.transform_first(lambda x: x - 1, lazy)[i] for i in (3, 4)])
            out.append([len(ds.filter(lambda s: s[1] > 2)), len(ds.take(5)), len(ds.shard(4, 3))])
            out.append(ds.shard(4, 1)[0])
            out.append(ds.sample(mod.IntervalSampler(37, 4))[2])
            out.append(mod.SimpleDataset([5, 6, 7])[1])
        for g, w in zip(got, want):
            if isinstance(g, list) and isinstance(g[0], int):
                assert g == w
            elif isinstance(g, int):
                assert g == w
            else:
                same_tree(g, w)
    with pytest.raises(MXNetError, match="length"):
        tdata.ArrayDataset(onp.zeros(3), onp.zeros(4))
    with pytest.raises(MXNetError, match="shard index"):
        tdata.ArrayDataset(onp.zeros(3)).shard(2, 2)


# --------------------------------------------------------- vision datasets
def _write_idx(path, arr):
    arr = onp.asarray(arr, onp.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.tobytes())


def _mnist_dir(root, n=12):
    rng = onp.random.RandomState(1)
    os.makedirs(root, exist_ok=True)
    _write_idx(os.path.join(root, "train-images-idx3-ubyte"), rng.randint(0, 256, (n, 28, 28)))
    _write_idx(os.path.join(root, "train-labels-idx1-ubyte"), rng.randint(0, 10, n))
    import gzip
    imgs = rng.randint(0, 256, (5, 28, 28)).astype(onp.uint8)
    with gzip.open(os.path.join(root, "t10k-images-idx3-ubyte.gz"), "wb") as f:
        f.write(struct.pack(">IIII", 0x0803, 5, 28, 28) + imgs.tobytes())
    _write_idx(os.path.join(root, "t10k-labels-idx1-ubyte"), rng.randint(0, 10, 5))
    return root


def _same_items(a, b, idx):
    for i in idx:
        (ai, al), (bi, bl) = a[i], b[i]
        same(ai, bi)
        assert onp.array_equal(onp.asarray(al), onp.asarray(bl))


def test_vision_datasets_from_files_match_jax(tmp_path):
    root = _mnist_dir(str(tmp_path / "mnist"))
    for cls in ("MNIST", "FashionMNIST"):
        for train in (True, False):
            j, t = getattr(jds, cls)(root, train), getattr(tds, cls)(root, train)
            assert len(j) == len(t)
            _same_items(j, t, range(len(t)))
    with pytest.raises(MXNetError, match="local files"):
        tds.MNIST(str(tmp_path / "nowhere"))
    rng = onp.random.RandomState(2)
    c10 = tmp_path / "c10"
    c10.mkdir()
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]:
        rng.randint(0, 256, (3, 3073)).astype(onp.uint8).tofile(str(c10 / name))
    c100 = tmp_path / "c100"
    c100.mkdir()
    for name in ("train.bin", "test.bin"):
        rng.randint(0, 100, (4, 3074)).astype(onp.uint8).tofile(str(c100 / name))
    for train in (True, False):
        _same_items(jds.CIFAR10(str(c10), train), tds.CIFAR10(str(c10), train), range(3))
        for fine in (True, False):
            _same_items(jds.CIFAR100(str(c100), train, fine), tds.CIFAR100(str(c100), train, fine),
                        range(4))
    j = jds.SyntheticImageDataset(10, (8, 8, 3), 4, seed=3, transform=lambda x, y: (x[::2], y))
    t = tds.SyntheticImageDataset(10, (8, 8, 3), 4, seed=3, transform=lambda x, y: (x[::2], y))
    _same_items(j, t, range(10))


def _write_npy_rec(mod, prefix, n, shape, seed):
    rng = onp.random.RandomState(seed)
    w = mod.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(n):
        img = rng.randint(0, 256, shape).astype(onp.uint8)
        w.write_idx(i, mod.pack_img(mod.IRHeader(0, float(i % 3), i, 0), img, img_fmt=".npy"))
    w.close()


def test_image_record_dataset_through_forked_workers(tmp_path):
    """Records the port wrote, read by both packages' ImageRecordDataset and
    by 3 forked workers, which each read through their own file handle."""
    prefix = str(tmp_path / "imgs")
    _write_npy_rec(trec, prefix, 24, (6, 5, 3), 4)
    j, t = jds.ImageRecordDataset(prefix + ".rec"), tds.ImageRecordDataset(prefix + ".rec")
    assert len(j) == len(t) == 24
    _same_items(j, t, range(24))
    tf = tT.Compose([tT.RandomFlipLeftRight(), tT.ToTensor()])
    ds = t.transform_first(tf)
    onp.random.seed(0)
    want = [(tf(t[i][0]), t[i][1]) for i in range(24)]
    loader = tdata.DataLoader(ds, batch_size=4, num_workers=3, thread_pool=False)
    got = list(loader)
    # forked workers inherit one numpy RNG state each, so flips differ from
    # the inline order; the un-flipped images are the records' own
    for b, (x, y) in enumerate(got):
        for r in range(4):
            i = 4 * b + r
            xi = host(x)[r]
            ref = want[i][0]
            assert onp.array_equal(xi, ref) or onp.array_equal(xi, ref[:, :, ::-1])
            assert float(host(y)[r]) == float(i % 3)


def test_image_folder_and_list_datasets_match_jax(tmp_path):
    from PIL import Image
    rng = onp.random.RandomState(5)
    for cls in ("cat", "dog"):
        (tmp_path / cls).mkdir()
        for k in range(2):
            Image.fromarray(rng.randint(0, 256, (6, 4, 3)).astype(onp.uint8)).save(
                str(tmp_path / cls / f"{k}.png"))
    (tmp_path / "notes.txt").write_text("x")
    for flag in (1, 0):
        j, t = jds.ImageFolderDataset(str(tmp_path), flag), tds.ImageFolderDataset(str(tmp_path), flag)
        assert j.synsets == t.synsets == ["cat", "dog"]
        _same_items(j, t, range(4))
    lst = tmp_path / "imgs.lst"
    lst.write_text("0\t1\tdog/0.png\n1\t0\tcat/1.png\n")
    for imglist in (str(lst), [[1, "dog/1.png"], [0, "cat/0.png"]]):
        j = jds.ImageListDataset(str(tmp_path), imglist)
        t = tds.ImageListDataset(str(tmp_path), imglist)
        assert j.synsets == t.synsets
        _same_items(j, t, range(2))


# -------------------------------------------------------------- transforms
def _jnd(a):
    return jmx.np.array(a)


def _tnd(a):
    return mx.np.array(a)


def _both(make, x, seed=None, tol=0.0):
    """A transform on the host input and on the CPU-tensor input of the
    port, against the JAX package's host and device paths."""
    out = []
    for mod_T, wrap in ((jT, None), (tT, None), (jT, _jnd), (tT, _tnd)):
        if seed is not None:
            onp.random.seed(seed)
        t = make(mod_T)
        out.append(t(x if wrap is None else wrap(x)))
    (jh, th, jd, td) = out
    assert isinstance(th, onp.ndarray) and isinstance(td, mx.NDArray)
    for got, want in ((th, jh), (td, jd)):
        g, w = host(got), host(want)
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
        if tol:
            assert onp.abs(g.astype("float64") - w).max() <= tol * max(1.0, onp.abs(w).max())
        else:
            assert onp.array_equal(g, w)


@pytest.mark.parametrize("batch", [False, True], ids=["hwc", "nhwc"])
def test_transforms_match_jax(batch):
    rng = onp.random.RandomState(6)
    shape = (2, 9, 7, 3) if batch else (9, 7, 3)
    img = rng.randint(0, 256, shape).astype(onp.uint8)
    fimg = img.astype("float32")
    chw = rng.rand(*((2, 3, 5, 4) if batch else (3, 5, 4))).astype("float32")
    _both(lambda T: T.Cast("float32"), img)
    _both(lambda T: T.ToTensor(), img)
    _both(lambda T: T.Normalize((0.5, 0.25, 0.1), (0.2, 0.3, 0.4)), chw)
    _both(lambda T: T.Normalize(0.5, 2.0), chw)
    for size in (4, (11, 6), (7, 9), (15, 21)):      # down, mixed, same, up
        _both(lambda T: T.Resize(size), fimg, tol=RESIZE_TOL)
    _both(lambda T: T.CenterCrop(5), img)
    _both(lambda T: T.CenterCrop((3, 6)), img)
    for seed in range(4):
        _both(lambda T: T.RandomCrop((5, 4)), img, seed=seed)
        _both(lambda T: T.RandomCrop(6, pad=2), img, seed=seed)
        _both(lambda T: T.RandomFlipLeftRight(), img, seed=seed)
        _both(lambda T: T.RandomFlipTopBottom(), img, seed=seed)
    _both(lambda T: T.Compose([T.RandomCrop(6, pad=1), T.RandomFlipLeftRight(), T.ToTensor(),
                               T.Normalize((0.4, 0.5, 0.6), (0.2, 0.2, 0.2))]), img, seed=9)


def test_resize_edges_up_and_down_match_jax_device_path():
    """The device path against ``jax.image.resize(..., antialias=False)``
    at shapes whose edge taps are clamped, up and down, and on a raw
    tensor input."""
    rng = onp.random.RandomState(7)
    for (H, W, h, w) in ((7, 9, 13, 5), (16, 16, 5, 7), (5, 4, 17, 19), (32, 30, 8, 9), (1, 6, 3, 2)):
        x = (rng.rand(H, W, 3) * 255).astype("float32")
        want = host(jT.Resize((w, h))(_jnd(x)))
        got = tT.Resize((w, h))(torch.from_numpy(x))
        assert isinstance(got, torch.Tensor)
        assert onp.abs(got.numpy() - want).max() <= RESIZE_TOL * max(1.0, onp.abs(want).max())
        hostw = jT.Resize((w, h))(x)
        assert onp.abs(got.numpy() - hostw).max() <= RESIZE_TOL * max(1.0, onp.abs(hostw).max())


# ------------------------------------------------------------------- image
def test_image_functions_match_jax():
    from PIL import Image
    import io as _io
    rng = onp.random.RandomState(8)
    img = rng.randint(0, 256, (12, 10, 3)).astype(onp.uint8)
    buf = _io.BytesIO()
    Image.fromarray(img).save(buf, format="png")
    for kw in (dict(), dict(flag=0), dict(to_rgb=False)):
        same(jimage.imdecode(buf.getvalue(), **kw), timage.imdecode(buf.getvalue(), **kw))
    fimg = img.astype("float32")
    for (w, h) in ((5, 7), (10, 12), (17, 23)):
        for interp in (1, 0):
            jf, tf = jimage.imresize(_jnd(fimg), w, h, interp), timage.imresize(_tnd(fimg), w, h, interp)
            jf, tf = host(jf), host(tf)
            assert tf.dtype == jf.dtype
            assert onp.abs(tf - jf).max() <= RESIZE_TOL * max(1.0, onp.abs(jf).max())
            ju, tu = host(jimage.imresize(_jnd(img), w, h, interp)), host(timage.imresize(img, w, h, interp))
            assert tu.dtype == ju.dtype == onp.uint8
            assert onp.abs(tu.astype(int) - ju).max() <= 1
            if interp == 0:
                same(tu, ju)
    same(jimage.resize_short(_jnd(fimg), 6, interp=0), timage.resize_short(fimg, 6, interp=0))
    same(jimage.fixed_crop(_jnd(img), 1, 2, 4, 5), timage.fixed_crop(img, 1, 2, 4, 5))
    jc, jbox = jimage.center_crop(_jnd(img), (4, 6), interp=0)
    tc, tbox = timage.center_crop(img, (4, 6), interp=0)
    same(jc, tc)
    assert jbox == tbox
    for seed in range(3):
        random.seed(seed)
        jc, jbox = jimage.random_crop(_jnd(img), (5, 5))
        random.seed(seed)
        tc, tbox = timage.random_crop(img, (5, 5))
        same(jc, tc)
        assert jbox == tbox
    same(jimage.color_normalize(_jnd(img), (1, 2, 3), (2, 3, 4)),
         timage.color_normalize(img, (1, 2, 3), (2, 3, 4)))
    same(jimage.color_normalize(_jnd(img), 5.0), timage.color_normalize(img, 5.0))
    for kw in (dict(resize=11, rand_crop=True, rand_mirror=True, mean=(1, 2, 3), std=(4, 5, 6)),
               dict()):
        jaugs = jimage.CreateAugmenter((3, 6, 5), **kw)
        taugs = timage.CreateAugmenter((3, 6, 5), **kw)
        assert [type(a).__name__ for a in jaugs] == [type(a).__name__ for a in taugs]
        for seed in range(3):
            jx, tx = _jnd(fimg), _tnd(fimg)
            random.seed(seed)
            for a in jaugs:
                jx = a(jx)
            random.seed(seed)
            for a in taugs:
                tx = a(tx)
            assert onp.abs(host(tx) - host(jx)).max() <= RESIZE_TOL * max(1.0, onp.abs(host(jx)).max())


# ------------------------------------------------------------- gluon.utils
def test_gluon_utils_match_jax(tmp_path):
    rng = onp.random.RandomState(9)
    x = rng.rand(8, 6).astype("float32")
    for n, axis, even in ((4, 0, True), (3, 1, False), (1, 0, True)):
        for g, w in zip(tutils.split_data(_tnd(x), n, axis, even),
                        jutils.split_data(_jnd(x), n, axis, even)):
            same(g, w)
    with pytest.raises(MXNetError, match="evenly"):
        tutils.split_data(_tnd(x), 3)
    parts = tutils.split_and_load(x, [mx.cpu()])
    assert len(parts) == 1 and parts[0]._data.device.type == "cpu"
    same(parts[0], x)
    parts = tutils.split_and_load(x, [mx.cpu(0), mx.cpu(1)], batch_axis=0)
    assert [p.shape for p in parts] == [(4, 6), (4, 6)]
    arrs = [rng.rand(3, 4).astype("float32") * 5 for _ in range(3)]
    ta, ja = [_tnd(a) for a in arrs], [_jnd(a) for a in arrs]
    tn, jn = tutils.clip_global_norm(ta, 2.0), jutils.clip_global_norm(ja, 2.0)
    assert abs(tn - float(jn)) <= 1e-6 * abs(float(jn))
    for g, w in zip(ta, ja):
        onp.testing.assert_allclose(host(g), host(w), rtol=1e-6)
    f = tmp_path / "blob.bin"
    f.write_bytes(b"abc" * 1000)
    sha = hashlib.sha1(b"abc" * 1000).hexdigest()
    assert tutils.check_sha1(str(f), sha) and not tutils.check_sha1(str(f), "0" * 40)
    with pytest.raises(MXNetError, match="download"):
        tutils.download("http://localhost:1/none")
