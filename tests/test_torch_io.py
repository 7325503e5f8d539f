"""Port parity of ``mxnet_tpu_torch.io`` and ``io.recordio`` on the CPU
against the JAX package: RecordIO files byte for byte identical when both
packages write the same records (plain, indexed, ``pack``/``pack_img``
with scalar and vector labels, ``.npy``/png/jpg payloads), each package
reading the other's files, split records; and the iterators fed the same
files or arrays: ``NDArrayIter`` (pad, discard, roll_over over epochs,
shuffle, dict and list inputs), ``CSVIter``, ``LibSVMIter``,
``MNISTIter``, ``ImageRecordIter``, ``PrefetchingIter`` and
``ResizeIter``.

Tolerance: exact (bytes, batches, pads and indices)."""
import os
import struct

import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import io as jio
from mxnet_tpu.io import recordio as jrec

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.io import recordio as trec


@pytest.fixture(autouse=True)
def on_cpu():
    with mx.cpu():
        yield


def host(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)


# ------------------------------------------------------------------ RecordIO
def _records(mod, rng):
    img = rng.randint(0, 256, (7, 5, 3)).astype(onp.uint8)
    out = [b"", b"a", b"abcd", bytes(range(255)) * 3,
           mod.pack(mod.IRHeader(0, 3.5, 7, 1), b"payload"),
           mod.pack(mod.IRHeader(0, [1.0, 2.5, -3.0], 8, 2), b"xyz"),
           mod.pack_img(mod.IRHeader(0, 1.0, 9, 0), img, img_fmt=".npy"),
           mod.pack_img(mod.IRHeader(0, 2.0, 10, 0), img, img_fmt=".png")]
    return out, img


def _write(mod, path, recs, indexed):
    if indexed:
        w = mod.MXIndexedRecordIO(path + ".idx", path + ".rec", "w")
        for i, r in enumerate(recs):
            w.write_idx(i * 3, r)
    else:
        w = mod.MXRecordIO(path + ".rec", "w")
        for r in recs:
            w.write(r)
    w.close()


@pytest.mark.parametrize("indexed", [False, True], ids=["plain", "indexed"])
def test_recordio_files_identical_and_cross_readable(tmp_path, indexed):
    jr, img = _records(jrec, onp.random.RandomState(0))
    tr, _ = _records(trec, onp.random.RandomState(0))
    assert jr == tr                           # pack / pack_img bytes
    jp, tp = str(tmp_path / "j"), str(tmp_path / "t")
    _write(jrec, jp, jr, indexed)
    _write(trec, tp, tr, indexed)
    for ext in ((".rec", ".idx") if indexed else (".rec",)):
        assert open(jp + ext, "rb").read() == open(tp + ext, "rb").read()
    for reader, path in ((trec, jp), (jrec, tp)):
        if indexed:
            r = reader.MXIndexedRecordIO(path + ".idx", path + ".rec", "r")
            assert r.keys == [i * 3 for i in range(len(tr))]
            got = [r.read_idx(k) for k in reversed(r.keys)][::-1]
        else:
            r = reader.MXRecordIO(path + ".rec", "r")
            got = []
            while (rec := r.read()) is not None:
                got.append(rec)
        r.close()
        assert got == tr
    h, s = trec.unpack(tr[4])
    assert (h.flag, h.label, h.id, h.id2, s) == (0, 3.5, 7, 1, b"payload")
    h, s = trec.unpack(tr[5])
    assert h.flag == 3 and h.label.tolist() == [1.0, 2.5, -3.0] and s == b"xyz"
    for k in (6, 7):
        (jh, ji), (th, ti) = jrec.unpack_img(jr[k]), trec.unpack_img(tr[k])
        assert onp.array_equal(ji, ti) and onp.array_equal(ti, img) and jh == th
    # jpeg: ".jpg" (the default) is no PIL format name, so both packages
    # raise on it; ".jpeg" packs the same bytes in both, read either way
    smooth = (onp.arange(16)[:, None, None] * 8 + onp.arange(16)[None, :, None] * 4
              + onp.array([0, 30, 60])).astype(onp.uint8)
    for mod in (trec, jrec):
        with pytest.raises(KeyError):
            mod.pack_img(mod.IRHeader(0, 0.0, 11, 0), smooth, quality=90, img_fmt=".jpg")
    jpg = trec.pack_img(trec.IRHeader(0, 0.0, 11, 0), smooth, quality=90, img_fmt=".jpeg")
    assert jpg == jrec.pack_img(jrec.IRHeader(0, 0.0, 11, 0), smooth, quality=90, img_fmt=".jpeg")
    (jh, ji), (th, ti) = jrec.unpack_img(jpg), trec.unpack_img(jpg)
    assert jh == th and onp.array_equal(ji, ti) and ti.shape == smooth.shape
    assert onp.abs(ti.astype(int) - smooth).mean() < 4     # lossy, but the image


def test_recordio_split_records_and_errors(tmp_path):
    """A record split into start/middle/end parts (cflag 1, 2, 3) reads as
    one, as the JAX reader joins it."""
    path = str(tmp_path / "split.rec")
    parts = [b"hello ", b"wide ", b"world"]
    with open(path, "wb") as f:
        for flag, p in zip((1, 2, 3), parts):
            f.write(struct.pack("<II", 0xCED7230A, (flag << 29) | len(p)) + p)
            f.write(b"\x00" * ((4 - len(p) % 4) % 4))
        f.write(struct.pack("<II", 0xCED7230A, 3) + b"end\x00")
    for mod in (jrec, trec):
        r = mod.MXRecordIO(path, "r")
        assert [r.read(), r.read(), r.read()] == [b"hello wide world", b"end", None]
        r.close()
    with open(str(tmp_path / "bad.rec"), "wb") as f:
        f.write(struct.pack("<II", 0x12345678, 0))
    with pytest.raises(MXNetError, match="magic"):
        trec.MXRecordIO(str(tmp_path / "bad.rec"), "r").read()
    with pytest.raises(MXNetError, match="flag"):
        trec.MXRecordIO(path, "x")
    with pytest.raises(MXNetError, match="writing"):
        trec.MXRecordIO(path, "r").write(b"x")


# ----------------------------------------------------------------- NDArrayIter
def _drain(it, epochs=3):
    out = []
    for _ in range(epochs):
        out.append([(tuple(host(d) for d in b.data), tuple(host(l) for l in b.label or []),
                     b.pad) for b in it])
        it.reset()
    return out


def _same_epochs(a, b):
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        assert len(ea) == len(eb)
        for (da, la, pa), (db, lb, pb) in zip(ea, eb):
            assert pa == pb
            for x, y in zip(da + la, db + lb):
                assert x.dtype == y.dtype and onp.array_equal(x, y)


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_matches_jax(handle, shuffle):
    rng = onp.random.RandomState(1)
    X, Y = rng.rand(11, 3).astype("float32"), rng.randint(0, 4, 11).astype("int64")
    runs = []
    for io_mod in (jio, tio):
        onp.random.seed(5)
        it = io_mod.NDArrayIter(X, Y, batch_size=4, shuffle=shuffle, last_batch_handle=handle)
        runs.append((_drain(it), it.provide_data, it.provide_label))
    _same_epochs(runs[0][0], runs[1][0])
    assert [tuple(d) for d in runs[0][1]] == [tuple(d) for d in runs[1][1]]
    assert [tuple(d) for d in runs[0][2]] == [tuple(d) for d in runs[1][2]]


def test_ndarray_iter_dict_and_list_inputs():
    rng = onp.random.RandomState(2)
    a, b = rng.rand(6, 2).astype("float32"), rng.rand(6, 5).astype("float32")
    for data in ({"x": a, "y": b}, [a, b]):
        got = []
        for io_mod, wrap in ((jio, jmx.np.array), (tio, mx.np.array)):
            d = {k: wrap(v) for k, v in data.items()} if isinstance(data, dict) else data
            it = io_mod.NDArrayIter(d, None, batch_size=4)
            got.append((_drain(it, 1), [x.name for x in it.provide_data]))
        _same_epochs(got[0][0], got[1][0])
        assert got[0][1] == got[1][1]
    with pytest.raises(MXNetError, match="last_batch_handle"):
        tio.NDArrayIter(a, batch_size=2, last_batch_handle="wrap")
    batch = next(iter(tio.NDArrayIter(a, batch_size=4)))
    assert "DataBatch" in str(batch) and batch.pad == 0
    assert tio.DataDesc("data", (4, 2)).layout == "NCHW"


# --------------------------------------------------------- file iterators
def _write_idx(path, arr):
    arr = onp.asarray(arr, onp.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.tobytes())


def test_file_iterators_match_jax(tmp_path):
    rng = onp.random.RandomState(3)
    csv_d, csv_l = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    onp.savetxt(csv_d, rng.rand(9, 6), delimiter=",")
    onp.savetxt(csv_l, rng.randint(0, 3, (9, 1)), delimiter=",")
    svm = str(tmp_path / "d.svm")
    with open(svm, "w") as f:
        for i in range(7):
            cols = sorted(rng.choice(8, 3, replace=False))
            f.write(f"{i % 2} " + " ".join(f"{c}:{rng.rand():.4f}" for c in cols) + "\n")
        f.write("\n")
    img, lbl = str(tmp_path / "img"), str(tmp_path / "lbl")
    _write_idx(img, rng.randint(0, 256, (10, 28, 28)))
    _write_idx(lbl, rng.randint(0, 10, 10))
    makers = [
        lambda m: m.CSVIter(csv_d, (2, 3), csv_l, (1,), batch_size=4),
        lambda m: m.CSVIter(csv_d, (6,), batch_size=4, round_batch=False),
        lambda m: m.LibSVMIter(svm, (8,), batch_size=3),
        lambda m: m.MNISTIter(img, lbl, batch_size=3, shuffle=True, seed=4),
        lambda m: m.MNISTIter(img, lbl, batch_size=4, shuffle=False, flat=True),
    ]
    for make in makers:
        _same_epochs(_drain(make(jio), 2), _drain(make(tio), 2))


def test_image_record_iter_reads_both_packages_files(tmp_path):
    rng = onp.random.RandomState(6)
    imgs = [rng.randint(0, 256, (6, 5, 3)).astype(onp.uint8) for _ in range(10)]
    for writer in (jrec, trec):
        prefix = str(tmp_path / writer.__name__.split(".")[0])
        w = writer.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
        for i, im in enumerate(imgs):
            w.write_idx(i, writer.pack_img(writer.IRHeader(0, float(i % 4), i, 0), im,
                                           img_fmt=".npy"))
        w.close()
        for kw in (dict(), dict(mean_r=10, mean_g=20, mean_b=30, scale=0.5)):
            runs = []
            for io_mod in (jio, tio):
                onp.random.seed(7)
                it = io_mod.ImageRecordIter(prefix + ".rec", (3, 6, 5), batch_size=4,
                                            shuffle=True, **kw)
                it.reset()
                runs.append(_drain(it, 2))
            _same_epochs(*runs)


def test_prefetching_and_resize_iters_match_jax():
    rng = onp.random.RandomState(8)
    X, Y = rng.rand(10, 2).astype("float32"), rng.rand(10).astype("float32")
    runs = []
    for io_mod in (jio, tio):
        base = io_mod.NDArrayIter(X, Y, batch_size=3, last_batch_handle="discard")
        pre = io_mod.PrefetchingIter(base, prefetch=2)
        got = _drain(pre, 2)
        rs = io_mod.ResizeIter(io_mod.NDArrayIter(X, Y, batch_size=4), 5)
        runs.append((got, _drain(rs, 2)))
    _same_epochs(runs[0][0], runs[1][0])
    _same_epochs(runs[0][1], runs[1][1])
    assert [len(e) for e in runs[1][1]] == [5, 5]
    # a PrefetchingIter made under the CPU scope fills on the CPU from its thread
    b = next(tio.PrefetchingIter(tio.NDArrayIter(X, Y, batch_size=3)))
    assert b.data[0]._data.device.type == "cpu"
    with pytest.raises(MXNetError, match="single iterator"):
        tio.PrefetchingIter([tio.NDArrayIter(X), tio.NDArrayIter(X)])
