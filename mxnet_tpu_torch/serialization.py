"""Tensor save/load (counterpart of ``mxnet_tpu/serialization.py``).

The ``.params`` container: the magic ``MXTPU001``, the JSON header's
length as a little-endian u64, the JSON header (names, shapes, dtypes as
numpy's dtype strings or ``"bfloat16"``, byte offsets), then the raw
little-endian payloads; bf16 is stored raw. The legacy dmlc V2 list format
(``format='legacy'``) is read and written, and ``.npy``/``.npz`` files
load as they are. For the same arrays the port writes the same bytes as
the JAX package, so each loads the other's files.

:func:`save` takes torch tensors (any device), numpy arrays or a list or
dict of them; :func:`load` returns CPU tensors in their stored dtypes.
"""
from __future__ import annotations

import json
import struct
from typing import Dict, List, Sequence, Union

import numpy as np
import torch

from .base import MXNetError

__all__ = ["save", "load", "host_copies"]

_MAGIC = b"MXTPU001"
_BF16 = "bfloat16"

_LIST_MAGIC = 0x112
_NDARRAY_V1_MAGIC = 0xF993FAC8
_NDARRAY_V2_MAGIC = 0xF993FAC9
_NDARRAY_V3_MAGIC = 0xF993FACA
# mshadow type_flag -> numpy dtype (kBfloat16 = 12 separately)
_TYPE_FLAG_TO_DTYPE = {
    0: "<f4", 1: "<f8", 2: "<f2", 3: "|u1", 4: "<i4", 5: "|i1", 6: "<i8",
    7: "|b1", 8: "<i2", 9: "<u2", 10: "<u4", 11: "<u8",
}
_DTYPE_TO_TYPE_FLAG = {
    "float32": 0, "float64": 1, "float16": 2, "uint8": 3, "int32": 4,
    "int8": 5, "int64": 6, "bool": 7, "int16": 8, "uint16": 9,
    "uint32": 10, "uint64": 11, _BF16: 12,
}

Tensors = Union[Dict[str, torch.Tensor], List[torch.Tensor]]


class _Host:
    """One array on the host: numpy, with bf16 kept as its raw u16 bits."""

    def __init__(self, a):
        if isinstance(a, torch.Tensor):
            t = a.detach().cpu().contiguous()
            self.bf16 = t.dtype == torch.bfloat16
            self.arr = (t.view(torch.int16).numpy().view(np.uint16) if self.bf16
                        else t.numpy())
        else:
            arr = np.asarray(a)
            self.bf16 = arr.dtype.name == _BF16
            self.arr = arr.view(np.uint16) if self.bf16 else arr

    @property
    def dtype_str(self) -> str:
        return _BF16 if self.bf16 else self.arr.dtype.str

    @property
    def dtype_name(self) -> str:
        return _BF16 if self.bf16 else self.arr.dtype.name

    def tobytes(self) -> bytes:
        return np.ascontiguousarray(self.arr).tobytes()


def host_copies(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """CPU copies of ``tensors`` taken now: card tensors are copied into
    pinned host memory behind the work already queued, with one wait for
    all of them; CPU tensors are cloned. Later in-place updates of the
    originals do not reach the copies."""
    out = []
    on_card = False
    for t in tensors:
        t = t.detach()
        if t.is_cuda:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            on_card = True
        else:
            h = t.clone()
        out.append(h)
    if on_card:
        torch.cuda.synchronize()
    return out


def _bf16_tensor(raw: bytes, shape) -> torch.Tensor:
    u16 = np.frombuffer(raw, dtype="<u2").reshape(tuple(int(d) for d in shape))
    return torch.from_numpy(u16.view(np.int16).copy()).view(torch.bfloat16)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, copy=True))


class _StreamReader:
    """Little-endian field reader over a bytes buffer."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise MXNetError("legacy .params file truncated")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u32(self) -> int:
        return struct.unpack("<I", self.read(4))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.read(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.read(8))[0]

    def i64s(self, n: int):
        return struct.unpack(f"<{n}q", self.read(8 * n))


def _empty() -> torch.Tensor:
    return torch.zeros((0,), dtype=torch.float32)


def _legacy_read_ndarray(r: _StreamReader) -> torch.Tensor:
    """One array in the V1/V2/V3 dmlc format; sparse storage is densified."""
    magic = r.u32()
    if magic in (_NDARRAY_V2_MAGIC, _NDARRAY_V3_MAGIC):
        stype = r.i32()
        nad = {1: 1, 2: 2}.get(stype, 0)    # row_sparse: 1 aux, csr: 2
        sshape = None
        if nad > 0:
            sndim = r.i32()
            if sndim < 0:
                raise MXNetError("legacy .params file: negative storage ndim")
            sshape = r.i64s(sndim)
        ndim = r.i32()
        if ndim < 0:        # V3 unknown shape: an empty array, the record ends
            return _empty()
        shape = r.i64s(ndim)
        if any(d < 0 for d in shape):
            return _empty()
        if magic == _NDARRAY_V2_MAGIC and ndim == 0:
            return torch.zeros((), dtype=torch.float32)
        r.i32()
        r.i32()             # context dev_type, dev_id
        type_flag = r.i32()
        aux = []
        for _ in range(nad):
            a_type = r.i32()
            a_ndim = r.i32()
            aux.append((a_type, r.i64s(a_ndim)))
        data = _legacy_read_blob(r, type_flag, sshape if nad > 0 else shape)
        if nad == 0:
            return data
        aux_arrays = [_legacy_read_blob(r, t, s) for t, s in aux]
        return _densify_legacy(stype, shape, data, aux_arrays)
    if magic == _NDARRAY_V1_MAGIC:
        ndim = r.i32()
        shape = r.i64s(ndim)
    else:                   # pre-V1: the magic is ndim, uint32 dims
        ndim = magic
        if ndim > 32:
            raise MXNetError("legacy .params file: bad ndim in header")
        shape = struct.unpack(f"<{ndim}I", r.read(4 * ndim))
    if ndim == 0:
        return torch.zeros((), dtype=torch.float32)
    r.i32()
    r.i32()
    return _legacy_read_blob(r, r.i32(), shape)


def _legacy_read_blob(r: _StreamReader, type_flag: int, shape) -> torch.Tensor:
    size = 1
    for d in shape:
        size *= int(d)
    if type_flag == 12:
        return _bf16_tensor(r.read(2 * size), shape)
    if type_flag not in _TYPE_FLAG_TO_DTYPE:
        raise MXNetError(f"legacy .params file: unknown type_flag {type_flag}")
    dt = np.dtype(_TYPE_FLAG_TO_DTYPE[type_flag])
    raw = r.read(dt.itemsize * size)
    return _tensor(np.frombuffer(raw, dtype=dt).reshape(tuple(int(d) for d in shape)))


def _densify_legacy(stype: int, shape, data: torch.Tensor, aux) -> torch.Tensor:
    out = torch.zeros(tuple(int(d) for d in shape), dtype=data.dtype)
    if stype == 1:          # row_sparse: aux[0] = row indices
        idx = aux[0].long()
        if idx.numel():
            out[idx] = data
    elif stype == 2:        # csr: aux[0] = indptr, aux[1] = column indices
        indptr, indices = aux[0].long().tolist(), aux[1].long()
        for row in range(len(indptr) - 1):
            cols = indices[indptr[row]:indptr[row + 1]]
            out[row, cols] = data[indptr[row]:indptr[row + 1]]
    else:
        raise MXNetError(f"legacy .params file: unknown stype {stype}")
    return out


def _load_legacy(buf: bytes, fname: str) -> Tensors:
    r = _StreamReader(buf)
    header = r.u64()
    if header != _LIST_MAGIC:
        raise MXNetError(
            f"{fname}: not a mxnet_tpu .params file and not a reference "
            f"legacy NDArray file (bad magic {header:#x})")
    r.u64()                 # reserved
    arrays = [_legacy_read_ndarray(r) for _ in range(r.u64())]
    names = [r.read(r.u64()).decode("utf-8") for _ in range(r.u64())]
    if names:
        return dict(zip(names, arrays))
    return list(arrays)


def _save_legacy(fname: str, items, keyed: bool) -> None:
    """The dmlc V2 list format, dense only (0-d arrays go out as V3)."""
    chunks = [struct.pack("<QQ", _LIST_MAGIC, 0), struct.pack("<Q", len(items))]
    for _, h in items:
        if h.dtype_name not in _DTYPE_TO_TYPE_FLAG:
            raise MXNetError(f"legacy save: unsupported dtype {h.dtype_name}")
        arr = h.arr
        magic = _NDARRAY_V3_MAGIC if arr.ndim == 0 else _NDARRAY_V2_MAGIC
        chunks.append(struct.pack("<I", magic))
        chunks.append(struct.pack("<i", 0))             # default storage
        chunks.append(struct.pack("<i", arr.ndim))
        chunks.append(struct.pack(f"<{arr.ndim}q", *arr.shape))
        chunks.append(struct.pack("<ii", 1, 0))         # cpu context
        chunks.append(struct.pack("<i", _DTYPE_TO_TYPE_FLAG[h.dtype_name]))
        chunks.append(h.tobytes())
    names = [name for name, _ in items] if keyed else []
    chunks.append(struct.pack("<Q", len(names)))
    for name in names:
        b = name.encode("utf-8")
        chunks.append(struct.pack("<Q", len(b)) + b)
    with open(fname, "wb") as f:
        f.write(b"".join(chunks))


def save(fname: str, data: Union[Dict[str, torch.Tensor], Sequence[torch.Tensor], torch.Tensor],
         format: str = "mxtpu") -> None:
    """Save tensors: a dict is saved by name, a list (or one tensor) by
    index. ``format='legacy'`` writes the dmlc V2 list format."""
    if isinstance(data, (torch.Tensor, np.ndarray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        items = [(str(i), _Host(a)) for i, a in enumerate(data)]
        keyed = False
    elif isinstance(data, dict):
        items = [(name, _Host(a)) for name, a in data.items()]
        keyed = True
    else:
        raise MXNetError(f"save: unsupported type {type(data)}")
    if format == "legacy":
        _save_legacy(fname, items, keyed)
        return
    if format != "mxtpu":
        raise MXNetError(f"save: unknown format {format!r}")
    header = {"version": 1, "keyed": keyed, "tensors": []}
    payloads: List[bytes] = []
    offset = 0
    for name, h in items:
        raw = h.tobytes()
        header["tensors"].append({
            "name": name, "shape": list(h.arr.shape), "dtype": h.dtype_str,
            "offset": offset, "nbytes": len(raw)})
        payloads.append(raw)
        offset += len(raw)
    hbytes = json.dumps(header).encode("utf-8")
    with open(fname, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(hbytes)))
        f.write(hbytes)
        for p in payloads:
            f.write(p)


def load(fname: str) -> Union[Tensors, torch.Tensor]:
    """Load what :func:`save` (of either package) wrote, a legacy dmlc
    list file, or a ``.npy``/``.npz`` file, as CPU tensors."""
    if fname.endswith(".npy") or fname.endswith(".npz"):
        out = np.load(fname, allow_pickle=False)
        if isinstance(out, np.lib.npyio.NpzFile):
            return {k: _tensor(out[k]) for k in out.files}
        return _tensor(out)
    with open(fname, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            if len(magic) == 8 and struct.unpack("<Q", magic)[0] == _LIST_MAGIC:
                return _load_legacy(magic + f.read(), fname)
            raise MXNetError(f"{fname}: not a mxnet_tpu .params file "
                             f"(bad magic {magic!r})")
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen).decode("utf-8"))
        base = f.tell()
        out_items = []
        for t in header["tensors"]:
            f.seek(base + t["offset"])
            raw = f.read(t["nbytes"])
            if t["dtype"] == _BF16:
                arr = _bf16_tensor(raw, t["shape"])
            else:
                arr = _tensor(np.frombuffer(raw, dtype=np.dtype(t["dtype"]))
                              .reshape(t["shape"]))
            out_items.append((t["name"], arr))
    if header.get("keyed", True):
        return dict(out_items)
    return [a for _, a in out_items]
