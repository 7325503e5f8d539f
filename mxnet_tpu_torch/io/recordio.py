"""RecordIO, the binary record container (counterpart of
``mxnet_tpu/io/recordio.py``; the reference's dmlc-core recordio and
python/mxnet/recordio.py). Files are byte for byte the JAX package's, so
either package reads what the other wrote:

record := [kMagic:u32][lrecord:u32][data][pad to 4B]
  lrecord = cflag(3 bits) << 29 | length(29 bits); cflag 0=whole record,
  1=start, 2=middle, 3=end of a split record.
Indexed variant keeps a text ``.idx`` of "key\\toffset" lines
(reference tools/rec2idx.py).

Pure Python over ``struct`` and numpy. ``pack_img``/``unpack_img`` encode
jpg/png with PIL, as the JAX package does: the extension is PIL's format
name (``.jpeg``, ``.png``; ``.jpg``, the default, raises in both packages).
The raw ``.npy`` payload needs nothing beyond numpy.
"""
from __future__ import annotations

import numbers
import os
import struct
from collections import namedtuple
from typing import List, Optional

import numpy as onp

from ..base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IndexedRecordIO", "IRHeader",
           "pack", "unpack", "pack_img", "unpack_img"]

_MAGIC = 0xCED7230A
_MAX_LEN = (1 << 29) - 1


class MXRecordIO:
    """Sequential record reader/writer (reference recordio.py MXRecordIO)."""

    def __init__(self, uri: str, flag: str):
        if flag not in ("r", "w"):
            raise MXNetError(f"invalid flag {flag!r}")
        self.uri = uri
        self.flag = flag
        self._fp = open(uri, "rb" if flag == "r" else "wb")
        self.is_open = True

    def close(self):
        if self.is_open:
            self._fp.close()
            self.is_open = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def reset(self):
        self._fp.seek(0)

    def tell(self) -> int:
        return self._fp.tell()

    def seek(self, pos: int):
        self._fp.seek(pos)

    def write(self, buf: bytes):
        if self.flag != "w":
            raise MXNetError("RecordIO not opened for writing")
        if len(buf) > _MAX_LEN:
            raise MXNetError(f"record too large ({len(buf)} bytes)")
        self._fp.write(struct.pack("<II", _MAGIC, len(buf)))
        self._fp.write(buf)
        pad = (4 - len(buf) % 4) % 4
        if pad:
            self._fp.write(b"\x00" * pad)

    def read(self) -> Optional[bytes]:
        if self.flag != "r":
            raise MXNetError("RecordIO not opened for reading")
        header = self._fp.read(8)
        if len(header) < 8:
            return None
        magic, lrec = struct.unpack("<II", header)
        if magic != _MAGIC:
            raise MXNetError(f"{self.uri}: bad record magic {magic:#x}")
        cflag = lrec >> 29
        length = lrec & _MAX_LEN
        data = self._fp.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self._fp.read(pad)
        if cflag in (0,):
            return data
        # split records: keep reading continuation parts
        parts = [data]
        while cflag not in (0, 3):
            header = self._fp.read(8)
            magic, lrec = struct.unpack("<II", header)
            cflag = lrec >> 29
            length = lrec & _MAX_LEN
            parts.append(self._fp.read(length))
            pad = (4 - length % 4) % 4
            if pad:
                self._fp.read(pad)
        return b"".join(parts)


class MXIndexedRecordIO(MXRecordIO):
    """Random-access records via .idx (reference MXIndexedRecordIO)."""

    def __init__(self, idx_path: str, uri: str, flag: str, key_type=int):
        super().__init__(uri, flag)
        self.idx_path = idx_path
        self.key_type = key_type
        self.idx = {}
        self.keys: List = []
        if flag == "r" and os.path.exists(idx_path):
            with open(idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) >= 2:
                        key = key_type(parts[0])
                        self.idx[key] = int(parts[1])
                        self.keys.append(key)

    def close(self):
        if self.flag == "w" and self.is_open:
            with open(self.idx_path, "w") as f:
                for key in self.keys:
                    f.write(f"{key}\t{self.idx[key]}\n")
        super().close()

    def read_idx(self, idx) -> bytes:
        self.seek(self.idx[idx])
        return self.read()

    def write_idx(self, idx, buf: bytes):
        pos = self.tell()
        self.write(buf)
        self.idx[idx] = pos
        self.keys.append(idx)


IndexedRecordIO = MXIndexedRecordIO

IRHeader = namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header: IRHeader, s: bytes) -> bytes:
    """Pack a (header, payload) into bytes (reference recordio.pack)."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        out = struct.pack(_IR_FORMAT, header.flag, header.label,
                          header.id, header.id2)
    else:
        label = onp.asarray(header.label, dtype=onp.float32)
        out = struct.pack(_IR_FORMAT, label.size, 0.0, header.id, header.id2)
        out += label.tobytes()
    return out + s


def unpack(s: bytes):
    """Unpack bytes into (IRHeader, payload)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = onp.frombuffer(s[:header.flag * 4], dtype=onp.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header: IRHeader, img, quality: int = 95, img_fmt: str = ".jpg"):
    """Encode an image array and pack (reference pack_img). Needs an image
    codec (PIL); raw ``.npy`` passthrough is always available."""
    if img_fmt == ".npy":
        import io as _io
        buf = _io.BytesIO()
        onp.save(buf, onp.asarray(img))
        return pack(header, buf.getvalue())
    try:
        from PIL import Image
    except ImportError as e:
        raise MXNetError("pack_img needs PIL for jpg/png; use img_fmt='.npy'") from e
    import io as _io
    buf = _io.BytesIO()
    Image.fromarray(onp.asarray(img)).save(buf, format=img_fmt.strip("."),
                                           quality=quality)
    return pack(header, buf.getvalue())


def unpack_img(s: bytes, iscolor: int = -1):
    """Unpack and decode an image record."""
    header, payload = unpack(s)
    if payload[:6] == b"\x93NUMPY":
        import io as _io
        return header, onp.load(_io.BytesIO(payload))
    try:
        from PIL import Image
    except ImportError as e:
        raise MXNetError("unpack_img needs PIL for jpg/png records") from e
    import io as _io
    img = onp.asarray(Image.open(_io.BytesIO(payload)))
    return header, img
