"""Minimal TensorBoard event-file writer (no tensorboard dependency).

The port's copy of the JAX package's numpy-only
`romp_tpu/utils/tensorboard.py`, so that the port imports nothing of that
package.

Writes standard TFRecord-framed `Event` protos (scalars + PNG images) that
TensorBoard reads natively. The proto subset is hand-encoded (varint/fixed
wire format) because the tensorboard/tensorflow packages are not available
in this environment; the on-disk format is identical.

Parity target: the reference's training observability
(`romp/train.py:65-78` — per-loss scalar curves and worst/best image grids
via torch.utils.tensorboard.SummaryWriter).

Format notes:
- TFRecord framing: [len u64 LE][masked crc32c(len)][data][masked crc32c
  (data)]; mask(crc) = ((crc >> 15) | (crc << 17)) + 0xa282ead8 (mod 2^32).
- Event proto fields: wall_time(1, double), step(2, varint),
  file_version(3, bytes), summary(5, msg). Summary.Value: tag(1),
  simple_value(2, float32), image(4, msg). Image: height(1), width(2),
  colorspace(3), encoded_image_string(4).
"""
from __future__ import annotations

import os
import os.path as osp
import struct
import time
from typing import Dict, Optional

import numpy as np

# ----------------------------------------------------------- crc32c (sw) --

_CRC32C_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (_CRC32C_POLY if _c & 1 else 0)
    _TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------- proto primitives --

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _bytes_field(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _double_field(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float_field(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _varint_field(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _event(step: Optional[int] = None, file_version: Optional[str] = None,
           summary: Optional[bytes] = None,
           wall_time: Optional[float] = None) -> bytes:
    out = _double_field(1, time.time() if wall_time is None else wall_time)
    if step is not None:
        out += _varint_field(2, step)
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if summary is not None:
        out += _bytes_field(5, summary)
    return out


def encode_png(image: np.ndarray) -> bytes:
    """uint8 (H, W, 3) RGB -> PNG bytes (cv2 if present, else a stored
    zlib-deflate PNG written by hand)."""
    img = np.ascontiguousarray(image.astype(np.uint8))
    try:
        import cv2

        ok, buf = cv2.imencode(".png", img[..., ::-1])   # expects BGR
        if ok:
            return bytes(buf.tobytes())
    except ImportError:
        pass
    import zlib

    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


class SummaryWriter:
    """Append-only TensorBoard event-file writer.

    Usage mirrors torch.utils.tensorboard.SummaryWriter:
        w = SummaryWriter(logdir)
        w.add_scalar("loss/total", 1.23, step)
        w.add_scalars({"loss/a": 1, "loss/b": 2}, step)
        w.add_image("eval/worst", rgb_uint8_hwc, step)
        w.close()
    """

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}"
                f".{os.uname().nodename}{filename_suffix}")
        self.path = osp.join(logdir, name)
        self._f = open(self.path, "ab")
        self._write(_event(file_version="brain.Event:2"))

    def _write(self, record: bytes) -> None:
        length = struct.pack("<Q", len(record))
        self._f.write(length + struct.pack("<I", _masked_crc(length))
                      + record + struct.pack("<I", _masked_crc(record)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self.add_scalars({tag: value}, step)

    def add_scalars(self, scalars: Dict[str, float], step: int) -> None:
        summary = b"".join(
            _bytes_field(1, _bytes_field(1, tag.encode())
                         + _float_field(2, float(v)))
            for tag, v in scalars.items())
        self._write(_event(step=step, summary=summary))

    def add_image(self, tag: str, image: np.ndarray, step: int) -> None:
        """image: (H, W, 3) uint8 RGB."""
        png = encode_png(image)
        img_msg = (_varint_field(1, image.shape[0])
                   + _varint_field(2, image.shape[1])
                   + _varint_field(3, 3)
                   + _bytes_field(4, png))
        val = _bytes_field(1, _bytes_field(1, tag.encode())
                           + _bytes_field(4, img_msg))
        self._write(_event(step=step, summary=val))

    def add_image_grid(self, tag: str, images: np.ndarray, step: int,
                       ncol: int = 4) -> None:
        """images: (N, H, W, 3) uint8 -> one tiled grid image (the
        reference's save_image(make_grid(...)) equivalent)."""
        n, h, w = images.shape[:3]
        ncol = min(ncol, n)
        nrow = (n + ncol - 1) // ncol
        grid = np.zeros((nrow * h, ncol * w, 3), np.uint8)
        for i in range(n):
            r, c = divmod(i, ncol)
            grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = images[i]
        self.add_image(tag, grid, step)

    def close(self) -> None:
        self._f.close()


# ------------------------------------------------------------- reader ----
# (for tests and quick inspection without tensorboard installed)

def read_events(path: str):
    """Yield (step, {tag: value}) scalar dicts and (step, tag, png_bytes)
    image tuples from an event file."""
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        (length,) = struct.unpack_from("<Q", data, off)
        lcrc = struct.unpack_from("<I", data, off + 8)[0]
        assert lcrc == _masked_crc(data[off:off + 8]), "corrupt length crc"
        rec = data[off + 12:off + 12 + length]
        rcrc = struct.unpack_from("<I", data, off + 12 + length)[0]
        assert rcrc == _masked_crc(rec), "corrupt data crc"
        off += 12 + length + 4
        yield _parse_event(rec)


def _parse_fields(buf: bytes):
    off = 0
    while off < len(buf):
        key, n = _read_varint(buf, off)
        off = n
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, off = _read_varint(buf, off)
        elif wire == 1:
            v = struct.unpack_from("<d", buf, off)[0]
            off += 8
        elif wire == 2:
            ln, off = _read_varint(buf, off)
            v = buf[off:off + ln]
            off += ln
        elif wire == 5:
            v = struct.unpack_from("<f", buf, off)[0]
            off += 4
        else:
            raise ValueError(f"wire {wire}")
        yield field, wire, v


def _read_varint(buf: bytes, off: int):
    out = 0
    shift = 0
    while True:
        b = buf[off]
        off += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, off
        shift += 7


def _parse_event(rec: bytes):
    step = 0
    scalars: Dict[str, float] = {}
    images = []
    version = None
    for field, _, v in _parse_fields(rec):
        if field == 2:
            step = v
        elif field == 3:
            version = v.decode()
        elif field == 5:
            for f2, _, val in _parse_fields(v):
                if f2 != 1:
                    continue
                tag, sv, img = None, None, None
                for f3, _, v3 in _parse_fields(val):
                    if f3 == 1:
                        tag = v3.decode()
                    elif f3 == 2:
                        sv = v3
                    elif f3 == 4:
                        for f4, _, v4 in _parse_fields(v3):
                            if f4 == 4:
                                img = v4
                if sv is not None:
                    scalars[tag] = sv
                if img is not None:
                    images.append((tag, img))
    return {"step": step, "scalars": scalars, "images": images,
            "file_version": version}
