"""Motion-JPEG AVI movies without OpenCV: the writer behind
``convert --movie x.avi`` and a reader of its frames.

The writer stores each frame as a JFIF JPEG (``io/imgcodec.jpeg_encode``,
YCbCr 4:2:0, quality 95 as OpenCV's MJPG writer by default; a gray plane
goes in as Y with Cb = Cr = 128) in a RIFF AVI with an ``idx1`` index.  A
RIFF holds at most `RIFF_LIMIT` bytes (1 GB, as OpenDML writers keep it);
past it the movie goes on in ``RIFF AVIX`` parts, each ``movi`` list with
its own ``ix00`` standard index, all listed by the ``indx`` super index in
the stream header, and ``dmlh`` holding the total frame count, as OpenCV
and FFmpeg write long movies.  Every file carries the OpenDML indexes, so
a movie reads the same whether it crossed the limit or not.

`read_avi` walks every RIFF's ``movi`` list in file order and yields the
frames decoded (a frame without Huffman tables, as some MJPEG writers leave
it, decodes with the standard ones).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Iterator, List, Tuple

import numpy as np

from .imgcodec import CodecError, jpeg_decode, jpeg_encode

__all__ = ["RIFF_LIMIT", "MjpegWriter", "avi_info", "read_avi"]

RIFF_LIMIT = 1 << 30
_SUPER_ENTRIES = 1024          # RIFF parts the super index can list
_CHUNK = b"00dc"
_AVIIF_KEYFRAME = 0x10


def _u32(v: int) -> bytes:
    return struct.pack("<I", v)


class MjpegWriter:
    """Write frames (h, w) gray or (h, w, 3) RGB u8 of one size into a
    Motion-JPEG AVI at `fps` frames a second."""

    def __init__(self, path, width: int, height: int, fps: int,
                 quality: int = 95):
        self.path = Path(path)
        self.size = (int(width), int(height))
        self.fps = int(fps)
        self.quality = int(quality)
        self.f = open(self.path, "wb")
        self.parts: List[Tuple[int, int, int]] = []   # ix00 pos, size, n
        self.total = 0
        self.biggest = 0
        self.first_frames = 0
        self._hdrl()
        self._start_riff(b"AVI ")

    # -- layout --------------------------------------------------------

    def _hdrl(self) -> None:
        w, h = self.size
        f = self.f
        f.write(b"RIFF" + _u32(0) + b"AVI ")
        hdrl = bytearray(b"LIST" + _u32(0) + b"hdrl")
        self._avih = len(hdrl) + 8
        hdrl += b"avih" + _u32(56) + bytes(56)
        strl = bytearray(b"strl")
        self._strh = len(hdrl) + 8 + len(strl) + 8
        strl += b"strh" + _u32(56) + bytes(56)
        strl += b"strf" + _u32(40) + struct.pack(
            "<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
        self._indx = len(hdrl) + 8 + len(strl) + 8
        indx = 24 + 16 * _SUPER_ENTRIES
        strl += b"indx" + _u32(indx) + bytes(indx)
        hdrl += b"LIST" + _u32(len(strl)) + strl
        odml = b"odml" + b"dmlh" + _u32(248) + bytes(248)
        self._dmlh = len(hdrl) + 8 + 4 + 8
        hdrl += b"LIST" + _u32(len(odml)) + odml
        struct.pack_into("<I", hdrl, 4, len(hdrl) - 8)
        self._hdrl_at = f.tell()
        f.write(hdrl)
        self.riff = 0                    # the first RIFF starts at 0

    def _start_riff(self, kind: bytes) -> None:
        f = self.f
        if kind != b"AVI ":
            self.riff = f.tell()
            f.write(b"RIFF" + _u32(0) + kind)
        self.movi = f.tell() + 8         # the 'movi' fourcc
        f.write(b"LIST" + _u32(0) + b"movi")
        self.index: List[Tuple[int, int]] = []   # (pos from movi, size)

    def _end_riff(self) -> None:
        f = self.f
        n = len(self.index)
        ix = f.tell()
        body = struct.pack("<HBBI4sQI", 2, 0, 1, n, _CHUNK, self.movi, 0)
        body += b"".join(struct.pack("<II", pos + 8, size)
                         for pos, size in self.index)
        f.write(b"ix00" + _u32(len(body)) + body)
        self.parts.append((ix, 8 + len(body), n))
        end = f.tell()
        f.seek(self.movi - 4)
        f.write(_u32(end - self.movi))
        f.seek(end)
        if self.riff == 0:               # idx1 closes the first RIFF only
            f.write(b"idx1" + _u32(16 * n))
            f.write(b"".join(struct.pack("<4sIII", _CHUNK, _AVIIF_KEYFRAME,
                                         pos, size)
                             for pos, size in self.index))
            self.first_frames = n
            end = f.tell()
        f.seek(self.riff + 4)
        f.write(_u32(end - self.riff - 8))
        f.seek(end)

    # -- frames --------------------------------------------------------

    def write(self, frame: np.ndarray, repeat: int = 1) -> None:
        frame = np.asarray(frame)
        if frame.shape[1::-1] != self.size:
            raise ValueError(f"frame of {frame.shape[1::-1]}, movie of "
                             f"{self.size}")
        self.write_jpeg(jpeg_encode(frame, self.quality, color=True), repeat)

    def write_jpeg(self, data: bytes, repeat: int = 1) -> None:
        size = len(data)
        chunk = _CHUNK + _u32(size) + data + (b"\0" if size & 1 else b"")
        for _ in range(max(1, repeat)):
            n = len(self.index) + 1
            grow = len(chunk) + 8 + 24 + 8 * n + (16 * n if self.riff == 0
                                                  else 0)
            if self.index and self.f.tell() + grow - self.riff > RIFF_LIMIT:
                if len(self.parts) + 1 >= _SUPER_ENTRIES:
                    raise CodecError(f"AVI: past {_SUPER_ENTRIES} RIFF parts, "
                                     f"which the super index can list")
                self._end_riff()
                self._start_riff(b"AVIX")
            self.index.append((self.f.tell() - self.movi, size))
            self.f.write(chunk)
            self.total += 1
            self.biggest = max(self.biggest, size)

    def close(self) -> None:
        if self.f is None:
            return
        self._end_riff()
        f = self.f
        end = f.tell()
        w, h = self.size
        usec = int(round(1e6 / self.fps))
        rate = self.biggest * self.fps
        f.seek(self._hdrl_at + self._avih)
        f.write(struct.pack("<14I", usec, rate, 0, 0x10 | 0x100,
                            self.first_frames, 0, 1, self.biggest, w, h,
                            0, 0, 0, 0))
        f.seek(self._hdrl_at + self._strh)
        f.write(struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"MJPG", 0, 0,
                            0, 0, 1, self.fps, 0, self.total, self.biggest,
                            0xFFFFFFFF, 0, 0, 0, w, h))
        f.seek(self._hdrl_at + self._indx)
        f.write(struct.pack("<HBBI4s3I", 4, 0, 0, len(self.parts), _CHUNK,
                            0, 0, 0))
        f.write(b"".join(struct.pack("<QII", pos, size, n)
                         for pos, size, n in self.parts))
        f.seek(self._hdrl_at + self._dmlh)
        f.write(_u32(self.total))
        f.seek(end)
        f.close()
        self.f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _walk(f, start: int, end: int, out: list, info: dict) -> None:
    pos = start
    while pos + 8 <= end:
        f.seek(pos)
        head = f.read(12)
        if len(head) < 8:
            break
        kind, size = head[:4], struct.unpack("<I", head[4:8])[0]
        body = pos + 8
        if kind in (b"RIFF", b"LIST"):
            _walk(f, body + 4, min(body + size, end), out, info)
        elif kind == b"strh":
            f.seek(body)
            strh = f.read(56)
            scale, rate = struct.unpack_from("<II", strh, 20)
            info["fps"] = rate / scale if scale else 0.0
        elif kind == b"strf":
            f.seek(body)
            info["width"], info["height"] = struct.unpack("<ii", f.read(12)[4:12])
        elif kind[2:] in (b"dc", b"db") and kind[:2].isdigit():
            out.append((body, size))
        pos = body + size + (size & 1)


def avi_info(path) -> dict:
    """fps, width, height and the (offset, size) of every frame chunk."""
    path = Path(path)
    frames: list = []
    info: dict = {}
    with open(path, "rb") as f:
        if f.read(4) != b"RIFF":
            raise CodecError(f"AVI: {path} is not a RIFF file")
        _walk(f, 0, path.stat().st_size, frames, info)
    info["frames"] = frames
    return info


def _standard_tables() -> bytes:
    """An abbreviated stream holding the standard Huffman tables: the DHT
    segments of a JPEG the encoder writes."""
    data = jpeg_encode(np.zeros((8, 16, 3), np.uint8))
    out, i = bytearray(b"\xff\xd8"), 2
    while data[i + 1] != 0xDA:
        n = struct.unpack(">H", data[i + 2:i + 4])[0]
        if data[i + 1] == 0xC4:
            out += data[i:i + 2 + n]
        i += 2 + n
    return bytes(out + b"\xff\xd9")


def read_avi(path) -> Iterator[np.ndarray]:
    """Every frame decoded, in file order: (h, w, 3) RGB or (h, w) gray
    u8."""
    tables = _standard_tables()
    with open(path, "rb") as f:
        for off, size in avi_info(path)["frames"]:
            f.seek(off)
            yield jpeg_decode(f.read(size), tables)
