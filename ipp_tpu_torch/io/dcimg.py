"""Hamamatsu DCIMG reader (v1.0 and DCAM-API-4 "2.0" session layouts).

Replaces the reference's dcimg dependency (pystripe/core.py DCIMGFile use)
and mirrors the format handling of the TeraStitcher dcimg ioplugin
(src/iomanager/plugins/dcimg/dcimg.cpp:100-290):

v1.0 (format_version < 0x1000000, the layout the reference plugin reads):
- file header: magic 'DCIMG', format_version u32 @8, nsess u32 @32,
  nfrms u32 @36, header_size u32 @40;
- session header at `header_size`: session_size u64, 6 reserved u32,
  nfrms u32, byte_depth u32, reserved, xsize u32, bytes_per_row u32,
  ysize u32;
- frame pixel data packed contiguously from byte offset 232;
- camera quirk: the first 4 pixels of each frame's first row hold metadata
  and are replaced with the pixels below them (dcimg.cpp:271-273).

"2.0" (format_version >= 0x2000000, written by DCAM-API 4+; the reference
plugin predates it and would misparse — its layout here follows the
publicly documented structure used by the open python-dcimg reader):
- same file header;
- session header at `header_size`: session_size u64 @0, 13 reserved u32,
  nfrms u32 @0x3C, byte_depth u32 @0x40, reserved u32, xsize u32 @0x48,
  ysize u32 @0x4C, bytes_per_row u32 @0x50, bytes_per_img u32 @0x54,
  2 reserved u32, offset_to_data u64 @0x60, frame_footer_size u32 @0x68;
- frame z lives at header_size + offset_to_data +
  z * (bytes_per_img + frame_footer_size); each frame is followed by its
  footer (timestamps/metadata) — pixel data is stored intact (no
  first-row metadata pixels), so no fixup applies.
  NOT yet validated against files from real DCAM-API 4 cameras (no sample
  files in this environment); the synthetic-fixture round-trip in
  tests/test_exports.py pins the implemented layout.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Union

import numpy as np

__all__ = ["DCIMGFile", "dcimg_imread"]

FMT_NEW = 0x2000000


class DCIMGFile:
    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            head = f.read(44)
            if head[:5] != b"DCIMG":
                raise ValueError(f"not a DCIMG file: {self.path}")
            self.format_version = struct.unpack_from("<I", head, 8)[0]
            if 0x1000000 <= self.format_version < FMT_NEW:
                # intermediate DCAM-API session layouts differ again;
                # misparsing them would return garbage pixels silently
                raise ValueError(
                    f"unsupported DCIMG format version "
                    f"0x{self.format_version:x} in {self.path}; the "
                    "contiguous-session v1.0 layout (< 0x1000000) and the "
                    "DCAM-API-4 layout (>= 0x2000000) are implemented")
            self.nsess = struct.unpack_from("<I", head, 32)[0]
            self.nfrms = struct.unpack_from("<I", head, 36)[0]
            header_size = struct.unpack_from("<I", head, 40)[0]
            f.seek(header_size)
            if self.format_version >= FMT_NEW:
                sess = f.read(0x6C)
                (self.session_size,) = struct.unpack_from("<Q", sess, 0)
                nfrms2, byte_depth, _r, xsize, ysize, bytes_per_row, \
                    bytes_per_img = struct.unpack_from("<7I", sess, 0x3C)
                (offset_to_data,) = struct.unpack_from("<Q", sess, 0x60)
                (footer,) = struct.unpack_from("<I", sess, 0x68)
                self.byte_depth = byte_depth
                self.xsize = xsize
                self.ysize = ysize
                self.bytes_per_row = bytes_per_row
                self._bytes_per_img = bytes_per_img
                self._frame_footer = footer
                self._data_offset = header_size + offset_to_data
                self._fixup_first_row = False
                # new-format semantics follow python-dcimg: xsize = image
                # WIDTH, ysize = HEIGHT, frames are (ysize, xsize) — the
                # width=ysize swap below applies ONLY to the v1.0 header
                # whose field order was (xsize, bytes_per_row, ysize)
                self.shape = (self.nfrms, self.ysize, self.xsize)
                self.dtype = (np.uint16 if self.byte_depth == 2
                              else np.uint8)
                self._validate()
                return
            else:
                sess = f.read(64)
                (self.session_size,) = struct.unpack_from("<Q", sess, 0)
                nfrms2, byte_depth, _r, xsize, bytes_per_row, ysize = (
                    struct.unpack_from("<6I", sess, 32))
                self.byte_depth = byte_depth
                self.xsize = xsize
                self.ysize = ysize
                self.bytes_per_row = bytes_per_row
                self._bytes_per_img = xsize * ysize * byte_depth
                self._frame_footer = 0
                self._data_offset = 232
                self._fixup_first_row = True
        # the TeraStitcher plugin maps width=ysize, height=xsize
        self.shape = (self.nfrms, self.xsize, self.ysize)
        self.dtype = np.uint16 if self.byte_depth == 2 else np.uint8
        self._validate()

    def _validate(self) -> None:
        """Header sanity: a corrupt header must raise here, not trigger a
        huge allocation or a garbage frame in read_frame (the fuzz-corpus
        contract shared with the TIFF salvage reader, tests/test_native.py)."""
        nfrms, h, w = self.shape
        fsize = self.path.stat().st_size
        need = self._data_offset + nfrms * (
            self._bytes_per_img + self._frame_footer)
        if (nfrms <= 0 or h <= 0 or w <= 0
                or self.byte_depth not in (1, 2)
                or self._bytes_per_img < w * self.byte_depth * h
                or need > fsize):
            raise ValueError(f"corrupt DCIMG header in {self.path}: "
                             f"{nfrms} frames of {h}x{w}x{self.byte_depth}B "
                             f"need {need} bytes, file has {fsize}")

    def read_frame(self, z: int) -> np.ndarray:
        nfrms, h, w = self.shape
        if not 0 <= z < nfrms:
            raise IndexError(z)
        row_bytes = w * self.byte_depth
        # new format honors bytes_per_row (rows may pad past the pixel
        # width); v1.0 reads contiguous pixels exactly like the reference
        # plugin (dcimg.cpp readData ignores its bytes_per_row field)
        stride_row = (row_bytes if self._fixup_first_row
                      else max(self.bytes_per_row, row_bytes))
        stride = self._bytes_per_img + self._frame_footer
        with open(self.path, "rb") as f:
            f.seek(self._data_offset + z * stride)
            raw = f.read(stride_row * h)
        if len(raw) < stride_row * h:
            raise ValueError(f"truncated DCIMG frame {z} in {self.path}")
        rows = np.frombuffer(raw, dtype=np.uint8).reshape(h, stride_row)
        img = rows[:, :row_bytes].copy().view(self.dtype).reshape(h, w)
        if self._fixup_first_row and h > 1:
            # metadata-pixel fixup, v1.0 only (dcimg.cpp:271-273)
            img[0, :4] = img[1, :4]
        return img

    def __getitem__(self, z):
        if isinstance(z, slice):
            return np.stack([self.read_frame(i)
                             for i in range(*z.indices(self.shape[0]))])
        return self.read_frame(z)

    def __len__(self):
        return self.shape[0]

    @staticmethod
    def write(path: Union[str, Path], frames: np.ndarray,
              format_version: int = 0x7,
              frame_footer_size: int = 32) -> None:
        """Write a DCIMG container (for tests / interop checks) in either
        the v1.0 (format_version=0x7) or DCAM-API-4 (0x2000000) layout."""
        frames = np.asarray(frames)
        assert frames.ndim == 3
        nfrms, h, w = frames.shape
        byte_depth = frames.dtype.itemsize
        header_size = 100
        with open(path, "wb") as f:
            head = bytearray(header_size)
            head[:5] = b"DCIMG"
            struct.pack_into("<I", head, 8, format_version)
            struct.pack_into("<I", head, 32, 1)        # nsess
            struct.pack_into("<I", head, 36, nfrms)
            struct.pack_into("<I", head, 40, header_size)
            f.write(head)
            if format_version >= FMT_NEW:
                sess_len = 0x80
                offset_to_data = sess_len  # relative to header_size
                bytes_per_img = h * w * byte_depth
                sess = bytearray(sess_len)
                struct.pack_into("<Q", sess, 0, sess_len)
                # new-format field semantics: xsize = WIDTH, ysize = HEIGHT
                struct.pack_into("<7I", sess, 0x3C, nfrms, byte_depth, 0,
                                 w, h, w * byte_depth, bytes_per_img)
                struct.pack_into("<Q", sess, 0x60, offset_to_data)
                struct.pack_into("<I", sess, 0x68, frame_footer_size)
                f.write(sess)
                footer = bytes(frame_footer_size)
                for z in range(nfrms):
                    f.write(np.ascontiguousarray(frames[z]).tobytes())
                    f.write(footer)
            else:
                sess = bytearray(232 - header_size)
                struct.pack_into("<Q", sess, 0, len(sess))
                struct.pack_into("<6I", sess, 32, nfrms, byte_depth, 0,
                                 h, w * byte_depth, w)
                f.write(sess)
                f.write(np.ascontiguousarray(frames).tobytes())


def dcimg_imread(path: Union[str, Path], z: int = 0) -> np.ndarray:
    return DCIMGFile(path).read_frame(z)
