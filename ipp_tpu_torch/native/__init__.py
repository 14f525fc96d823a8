"""ctypes bindings for the native fastio runtime (fastio.cpp), the port's
copy of ipp_tpu/native.

Builds the shared library with g++ on first use (`build_shared`, which
the port's other host codecs use too), into `build/ipp_tpu_torch/` at the
repository root (listed in .gitignore), under a name that carries a hash
of its sources, headers and g++ flags, through a temporary name and an
atomic rename (concurrent processes never load a half-written file).
fastio.cpp includes <zstd.h>; the port's own `native/include/zstd.h`
answers it, on the port's Zstandard codec (zstd.cpp decodes, zstd_enc.cpp
encodes, zstd_api.cpp gives libzstd's four calls), so the library needs
g++ and zlib only, never libzstd.  When the build fails anyway,
`build_error()` says why: the TIFF calls return None / False and the
callers read and write through numpy (ipp_tpu_torch.io.tiff), as the
reference does without its library; the brick cache calls (`zstd_save`,
`zstd_load`, `load_slab`) return False / None and have no fallback.
This is host IO, a throughput optimisation mirroring the reference's C++
MEX IO (load_bl_tif.cpp / save_bl_tif.cpp / *_lz4_*).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["build_shared", "available", "build_error", "read_block",
           "warn_zero_filled",
           "tiff_read", "tiff_write",
           "zstd_save", "zstd_load", "load_slab", "load_slab_serial",
           "load_slab_auto", "slab_mode"]

_SRC = Path(__file__).resolve().parent / "fastio.cpp"
# fastio's build: the port's Zstandard codec beside it, its zstd.h first on
# the include path; -Bsymbolic binds fastio's ZSTD_* calls to these, even
# where another module has loaded libzstd globally
_ZSTD_SOURCES = tuple(_SRC.parent / f for f in ("zstd.cpp", "zstd_enc.cpp",
                                                "zstd_api.cpp"))
_INCLUDE = (_SRC.parent / "include",)
_FLAGS = ("-O3", "-pthread", "-Wl,-Bsymbolic")
_LIBS = ("-lz",)
_BUILD_DIR = _SRC.parent.parent.parent / "build" / "ipp_tpu_torch"
_lib = None
_build_error: Optional[str] = None
_build_lock = threading.Lock()
_ABI_VERSION = 2  # must match fastio_abi_version() in fastio.cpp


def library_path(src: Path, flags: Sequence[str] = ("-O2",),
                 libs: Sequence[str] = (), sources: Sequence[Path] = (),
                 include: Sequence[Path] = ()) -> Path:
    """Where `build_shared` builds `src` with these arguments:
    build/ipp_tpu_torch/lib<stem>_<hash>.so, the hash over every source,
    every header in the include directories and the flags, so that a
    change to any one of them builds a new library."""
    h = hashlib.sha256()
    headers = sorted(f for d in include for f in Path(d).rglob("*.h"))
    for f in (src, *sources, *headers):
        h.update(Path(f).name.encode() + b"\0" + Path(f).read_bytes())
    h.update("\0".join((*flags, *libs)).encode())
    return _BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_shared(src: Path, abi_symbol: str, abi_version: int,
                 flags: Sequence[str] = ("-O2",),
                 libs: Sequence[str] = (), sources: Sequence[Path] = (),
                 include: Sequence[Path] = ()) -> ctypes.CDLL:
    """`src` and `sources` built with g++ into one library (unless built
    already), `include` first on the include path, and loaded; its
    `abi_symbol()` must return `abi_version`, since a library whose ABI
    differs from its bindings would corrupt memory.  Raises OSError when
    the build, the load or that check fails."""
    target = library_path(src, flags, libs, sources, include)
    try:
        lib = ctypes.CDLL(str(target)) if target.exists() else None
    except OSError:
        lib = None
    if lib is None:
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f".{target.name}.{os.getpid()}."
                               f"{threading.get_ident()}.tmp")
        try:
            run = subprocess.run(
                ["g++", *flags, "-std=c++17", "-shared", "-fPIC",
                 *(f"-I{d}" for d in include), str(src),
                 *(str(f) for f in sources), "-o", str(tmp), *libs],
                capture_output=True, text=True, timeout=300)
            if run.returncode != 0:
                raise OSError(f"g++ exit {run.returncode}: "
                              f"{run.stderr.strip()[-2000:]}")
            os.replace(tmp, target)
        except subprocess.SubprocessError as e:
            raise OSError(f"g++: {e}") from e
        finally:
            tmp.unlink(missing_ok=True)
        lib = ctypes.CDLL(str(target))
    try:
        fn = getattr(lib, abi_symbol)
    except AttributeError:
        raise OSError(f"{target.name} has no {abi_symbol}") from None
    fn.restype = ctypes.c_int
    if fn() != abi_version:
        raise OSError(f"{target.name}: ABI {fn()}, {abi_version} expected")
    return lib


def _library_path() -> Path:
    return library_path(_SRC, _FLAGS, _LIBS, _ZSTD_SOURCES, _INCLUDE)


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    if _lib is not None:
        return _lib if _lib != "unavailable" else None
    with _build_lock:
        if _lib is None:
            try:
                lib = build_shared(_SRC, "fastio_abi_version", _ABI_VERSION,
                                   _FLAGS, _LIBS, _ZSTD_SOURCES, _INCLUDE)
                _configure(lib)
                _lib = lib
            except OSError as e:    # the callers fall back to numpy
                _lib = "unavailable"
                _build_error = f"{type(e).__name__}: {e}"
    return _lib if _lib != "unavailable" else None


def build_error() -> Optional[str]:
    """Why fastio did not build or load (g++'s message, its last 2000
    characters), after a call that tried; None when it built or no call
    has tried yet."""
    return _build_error


def _configure(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.fastio_tiff_info.argtypes = [c.c_char_p] + [c.POINTER(c.c_int32)] * 4
    lib.fastio_tiff_info.restype = c.c_int
    lib.fastio_tiff_read.argtypes = [c.c_char_p, c.c_void_p, c.c_int64]
    lib.fastio_tiff_read.restype = c.c_int
    lib.fastio_read_block.argtypes = [
        c.POINTER(c.c_char_p), c.c_int32, c.c_int32, c.c_int32, c.c_int32,
        c.c_int32, c.c_void_p, c.c_int32, c.c_int32, c.c_int32, c.c_void_p]
    lib.fastio_read_block.restype = c.c_int
    lib.fastio_tiff_write.argtypes = [
        c.c_char_p, c.c_void_p, c.c_int32, c.c_int32, c.c_int32, c.c_int32,
        c.c_int32]
    lib.fastio_tiff_write.restype = c.c_int
    lib.fastio_zstd_save.argtypes = [c.c_char_p, c.c_void_p, c.c_int64,
                                     c.c_int32]
    lib.fastio_zstd_save.restype = c.c_int
    lib.fastio_zstd_load.argtypes = [c.c_char_p, c.c_void_p, c.c_int64]
    lib.fastio_zstd_load.restype = c.c_int64
    lib.fastio_load_slab.argtypes = [
        c.POINTER(c.c_char_p), c.c_int32, c.POINTER(c.c_int32),
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.c_int32, c.c_int32, c.c_int32, c.c_void_p, c.c_int32, c.c_int32]
    lib.fastio_load_slab.restype = c.c_int


def available() -> bool:
    return _get_lib() is not None


def _dtype_meta(dtype) -> Tuple[int, int]:
    """(bits, TIFF SampleFormat) for a dtype; SampleFormat 0 = not
    representable (bool, complex, ...) — readers treat it as don't-care,
    the writer refuses and falls back to the Python codec."""
    dt = np.dtype(dtype)
    sfmt = {"u": 1, "i": 2, "f": 3}.get(dt.kind, 0)
    return dt.itemsize * 8, sfmt


def tiff_read(path) -> Optional[np.ndarray]:
    """Native single-TIFF decode; None if unsupported (caller falls back)."""
    lib = _get_lib()
    if lib is None:
        return None
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    bits = ctypes.c_int32()
    sfmt = ctypes.c_int32()
    if lib.fastio_tiff_info(str(path).encode(), ctypes.byref(w),
                            ctypes.byref(h), ctypes.byref(bits),
                            ctypes.byref(sfmt)) != 0:
        return None
    kind = {1: "u", 2: "i", 3: "f"}.get(sfmt.value, "u")
    if bits.value not in (8, 16, 32, 64):  # corrupt header
        return None
    dt = np.dtype(f"{kind}{bits.value // 8}")
    out = np.empty((h.value, w.value), dt)
    rc = lib.fastio_tiff_read(str(path).encode(),
                              out.ctypes.data_as(ctypes.c_void_p), out.nbytes)
    return out if rc == 0 else None


def tiff_write(path, img: np.ndarray, compress_level: int = 0) -> bool:
    lib = _get_lib()
    if lib is None or img.ndim != 2:
        return False
    img = np.ascontiguousarray(img)
    bits, sfmt = _dtype_meta(img.dtype)
    if sfmt == 0:  # dtype has no TIFF SampleFormat: Python codec path
        return False
    rc = lib.fastio_tiff_write(str(path).encode(),
                               img.ctypes.data_as(ctypes.c_void_p),
                               img.shape[0], img.shape[1], bits, sfmt,
                               compress_level)
    return rc == 0


def read_block(paths: Sequence, y0: int, y1: int, x0: int, x1: int,
               dtype=np.uint16, nthreads: int = 8) -> Optional[np.ndarray]:
    """Threaded ROI block load: (len(paths), y1-y0, x1-x0).

    Planes the minimal C++ parser cannot decode (tiled layout, LZW, zstd,
    big-endian f32, ...) are re-read through the robust Python codec
    (ipp_tpu_torch.io.tiff.imread: numpy parser, the port's own codecs,
    retries), one after another on this thread; only
    genuinely missing/corrupt files come back zero-filled — the reference's
    dummy-substitution semantics (tsv/volume.py:378-397).  A plane in an
    encoding the port does not read raises UnsupportedTiffError naming
    it: zeros there would be a wrong result, not a dummy."""
    lib = _get_lib()
    if lib is None:
        return None
    dt = np.dtype(dtype)
    _, sfmt = _dtype_meta(dt)  # 0 = don't-care for unusual kinds
    out = np.empty((len(paths), y1 - y0, x1 - x0), dt)
    enc = [str(p).encode() for p in paths]
    arr = (ctypes.c_char_p * len(enc))(*enc)
    failed = np.zeros(len(enc), np.uint8)
    n_failed = lib.fastio_read_block(
        arr, len(enc), y0, y1, x0, x1,
        out.ctypes.data_as(ctypes.c_void_p), dt.itemsize, sfmt, nthreads,
        failed.ctypes.data_as(ctypes.c_void_p))
    if n_failed:
        from ..io import tiff as _tio

        for z in np.nonzero(failed)[0]:
            try:
                # only the decode is guarded (same invariant as
                # TileStack.imread): a wrong-SIZED plane raises loudly
                # below instead of silently zero-filling
                img = _tio.imread(paths[z], retries=2)
            except _tio.UnsupportedTiffError:
                raise       # names the file and its encoding
            except Exception:
                out[z] = 0  # genuinely missing/corrupt: dummy zeros
                warn_zero_filled(paths[z])
                continue
            out[z] = img[y0:y1, x0:x1].astype(dt, copy=False)
    return out


def warn_zero_filled(path) -> None:
    """The dummy-substitution notice (reference tsv/volume.py:378-397):
    an undecodable or missing plane becomes zeros, LOUDLY — shared by the
    native fallback and TileStack.imread's Python path so the message and
    semantics cannot drift."""
    import warnings

    warnings.warn(
        f"zero-filled undecodable plane {path} (the reference's "
        "dummy-substitution semantics, tsv/volume.py:378-397)",
        stacklevel=3)


def zstd_save(path, arr: np.ndarray, level: int = 3) -> bool:
    lib = _get_lib()
    if lib is None:
        return False
    arr = np.ascontiguousarray(arr)
    rc = lib.fastio_zstd_save(str(path).encode(),
                              arr.ctypes.data_as(ctypes.c_void_p),
                              arr.nbytes, level)
    return rc == 0


def zstd_load(path, shape, dtype) -> Optional[np.ndarray]:
    lib = _get_lib()
    if lib is None:
        return None
    out = np.empty(shape, dtype)
    got = lib.fastio_zstd_load(str(path).encode(),
                               out.ctypes.data_as(ctypes.c_void_p), out.nbytes)
    return out if got == out.nbytes else None


def load_slab(bricks: List[Tuple[str, int, int, int, int]], bz: int,
              slab_h: int, slab_w: int, dtype=np.float32,
              nthreads: int = 8) -> Optional[np.ndarray]:
    """Assemble [(path, y0, x0, by, bx)] bricks into a (bz, slab_h, slab_w)
    slab (reference load_slab_lz4.cpp)."""
    lib = _get_lib()
    if lib is None:
        return None
    dt = np.dtype(dtype)
    out = np.zeros((bz, slab_h, slab_w), dt)
    enc = [str(b[0]).encode() for b in bricks]
    arr = (ctypes.c_char_p * len(enc))(*enc)
    y0s = (ctypes.c_int32 * len(bricks))(*[b[1] for b in bricks])
    x0s = (ctypes.c_int32 * len(bricks))(*[b[2] for b in bricks])
    bys = (ctypes.c_int32 * len(bricks))(*[b[3] for b in bricks])
    bxs = (ctypes.c_int32 * len(bricks))(*[b[4] for b in bricks])
    rc = lib.fastio_load_slab(arr, len(bricks), y0s, x0s, bys, bxs, bz,
                              slab_h, slab_w,
                              out.ctypes.data_as(ctypes.c_void_p),
                              dt.itemsize, nthreads)
    return out if rc == 0 else None


def load_slab_serial(bricks: List[Tuple[str, int, int, int, int]], bz: int,
                     slab_h: int, slab_w: int,
                     dtype=np.float32) -> Optional[np.ndarray]:
    """Single-threaded slab assembly: one zstd_load per brick into the
    output array.  On hosts pinned to one schedulable CPU this beats the
    threaded C++ path (BENCH_r04 measured 0.8x for threads)."""
    dt = np.dtype(dtype)
    out = np.zeros((bz, slab_h, slab_w), dt)
    for p, y0, x0, by, bx in bricks:
        b = zstd_load(p, (bz, by, bx), dt)
        if b is None:
            return None
        out[:, y0:y0 + by, x0:x0 + bx] = b
    return out


_slab_choice = {"mode": None}


def slab_mode() -> Optional[str]:
    """The slab-assembly mode load_slab_auto calibrated to ('native' |
    'serial'), or None before the first call."""
    return _slab_choice["mode"]


def load_slab_auto(bricks: List[Tuple[str, int, int, int, int]], bz: int,
                   slab_h: int, slab_w: int, dtype=np.float32,
                   nthreads: int = 8) -> Optional[np.ndarray]:
    """Slab assembly that is never the slower path (VERDICT r4 item 8).

    The reference claims 6-8x for its threaded load_slab_lz4
    (LsDeconvolveMultiGPU/README.md:42), but on a host cgroup-pinned to one
    schedulable CPU the thread pool measured 0.8x serial (BENCH_r04).  The
    first call races both implementations on the caller's actual bricks and
    caches the winner for the process lifetime; hosts with one schedulable
    CPU (or no native library) skip straight to serial.
    """
    import os
    import time

    mode = _slab_choice["mode"]
    if mode is None:
        try:
            ncpu = len(os.sched_getaffinity(0))
        except AttributeError:  # pragma: no cover - non-Linux
            ncpu = os.cpu_count() or 1
        if ncpu <= 1 or _get_lib() is None:
            _slab_choice["mode"] = "serial"
        else:
            # warm the page cache first so neither arm gets disk-bound
            # while the other reads RAM-cached files (never time a
            # first call) — otherwise the first arm is
            # systematically penalized and the slower mode gets pinned
            for b in bricks:
                try:
                    with open(b[0], "rb") as f:
                        while f.read(1 << 22):
                            pass
                except OSError:
                    pass
            t0 = time.perf_counter()
            nat = load_slab(bricks, bz, slab_h, slab_w, dtype, nthreads)
            t_nat = time.perf_counter() - t0
            t0 = time.perf_counter()
            ser = load_slab_serial(bricks, bz, slab_h, slab_w, dtype)
            t_ser = time.perf_counter() - t0
            # a failed arm can't win (its short wall is a failure, not
            # speed); prefer whichever produced a result
            if nat is None and ser is None:
                _slab_choice["mode"] = "serial"
                return None
            if nat is None or ser is None:
                _slab_choice["mode"] = "serial" if nat is None else "native"
                return ser if nat is None else nat
            _slab_choice["mode"] = ("native" if t_nat <= t_ser
                                    else "serial")
            return nat if _slab_choice["mode"] == "native" else ser
        mode = _slab_choice["mode"]
    if mode == "native":
        out = load_slab(bricks, bz, slab_h, slab_w, dtype, nthreads)
        if out is not None:
            return out
    return load_slab_serial(bricks, bz, slab_h, slab_w, dtype)
