"""Build the port's CUDA sources with nvcc and load them with ctypes.

`ipp_tpu_torch/csrc/*.cu` compile on first use into one shared library
with a plain C interface: every source to an object file, all nvcc
processes started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
         -fPIC -Xptxas -v -c -o build/ipp_tpu_torch/<src>.o csrc/<src>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o lib...so *.o

The library name carries a hash of the sources, so an edit rebuilds; the
build goes to `build/ipp_tpu_torch/` at the repository root (listed in
.gitignore) through a temporary name and an atomic rename, so concurrent
processes never load a half-written file.  A failed build raises with
nvcc's stderr.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

__all__ = ["load_library", "build_info"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG.parent / "build" / "ipp_tpu_torch"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_info: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# (name, argtypes) of every C entry point; pointers and the stream are
# c_void_p so ctypes never truncates them to 32 bits
_SIGNATURES = {
    "ipp_rdft_y_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "ipp_rdft_y_inv": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "ipp_radix2_stage": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L,
                         _L, _P],
    "ipp_radix2_stage_inv_otf": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _I, _P],
    "ipp_stage_fft_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _L, _P],
    "ipp_stage_fft_inv": [_P, _P, _P, _P, _P, _I, _I, _I, _L, _P],
    "ipp_stage_fft_inv_otf": [_P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I,
                              _P],
    "ipp_stage_mixed": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _I, _I,
                        _P, _I, _I, _I, _I, _I, _P],
    "ipp_stage_large": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _I, _L, _I, _I, _P, _I, _I, _P, _I, _I, _I, _I, _I,
                        _I, _I, _P],
    "ipp_dwt_analysis": [_P, _P, _P, _P, _L, _I, _L, _I, _P],
    "ipp_dwt_analysis_knobs": [_P, _P, _P, _P, _L, _I, _L, _I, _I, _I, _I,
                               _P],
    "ipp_dwt_synthesis": [_P, _P, _P, _P, _L, _I, _L, _I, _P],
    "ipp_cplx_matmul": [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _P],
    "ipp_dft_last": [_P, _P, _P, _P, _P, _I, _L, _I, _I, _P, _I, _I, _I, _I,
                     _P],
    "ipp_rdft_y_fwd_fft": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                           _I, _I, _I, _P],
    "ipp_rdft_y_inv_fft": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                           _I, _I, _I, _P],
}


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of ipp_tpu_torch cannot be built")


def _run(cmds):
    """Run nvcc commands side by side; raise with the stderr of the first
    that fails.  Returns their joined compiler output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    logs, failed = [], None
    for cmd, proc in procs:
        out, err = proc.communicate()
        logs.append(err + out)
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, err)
    if failed is not None:
        cmd, rc, err = failed
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{err}")
    return "".join(logs)


def _build(target: Path) -> str:
    nvcc = _nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{target.stem}.{os.getpid()}"
    objs = [target.with_name(f".{tag}.{src.stem}.o")
            for src in sorted(_CSRC.glob("*.cu"))]
    tmp = target.with_name(f".{tag}.tmp")
    try:
        log = _run([[nvcc, *_ARCH, "-std=c++17", "-O3", "-Xcompiler",
                     "-fPIC", "-Xptxas", "-v", "-c", "-o", str(obj),
                     str(src)]
                    for obj, src in zip(objs, sorted(_CSRC.glob("*.cu")))])
        log += _run([[nvcc, *_ARCH, "-shared", "-o", str(tmp),
                      *[str(o) for o in objs]]])
        os.replace(tmp, target)
    finally:
        for f in objs + [tmp]:
            f.unlink(missing_ok=True)
    target.with_suffix(".log").write_text(log)
    return log


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    library yet."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256()
        for p in _sources():
            h.update(p.name.encode())
            h.update(p.read_bytes())
        target = _BUILD_DIR / f"libipp_tpu_torch_{h.hexdigest()[:16]}.so"
        t0 = time.perf_counter()
        built = not target.exists()
        log = _build(target) if built else ""
        lib = ctypes.CDLL(str(target))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _info.update(path=str(target), built=built,
                     seconds=time.perf_counter() - t0, ptxas=log)
        _lib = lib
        return lib


def build_info() -> dict:
    """Library path, whether this process built it, the seconds taken and
    ptxas' register/shared-memory report (empty until load_library)."""
    return dict(_info)
