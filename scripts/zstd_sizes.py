#!/usr/bin/env python3
"""Frame sizes of the port's Zstandard encoder against libzstd's.

    python3 scripts/zstd_sizes.py [--planes N] [--levels L,L,...]

Compresses the tests' corpus (`tests/torch_zstd_corpus.py`: bricks at N
planes of 256^2, 64 by default, and the edge cases) with the port's
ZSTD_compress (fastio's library: native/zstd_enc.cpp) and the system
libzstd's (through ctypes) at each level (-5, 1, 3, 9, 19, 22 by default)
and prints, per entry and level, both sizes, their ratio and both
compressors' MB/s on one thread of this host; every frame is decoded by
libzstd and checked.  Needs the libzstd shared library; reads and writes
nothing else.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def arg(name, default):
    return sys.argv[sys.argv.index(name) + 1] if name in sys.argv else default


def main() -> int:
    from ipp_tpu_torch import native
    from tests import torch_zstd_corpus as zc

    name = ctypes.util.find_library("zstd") or "libzstd.so.1"
    try:
        theirs = zc.bind(ctypes.CDLL(name))
    except OSError:
        theirs = None
    if theirs is None or not native.available():
        print(f"FAIL: libzstd {name}, fastio {native.build_error()}")
        return 1
    ours = zc.bind(ctypes.CDLL(str(native._library_path())))
    planes = int(arg("--planes", "64"))
    levels = [int(v) for v in arg("--levels", "-5,1,3,9,19,22").split(",")]
    corpus = zc.make_corpus(planes)
    print(f"corpus: bricks of {planes} x 256 x 256; libzstd {name}")
    worst = {}
    for key, data in corpus.items():
        for level in levels:
            row = []
            for lib in (ours, theirs):
                t0 = time.perf_counter()
                frame = zc.compress(lib, data, level)
                row.append((len(frame), time.perf_counter() - t0))
                assert zc.decompress(theirs, frame, len(data)) == data
            (a, ta), (b, tb) = row
            r = a / b if b else 1.0
            worst[level] = max(worst.get(level, 0.0), r)
            print(f"{key:15s} level {level:3d}: {len(data):9d} bytes -> port "
                  f"{a:9d} ({len(data) / max(ta, 1e-9) / 1e6:7.1f} MB/s), "
                  f"libzstd {b:9d} ({len(data) / max(tb, 1e-9) / 1e6:7.1f} "
                  f"MB/s), port / libzstd {r:.4f}")
    print("largest port / libzstd by level: " + ", ".join(
        f"{lv}: {r:.4f}" for lv, r in worst.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
