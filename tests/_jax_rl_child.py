"""Child process of tests/test_torch_deconv.py's regularised RL twin.

Runs the JAX package's `richardson_lucy` (XLA FFT, as the twin tests set
it) on the volume and PSF of --inp for each keyword set of --kwargs (a
JSON list) and saves the results as r0, r1, ... to --out.  The parent
starts it with XLA_FLAGS=--xla_backend_optimization_level=0: XLA's CPU
backend segfaults on the regularised call at the walk shape (256, 24, 256)
with its default optimisation, in a process that never imports torch, and
the crash would take the test's worker down with it.
"""

import argparse
import json

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")

from ipp_tpu.ops import deconv as dj  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--inp", required=True)
    ap.add_argument("--kwargs", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    dj._RESOLVED_FFT = "xla"
    data = np.load(args.inp)
    out = {f"r{i}": np.asarray(dj.richardson_lucy(data["vol"], data["psf"],
                                                  **kw))
           for i, kw in enumerate(json.loads(args.kwargs))}
    np.savez(args.out, **out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
