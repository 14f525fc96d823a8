"""numpy/jax.numpy `pad` on tensors, for every mode and pad size.

`F.pad` takes reflect pads only up to the axis length and only on 3-D or
4-D inputs; `jnp.pad` (which the reference's destripe, blur and resize
use) takes any pad.  Here each padded axis gathers the indices that
`np.pad(np.arange(n), (before, after), mode)` yields, which is exact for
every index mode ('wrap', 'reflect', 'symmetric', 'edge') and size; the
'constant' mode pads zeros.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["pad_trailing"]


def pad_trailing(x: torch.Tensor, pads: Sequence[Tuple[int, int]],
                 mode: str) -> torch.Tensor:
    """Pad the trailing len(pads) axes of x by (before, after) each, as
    np.pad(x, [(0, 0)] * lead + pads, mode) would."""
    lead = x.dim() - len(pads)
    if mode == "constant":
        flat = []
        for before, after in reversed(list(pads)):
            flat += [int(before), int(after)]
        return F.pad(x, flat) if any(flat) else x
    for i, (before, after) in enumerate(pads):
        if before or after:
            dim = lead + i
            idx = np.pad(np.arange(x.shape[dim]), (int(before), int(after)),
                         mode=mode)
            x = x.index_select(dim, torch.from_numpy(idx).to(x.device))
    return x
