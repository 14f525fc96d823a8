"""Volume extents — the 3D bounding-box algebra underlying stitching.

Re-design of the reference's VExtent family (tsv/volume.py:65-197) as a
frozen dataclass: half-open [x0,x1) x [y0,y1) x [z0,z1) boxes with
intersection/containment tests used by the merge stage.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

__all__ = ["VExtent"]


@dataclass(frozen=True, order=True)
class VExtent:
    """Half-open voxel extent (reference: tsv/volume.py:65-197)."""

    x0: int
    x1: int
    y0: int
    y1: int
    z0: int
    z1: int

    @property
    def shape(self) -> Tuple[int, int, int]:
        """(z, y, x) shape, numpy axis order (reference: tsv/volume.py:100)."""
        return (self.z1 - self.z0, self.y1 - self.y0, self.x1 - self.x0)

    def start(self, idx: int) -> int:
        """Start coordinate along numpy axis idx (0=z, 1=y, 2=x)."""
        return (self.z0, self.y0, self.x0)[idx]

    def end(self, idx: int) -> int:
        return (self.z1, self.y1, self.x1)[idx]

    def intersects(self, other: "VExtent") -> bool:
        """(reference: tsv/volume.py:112-122)"""
        return (self.x0 < other.x1 and self.x1 > other.x0 and
                self.y0 < other.y1 and self.y1 > other.y0 and
                self.z0 < other.z1 and self.z1 > other.z0)

    def intersection(self, other: "VExtent") -> "VExtent":
        """(reference: tsv/volume.py:124-133)"""
        return VExtent(max(self.x0, other.x0), min(self.x1, other.x1),
                       max(self.y0, other.y0), min(self.y1, other.y1),
                       max(self.z0, other.z0), min(self.z1, other.z1))

    def contains(self, other: "VExtent") -> bool:
        """(reference: tsv/volume.py:135-144)"""
        return (self.x0 <= other.x0 and self.x1 >= other.x1 and
                self.y0 <= other.y0 and self.y1 >= other.y1 and
                self.z0 <= other.z0 and self.z1 >= other.z1)

    def contains_point(self, x: int, y: int, z: int) -> bool:
        return (self.x0 <= x < self.x1 and
                self.y0 <= y < self.y1 and
                self.z0 <= z < self.z1)

    def shifted(self, dx: int = 0, dy: int = 0, dz: int = 0) -> "VExtent":
        return VExtent(self.x0 + dx, self.x1 + dx, self.y0 + dy, self.y1 + dy,
                       self.z0 + dz, self.z1 + dz)

    def local_slices(self, sub: "VExtent"):
        """numpy (z, y, x) slices of `sub` relative to this extent's origin."""
        return (slice(sub.z0 - self.z0, sub.z1 - self.z0),
                slice(sub.y0 - self.y0, sub.y1 - self.y0),
                slice(sub.x0 - self.x0, sub.x1 - self.x0))

    def __str__(self):
        return (f"VExtent(x={self.x0}:{self.x1}, y={self.y0}:{self.y1}, "
                f"z={self.z0}:{self.z1})")
