"""Tile-grid volume model with TeraStitcher-compatible XML interop.

Re-design of the reference's unstitched-volume models:
- TSVStack / TSVVolume XML consumption (tsv/volume.py:304-807),
- vm::Stack XML production (TeraStitcher/src/volumemanager/vmStack.cpp:360-398),
- DisplacementMIPNCC XML schema (src/stitcher/DisplacementMIPNCC.cpp:375-394).

Axis naming follows TeraStitcher: V = vertical = y = row direction,
H = horizontal = x = column direction, D = depth = z.
Keeping the XML format means outputs stay interoperable with TeraFly/Imaris
tooling and the reference's own scripts.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple
from xml.etree import ElementTree as ET

import numpy as np

from ..io import tiff as tio
from ..io.raw import raw_imread
from .extent import VExtent

__all__ = ["Displacement", "TileStack", "TileGrid"]


@dataclass
class Displacement:
    """Pairwise MIP-NCC displacement record, one per axis (V, H, D).

    (reference: DisplacementMIPNCC.cpp:375-394 XML schema)."""

    displ: Tuple[int, int, int] = (0, 0, 0)
    default_displ: Tuple[int, int, int] = (0, 0, 0)
    reliability: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ncc_peak: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ncc_width: Tuple[int, int, int] = (0, 0, 0)
    ncc_w_range_thr: Tuple[int, int, int] = (0, 0, 0)
    ncc_inv_width: Tuple[int, int, int] = (0, 0, 0)
    delay: Tuple[int, int, int] = (0, 0, 0)

    AXES = ("V", "H", "D")

    def to_xml(self) -> ET.Element:
        el = ET.Element("Displacement", TYPE="MIP_NCC")
        for i, ax in enumerate(self.AXES):
            d = ET.SubElement(el, ax)
            d.set("displ", str(int(self.displ[i])))
            d.set("default_displ", str(int(self.default_displ[i])))
            d.set("reliability", f"{self.reliability[i]:.6f}")
            d.set("nccPeak", f"{self.ncc_peak[i]:.6f}")
            d.set("nccWidth", str(int(self.ncc_width[i])))
            d.set("nccWRangeThr", str(int(self.ncc_w_range_thr[i])))
            d.set("nccInvWidth", str(int(self.ncc_inv_width[i])))
            d.set("delay", str(int(self.delay[i])))
        return el

    @classmethod
    def from_xml(cls, el: ET.Element) -> "Displacement":
        vals: Dict[str, List] = {k: [] for k in (
            "displ", "default_displ", "reliability", "nccPeak", "nccWidth",
            "nccWRangeThr", "nccInvWidth", "delay")}
        for ax in cls.AXES:
            d = el.find(ax)
            vals["displ"].append(int(d.get("displ", 0)))
            vals["default_displ"].append(int(d.get("default_displ", 0)))
            vals["reliability"].append(float(d.get("reliability", 0)))
            vals["nccPeak"].append(float(d.get("nccPeak", 0)))
            vals["nccWidth"].append(int(d.get("nccWidth", 0)))
            vals["nccWRangeThr"].append(int(d.get("nccWRangeThr", 0)))
            vals["nccInvWidth"].append(int(d.get("nccInvWidth", 0)))
            vals["delay"].append(int(d.get("delay", 0)))
        return cls(
            displ=tuple(vals["displ"]),
            default_displ=tuple(vals["default_displ"]),
            reliability=tuple(vals["reliability"]),
            ncc_peak=tuple(vals["nccPeak"]),
            ncc_width=tuple(vals["nccWidth"]),
            ncc_w_range_thr=tuple(vals["nccWRangeThr"]),
            ncc_inv_width=tuple(vals["nccInvWidth"]),
            delay=tuple(vals["delay"]),
        )


@dataclass
class TileStack:
    """One tile column of z-planes on disk (reference TSVStack,
    tsv/volume.py:304-400)."""

    row: int
    col: int
    dir_name: str
    root_dir: str
    abs_v: int = 0  # y offset (voxels)
    abs_h: int = 0  # x offset
    abs_d: int = 0  # z offset
    n_chans: int = 1
    bytes_per_chan: int = 2
    stitchable: bool = True
    img_regex: str = ""
    z_ranges: str = ""
    north: Optional[Displacement] = None
    west: Optional[Displacement] = None
    _paths: Optional[List[Path]] = field(default=None, repr=False)
    _plane_shape: Optional[Tuple[int, int]] = field(default=None, repr=False)

    @property
    def dtype(self) -> np.dtype:
        # (reference: tsv/volume.py:799-807)
        return {1: np.uint8, 2: np.uint16, 4: np.uint32}[self.bytes_per_chan]

    @property
    def paths(self) -> List[Path]:
        if self._paths is None:
            directory = Path(self.root_dir) / self.dir_name
            # tiff/raw native codecs + the generic 2D plugin surface
            # (io/generic2d.py — the opencv2D/bioformats2D input role)
            pattern = re.compile(
                r"[^0-9]*(\d+).*\.(tiff?|raw|png|jp2|j2k|jpe?g|jpe|bmp|dib"
                r"|p[bgp]m)$", re.I)
            found = []
            for p in sorted(directory.iterdir()):
                m = pattern.match(p.name)
                if not m:
                    continue
                if self.img_regex and not re.match(self.img_regex, p.name):
                    continue
                found.append((int(m.group(1)), p))
            self._paths = [p for _, p in sorted(found)]
        return self._paths

    @property
    def plane_shape(self) -> Tuple[int, int]:
        if self._plane_shape is None:
            self._plane_shape = self.read_plane(0).shape
        return self._plane_shape

    @property
    def depth(self) -> int:
        return len(self.paths)

    @property
    def extent(self) -> VExtent:
        h, w = self.plane_shape
        return VExtent(self.abs_h, self.abs_h + w, self.abs_v, self.abs_v + h,
                       self.abs_d, self.abs_d + self.depth)

    def read_plane(self, z: int) -> np.ndarray:
        path = self.paths[z]
        if path.suffix.lower() == ".raw":
            return np.asarray(raw_imread(path))
        return tio.imread(path)

    def imread(self, ext: VExtent) -> np.ndarray:
        """Read an extent (absolute coords) contained in this stack
        (reference TSVStackBase.imread, tsv/volume.py:267-302).

        TIFF stacks go through the native threaded ROI loader
        (native/fastio.cpp, the load_bl_tif role): one call decodes only
        the requested window from every plane instead of a full-plane
        Python decode per z — the dominant IO of the align substack and
        merge crop reads."""
        from ..utils import iostat

        mine = self.extent
        assert mine.contains(ext), f"{ext} not inside {mine}"
        z0, z1 = ext.z0 - self.abs_d, ext.z1 - self.abs_d
        y0, y1 = ext.y0 - self.abs_v, ext.y1 - self.abs_v
        x0, x1 = ext.x0 - self.abs_h, ext.x1 - self.abs_h
        paths = self.paths[z0:z1]
        if paths and paths[0].suffix.lower() in (".tif", ".tiff"):
            from .. import native

            with iostat.span("host_decode",
                             int(np.prod(ext.shape))
                             * np.dtype(self.dtype).itemsize):
                blk = native.read_block(paths, y0, y1, x0, x1,
                                        dtype=self.dtype,
                                        nthreads=min(8, len(paths)))
            if blk is not None:
                return blk
        out = np.empty(ext.shape, self.dtype)
        for zi, z in enumerate(range(z0, z1)):
            try:
                # ONLY the decode is guarded: a corrupt/missing plane
                # becomes zeros with a warning (dummy-substitution, same
                # as the native path) instead of aborting a multi-hour
                # merge; slicing/shape errors still raise loudly
                plane = self.read_plane(z)
            except Exception:  # noqa: BLE001
                import time as _time

                # one delayed retry first: transient environmental errors
                # (NFS hiccup, EMFILE) must not permanently punch a zero
                # hole into the output (raw_imread has no internal retry
                # loop, unlike tio.imread)
                _time.sleep(0.2)
                try:
                    plane = self.read_plane(z)
                except Exception:  # noqa: BLE001
                    from .. import native

                    out[zi] = 0
                    native.warn_zero_filled(self.paths[z])
                    continue
            out[zi] = plane[y0:y1, x0:x1]
        return out

    def to_xml(self) -> ET.Element:
        el = ET.Element("Stack")
        el.set("N_CHANS", str(self.n_chans))
        el.set("N_BYTESxCHAN", str(self.bytes_per_chan))
        el.set("ROW", str(self.row))
        el.set("COL", str(self.col))
        el.set("ABS_V", str(self.abs_v))
        el.set("ABS_H", str(self.abs_h))
        el.set("ABS_D", str(self.abs_d))
        el.set("STITCHABLE", "yes" if self.stitchable else "no")
        el.set("DIR_NAME", self.dir_name)
        el.set("Z_RANGES", self.z_ranges or f"[0,{self.depth})")
        el.set("IMG_REGEX", self.img_regex)
        for side, disp in (("NORTH", self.north), ("EAST", None),
                           ("SOUTH", None), ("WEST", self.west)):
            d_el = ET.SubElement(el, f"{side}_displacements")
            if disp is not None:
                d_el.append(disp.to_xml())
        return el

    @classmethod
    def from_xml(cls, el: ET.Element, root_dir: str) -> "TileStack":
        stack = cls(
            row=int(el.get("ROW")),
            col=int(el.get("COL")),
            dir_name=el.get("DIR_NAME"),
            root_dir=root_dir,
            abs_v=int(el.get("ABS_V", 0)),
            abs_h=int(el.get("ABS_H", 0)),
            abs_d=int(el.get("ABS_D", 0)),
            n_chans=int(el.get("N_CHANS", 1)),
            bytes_per_chan=int(el.get("N_BYTESxCHAN", 2)),
            stitchable=el.get("STITCHABLE", "yes") == "yes",
            img_regex=el.get("IMG_REGEX", "") or "",
            z_ranges=el.get("Z_RANGES", "") or "",
        )
        for side, attr in (("NORTH", "north"), ("WEST", "west")):
            d_el = el.find(f"{side}_displacements")
            if d_el is not None:
                disp = d_el.find("Displacement")
                if disp is not None:
                    setattr(stack, attr, Displacement.from_xml(disp))
        return stack


class TileGrid:
    """A rows x cols grid of TileStacks plus scan metadata — the volume model
    threading through import (step 1), alignment (2-5) and merge (6)
    (reference TSVVolume, tsv/volume.py:685-807)."""

    def __init__(self, stacks: List[List[TileStack]],
                 voxel_um: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                 origin_mm: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                 mechanical_displ: Tuple[float, float] = (0.0, 0.0),
                 stacks_dir: str = "", volume_format: str = "TiledXY|2Dseries",
                 input_plugin: str = "tiff2D"):
        self.stacks = stacks
        self.voxel_um = voxel_um  # (V, H, D) um
        self.origin_mm = origin_mm
        self.mechanical_displ = mechanical_displ
        self.stacks_dir = stacks_dir
        self.volume_format = volume_format
        self.input_plugin = input_plugin

    # -- basic accessors ----------------------------------------------------

    @property
    def n_rows(self) -> int:
        return len(self.stacks)

    @property
    def n_cols(self) -> int:
        return len(self.stacks[0]) if self.stacks else 0

    def flattened(self) -> List[TileStack]:
        return [s for row in self.stacks for s in row if s is not None]

    @property
    def dtype(self):
        return self.flattened()[0].dtype

    @property
    def volume(self) -> VExtent:
        """Bounding box of all placed stacks (reference: tsv/volume.py:670-683)."""
        exts = [s.extent for s in self.flattened()]
        return VExtent(min(e.x0 for e in exts), max(e.x1 for e in exts),
                       min(e.y0 for e in exts), max(e.y1 for e in exts),
                       min(e.z0 for e in exts), max(e.z1 for e in exts))

    # -- placement ----------------------------------------------------------

    def place_from_neighbor_chain(self, ignore_z_offsets: bool = False) -> None:
        """Propagate NORTH/WEST displacements into absolute offsets along the
        first row/column chain, then rebase to zero — the TSV consumer's
        placement rule (reference make_stacks, tsv/volume.py:755-797)."""
        rows, cols = self.n_rows, self.n_cols
        offs = [[None] * cols for _ in range(rows)]
        offs[0][0] = (0, 0, 0)
        for r in range(rows):
            for c in range(cols):
                if r == 0 and c == 0:
                    continue
                s = self.stacks[r][c]
                # sparse cells still get a chain offset (zero displacement
                # pass-through) so cells beyond them stay positioned
                if r > 0:
                    prev = offs[r - 1][c]
                    disp = s.north if s is not None else None
                else:
                    prev = offs[r][c - 1]
                    disp = s.west if s is not None else None
                dv, dh, dd = disp.displ if disp else (0, 0, 0)
                dd = 0 if ignore_z_offsets else dd
                offs[r][c] = (prev[0] - dh, prev[1] - dv, prev[2] - dd)
        present = [(offs[r][c], self.stacks[r][c] is not None)
                   for r in range(rows) for c in range(cols)]
        anchor = [o for o, real in present if real] or [o for o, _ in present]
        mx = min(o[0] for o in anchor)
        my = min(o[1] for o in anchor)
        mz = min(o[2] for o in anchor)
        for r in range(rows):
            for c in range(cols):
                s = self.stacks[r][c]
                if s is None:
                    continue
                x, y, z = offs[r][c]
                s.abs_h, s.abs_v, s.abs_d = x - mx, y - my, z - mz

    # -- XML interop --------------------------------------------------------

    def _mirror_displ(self, d: "Displacement") -> "Displacement":
        return Displacement(
            displ=tuple(-c for c in d.displ),
            default_displ=tuple(-c for c in d.default_displ),
            reliability=d.reliability, ncc_peak=d.ncc_peak,
            ncc_width=d.ncc_width, ncc_w_range_thr=d.ncc_w_range_thr,
            ncc_inv_width=d.ncc_inv_width, delay=d.delay)

    def to_xml(self, path: Optional[Path] = None) -> ET.ElementTree:
        root = ET.Element("TeraStitcher", volume_format=self.volume_format,
                          input_plugin=self.input_plugin)
        ET.SubElement(root, "stacks_dir", value=str(self.stacks_dir))
        ET.SubElement(root, "ref_sys", ref1="1", ref2="2", ref3="3")
        ET.SubElement(root, "voxel_dims", V=f"{self.voxel_um[0]}",
                      H=f"{self.voxel_um[1]}", D=f"{self.voxel_um[2]}")
        ET.SubElement(root, "origin", V=f"{self.origin_mm[0]}",
                      H=f"{self.origin_mm[1]}", D=f"{self.origin_mm[2]}")
        ET.SubElement(root, "mechanical_displacements",
                      V=f"{self.mechanical_displ[0]}",
                      H=f"{self.mechanical_displ[1]}")
        depth = max((s.depth for s in self.flattened()), default=0)
        ET.SubElement(root, "dimensions", stack_rows=str(self.n_rows),
                      stack_columns=str(self.n_cols), stack_slices=str(depth))
        stacks_el = ET.SubElement(root, "STACKS")
        for r, row in enumerate(self.stacks):
            for c, s in enumerate(row):
                if s is None:
                    continue
                el = s.to_xml()
                # populate SOUTH/EAST as mirrors of the neighbors' NORTH/WEST
                # so the XML drives TeraStitcher's own steps 4-5, which
                # require one displacement per adjacent pair on both sides
                # (StackStitcher.cpp:1640-1690)
                if r + 1 < self.n_rows and self.stacks[r + 1][c] is not None \
                        and self.stacks[r + 1][c].north is not None:
                    el.find("SOUTH_displacements").append(
                        self._mirror_displ(self.stacks[r + 1][c].north).to_xml())
                if c + 1 < self.n_cols and self.stacks[r][c + 1] is not None \
                        and self.stacks[r][c + 1].west is not None:
                    el.find("EAST_displacements").append(
                        self._mirror_displ(self.stacks[r][c + 1].west).to_xml())
                stacks_el.append(el)
        tree = ET.ElementTree(root)
        if path is not None:
            ET.indent(tree)
            tree.write(path, xml_declaration=True, encoding="utf-8")
        return tree

    @classmethod
    def from_xml(cls, path, alt_stack_dir: Optional[str] = None) -> "TileGrid":
        tree = ET.parse(path)
        root = tree.getroot()
        assert root.tag == "TeraStitcher"
        dims = root.find("dimensions")
        rows = int(dims.get("stack_rows"))
        cols = int(dims.get("stack_columns"))
        stacks_dir = (alt_stack_dir if alt_stack_dir is not None
                      else root.find("stacks_dir").get("value"))
        vox = root.find("voxel_dims")
        org = root.find("origin")
        mech = root.find("mechanical_displacements")
        grid: List[List[Optional[TileStack]]] = [
            [None] * cols for _ in range(rows)]
        for el in root.find("STACKS").iter("Stack"):
            s = TileStack.from_xml(el, stacks_dir)
            grid[s.row][s.col] = s
        return cls(
            grid,
            voxel_um=(float(vox.get("V")), float(vox.get("H")),
                      float(vox.get("D"))),
            origin_mm=(float(org.get("V")), float(org.get("H")),
                       float(org.get("D"))),
            mechanical_displ=(float(mech.get("V")), float(mech.get("H"))),
            stacks_dir=stacks_dir,
            volume_format=root.get("volume_format", "TiledXY|2Dseries"),
            input_plugin=root.get("input_plugin", "tiff2D"),
        )

    # -- dataset discovery ---------------------------------------------------

    @classmethod
    def from_directory(cls, root_dir, voxel_um=(1.0, 1.0, 1.0)) -> "TileGrid":
        """Discover a two-level row/col hierarchy with names in tenths of
        micrometers: root/<X>/<X>_<Y>/ (reference TSVSimpleVolume,
        tsv/volume.py:810-860; SmartSPIM convention)."""
        root_dir = Path(root_dir)
        xdirs = sorted([d for d in root_dir.iterdir()
                        if d.is_dir() and re.fullmatch(r"\d+", d.name)],
                       key=lambda d: int(d.name))
        if not xdirs:
            raise FileNotFoundError(f"no tile column dirs under {root_dir}")
        col_x = [int(d.name) for d in xdirs]
        # union of y coordinates across ALL columns: sparse acquisitions
        # can miss whole stacks in any column (the reference's
        # --sparse_data role, vmStackedVolume sparse support); missing
        # (x, y) cells become None stacks, which every downstream step
        # (steps 2-6, to_xml) already tolerates
        ys = set()
        present = set()
        for d in xdirs:
            for dy in d.iterdir():
                if dy.is_dir() and re.fullmatch(r"\d+_\d+", dy.name):
                    y = int(dy.name.split("_")[1])
                    ys.add(y)
                    present.add((int(d.name), y))
        row_y = sorted(ys)
        vox_v, vox_h, vox_d = voxel_um
        stacks: List[List[Optional[TileStack]]] = []
        for r, y in enumerate(row_y):
            row_stacks: List[Optional[TileStack]] = []
            for c, x in enumerate(col_x):
                if (x, y) not in present:
                    row_stacks.append(None)
                    continue
                dir_name = f"{x:06d}/{x:06d}_{y:06d}"
                # the reference TRUNCATES the pixel offset relative to the
                # first tile (tsv/volume.py:848-856: int((x-x0)/vox/10)) —
                # match it exactly so simple-mode canvases align
                row_stacks.append(TileStack(
                    row=r, col=c, dir_name=dir_name, root_dir=str(root_dir),
                    abs_h=int((x - col_x[0]) / vox_h / 10.0),
                    abs_v=int((y - row_y[0]) / vox_v / 10.0),
                    abs_d=0))
            stacks.append(row_stacks)
        return cls(stacks, voxel_um=voxel_um, stacks_dir=str(root_dir))
