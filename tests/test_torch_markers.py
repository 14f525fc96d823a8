"""The port's marker, SWC / ESWC / APO and recut-seed utilities
(ipp_tpu_torch/utils/markers.py, reconops.py) against the JAX package's,
which read and write through pandas, on the same inputs made from seeds.

The port holds tables as numpy structured arrays (utils/csvtable.py): each
of the JAX package's DataFrames must come back field by field, values bit
for bit, NaN where NaN, with the dtype's kind; written files byte for
byte; the recut-seed directories file for file.  A seeded fuzz of decimal
text (17-21 digits, exponents, signs, NA strings, quoted fields, inline
comments) goes through `read_marker` and `read_apo` of both packages."""

from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from ipp_tpu.utils import markers as mj
from ipp_tpu.utils import reconops as rj
from ipp_tpu_torch.utils import csvtable as ct
from ipp_tpu_torch.utils import markers as mt
from ipp_tpu_torch.utils import reconops as rt

NA = sorted(ct.NA_VALUES)
BIG = "123456789012345678901"       # past uint64
UBIG = "12345678901234567890"       # past int64, inside uint64


def _kind(series: pd.Series) -> str:
    return "O" if series.dtype == object or str(series.dtype) == "str" \
        else series.dtype.kind


def _same_value(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return np.float64(a).tobytes() == np.float64(b).tobytes() or \
            (a != a and b != b)
    return type(a) is type(b) and a == b


def assert_same_table(want: pd.DataFrame, got: np.ndarray):
    """`got` holds `want`'s columns in order, each with its dtype's kind
    and its values bit for bit."""
    assert [str(c) for c in want.columns] == ct.columns(got)
    assert len(want) == len(got)
    for name in want.columns:
        w = want[name]
        g = got[str(name)]
        assert g.dtype.kind == _kind(w), (name, w.dtype, g.dtype)
        for k, (a, b) in enumerate(zip(w.to_numpy().tolist(), g.tolist())):
            assert _same_value(a, b), (name, k, a, b)


def same_outcome(fn_j, fn_t):
    """Both raise (the same kind of error), or both return; the values."""
    try:
        want = fn_j()
    except Exception as e:           # noqa: BLE001 - compared below
        with pytest.raises(type(e) if isinstance(e, KeyError)
                           else ValueError):
            fn_t()
        return None, None
    return want, fn_t()


def frame_and_table(cols: dict):
    """The same columns as a DataFrame and as a structured array."""
    frame = pd.DataFrame({k: (pd.Series(v, dtype=object)
                              if np.asarray(v).dtype == object else v)
                          for k, v in cols.items()})
    arrays = []
    for v in cols.values():
        v = np.asarray(v)
        if v.dtype.kind == "U":
            v = v.astype(object)
        arrays.append(v)
    return frame, ct.table(list(cols), arrays)


# -- decimal text ------------------------------------------------------------

def decimal(rng, lo=17, hi=21) -> str:
    """A decimal of lo-hi digits, a point anywhere, maybe an exponent and
    a sign."""
    digits = "".join(map(str, rng.integers(0, 10, int(rng.integers(lo,
                                                                   hi + 1)))))
    k = int(rng.integers(0, len(digits) + 1))
    s = digits[:k] + "." + digits[k:]
    if rng.random() < 0.4:
        s += "eE"[rng.integers(2)] + ["", "+", "-"][rng.integers(3)] + \
            str(rng.integers(0, 330))
    return ["", "-", "+"][rng.integers(3)] + s


def token(rng) -> str:
    """One field's text: mostly decimals, else integers (some past int64),
    NA strings, booleans, words, blanks, quoted fields with separators,
    quotes or comment characters in them."""
    r = rng.random()
    if r < 0.55:
        return decimal(rng, 1, 21) if rng.random() < 0.3 else decimal(rng)
    if r < 0.62:
        return str(rng.integers(-10 ** 6, 10 ** 6))
    if r < 0.64:
        return [BIG, UBIG, "-5", "9223372036854775808"][rng.integers(4)]
    if r < 0.74:
        return NA[rng.integers(len(NA))]
    if r < 0.78:
        return ["True", "false", "TRUE", "inf", "-Infinity"][rng.integers(5)]
    if r < 0.82:
        return ["abc", " 7 ", " 1.5", "x y", "1e", "."][rng.integers(6)]
    return ['"a,b"', '"q""x"', '"has # hash"', '"NA"', '"1.25"', '""',
            '"two\nlines"'][rng.integers(7)]


def column_text(rng, ncols: int, nrows: int, sep: str = ",",
                pool=token) -> str:
    """Rows of a table whose columns each keep to one or two kinds of
    token (so that numeric columns happen), with comment lines, blank
    lines, inline comments and short rows."""
    kinds = [[decimal] if rng.random() < 0.6 else [pool]
             for _ in range(ncols)]
    lines = []
    for _ in range(nrows):
        r = rng.random()
        if r < 0.05:
            lines.append("# a comment, with a comma")
        elif r < 0.08:
            lines.append(["", "   ", "\t"][rng.integers(3)])
        row = [kinds[c][0](rng) for c in range(ncols)]
        if rng.random() < 0.05 and ncols > 1:
            row = row[: int(rng.integers(1, ncols))]
        line = sep.join(row)
        if rng.random() < 0.05:
            line += " # trailing, comment"
        lines.append(line)
    return "\n".join(lines) + ("\n" if rng.random() < 0.8 else "")


@pytest.mark.parametrize("seed", range(6))
def test_decimals_read_bit_for_bit_through_read_marker(tmp_path, seed):
    """pandas' parser, not float(): 17-21 digit decimals give the JAX
    package's doubles bit for bit, in every column of a marker file."""
    rng = np.random.default_rng(seed)
    p = tmp_path / "a.marker"
    for trial in range(25):
        p.write_text(column_text(rng, int(rng.integers(3, 11)),
                                 int(rng.integers(1, 30))))
        want, got = same_outcome(lambda: mj.read_marker(p),
                                 lambda: mt.read_marker(p))
        if want is not None:
            assert_same_table(want, got)


@pytest.mark.parametrize("seed", range(4))
def test_decimals_read_bit_for_bit_through_read_apo(tmp_path, seed):
    """The same text under an .apo header (repeated and empty names)."""
    rng = np.random.default_rng(100 + seed)
    p = tmp_path / "a.apo"
    head = "##n,orderinfo,name,comment,z,x,y,pixmax,intensity,sdev," \
        "volsize,mass,,,,color_r,color_g,color_b"
    for trial in range(20):
        body = column_text(rng, 18, int(rng.integers(1, 25)))
        if rng.random() < 0.3:             # duplicated rows, dropped
            body += body
        p.write_text(head + "\n" + body)
        want, got = same_outcome(lambda: rj.read_apo(p, radius=3.5),
                                 lambda: rt.read_apo(p, radius=3.5))
        if want is not None:
            assert_same_table(want, got)


def test_parse_float_is_not_float(tmp_path):
    """Values where pandas and float() disagree, read as pandas reads
    them (the leading zeros count against the 17 digits)."""
    toks = ["934043515.9562497", "0.000000000000000012345",
            "00000000000000000001.5", "1e400", "-0e500", "-1e-700",
            "4.9e-324", "2.2250738585072014e-308", "1.7976931348623157e308"]
    p = tmp_path / "f.marker"
    p.write_text("\n".join(f"{t},0,0" for t in toks) + "\n")
    want = mj.read_marker(p)["x"].to_numpy()
    got = mt.read_marker(p)["x"]
    assert want.tobytes() == got.tobytes()
    assert ct.parse_float("934043515.9562497") != float("934043515.9562497")
    assert ct.parse_float("0.000000000000000012345") == 0.0


@pytest.mark.parametrize("text", [
    "1,2\n3,4,5\n", "1,2,3\n3,4\n5,6,7\n", '"a\nb",1\n2,3\n',
    "1,\"a\"b,2\n", '1,a"b,2\n', '1,"a" ,2\n', "x\r\ny\r\n",
    "1,2\n  #x\n3,4\n", "1,2\n\x0c\n3,4\n", ",\n1,2\n", "﻿1,2\n",
    "#only a comment\n", "", "True,1\nfalse,NA\n",
    f"{BIG},1\nNA,2\n", f"{UBIG},1\nNA,2\n", f"{UBIG},1\n-5,2\n",
    f"-5,1\n{BIG},2\n", f"{BIG},1\nabc,2\nNA,3\n", f"{UBIG},1\n1.5,2\n"])
def test_read_marker_edge_cases(tmp_path, text):
    p = tmp_path / "e.marker"
    p.write_text(text, newline="")
    want, got = same_outcome(lambda: mj.read_marker(p),
                             lambda: mt.read_marker(p))
    if want is not None:
        assert_same_table(want, got)


def swc_text(rng, nrows: int, ncols: int = 7) -> str:
    lines = ["# an SWC", "#id type x y z radius parent_id"]
    for i in range(nrows):
        r = rng.random()
        if r < 0.04:
            lines.append("   # indented comment: a row of NaN")
        elif r < 0.07:
            lines.append("  \t ")
        row = [str(i + 1), str(rng.integers(0, 5)),
               *[decimal(rng, 3, 19) if rng.random() < 0.7 else
                 f"{rng.random() * 1000:.3f}" for _ in range(4)],
               str(i if i else -1)]
        row += [str(rng.integers(0, 9)) for _ in range(ncols - 7)]
        if rng.random() < 0.04:
            row = row[: int(rng.integers(2, ncols))]
        lines.append(("\t" if rng.random() < 0.2 else " ").join(row)
                     + (" # c" if rng.random() < 0.05 else ""))
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("seed", range(3))
def test_read_swc_and_eswc(tmp_path, seed):
    rng = np.random.default_rng(200 + seed)
    for trial in range(10):
        p = tmp_path / "n.swc"
        p.write_text(swc_text(rng, int(rng.integers(1, 40)),
                              int(rng.choice([7, 8, 12]))))
        for fj, ft in ((rj.read_swc, rt.read_swc),
                       (rj.read_eswc, rt.read_eswc)):
            want, got = same_outcome(lambda: fj(p), lambda: ft(p))
            if want is not None:
                assert_same_table(want, got)


# -- the functions, twin by twin ---------------------------------------------

def marker_columns(rng, n: int) -> dict:
    names = np.array(["a", "b,c", 'q"t', "", "has space", "#h"], object)
    return {"x": rng.random(n) * 1e4, "y": rng.integers(0, 5000, n),
            "z": np.round(rng.random(n) * 300, 3), "radius": rng.integers(
                0, 9, n), "shape": np.ones(n, np.int64),
            "name": names[rng.integers(0, len(names), n)],
            "comment": np.where(rng.random(n) < 0.5, "", "ok").astype(
                object),
            "color_r": rng.integers(0, 256, n), "color_g": np.zeros(
                n, np.int64), "color_b": rng.integers(0, 256, n)}


@pytest.mark.parametrize("seed", range(3))
def test_write_and_merge_markers_byte_for_byte(tmp_path, seed):
    rng = np.random.default_rng(300 + seed)
    paths = {"j": [], "t": []}
    for k in range(3):
        frame, tab = frame_and_table(marker_columns(rng, int(
            rng.integers(1, 12))))
        if k == 1:                     # near-duplicates of file 0's points
            frame["x"] = frame["x"] + 0.1
            tab = ct.assign(tab, "x", tab["x"] + 0.1)
        pj = mj.write_marker(frame, tmp_path / f"j{k}.marker")
        pt = mt.write_marker(tab, tmp_path / f"t{k}.marker")
        assert pj.read_bytes() == pt.read_bytes()
        paths["j"].append(pj)
        paths["t"].append(pt)
        # a name that starts with "#" cuts its row short: pandas may refuse
        # the file, and then the port must too
        want, got = same_outcome(lambda: mj.read_marker(pj),
                                 lambda: mt.read_marker(pt))
        if want is not None:
            assert_same_table(want, got)
    for radius in (0.0, 2.5):
        a, b = same_outcome(
            lambda: mj.merge_marker_files(paths["j"], tmp_path / "mj.marker",
                                          radius),
            lambda: mt.merge_marker_files(paths["t"], tmp_path / "mt.marker",
                                          radius))
        if a is not None:
            assert a.read_bytes() == b.read_bytes()


def test_markers_with_fewer_columns_take_the_defaults(tmp_path):
    p = tmp_path / "short.marker"
    p.write_text("#x,y,z\n1.5,2,3\n4,5,6.25\n")
    assert_same_table(mj.read_marker(p), mt.read_marker(p))
    a = mj.write_marker(mj.read_marker(p), tmp_path / "a.marker")
    b = mt.write_marker(mt.read_marker(p), tmp_path / "b.marker")
    assert a.read_bytes() == b.read_bytes()


def test_merge_promotes_ints_beside_floats(tmp_path):
    (tmp_path / "i.marker").write_text("1,2,3\n")
    (tmp_path / "f.marker").write_text("1.5,2,3\n")
    ps = [tmp_path / "i.marker", tmp_path / "f.marker"]
    a = mj.merge_marker_files(ps, tmp_path / "a.marker")
    b = mt.merge_marker_files(ps, tmp_path / "b.marker")
    assert a.read_bytes() == b.read_bytes()
    assert b"1.0,2,3" in b.read_bytes()


@pytest.mark.parametrize("args", [
    dict(voxel_source=(2, 1, 1), voxel_target=(1, 1, 1),
         flip_lengths=(0, 100, 0), offset=(1, 0, 0)),
    dict(voxel_source=(0.4, 0.4, 1.0), voxel_target=(1.8, 1.8, 2.0),
         flip_lengths=(512.5, 0, 77), offset=(0.1, -3, 2.5))])
def test_convert_coordinates(rng, args):
    frame, tab = frame_and_table(marker_columns(rng, 17))
    assert_same_table(mj.convert_coordinates(frame, **args),
                      mt.convert_coordinates(tab, **args))


def apo_text(rng, n: int) -> str:
    head = "##n,orderinfo,name,comment,z,x,y,pixmax,intensity,sdev," \
        "volsize,mass,,,,color_r,color_g,color_b\n"
    rows = []
    for i in range(n):
        z, x, y = (f"{v:.3f}" for v in rng.random(3) * [300, 4000, 4000])
        vol = f"{rng.random() * 5000:.3f}"
        rows.append(f"{i},,,,{z},{x},{y},0.000,0.000,0.000,{vol},0.000,,,,"
                    f"0,0,255")
    rows += rows[: n // 3]                 # duplicates, dropped
    return head + "\n".join(rows) + "\n"


def tree_bytes(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("default_radius", [0.0, 6.0])
def test_apo_to_recut_seeds_and_back(tmp_path, rng, default_radius):
    """terafly_apo_to_recut_seeds, then recut_seeds_to_terafly_ano on its
    seeds and swc_to_recut_seeds on its SWC: the same directories."""
    text = apo_text(rng, 23)
    out = {}
    for tag, m in (("j", mj), ("t", mt)):
        d = tmp_path / tag
        d.mkdir()
        (d / "cells.ano.apo").write_text(text)
        recut = m.terafly_apo_to_recut_seeds(d / "cells.ano.apo",
                                             default_radius=default_radius,
                                             voxel=(0.4, 0.45, 1.2))
        m.recut_seeds_to_terafly_ano(recut, voxel=(0.4, 0.45, 1.2))
        m.swc_to_recut_seeds(recut / "seeds_for_Imaris_proofread.swc",
                             radii=7.0, voxel=(0.4, 0.45, 1.2))
        out[tag] = tree_bytes(d)
    assert len(out["t"]) > 23
    assert out["j"] == out["t"]


def test_recut_seeds_with_mixed_and_empty_marker_files(tmp_path):
    files = {"marker_1": "# x,y,z,radius_um\n10,20,30,4.5",
             "marker_2": "# x,y,z,radius_um\n10.5,20,31,4",
             "marker_3": "# x,y,z,radius_um\n",
             "marker_4": "# x,y,z,radius_um\n1e2,NA,3,\n7,8,9,1.25\n"}
    out = {}
    for tag, m in (("j", mj), ("t", mt)):
        d = tmp_path / tag / "seeds"
        d.mkdir(parents=True)
        for k, v in files.items():
            (d / k).write_text(v)
        m.recut_seeds_to_terafly_ano(d, color=(1, 2, 3), voxel=(2, 2, 3))
        out[tag] = tree_bytes(d)
    assert out["j"] == out["t"]


def swc_columns(rng, n: int) -> dict:
    ids = rng.permutation(np.arange(1, n + 1))
    parents = np.array([-1 if i == 1 else int(rng.integers(1, i))
                        for i in ids])
    return {"id": ids, "type": rng.integers(0, 5, n),
            "x": rng.random(n) * 1000, "y": rng.random(n) * 1000,
            "z": rng.random(n) * 100, "radius": rng.random(n) * 4,
            "parent_id": parents}


@pytest.mark.parametrize("seed", range(3))
def test_swc_tables_and_writers(tmp_path, seed):
    rng = np.random.default_rng(400 + seed)
    frame, tab = frame_and_table(swc_columns(rng, int(rng.integers(2, 60))))
    a = rj.write_swc(frame, tmp_path / "a.swc", comment="c")
    b = rt.write_swc(tab, tmp_path / "b.swc", comment="c")
    assert a.read_bytes() == b.read_bytes()
    assert_same_table(rj.read_swc(a), rt.read_swc(b))
    a = rj.write_eswc(frame, tmp_path / "a.eswc")
    b = rt.write_eswc(tab, tmp_path / "b.eswc")
    assert a.read_bytes() == b.read_bytes()
    assert_same_table(rj.read_eswc(a), rt.read_eswc(b))
    # duplicated rows and ids, then the topological sort
    dup = np.concatenate([np.arange(len(tab)), rng.integers(0, len(tab), 5)])
    fs = frame.iloc[dup].reset_index(drop=True)
    assert_same_table(rj.sort_swc(fs), rt.sort_swc(tab[dup]))
    assert_same_table(rj.sort_swc(rj.read_swc(a)), rt.sort_swc(rt.read_swc(b)))
    args = dict(flip_lengths=(500, 0, 80.5), voxel_source=(0.4, 0.4, 1),
                voxel_target=(1, 2, 3))
    assert_same_table(rj.flip_and_scale(frame, **args),
                      rt.flip_and_scale(tab, **args))
    assert_same_table(rj.flip_and_scale(frame), rt.flip_and_scale(tab))
    assert_same_table(rj.swc_to_seeds(frame).reset_index(drop=True),
                      rt.swc_to_seeds(tab))


def test_read_apo_and_its_swc(tmp_path, rng):
    p = tmp_path / "c.apo"
    p.write_text(apo_text(rng, 14).replace(",z,x,y,", ", z , x,y ,"))
    want, got = rj.read_apo(p, radius=7), rt.read_apo(p, radius=7)
    assert_same_table(want, got)
    a = rj.write_swc(want, tmp_path / "a.swc")
    b = rt.write_swc(got, tmp_path / "b.swc")
    assert a.read_bytes() == b.read_bytes()


def test_soma_of_swc_and_find_swc_location(tmp_path, rng):
    """The soma is the type-1 node; with none, both packages raise
    KeyError('parent') (the column they look for does not exist)."""
    recon = tmp_path / "recon"
    recon.mkdir()
    for k in range(4):
        frame, _ = frame_and_table(swc_columns(rng, 6))
        frame.loc[0, "type"] = 1
        frame.loc[0, ["x", "y", "z"]] = [0.5 + 0.1 * k, 0.5, 0.5 + k]
        rj.write_swc(frame, recon / f"n{k}.swc")
        assert np.array_equal(rj.soma_of_swc(recon / f"n{k}.swc"),
                              rt.soma_of_swc(recon / f"n{k}.swc"))
    cube = tmp_path / "cube.obj"
    v = [(x, y, z) for x in (0, 1) for y in (0, 1) for z in (0, 2)]
    faces = ["1 2 4 3", "5 7 8 6", "1 5 6 2", "3 4 8 7", "1 3 7 5",
             "2 6 8 4"]
    cube.write_text("".join(f"v {x} {y} {z}\n" for x, y, z in v)
                    + "".join(f"f {f}\n" for f in faces))
    hj = rj.find_swc_location(recon, cube, out_dir=tmp_path / "oj")
    ht = rt.find_swc_location(recon, cube, out_dir=tmp_path / "ot")
    assert [p.name for p in hj] == [p.name for p in ht] == ["n0.swc", "n1.swc"]
    assert tree_bytes(tmp_path / "oj") == tree_bytes(tmp_path / "ot")
    tris_j, tris_t = rj.load_obj_mesh(cube), rt.load_obj_mesh(cube)
    pts = rng.random((50, 3)) * [1.4, 1.4, 2.8] - 0.2
    assert np.array_equal(tris_j, tris_t)
    assert np.array_equal(rj.points_inside_mesh(tris_j, pts),
                          rt.points_inside_mesh(tris_t, pts))
    no_soma = tmp_path / "no_soma.swc"
    no_soma.write_text("1 3 1 2 3 1 -1\n2 3 1 2 4 1 1\n")
    with pytest.raises(KeyError, match="parent"):
        rj.soma_of_swc(no_soma)
    with pytest.raises(KeyError, match="parent"):
        rt.soma_of_swc(no_soma)


def test_no_pandas_in_the_port_modules():
    """markers.py, reconops.py and csvtable.py name pandas only in their
    docstrings."""
    import ast

    root = Path(__file__).resolve().parent.parent / "ipp_tpu_torch" / "utils"
    for name in ("markers.py", "reconops.py", "csvtable.py"):
        tree = ast.parse((root / name).read_text())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names] + [n.module or "" for n in ast.walk(tree)
                                     if isinstance(n, ast.ImportFrom)]
        assert not [m for m in mods if m.split(".")[0] == "pandas"], name


def test_swc_to_recut_seeds_is_a_verbatim_twin(tmp_path):
    swc = "1 0 10 20 30 2 -1\n2 0 11.5 21 31 2 -1\n# c\n3 0 1 2\n"
    out = {}
    for tag, m in (("j", mj), ("t", mt)):
        d = tmp_path / tag
        d.mkdir()
        (d / "s.swc").write_text(swc)
        m.swc_to_recut_seeds(d / "s.swc")
        out[tag] = tree_bytes(d)
    assert out["j"] == out["t"] and len(out["t"]) == 2   # one seed + swc


# -- the committed fixtures that chip_smoke.py phase 18 (g) runs -------------

def _fixture_maker():
    import importlib.util

    root = Path(__file__).resolve().parent / "torch_marker_fixtures"
    spec = importlib.util.spec_from_file_location(
        "make_marker_fixtures", root / "make_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_committed_marker_fixtures_through_the_port(tmp_path):
    """The port's utilities on the committed inputs write the committed
    outputs (the JAX package's) byte for byte."""
    import json

    mk = _fixture_maker()
    want = json.loads((mk.HERE / "fixtures.json").read_text())["expected"]
    assert mk.tree(mk.EXPECTED) == want
    mk.run(mt, rt, mk.INPUTS, tmp_path / "out")
    assert mk.tree(tmp_path / "out") == want


def test_marker_fixtures_are_what_the_maker_writes(tmp_path):
    """Regenerated here, the inputs are the committed ones and the JAX
    package writes the committed outputs from them."""
    mk = _fixture_maker()
    mk.write_inputs(tmp_path / "in")
    assert mk.tree(tmp_path / "in") == mk.tree(mk.INPUTS)
    mk.run(mj, rj, tmp_path / "in", tmp_path / "jax")
    assert mk.tree(tmp_path / "jax") == mk.tree(mk.EXPECTED)
