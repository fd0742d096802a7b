"""Minimal PLY reader/writer (ascii + binary_little_endian).

Self-contained replacement for the ``plyfile``/``open3d`` dependencies the
reference uses for preprocessing and visualization export
(scripts/preprocess/*.py, util/util.py:157-185); the package depends on
neither.  A copy of ``openscene_tpu.utils.ply``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}
_INV = {"i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
        "i4": "int", "u4": "uint", "f4": "float", "f8": "double"}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read a PLY file -> {element_name: structured array}.

    Supports list properties (e.g. face vertex_indices) of uniform length by
    storing them as 2D fields named ``<prop>``.
    """
    with open(path, "rb") as f:
        assert f.readline().strip() == b"ply", "not a PLY file"
        fmt = None
        elements: List[Tuple[str, int, List]] = []
        cur = None
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("comment"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, count = line.split()
                cur = (name, int(count), [])
                elements.append(cur)
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    cur[2].append(("list", _TYPES[parts[2]],
                                   _TYPES[parts[3]], parts[4]))
                else:
                    cur[2].append(("scalar", _TYPES[parts[1]], parts[2]))
            elif line == "end_header":
                break
        out: Dict[str, np.ndarray] = {}
        for name, count, props in elements:
            if fmt == "ascii":
                out[name] = _read_ascii(f, count, props)
            elif fmt == "binary_little_endian":
                out[name] = _read_binary(f, count, props, "<")
            elif fmt == "binary_big_endian":
                out[name] = _read_binary(f, count, props, ">")
            else:
                raise ValueError(f"unsupported format {fmt}")
        return out


def _read_ascii(f, count, props):
    rows = []
    for _ in range(count):
        vals = f.readline().split()
        row = []
        i = 0
        for p in props:
            if p[0] == "list":
                n = int(vals[i]); i += 1
                row.append(np.array(vals[i:i + n], dtype=p[2])); i += n
            else:
                row.append(np.array(vals[i], dtype=p[1])); i += 1
        rows.append(row)
    return _rows_to_struct(rows, props)


def _read_binary(f, count, props, endian):
    if all(p[0] == "scalar" for p in props):
        dt = np.dtype([(p[2], endian + p[1]) for p in props])
        return np.frombuffer(f.read(dt.itemsize * count), dtype=dt)
    rows = []
    for _ in range(count):
        row = []
        for p in props:
            if p[0] == "list":
                n = int(np.frombuffer(f.read(np.dtype(p[1]).itemsize),
                                      dtype=endian + p[1])[0])
                row.append(np.frombuffer(
                    f.read(np.dtype(p[2]).itemsize * n), dtype=endian + p[2]))
            else:
                row.append(np.frombuffer(
                    f.read(np.dtype(p[1]).itemsize), dtype=endian + p[1])[0])
        rows.append(row)
    return _rows_to_struct(rows, props)


def _rows_to_struct(rows, props):
    fields = []
    for j, p in enumerate(props):
        name = p[3] if p[0] == "list" else p[2]
        col = [r[j] for r in rows]
        if p[0] == "list":
            fields.append((name, np.stack(col)))
        else:
            fields.append((name, np.array(col)))
    dt = []
    for name, col in fields:
        dt.append((name, col.dtype, col.shape[1:]) if col.ndim > 1
                  else (name, col.dtype))
    out = np.empty(len(rows), dtype=dt)
    for name, col in fields:
        out[name] = col
    return out


def write_ply_points(path: str, points: np.ndarray,
                     colors: Optional[np.ndarray] = None) -> None:
    """Write a point cloud (colors in [0,1]) as binary PLY — the visualization
    export path (reference util/util.py:157-172 via open3d)."""
    n = len(points)
    props = ["property float x", "property float y", "property float z"]
    if colors is not None:
        props += ["property uchar red", "property uchar green",
                  "property uchar blue"]
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n" + "\n".join(props) + "\nend_header\n")
    dt = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if colors is not None:
        dt += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    arr = np.empty(n, dtype=dt)
    arr["x"], arr["y"], arr["z"] = points.T.astype(np.float32)
    if colors is not None:
        c = np.clip(np.asarray(colors) * 255, 0, 255).astype(np.uint8)
        arr["red"], arr["green"], arr["blue"] = c.T
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(arr.tobytes())
