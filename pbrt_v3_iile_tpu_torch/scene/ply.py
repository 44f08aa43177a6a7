"""Minimal PLY mesh loader (ascii + binary LE/BE).

Replaces the reference's rply-based plymesh loader
(ref: src/shapes/plymesh.cpp, src/ext/rply).  Supports vertex properties
x y z [nx ny nz] [u v | s t] and triangle/quad face lists.
"""

from __future__ import annotations

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def load_ply(path: str):
    """Returns dict with 'p' (V,3), optional 'n' (V,3), 'uv' (V,2),
    'indices' (F,3)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"ply"):
        raise ValueError(f"not a PLY file: {path}")
    hdr_end = data.index(b"end_header")
    hdr_end = data.index(b"\n", hdr_end) + 1
    header = data[:hdr_end].decode("ascii", errors="replace").splitlines()
    body = data[hdr_end:]

    fmt = "ascii"
    elements = []  # (name, count, [(prop_name, dtype, is_list, count_type)])
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], _TYPES[parts[3]], True,
                                        _TYPES[parts[2]]))
            else:
                elements[-1][2].append((parts[2], _TYPES[parts[1]], False, None))

    endian = "<" if fmt == "binary_little_endian" else ">"
    out = {}
    if fmt == "ascii":
        tokens = body.split()
        ti = 0
        for name, count, props in elements:
            if name == "vertex":
                cols = {p[0]: np.empty(count) for p in props}
                for i in range(count):
                    for pname, _, is_list, _ in props:
                        if is_list:
                            n = int(tokens[ti]); ti += 1 + n
                        else:
                            cols[pname][i] = float(tokens[ti]); ti += 1
                out["vertex"] = cols
            elif name == "face":
                idx = []
                for i in range(count):
                    n = int(tokens[ti]); ti += 1
                    verts = [int(tokens[ti + k]) for k in range(n)]
                    ti += n
                    for k in range(1, n - 1):
                        idx.append([verts[0], verts[k], verts[k + 1]])
                out["face"] = np.asarray(idx, dtype=np.int64)
            else:
                for i in range(count):
                    for pname, _, is_list, _ in props:
                        if is_list:
                            n = int(tokens[ti]); ti += 1 + n
                        else:
                            ti += 1
    else:
        pos = 0
        for name, count, props in elements:
            has_list = any(p[2] for p in props)
            if not has_list:
                dtype = np.dtype([(p[0], endian + p[1]) for p in props])
                arr = np.frombuffer(body, dtype=dtype, count=count, offset=pos)
                pos += dtype.itemsize * count
                if name == "vertex":
                    out["vertex"] = {p[0]: arr[p[0]].astype(np.float64)
                                     for p in props}
            else:
                idx = []
                for i in range(count):
                    row = []
                    for pname, dt, is_list, ct in props:
                        if is_list:
                            cdt = np.dtype(endian + ct)
                            n = int(np.frombuffer(body, dtype=cdt, count=1,
                                                  offset=pos)[0])
                            pos += cdt.itemsize
                            vdt = np.dtype(endian + dt)
                            vals = np.frombuffer(body, dtype=vdt, count=n,
                                                 offset=pos)
                            pos += vdt.itemsize * n
                            if name == "face" and pname in ("vertex_indices",
                                                            "vertex_index"):
                                row = [int(x) for x in vals]
                        else:
                            vdt = np.dtype(endian + dt)
                            pos += vdt.itemsize
                    if name == "face" and len(row) >= 3:
                        for k in range(1, len(row) - 1):
                            idx.append([row[0], row[k], row[k + 1]])
                if name == "face":
                    out["face"] = np.asarray(idx, dtype=np.int64)

    if "vertex" not in out or "face" not in out:
        raise ValueError(f"PLY missing vertex/face elements: {path}")
    vcols = out["vertex"]
    res = {
        "p": np.stack([vcols["x"], vcols["y"], vcols["z"]], axis=1),
        "indices": out["face"],
    }
    if "nx" in vcols:
        res["n"] = np.stack([vcols["nx"], vcols["ny"], vcols["nz"]], axis=1)
    if "u" in vcols:
        res["uv"] = np.stack([vcols["u"], vcols["v"]], axis=1)
    elif "s" in vcols:
        res["uv"] = np.stack([vcols["s"], vcols["t"]], axis=1)
    return res
