"""PLY mesh loader (ascii, binary little and big endian).

Port of pbrt_tpu/sceneio/plyload.py, the stand-in for pbrt-v3's rply-backed
loader (shapes/plymesh.cpp:292): returns (indices [T,3], P [V,3], N or None,
uv or None) ready for SceneBuilder.add_triangle_mesh.  Faces with more than
three corners are fan-triangulated.  A binary face element whose faces all
have the same corner count is read in one numpy pass; any other is read face
by face, with the same result.
"""
from __future__ import annotations

import numpy as np

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _fan(idx: np.ndarray) -> np.ndarray:
    """[F, k] polygons -> [F * (k - 2), 3] fan triangles, face-major."""
    k = idx.shape[1]
    tris = [np.stack([idx[:, 0], idx[:, j], idx[:, j + 1]], -1)
            for j in range(1, k - 1)]
    return np.stack(tris, 1).reshape(-1, 3)


def _binary_faces(body, off, count, bo, cdt, dt):
    """Face list of `count` faces at byte `off`: (triangles, bytes read)."""
    csize = np.dtype(cdt).itemsize
    isize = np.dtype(dt).itemsize
    if count and off + csize <= len(body):
        k = int(np.frombuffer(body, bo + cdt, 1, off)[0])
        rec = np.dtype([("n", bo + cdt), ("i", bo + dt, (k,))])
        if k >= 3 and off + rec.itemsize * count <= len(body):
            arr = np.frombuffer(body, rec, count, off)
            if (arr["n"] == k).all():
                return _fan(arr["i"].astype(np.int64)), rec.itemsize * count
    faces = []
    start = off
    for _ in range(count):
        n = int(np.frombuffer(body, bo + cdt, 1, off)[0])
        off += csize
        idx = np.frombuffer(body, bo + dt, n, off)
        off += isize * n
        for k in range(1, n - 1):
            faces.append((int(idx[0]), int(idx[k]), int(idx[k + 1])))
    return np.asarray(faces, np.int64).reshape(-1, 3), off - start


def load_ply(path: str):
    with open(path, "rb") as f:
        data = f.read()

    end = data.find(b"end_header\n")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file")
    header = data[:end].decode("ascii", "replace").split("\n")
    body = data[end + len(b"end_header\n"):]

    fmt = None
    elements = []  # (name, count, [(prop_name, dtype, is_list, count_dtype)])
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
                elements[-1][2].append(
                    (parts[4], _PLY_TYPES[parts[3]], True, _PLY_TYPES[parts[2]]))
            else:
                elements[-1][2].append((parts[2], _PLY_TYPES[parts[1]], False, None))

    verts = {}
    faces = np.zeros((0, 3), np.int64)
    if fmt == "ascii":
        toks = body.split()
        ti = 0
        tri = []
        for name, count, props in elements:
            if name == "vertex":
                cols = {p[0]: [] for p in props}
                for _ in range(count):
                    for pname, dt, is_list, _ in props:
                        cols[pname].append(float(toks[ti]))
                        ti += 1
                verts = {k: np.asarray(v) for k, v in cols.items()}
            elif name == "face":
                for _ in range(count):
                    n = int(toks[ti])
                    ti += 1
                    idx = [int(toks[ti + k]) for k in range(n)]
                    ti += n
                    for k in range(1, n - 1):  # fan triangulation
                        tri.append((idx[0], idx[k], idx[k + 1]))
            else:
                # Skip unknown elements: count * n_props tokens.
                for _ in range(count):
                    for pname, dt, is_list, _ in props:
                        if is_list:
                            n = int(toks[ti])
                            ti += 1 + n
                        else:
                            ti += 1
        faces = np.asarray(tri, np.int64).reshape(-1, 3)
    elif fmt in ("binary_little_endian", "binary_big_endian"):
        bo = "<" if "little" in fmt else ">"
        off = 0
        for name, count, props in elements:
            if name == "vertex" and all(not p[2] for p in props):
                dt = np.dtype([(p[0], bo + p[1]) for p in props])
                arr = np.frombuffer(body, dt, count, off)
                off += dt.itemsize * count
                verts = {p[0]: arr[p[0]].astype(np.float64) for p in props}
            elif name == "face":
                pname, dt, is_list, cdt = props[0]
                faces, nbytes = _binary_faces(body, off, count, bo, cdt, dt)
                off += nbytes
            elif all(not p[2] for p in props):
                dt = np.dtype([(p[0], bo + p[1]) for p in props])
                off += dt.itemsize * count  # fixed-size unknown element
            else:
                raise ValueError(f"{path}: unsupported list element {name}")
    else:
        raise ValueError(f"{path}: unknown PLY format {fmt!r}")

    p = np.stack([verts["x"], verts["y"], verts["z"]], -1).astype(np.float32)
    n = None
    if all(k in verts for k in ("nx", "ny", "nz")):
        n = np.stack([verts["nx"], verts["ny"], verts["nz"]], -1).astype(np.float32)
    uv = None
    for ux, vx in (("u", "v"), ("s", "t")):
        if ux in verts and vx in verts:
            uv = np.stack([verts[ux], verts[vx]], -1).astype(np.float32)
            break
    return faces.astype(np.int32), p, n, uv
