"""obj2pbrt: a Wavefront OBJ (and its MTL) to a .pbrt scene.

Port of pbrt_tpu/tools/obj2pbrt.py (pbrt-v3 tools/obj2pbrt.cpp, over a
small OBJ/MTL reader of its own, not tinyobjloader); the .pbrt file it
writes is the JAX package's byte for byte.  One trianglemesh per material,
fan-triangulated faces, a matte or (with Ks) plastic material.

    python -m pbrt_tpu_torch.tools.obj2pbrt scene.obj scene.pbrt
"""
from __future__ import annotations

import argparse
import os
import sys


def parse_mtl(path):
    mats = {}
    cur = None
    if not os.path.exists(path):
        return mats
    with open(path, errors="replace") as f:
        lines = f.readlines()
    for line in lines:
        t = line.split()
        if not t or t[0].startswith("#"):
            continue
        if t[0] == "newmtl":
            cur = {"name": t[1]}
            mats[t[1]] = cur
        elif cur is None:
            continue
        elif t[0] == "Kd":
            cur["kd"] = tuple(float(x) for x in t[1:4])
        elif t[0] == "Ks":
            cur["ks"] = tuple(float(x) for x in t[1:4])
        elif t[0] == "Ns":
            cur["ns"] = float(t[1])
        elif t[0] == "d":
            cur["d"] = float(t[1])
        elif t[0] == "map_Kd":
            cur["map_kd"] = t[-1]
    return mats


def convert(obj_path, out_path):
    v, vn, vt = [], [], []
    groups = {}  # material name -> list of (vi, ti, ni) triangles
    cur_mat = ""
    mtl = {}
    with open(obj_path, errors="replace") as f:
        lines = f.readlines()
    for line in lines:
        t = line.split()
        if not t or t[0].startswith("#"):
            continue
        if t[0] == "v":
            v.append(tuple(float(x) for x in t[1:4]))
        elif t[0] == "vn":
            vn.append(tuple(float(x) for x in t[1:4]))
        elif t[0] == "vt":
            vt.append(tuple(float(x) for x in t[1:3]))
        elif t[0] == "mtllib":
            mtl.update(parse_mtl(os.path.join(os.path.dirname(obj_path), t[1])))
        elif t[0] == "usemtl":
            cur_mat = t[1]
        elif t[0] == "f":
            idx = []
            for vert in t[1:]:
                parts = (vert.split("/") + ["", ""])[:3]
                vi = int(parts[0])
                ti = int(parts[1]) if parts[1] else 0
                ni = int(parts[2]) if parts[2] else 0
                # OBJ 1-based; negatives relative.
                vi = vi - 1 if vi > 0 else len(v) + vi
                ti = ti - 1 if ti > 0 else (len(vt) + ti if ti else -1)
                ni = ni - 1 if ni > 0 else (len(vn) + ni if ni else -1)
                idx.append((vi, ti, ni))
            for k in range(1, len(idx) - 1):  # fan-triangulate
                groups.setdefault(cur_mat, []).append(
                    (idx[0], idx[k], idx[k + 1])
                )

    with open(out_path, "w") as f:
        f.write(f"# converted from {os.path.basename(obj_path)} by obj2pbrt\n")
        f.write("WorldBegin\n")
        for mat_name, tris in groups.items():
            m = mtl.get(mat_name, {})
            kd = m.get("kd", (0.5, 0.5, 0.5))
            ks = m.get("ks", (0.0, 0.0, 0.0))
            f.write(f"# material {mat_name or '(default)'}\n")
            if max(ks) > 0:
                rough = 1.0 / max(m.get("ns", 10.0), 1.0)
                f.write(
                    f'Material "plastic" "rgb Kd" [{kd[0]} {kd[1]} {kd[2]}] '
                    f'"rgb Ks" [{ks[0]} {ks[1]} {ks[2]}] '
                    f'"float roughness" [{rough:.5f}]\n'
                )
            else:
                f.write(f'Material "matte" "rgb Kd" [{kd[0]} {kd[1]} {kd[2]}]\n')
            # Re-index vertices used by this group.
            remap = {}
            P, N, UV, I = [], [], [], []
            has_n = all(c[2] >= 0 for tri in tris for c in tri)
            has_t = all(c[1] >= 0 for tri in tris for c in tri)
            for tri in tris:
                tri_ids = []
                for corner in tri:
                    key = corner
                    if key not in remap:
                        remap[key] = len(P)
                        P.append(v[corner[0]])
                        if has_n:
                            N.append(vn[corner[2]])
                        if has_t:
                            UV.append(vt[corner[1]])
                    tri_ids.append(remap[key])
                I.append(tri_ids)
            f.write('Shape "trianglemesh"\n  "integer indices" [')
            f.write(" ".join(f"{a} {b} {c}" for a, b, c in I))
            f.write(']\n  "point P" [')
            f.write(" ".join(f"{x:.6g} {y:.6g} {z:.6g}" for x, y, z in P))
            f.write("]\n")
            if has_n:
                f.write('  "normal N" [')
                f.write(" ".join(f"{x:.6g} {y:.6g} {z:.6g}" for x, y, z in N))
                f.write("]\n")
            if has_t:
                f.write('  "float uv" [')
                f.write(" ".join(f"{x:.6g} {y:.6g}" for x, y in UV))
                f.write("]\n")
        f.write("WorldEnd\n")
    n_tris = sum(len(t) for t in groups.values())
    print(f"wrote {out_path}: {len(v)} vertices, {n_tris} triangles, "
          f"{len(groups)} materials")


def main(argv=None):
    p = argparse.ArgumentParser(prog="obj2pbrt")
    p.add_argument("obj")
    p.add_argument("out")
    a = p.parse_args(argv)
    convert(a.obj, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
