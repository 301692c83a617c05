"""The ``--cat`` / ``--toply`` scene reformatters.

Port of pbrt_tpu/sceneio/cat.py (pbrt-v3 pbrt.cpp:92-97 and the
``PbrtOptions.cat || PbrtOptions.toPly`` branches of api.cpp).  ``CatAPI``
has the method surface the parser dispatches into (api.py's graphics-state
machine), but builds no scene: it prints each statement normalized
(comments stripped, Includes inlined, numbers reformatted) with pbrt's
4-space indentation inside attribute, transform and object blocks
(catIndentCount, api.cpp:1131-1152).  With ``to_ply=True`` each inline
``trianglemesh`` is written to an ASCII ``.ply`` sidecar and printed as a
``plymesh`` statement instead (api.cpp:1338-1370).

Printing renders nothing and needs no card.  The parser reads each number
of a list on its own here (``parser._per_token``), as the JAX package's
does, so that ``[1000000 0.5]`` prints as the JAX package prints it.
"""
from __future__ import annotations

import os
import sys


def _fmt_val(v):
    if isinstance(v, str):
        return f'"{v}"'
    if isinstance(v, bool):
        return '"true"' if v else '"false"'
    if isinstance(v, int):
        return str(v)
    return f"{float(v):g}"


class CatAPI:
    """Print-only stand-in for sceneio.api's state machine."""

    def __init__(self, out=None, to_ply: bool = False, ply_dir: str = "."):
        self.out = out or sys.stdout
        self.to_ply = to_ply
        self.ply_dir = ply_dir
        self.indent = 0
        self.n_ply = 0

    def _p(self, *parts):
        self.out.write(" " * self.indent + " ".join(parts) + "\n")

    def _params_str(self, params):
        return " ".join(f'"{decl}" [ {" ".join(_fmt_val(v) for v in vals)} ]'
                        for decl, vals in params)

    def _open(self, *parts):
        self._p(*parts)
        self.indent += 4

    def _close(self, word):
        self.indent = max(0, self.indent - 4)
        self._p(word)

    # -- bare statements --
    def attribute_begin(self):
        self._open("AttributeBegin")

    def attribute_end(self):
        self._close("AttributeEnd")

    def transform_begin(self):
        self._open("TransformBegin")

    def transform_end(self):
        self._close("TransformEnd")

    def object_end(self):
        self._close("ObjectEnd")

    def world_begin(self):
        self._p("WorldBegin")

    def world_end(self):
        self._p("WorldEnd")

    def reverse_orientation(self):
        self._p("ReverseOrientation")

    def identity(self):
        self._p("Identity")

    # -- numeric statements --
    def _numeric(self, name, *args):
        self._p(name, " ".join(f"{float(a):g}" for a in args))

    def translate(self, *a):
        self._numeric("Translate", *a)

    def scale(self, *a):
        self._numeric("Scale", *a)

    def rotate(self, *a):
        self._numeric("Rotate", *a)

    def look_at(self, *a):
        self._numeric("LookAt", *a)

    def transform(self, *a):
        self._p("Transform", "[", " ".join(f"{float(x):g}" for x in a), "]")

    def concat_transform(self, *a):
        self._p("ConcatTransform", "[", " ".join(f"{float(x):g}" for x in a), "]")

    def transform_times(self, *a):
        self._numeric("TransformTimes", *a)

    def active_transform(self, which):
        # printed as the parser hands it over (the JAX package's CatAPI);
        # a render refuses it (api.py)
        self._p("ActiveTransform", which)

    # -- typed statements --
    def _typed(self, directive, name, params):
        s = self._params_str(params)
        self._p(directive, f'"{name}"', *([s] if s else []))

    def accelerator(self, n, p):
        self._typed("Accelerator", n, p)

    def area_light_source(self, n, p):
        self._typed("AreaLightSource", n, p)

    def camera(self, n, p):
        self._typed("Camera", n, p)

    def coordinate_system(self, n, p=()):
        self._p("CoordinateSystem", f'"{n}"')

    def coord_sys_transform(self, n, p=()):
        self._p("CoordSysTransform", f'"{n}"')

    def film(self, n, p):
        self._typed("Film", n, p)

    def filter(self, n, p):
        self._typed("Filter", n, p)

    def pixel_filter(self, n, p):
        self._typed("PixelFilter", n, p)

    def integrator(self, n, p):
        self._typed("Integrator", n, p)

    def light_source(self, n, p):
        self._typed("LightSource", n, p)

    def make_named_material(self, n, p):
        self._typed("MakeNamedMaterial", n, p)

    def make_named_medium(self, n, p):
        self._typed("MakeNamedMedium", n, p)

    def material(self, n, p):
        self._typed("Material", n, p)

    def named_material(self, n, p=()):
        self._p("NamedMaterial", f'"{n}"')

    def object_begin(self, n, p=()):
        self._open("ObjectBegin", f'"{n}"')

    def object_instance(self, n, p=()):
        self._p("ObjectInstance", f'"{n}"')

    def sampler(self, n, p):
        self._typed("Sampler", n, p)

    def medium_interface(self, inside, outside):
        self._p("MediumInterface", f'"{inside}"', f'"{outside}"')

    def texture(self, name, ttype, tclass, params):
        s = self._params_str(params)
        self._p("Texture", f'"{name}"', f'"{ttype}"', f'"{tclass}"',
                *([s] if s else []))

    def shape(self, n, p):
        if self.to_ply and n == "trianglemesh":
            self._shape_to_ply(p)
        else:
            self._typed("Shape", n, p)

    # -- --toply: write the mesh, keep its other parameters (api.cpp:1338-1370) --
    def _shape_to_ply(self, params):
        d = {decl.split()[-1]: vals for decl, vals in params}
        idx = d.get("indices", [])
        P = d.get("P", [])
        N = d.get("N", [])
        uv = d.get("uv", d.get("st", []))
        self.n_ply += 1
        fname = f"mesh_{self.n_ply:05d}.ply"
        nv = len(P) // 3
        nf = len(idx) // 3
        with open(os.path.join(self.ply_dir, fname), "w") as f:
            f.write("ply\nformat ascii 1.0\n")
            f.write(f"element vertex {nv}\n")
            f.write("property float x\nproperty float y\nproperty float z\n")
            if N:
                f.write("property float nx\nproperty float ny\nproperty float nz\n")
            if uv:
                f.write("property float u\nproperty float v\n")
            f.write(f"element face {nf}\n")
            f.write("property list uchar int vertex_indices\nend_header\n")
            for i in range(nv):
                row = P[3 * i:3 * i + 3]
                if N:
                    row += N[3 * i:3 * i + 3]
                if uv:
                    row += uv[2 * i:2 * i + 2]
                f.write(" ".join(f"{float(x):g}" for x in row) + "\n")
            for i in range(nf):
                a, b, c = (int(x) for x in idx[3 * i:3 * i + 3])
                f.write(f"3 {a} {b} {c}\n")
        # the mesh's own arrays go to the sidecar; S and faceIndices are dropped
        rest = [(decl, vals) for decl, vals in params
                if decl.split()[-1] not in
                ("indices", "P", "N", "uv", "st", "S", "faceIndices")]
        self._typed("Shape", "plymesh", [("string filename", [fname])] + rest)


def cat_file(path: str, out=None, to_ply: bool = False):
    """Reformat a .pbrt file to `out` (default stdout).  The mesh sidecars
    of to_ply land in the working directory (the scene's may be
    read-only), as pbrt writes its mesh_%05d.ply."""
    from .parser import _per_token, _TokenStream, parse_tokens, tokenize

    with open(path) as f:
        ts = _TokenStream(tokenize(f.read()))
    api = CatAPI(out=out, to_ply=to_ply, ply_dir=os.getcwd())
    parse_tokens(ts, api, cwd=os.path.dirname(path) or ".", numbers=_per_token)
