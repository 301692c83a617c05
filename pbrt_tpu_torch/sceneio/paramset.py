"""ParamSet: typed key/value parameter bags from .pbrt files.

Port of pbrt_tpu/sceneio/paramset.py (pbrt-v3 core/paramset.{h,cpp}):
typed lookups with defaults (``FindOne*``, paramset.h:95) and used-flag
tracking with ``ReportUnused`` (paramset.h:118).  Spectrum parameters are
taken in the ``rgb``/``color`` forms, as ``spectrum`` (inline (lambda,
value) pairs, or an .spd file resolved against the scene file's directory)
and as ``blackbody`` (temperature and scale), through
core/sampled_spectrum.py as the JAX package takes them.  ``xyz`` values
raise NotImplementedError (the JAX package reads them as rgb), and so does
a texture bound where a constant is asked for.
"""
from __future__ import annotations

import logging
import os

import numpy as np

from ..core import sampled_spectrum as ss

log = logging.getLogger("pbrt_tpu_torch")

_TYPES = {
    "float", "integer", "string", "bool", "point", "point3", "point2",
    "vector", "vector2", "normal", "rgb", "color", "xyz", "spectrum",
    "texture", "blackbody",
}
_RGB_TYPES = ("rgb", "color")


class ParamSet:
    def __init__(self, items: dict | None = None, cwd: str = "."):
        # name -> (ptype, values list)
        self._items: dict = dict(items or {})
        self._used: set = set()
        self.cwd = cwd  # where a relative .spd file name is looked up

    @staticmethod
    def from_decls(decls, cwd: str = ".") -> "ParamSet":
        """decls: list of (decl_string, values) from the parser; cwd: the
        scene file's directory."""
        items = {}
        for decl, vals in decls:
            parts = decl.split()
            if len(parts) != 2 or parts[0] not in _TYPES:
                raise ValueError(f"bad parameter declaration {decl!r}")
            ptype, name = parts
            items[name] = (ptype, vals)
        return ParamSet(items, cwd)

    def keys(self):
        return self._items.keys()

    def set(self, name, ptype, values):
        """Add or replace one parameter."""
        self._items[name] = (ptype, list(values))

    def _get(self, name):
        self._used.add(name)
        return self._items.get(name)

    def find_one_float(self, name, default):
        v = self._get(name)
        return float(v[1][0]) if v else float(default)

    def find_one_int(self, name, default):
        v = self._get(name)
        return int(v[1][0]) if v else int(default)

    def find_one_bool(self, name, default):
        v = self._get(name)
        if not v:
            return bool(default)
        x = v[1][0]
        if isinstance(x, str):
            return x == "true"
        return bool(x)

    def find_one_string(self, name, default):
        v = self._get(name)
        return str(v[1][0]) if v else default

    def find_one_point(self, name, default):
        v = self._get(name)
        return np.asarray(v[1][:3] if v else default, np.float32)

    def find_one_spectrum(self, name, default):
        """An rgb / color, spectrum or blackbody parameter as an rgb triple
        (a single rgb value is broadcast); the default likewise."""
        v = self._get(name)
        if not v:
            if default is None:
                return None
            d = np.asarray(default, np.float32)
            if d.shape == (3,):
                return d
            return np.full(3, float(default), np.float32)
        ptype, vals = v
        if ptype == "texture":
            raise NotImplementedError(
                f'"texture {name}": this parameter takes a constant in the port')
        if ptype == "blackbody":
            return ss.blackbody_rgb_normalized(float(vals[0])) * (
                float(vals[1]) if len(vals) > 1 else 1.0)
        if ptype == "spectrum":
            if vals and isinstance(vals[0], str):
                path = vals[0]
                if not os.path.isabs(path):
                    path = os.path.join(self.cwd, path)
                lam, sv = ss.read_spd_file(path)
            else:
                arr = np.asarray(vals, np.float64).reshape(-1, 2)
                lam, sv = arr[:, 0], arr[:, 1]
            return ss.spd_to_rgb(lam, sv)
        if ptype not in _RGB_TYPES:
            raise NotImplementedError(
                f'"{ptype} {name}": the port takes spectra as rgb, color, '
                "spectrum or blackbody (the JAX package reads xyz values as "
                "rgb)")
        arr = np.asarray(vals, np.float32)
        if arr.size == 1:
            return np.full(3, float(arr[0]), np.float32)
        return arr[:3]

    def find_texture(self, name):
        v = self._get(name)
        if v and v[0] == "texture":
            return str(v[1][0])
        return None

    def find_floats(self, name):
        v = self._get(name)
        return np.asarray(v[1], np.float32) if v else None

    def find_ints(self, name):
        v = self._get(name)
        return np.asarray(v[1], np.int64).astype(np.int32) if v else None

    def find_points(self, name):
        v = self._get(name)
        return np.asarray(v[1], np.float32).reshape(-1, 3) if v else None

    def find_point2s(self, name):
        v = self._get(name)
        return np.asarray(v[1], np.float32).reshape(-1, 2) if v else None

    def report_unused(self, where=""):
        for name in self._items:
            if name not in self._used:
                log.warning("Parameter %r (%s) not used", name, where)
