"""Typed name->value parameter bags parsed from .pbrt statements.

Semantics follow the reference's ParamSet (ref: src/core/paramset.h), but a
single dict-backed class replaces the per-type vectors; values are numpy
arrays or python scalars/strings.
"""

from __future__ import annotations

import numpy as np

_SCALAR_TYPES = {"integer", "float", "bool", "string", "texture"}
_VEC3_TYPES = {"point", "point3", "vector", "vector3", "normal", "rgb", "color", "xyz"}
_VEC2_TYPES = {"point2", "vector2"}


class ParamSet:
    def __init__(self):
        self._items = {}  # name -> (type, value)

    def add(self, decl: str, values):
        parts = decl.split()
        if len(parts) != 2:
            raise ValueError(f"bad parameter declaration: {decl!r}")
        typ, name = parts
        if typ in ("bool",):
            values = [v == "true" if isinstance(v, str) else bool(v) for v in values]
        if typ == "spectrum" and values and isinstance(values[0], str):
            # .spd filename form (ref: paramset.cpp AddSampledSpectrumFiles)
            val = values if len(values) > 1 else values[0]
        elif typ in ("string", "texture", "bool"):
            val = values if len(values) > 1 else values[0]
        elif typ == "integer":
            arr = np.asarray(values, dtype=np.int64)
            val = arr
        else:
            val = np.asarray(values, dtype=np.float64)
        self._items[name] = (typ, val)

    def __contains__(self, name):
        return name in self._items

    def type_of(self, name):
        return self._items[name][0] if name in self._items else None

    def find_one_float(self, name, default):
        if name not in self._items:
            return float(default)
        if self._items[name][0] == "texture":
            # textured slot: constant fallback (resolved via
            # find_texture_name by the material builder)
            return float(default)
        return float(np.ravel(self._items[name][1])[0])

    def find_one_int(self, name, default):
        if name not in self._items:
            return int(default)
        return int(np.ravel(self._items[name][1])[0])

    def find_one_bool(self, name, default):
        if name not in self._items:
            return bool(default)
        v = self._items[name][1]
        return bool(v if not isinstance(v, list) else v[0])

    def find_one_string(self, name, default):
        if name not in self._items:
            return default
        v = self._items[name][1]
        return v if isinstance(v, str) else v[0]

    def find_one_rgb(self, name, default):
        if name not in self._items:
            if default is None:
                return None
            return np.asarray(default, dtype=np.float64)
        typ, v = self._items[name]
        if typ == "texture":
            # textured slot: constant fallback (resolved via
            # find_texture_name by the material builder)
            if default is None:
                return None
            return np.asarray(default, dtype=np.float64)
        if typ == "spectrum":
            return _spectrum_rgb(v)
        v = np.ravel(np.asarray(v, dtype=np.float64))
        if typ == "blackbody":
            return _blackbody_rgb(v)
        if v.size == 1:
            return np.full(3, v[0])
        return v[:3].copy()

    def find_texture_name(self, name):
        """Returns texture name if the param was declared 'texture', else None."""
        if name in self._items and self._items[name][0] == "texture":
            v = self._items[name][1]
            return v if isinstance(v, str) else v[0]
        return None

    def find_floats(self, name):
        if name not in self._items:
            return None
        return np.ravel(np.asarray(self._items[name][1], dtype=np.float64)).copy()

    def find_ints(self, name):
        if name not in self._items:
            return None
        return np.ravel(np.asarray(self._items[name][1], dtype=np.int64)).copy()

    def find_points(self, name):
        v = self.find_floats(name)
        if v is None:
            return None
        if v.size % 3:
            raise ValueError(f"point array {name} length {v.size} not multiple of 3")
        return v.reshape(-1, 3)

    def find_point2s(self, name):
        v = self.find_floats(name)
        if v is None:
            return None
        return v.reshape(-1, 2)

    def keys(self):
        return self._items.keys()

    def __repr__(self):
        return f"ParamSet({list(self._items.keys())})"


def _blackbody_rgb(v):
    """Blackbody [temperature, scale] -> linear RGB via full spectral
    integration (ref: BlackbodyNormalized spectrum.cpp:45 + RGB
    conversion; utils/spectrum.py)."""
    from ..utils import spectrum as spectrumlib

    t = float(v[0])
    sc = float(v[1]) if v.size > 1 else 1.0
    return spectrumlib.blackbody_rgb(t, sc)


def _spectrum_rgb(v):
    """'spectrum'-typed parameter -> linear RGB: either a .spd filename
    or inline (lambda, value) pairs (ref: paramset.cpp
    AddSampledSpectrumFiles / AddSampledSpectrum)."""
    from ..utils import spectrum as spectrumlib

    if isinstance(v, str):
        return spectrumlib.spd_file_to_rgb(v)
    if isinstance(v, list) and v and isinstance(v[0], str):
        return spectrumlib.spd_file_to_rgb(v[0])
    return spectrumlib.spd_pairs_to_rgb(np.asarray(v, dtype=np.float64))
