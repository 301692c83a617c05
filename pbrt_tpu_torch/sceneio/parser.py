""".pbrt tokenizer and statement parser.

Port of pbrt_tpu/sceneio/parser.py, unchanged in its grammar (pbrt-v3
core/parser.cpp:98-252 tokenizer, :786-1120 statement loop): directives,
bracketed typed parameter lists, quoted strings, ``#`` comments and
``Include`` relative to the including file.  It dispatches into the
graphics-state machine of api.py.
"""
from __future__ import annotations

import os
import re

import numpy as np

_TOKEN_RE = re.compile(
    r"""
    "(?:[^"\\]|\\.)*"      # quoted string
    | \[ | \]
    | [^\s"\[\]\#]+        # bare token
    """,
    re.X,
)


def tokenize(text: str):
    """Yield tokens, stripping comments (# to end of line)."""
    for line in text.split("\n"):
        h = line.find("#")
        if h >= 0:
            line = line[:h]
        for m in _TOKEN_RE.finditer(line):
            yield m.group(0)


# directives with a quoted type/name argument before their parameters
_DIRECTIVES_PARAMS = {
    "Accelerator", "AreaLightSource", "Camera", "CoordinateSystem",
    "CoordSysTransform", "Film", "Filter", "PixelFilter", "Include",
    "Integrator", "LightSource", "MakeNamedMaterial", "MakeNamedMedium",
    "Material", "NamedMaterial", "ObjectBegin", "ObjectInstance", "Sampler",
    "Shape",
}

_NUMERIC_ARGS = {
    "Translate": 3,
    "Scale": 3,
    "Rotate": 4,
    "LookAt": 9,
    "Transform": 16,
    "ConcatTransform": 16,
    "TransformTimes": 2,
}

_BARE = {
    "AttributeBegin", "AttributeEnd", "TransformBegin", "TransformEnd",
    "ObjectEnd", "WorldBegin", "WorldEnd", "ReverseOrientation", "Identity",
}


def _unquote(tok: str) -> str:
    return tok[1:-1] if tok.startswith('"') else tok


def _to_num(tok: str):
    try:
        return int(tok)
    except ValueError:
        return float(tok)


def _numbers(toks: list) -> list:
    """A list of numeric tokens as numbers: ints when every one is an int,
    else floats, converted in one pass (a density grid holds millions)."""
    try:
        return np.array(toks, dtype=np.int64).tolist()
    except (ValueError, OverflowError):
        return np.array(toks, dtype=np.float64).tolist()


class _TokenStream:
    def __init__(self, tokens):
        self.toks = list(tokens)
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def done(self):
        return self.i >= len(self.toks)


def _parse_params(ts: _TokenStream):
    """Parse `"type name" [v...]` pairs until the next directive."""
    decls = []
    while True:
        t = ts.peek()
        if t is None or not t.startswith('"'):
            break
        decl = _unquote(ts.next())
        vals = []
        if ts.peek() == "[":
            try:
                end = ts.toks.index("]", ts.i + 1)
            except ValueError:
                raise ValueError("unterminated [ in parameter list") from None
            raw = ts.toks[ts.i + 1:end]
            ts.i = end + 1
            if raw and not any(t.startswith('"') for t in raw):
                vals = _numbers(raw)
            else:
                vals = [_unquote(t) if t.startswith('"') else _to_num(t) for t in raw]
        else:
            tok = ts.next()
            vals.append(_unquote(tok) if tok.startswith('"') else _to_num(tok))
        decls.append((decl, vals))
    return decls


def parse_tokens(ts: _TokenStream, api, cwd="."):
    """Statement dispatch loop (parser.cpp:786-1120)."""
    while not ts.done():
        tok = ts.next()
        if tok in _BARE:
            getattr(api, _snake(tok))()
        elif tok in _NUMERIC_ARGS:
            n = _NUMERIC_ARGS[tok]
            args = []
            while len(args) < n:
                t = ts.next()
                if t in ("[", "]"):
                    continue
                args.append(float(t))
            getattr(api, _snake(tok))(*args)
        elif tok == "ActiveTransform":
            api.active_transform(ts.next())
        elif tok == "Texture":
            name = _unquote(ts.next())
            ttype = _unquote(ts.next())
            tclass = _unquote(ts.next())
            params = _parse_params(ts)
            api.texture(name, ttype, tclass, params)
        elif tok == "MediumInterface":
            inside = _unquote(ts.next())
            outside = _unquote(ts.next()) if (
                ts.peek() and ts.peek().startswith('"')) else ""
            api.medium_interface(inside, outside)
        elif tok == "Include":
            fname = _unquote(ts.next())
            path = fname if os.path.isabs(fname) else os.path.join(cwd, fname)
            with open(path) as f:
                sub = _TokenStream(tokenize(f.read()))
            parse_tokens(sub, api, cwd=os.path.dirname(path) or cwd)
        elif tok in _DIRECTIVES_PARAMS:
            name = _unquote(ts.next())
            params = _parse_params(ts)
            getattr(api, _snake(tok))(name, params)
        else:
            raise ValueError(f"unknown directive {tok!r}")


def _snake(name: str) -> str:
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()


def parse_pbrt_string(text: str, cwd="."):
    """Parse scene text; returns the RenderSetup."""
    from .api import PbrtApi

    api = PbrtApi()
    api.cwd = cwd  # base for relative file names (fileutil.cpp:47-61)
    parse_tokens(_TokenStream(tokenize(text)), api, cwd=cwd)
    return api.finalize()


def parse_pbrt_file(path: str):
    with open(path) as f:
        text = f.read()
    return parse_pbrt_string(text, cwd=os.path.dirname(os.path.abspath(path)))
