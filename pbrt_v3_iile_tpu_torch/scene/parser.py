"""Tokenizer and recursive statement parser for the .pbrt scene language.

Semantics follow the reference's hand-written parser (ref:
src/core/parser.h:103 Tokenizer, parser.cpp ParseFile): '#' comments,
quoted strings, bracketed value lists, Include files resolved relative to
the including file.  Statements are dispatched to an Api object
(scene/api.py) mirroring the pbrt* C API (ref: src/core/api.cpp).
"""

from __future__ import annotations

import os
import re

from .paramset import ParamSet

_TOKEN_RE = re.compile(
    r"""
    (?P<comment>\#[^\n]*)
  | (?P<string>"[^"]*")
  | (?P<lbrack>\[)
  | (?P<rbrack>\])
  | (?P<atom>[^\s\[\]"]+)
    """,
    re.VERBOSE,
)


def tokenize(text: str):
    for m in _TOKEN_RE.finditer(text):
        kind = m.lastgroup
        if kind == "comment":
            continue
        tok = m.group()
        yield tok


_DIRECTIVES_PARAMS = {
    # directive -> (n_string_args, has_params)
    "Integrator": (1, True),
    "Camera": (1, True),
    "Sampler": (1, True),
    "Film": (1, True),
    "Filter": (1, True),
    "PixelFilter": (1, True),
    "Accelerator": (1, True),
    "Shape": (1, True),
    "Material": (1, True),
    "MakeNamedMaterial": (1, True),
    "NamedMaterial": (1, False),
    "AreaLightSource": (1, True),
    "LightSource": (1, True),
    "Texture": (3, True),
    "MakeNamedMedium": (1, True),
    "MediumInterface": (2, False),
    "ObjectBegin": (1, False),
    "Include": (1, False),
    "CoordinateSystem": (1, False),
    "CoordSysTransform": (1, False),
}

_DIRECTIVES_NUMERIC = {
    "Translate": 3,
    "Scale": 3,
    "Rotate": 4,
    "LookAt": 9,
    "Transform": 16,
    "ConcatTransform": 16,
}

_DIRECTIVES_BARE = {
    "WorldBegin",
    "WorldEnd",
    "AttributeBegin",
    "AttributeEnd",
    "TransformBegin",
    "TransformEnd",
    "ObjectEnd",
    "ObjectInstance",
    "ReverseOrientation",
    "Identity",
    "ActiveTransform",
    "TransformTimes",
}


class _TokenStream:
    def __init__(self):
        self.stack = []  # list of (iterator, directory)

    def push_file(self, path: str):
        with open(path, "r") as f:
            text = f.read()
        self.stack.append((iter(list(tokenize(text))), os.path.dirname(path)))

    def push_text(self, text: str, directory: str = "."):
        self.stack.append((iter(list(tokenize(text))), directory))

    @property
    def directory(self):
        return self.stack[-1][1] if self.stack else "."

    def next(self):
        while self.stack:
            it, _ = self.stack[-1]
            try:
                return next(it)
            except StopIteration:
                self.stack.pop()
        return None


def _unquote(tok: str) -> str:
    if tok.startswith('"') and tok.endswith('"'):
        return tok[1:-1]
    return tok


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def _coerce(tok: str):
    tok = _unquote(tok)
    if _is_number(tok):
        f = float(tok)
        return f
    return tok


def _parse_params(stream: _TokenStream, pending):
    """Parse '"type name" value-or-[values...]' pairs until a directive token.

    Returns (paramset, next_directive_token).
    """
    ps = ParamSet()
    while True:
        tok = pending[0] if pending else stream.next()
        pending.clear()
        if tok is None:
            return ps, None
        if not tok.startswith('"'):
            return ps, tok  # a new directive
        decl = _unquote(tok)
        if " " not in decl:
            # a lone string (e.g. ObjectInstance name in quotes) — caller deals
            return ps, tok
        nxt = stream.next()
        values = []
        if nxt == "[":
            while True:
                v = stream.next()
                if v == "]":
                    break
                if v is None:
                    raise ValueError("unterminated [ in parameter list")
                values.append(_coerce(v))
        else:
            values.append(_coerce(nxt))
        if decl.startswith("spectrum "):
            # resolve .spd filenames relative to the scene file
            values = [os.path.join(stream.directory, v)
                      if isinstance(v, str) and not os.path.isabs(v) else v
                      for v in values]
        ps.add(decl, values)


def parse_file(path: str, api) -> None:
    stream = _TokenStream()
    stream.push_file(path)
    _parse(stream, api)


def parse_string(text: str, api, directory: str = ".") -> None:
    stream = _TokenStream()
    stream.push_text(text, directory)
    _parse(stream, api)


def _parse(stream: _TokenStream, api) -> None:
    pending = []
    while True:
        tok = pending[0] if pending else stream.next()
        pending.clear()
        if tok is None:
            break
        if tok.startswith('"'):
            raise ValueError(f"unexpected string token at top level: {tok}")

        if tok in _DIRECTIVES_NUMERIC:
            n = _DIRECTIVES_NUMERIC[tok]
            args = []
            nxt = stream.next()
            if nxt == "[":
                while True:
                    v = stream.next()
                    if v == "]":
                        break
                    args.append(float(_unquote(v)))
            else:
                args.append(float(_unquote(nxt)))
                for _ in range(n - 1):
                    args.append(float(_unquote(stream.next())))
            getattr(api, tok)(*args)
        elif tok in _DIRECTIVES_PARAMS:
            nstr, has_params = _DIRECTIVES_PARAMS[tok]
            strs = [_unquote(stream.next()) for _ in range(nstr)]
            if tok == "Include":
                inc = strs[0]
                if not os.path.isabs(inc):
                    inc = os.path.join(stream.directory, inc)
                stream.push_file(inc)
                continue
            if has_params:
                ps, nxt = _parse_params(stream, pending)
                if nxt is not None:
                    pending.append(nxt)
                getattr(api, tok)(*strs, ps)
            else:
                getattr(api, tok)(*strs)
        elif tok in _DIRECTIVES_BARE:
            if tok == "ObjectInstance":
                name = _unquote(stream.next())
                api.ObjectInstance(name)
            elif tok == "ActiveTransform":
                api.ActiveTransform(stream.next())
            elif tok == "TransformTimes":
                api.TransformTimes(float(stream.next()),
                                   float(stream.next()))
            else:
                getattr(api, tok)()
        else:
            raise ValueError(f"unknown directive: {tok!r}")
