"""Nested-YAML config system: the port of adaptigraph_tpu/utils/config.py.

`Config` is a dict with attribute access (``cfg.train.batch_size``), deep
merge (``cfg.override({...})``) and ``to_dict``; `load_config` reads a
bundled config by name ('dynamics/rope', from ``adaptigraph_torch/configs/``,
byte-identical copies of the JAX package's files) or by path.

The port may not import PyYAML, so `parse_yaml` reads the subset of YAML
those files use: block mappings and sequences (a sequence may sit at its
key's indent), flow lists and mappings, single- and double-quoted strings,
``#`` comments, and plain scalars resolved as ``yaml.safe_load`` resolves
them (YAML 1.1: null, booleans, decimal ints, floats with a dot, strings).
Anything outside that subset (anchors, tags, block scalars, several
documents) raises ValueError rather than being read differently.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Mapping

_CONFIG_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")

# yaml.safe_load's (YAML 1.1) implicit resolvers for the scalars kept here
_NULL = {"", "~", "null", "Null", "NULL"}
_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False,
         "NO": False, "true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False, "on": True,
         "On": True, "ON": True, "off": False, "Off": False, "OFF": False}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_INF_NAN = {".inf": float("inf"), ".Inf": float("inf"), ".INF": float("inf"),
            "+.inf": float("inf"), "+.Inf": float("inf"),
            "+.INF": float("inf"), "-.inf": float("-inf"),
            "-.Inf": float("-inf"), "-.INF": float("-inf"),
            ".nan": float("nan"), ".NaN": float("nan"), ".NAN": float("nan")}
_UNSUPPORTED = ("&", "*", "!", "|", ">", "%", "@", "`")
# ints yaml.safe_load reads in other bases or sexagesimal: refused
_OTHER_INT = re.compile(r"[-+]?(?:0[0-9_]+|0x[0-9a-fA-F_]+|0b[01_]+"
                        r"|[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?)$")


class Config(dict):
    """A dict with attribute access and deep merge. Values stay plain."""

    def __init__(self, data: Mapping[str, Any] | None = None, **kwargs):
        super().__init__()
        merged = dict(data or {})
        merged.update(kwargs)
        for k, v in merged.items():
            self[k] = _wrap(v)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def override(self, other: Mapping[str, Any] | None = None,
                 **kwargs) -> "Config":
        """Return a new Config with `other` (then kwargs) deep-merged on
        top."""
        out = copy.deepcopy(self)
        for src in (other or {}), kwargs:
            _deep_merge(out, src)
        return out

    def to_dict(self) -> dict:
        return _unwrap(self)


def _wrap(v: Any) -> Any:
    if isinstance(v, Config):
        return v
    if isinstance(v, Mapping):
        return Config(v)
    if isinstance(v, list):
        return [_wrap(x) for x in v]
    return v


def _unwrap(v: Any) -> Any:
    if isinstance(v, Mapping):
        return {k: _unwrap(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_unwrap(x) for x in v]
    return v


def _deep_merge(dst: Config, src: Mapping[str, Any]) -> None:
    for k, v in src.items():
        if k in dst and isinstance(dst[k], Mapping) and isinstance(v, Mapping):
            _deep_merge(dst[k], v)
        else:
            dst[k] = _wrap(v)


def _scalar(text: str, where: str):
    """A plain or quoted scalar, typed as yaml.safe_load types it."""
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text, 0, where)
        if text[rest:].strip():
            raise ValueError(f"{where}: text after a quoted scalar")
        return value
    if text[:1] in _UNSUPPORTED or text.startswith("- ") or text == "-":
        raise ValueError(f"{where}: unsupported YAML {text!r}")
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _OTHER_INT.match(text):
        raise ValueError(f"{where}: unsupported YAML number {text!r}")
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if text in _INF_NAN:
        return _INF_NAN[text]
    return text


def _quoted(text: str, i: int, where: str):
    """(string, index past it) of the quoted scalar starting at text[i]."""
    q = text[i]
    out, j = [], i + 1
    escapes = {'"': '"', "\\": "\\", "/": "/", "n": "\n", "t": "\t",
               "r": "\r", "0": "\0"}
    while j < len(text):
        c = text[j]
        if q == "'" and c == "'":
            if text[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            e = text[j + 1:j + 2]
            if e not in escapes:
                raise ValueError(f"{where}: unsupported escape \\{e}")
            out.append(escapes[e])
            j += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), j + 1
        out.append(c)
        j += 1
    raise ValueError(f"{where}: unterminated quoted scalar")


def _flow(text: str, i: int, where: str):
    """(value, index past it) of the flow node starting at text[i]."""
    while text[i] == " ":
        i += 1
    if text[i] in "[{":
        close = "]" if text[i] == "[" else "}"
        out = [] if close == "]" else {}
        i += 1
        while True:
            while text[i] == " ":
                i += 1
            if text[i] == close:
                return out, i + 1
            if close == "]":
                v, i = _flow(text, i, where)
                out.append(v)
            else:
                k, i = _flow_key(text, i, where)
                v, i = _flow(text, i, where)
                out[k] = v
            while text[i] == " ":
                i += 1
            if text[i] == ",":
                i += 1
            elif text[i] != close:
                raise ValueError(f"{where}: expected ',' or {close!r}")
    if text[i] in "'\"":
        v, i = _quoted(text, i, where)
        return v, i
    j = i
    while j < len(text) and text[j] not in ",]}":
        j += 1
    return _scalar(text[i:j].strip(), where), j


def _flow_key(text: str, i: int, where: str):
    """(key, index past its ':') inside a flow mapping."""
    if text[i] in "'\"":
        k, i = _quoted(text, i, where)
    else:
        j = text.index(":", i)
        k, i = _scalar(text[i:j].strip(), where), j
    while text[i] == " ":
        i += 1
    if text[i] != ":":
        raise ValueError(f"{where}: expected ':' in a flow mapping")
    return k, i + 1


def _value(text: str, where: str):
    """An inline value: a flow collection or a scalar."""
    if text[:1] in "[{":
        try:
            v, i = _flow(text, 0, where)
        except IndexError:
            raise ValueError(f"{where}: unterminated flow collection") from None
        if text[i:].strip():
            raise ValueError(f"{where}: text after a flow collection")
        return v
    return _scalar(text, where)


def _strip_comment(line: str) -> str:
    """The line without its comment: '#' at its start or after a space,
    outside quotes."""
    q = None
    for i, c in enumerate(line):
        if q:
            if c == q:
                q = None
        elif c in "'\"":
            q = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(text: str, where: str):
    """(key, rest) of a block mapping entry 'key: rest', or None."""
    if text[:1] in "'\"":
        k, i = _quoted(text, 0, where)
        rest = text[i:]
        if rest.startswith(":") and (len(rest) == 1 or rest[1] == " "):
            return k, rest[1:].strip()
        return None
    m = re.match(r"([^\s\[\]{},#'\"][^:]*?)\s*:(?:\s+|$)", text)
    if not m:
        return None
    return _scalar(m.group(1), where), text[m.end():].strip()


def parse_yaml(source: str, name: str = "<yaml>"):
    """The value of one YAML document in the subset described above."""
    lines = []
    for no, raw in enumerate(source.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError(f"{name}:{no}: tab in indentation")
        text = _strip_comment(raw)
        if not text.strip():
            continue
        if text.startswith(("---", "...")):
            raise ValueError(f"{name}:{no}: several documents")
        indent = len(text) - len(text.lstrip(" "))
        lines.append([indent, text.strip(), f"{name}:{no}"])
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"{lines[i][2]}: unexpected indentation")
    return value


def _block(lines, i: int, indent: int):
    """(value, next line) of the block node whose lines start at lines[i],
    at `indent`."""
    ind, text, where = lines[i]
    if text == "-" or text.startswith("- "):
        out = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1] == "-" or lines[i][1].startswith("- ")):
            ind, text, where = lines[i]
            rest = text[1:].lstrip(" ")
            if not rest:
                if i + 1 < len(lines) and lines[i + 1][0] > indent:
                    v, i = _block(lines, i + 1, lines[i + 1][0])
                else:
                    v, i = None, i + 1
            else:
                # the item's content is a node at the column it starts in
                lines[i] = [indent + len(text) - len(rest), rest, where]
                v, i = _block(lines, i, lines[i][0])
            out.append(v)
        return out, i
    kv = _split_key(text, where)
    if kv is None:
        if i + 1 < len(lines) and lines[i + 1][0] > indent:
            raise ValueError(f"{where}: unsupported multi-line scalar")
        return _value(text, where), i + 1
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        ind, text, where = lines[i]
        kv = _split_key(text, where)
        if kv is None:
            raise ValueError(f"{where}: expected 'key: value'")
        key, rest = kv
        if key in out:
            raise ValueError(f"{where}: duplicate key {key!r}")
        i += 1
        if rest:
            out[key] = _value(rest, where)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and (lines[i][1] == "-"
                                           or lines[i][1].startswith("- ")))):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"{lines[i][2]}: unexpected indentation")
    return out, i


def load_yaml(path: str) -> Config:
    with open(path, "r") as f:
        return Config(parse_yaml(f.read(), path) or {})


def load_config(name_or_path: str) -> Config:
    """Load a config by bundled name ('dynamics/rope') or filesystem
    path."""
    if os.path.exists(name_or_path):
        return load_yaml(name_or_path)
    path = os.path.join(_CONFIG_ROOT, name_or_path)
    if not path.endswith(".yaml"):
        path += ".yaml"
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no config named {name_or_path!r} (looked in {_CONFIG_ROOT})")
    return load_yaml(path)
