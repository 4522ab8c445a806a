"""Configs: a YAML reader and writer for the subset that the configs use,
and the resolution of defaults, a config file, overrides and
``--key value`` command-line arguments.

Counterpart of espnet_tpu/utils/config.py, without PyYAML. The reader
reads block maps, block lists (also a list right under its key at the
key's own indent, as PyYAML writes them), nested ``- - x`` lists,
anchors and aliases (``&id001`` / ``*id001``), the empty flow
collections ``{}`` and ``[]``, and plain or quoted scalars resolved as
YAML 1.1's safe loader resolves them: null, booleans, ints, floats and
strings. Anything else (flow collections with content, block scalars,
tags) raises ValueError. ``dump_yaml`` writes what the reader (and
PyYAML's safe loader) reads back as the same value.
"""

from __future__ import annotations

import copy
import math
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?")
_NULL = {"null", "Null", "NULL", "~", ""}
_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"}


def _scalar(text: str) -> Any:
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        body = text[1:-1]
        return body.replace("''", "'") if text[0] == "'" else body
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if text == "{}":
        return {}
    if text == "[]":
        return []
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _FLOAT.fullmatch(text) and text not in (".", "+.", "-."):
        return float(text.replace("_", ""))
    low = text.lower()
    if low in (".inf", "+.inf"):
        return float("inf")
    if low == "-.inf":
        return float("-inf")
    if low == ".nan":
        return float("nan")
    if text[0] in "{[|>!%@`":
        raise ValueError(f"unsupported YAML: {text!r}")
    return text


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


class _Parser:
    def __init__(self, text: str):
        self.lines: List[Tuple[int, str]] = []
        for raw in text.splitlines():
            line = _strip_comment(raw).rstrip()
            if not line.strip() or line.strip() in ("---", "..."):
                continue
            self.lines.append((len(line) - len(line.lstrip(" ")),
                               line.strip()))
        self.anchors: Dict[str, Any] = {}

    @staticmethod
    def _is_item(content: str) -> bool:
        return content == "-" or content.startswith("- ")

    def _value(self, rest: str, i: int, indent: int, is_item: bool):
        """Value written after ``key:`` or ``-`` on line i-1: inline, or
        the block that follows. Returns (value, next line)."""
        anchor = None
        if rest.startswith("&"):
            anchor, _, rest = rest.partition(" ")
            anchor, rest = anchor[1:], rest.strip()
        if rest.startswith("*"):
            value = self.anchors[rest[1:]]
        elif rest:
            value = _scalar(rest)
        elif i < len(self.lines) and (
                self.lines[i][0] > indent
                or (not is_item and self.lines[i][0] == indent
                    and self._is_item(self.lines[i][1]))):
            value, i = self.block(i, self.lines[i][0])
        else:
            value = None
        if anchor is not None:
            self.anchors[anchor] = value
        return value, i

    def block(self, i: int, indent: int):
        if self._is_item(self.lines[i][1]):
            return self._list(i, indent)
        return self._map(i, indent)

    def _list(self, i: int, indent: int):
        out = []
        while (i < len(self.lines) and self.lines[i][0] == indent
               and self._is_item(self.lines[i][1])):
            rest = self.lines[i][1][1:].strip()
            if self._is_item(rest) or re.match(r"[^'\"&*{\[]\S*:( |$)",
                                               rest):
                # "- - x" or "- key: v": the rest opens a block two
                # columns in
                self.lines[i] = (indent + 2, rest)
                value, i = self.block(i, indent + 2)
            else:
                value, i = self._value(rest, i + 1, indent, True)
            out.append(value)
        return out, i

    def _map(self, i: int, indent: int):
        out: Dict[str, Any] = {}
        while (i < len(self.lines) and self.lines[i][0] == indent
               and not self._is_item(self.lines[i][1])):
            content = self.lines[i][1]
            m = re.match(r"([^:]+?):( (.*))?$", content)
            if m is None:
                raise ValueError(f"unsupported YAML line: {content!r}")
            key = _scalar(m.group(1).strip())
            out[key], i = self._value((m.group(3) or "").strip(), i + 1,
                                      indent, False)
        if i < len(self.lines) and self.lines[i][0] > indent:
            raise ValueError(f"bad indentation: {self.lines[i][1]!r}")
        return out, i


def loads_yaml(text: str) -> Any:
    p = _Parser(text)
    if not p.lines:
        return None
    value, i = p.block(0, p.lines[0][0])
    if i != len(p.lines):
        raise ValueError(f"unparsed YAML from: {p.lines[i][1]!r}")
    return value


def load_yaml(path) -> Dict[str, Any]:
    return loads_yaml(Path(path).read_text(encoding="utf-8")) or {}


def _dump_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        if "e" in text and "." not in text.split("e")[0]:
            # YAML 1.1 reads "1e-05" as a string
            mant, exp = text.split("e")
            text = f"{mant}.0e{exp}"
        return text
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    raise ValueError(f"cannot write {type(v).__name__} as YAML")


def _dump_lines(v: Any, indent: int) -> List[str]:
    pad = " " * indent
    if isinstance(v, dict) and v:
        lines = []
        for k, x in v.items():
            key = _dump_scalar(str(k)) if not re.fullmatch(
                r"[A-Za-z_][A-Za-z0-9_.\-]*", str(k)) else str(k)
            if isinstance(x, (dict, list, tuple)) and x:
                lines.append(f"{pad}{key}:")
                lines += _dump_lines(x, indent + 2)
            else:
                lines.append(f"{pad}{key}: {_dump_one(x)}")
        return lines
    if isinstance(v, (list, tuple)) and v:
        lines = []
        for x in v:
            if isinstance(x, (dict, list, tuple)) and x:
                sub = _dump_lines(x, indent + 2)
                lines.append(f"{pad}- {sub[0].lstrip()}")
                lines += sub[1:]
            else:
                lines.append(f"{pad}- {_dump_one(x)}")
        return lines
    return [pad + _dump_one(v)]


def _dump_one(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _dump_scalar(v)


def dumps_yaml(d: Dict[str, Any]) -> str:
    return "\n".join(_dump_lines(d, 0)) + "\n"


def dump_yaml(d: Dict[str, Any], path):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(dumps_yaml(d), encoding="utf-8")


def deep_update(base: Dict, overlay: Optional[Dict]) -> Dict:
    out = copy.deepcopy(base)
    for k, v in (overlay or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_update(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def parse_cli_overrides(argv: List[str]) -> Dict[str, Any]:
    """['--a.b', '3', '--c=x'] -> {"a": {"b": 3}, "c": "x"}; values read
    as YAML scalars (numbers, booleans, null, [] and {})."""
    out: Dict[str, Any] = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise ValueError(f"expected --key, got {arg!r}")
        key = arg[2:]
        if "=" in key:
            key, raw = key.split("=", 1)
            i += 1
        else:
            if i + 1 >= len(argv):
                raise ValueError(f"missing value for --{key}")
            raw = argv[i + 1]
            i += 2
        node = out
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = _scalar(raw.strip())
    return out


def resolve_config(defaults: Dict[str, Any],
                   config_path: Optional[str] = None,
                   overrides: Optional[Dict[str, Any]] = None,
                   argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """defaults <- the config file (``--config`` or config_path) <-
    overrides <- the other command-line arguments."""
    cli = parse_cli_overrides(argv) if argv else {}
    config_path = cli.pop("config", config_path)
    cfg = copy.deepcopy(defaults)
    if config_path:
        cfg = deep_update(cfg, load_yaml(config_path))
    cfg = deep_update(cfg, overrides)
    return deep_update(cfg, cli)
