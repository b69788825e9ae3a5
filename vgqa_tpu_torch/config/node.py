"""Lightweight hierarchical config tree (yacs-compatible surface).

Counterpart of ``vgqa_tpu/config/node.py`` with the same keys and behaviour.
PyYAML is optional: ``merge_from_file`` uses it where it is installed and
reads the config files' YAML subset itself where not, and ``dump`` writes
that subset itself, so configs load and dump on a host without it:

    cfg.MODEL.VSTG.HIDDEN            # attribute access
    cfg.merge_from_file("x.yaml")    # YAML overlay
    cfg.merge_from_list(["SOLVER.BASE_LR", "1e-4"])
    cfg.freeze() / cfg.defrost() / cfg.clone() / cfg.dump()
"""

from __future__ import annotations

import ast
import copy
import json
from typing import Any, Dict, List

_VALID_SCALARS = (int, float, bool, str, type(None), tuple, list)


class CfgNode(dict):
    """A dict with attribute access, freezing, and YAML merge support."""

    _IMMUTABLE_KEY = "__immutable__"

    def __init__(self, init_dict: Dict[str, Any] | None = None):
        super().__init__()
        object.__setattr__(self, "_frozen", False)
        if init_dict:
            for k, v in init_dict.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, "_frozen"):
            raise AttributeError(f"CfgNode is frozen; cannot set {name}")
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, "_frozen"):
            raise AttributeError(f"CfgNode is frozen; cannot set {name}")
        super().__setitem__(name, value)

    # -- freeze / clone ---------------------------------------------------
    def freeze(self) -> None:
        object.__setattr__(self, "_frozen", True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def defrost(self) -> None:
        object.__setattr__(self, "_frozen", False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, "_frozen")

    def clone(self) -> "CfgNode":
        node = CfgNode()
        for k, v in self.items():
            node[k] = v.clone() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return node

    # -- merging ----------------------------------------------------------
    def _merge_dict(self, other: Dict[str, Any], path: str = "") -> None:
        for k, v in other.items():
            full = f"{path}.{k}" if path else k
            if k not in self:
                raise KeyError(f"Unknown config key: {full}")
            if isinstance(v, dict):
                if not isinstance(self[k], CfgNode):
                    raise TypeError(f"Cannot merge dict into scalar at {full}")
                self[k]._merge_dict(v, full)
            else:
                super().__setitem__(k, _coerce(v, self[k], full))

    def merge_from_file(self, path: str) -> None:
        """Overlay a YAML file: through PyYAML where it is installed, else
        through :func:`_yaml_mapping`, which reads only the subset config
        files use (block mappings, scalars, flow lists) and raises
        ``ValueError`` on anything else, such as block lists. The files in
        ``configs/`` and every file :meth:`dump` writes are in that subset,
        so they load alike with or without PyYAML."""
        with open(path, "r") as f:
            text = f.read()
        try:
            import yaml
        except ImportError:
            data = _yaml_mapping(text)
        else:
            data = yaml.safe_load(text) or {}
        if self.is_frozen():
            raise AttributeError("CfgNode is frozen")
        self._merge_dict(data)

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        self._merge_dict(other)

    def merge_from_list(self, opts: List[str]) -> None:
        if self.is_frozen():
            raise AttributeError("CfgNode is frozen")
        assert len(opts) % 2 == 0, f"Override list must be key/value pairs, got {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Unknown config key: {key}")
            parsed = _parse_scalar(value) if isinstance(value, str) else value
            dict.__setitem__(node, leaf, _coerce(parsed, node[leaf], key))

    # -- serialization ----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            k: (v.to_dict() if isinstance(v, CfgNode) else v) for k, v in self.items()
        }

    def dump(self) -> str:
        """The tree as YAML in the subset :func:`_yaml_mapping` reads:
        block mappings, and every other value on its key's line (lists and
        tuples as flow lists, strings double-quoted), without PyYAML."""
        return "".join(_yaml_lines(self.to_dict(), ""))

    def __repr__(self) -> str:  # pragma: no cover
        return f"CfgNode({self.to_dict()!r})"


def _parse_scalar(text: str) -> Any:
    """A command-line override value as YAML would read it, for the forms
    configs use (bools, null, numbers, lists, tuples, strings), without
    PyYAML (absent on the card machine)."""
    word = text.strip()
    low = word.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none", "~", ""):
        return None
    try:
        return ast.literal_eval(word)
    except (ValueError, SyntaxError):
        return word


def _strip_comment(line: str) -> str:
    """``line`` without a ``#`` comment that starts outside quotes (a
    backslash escapes the next character inside double quotes)."""
    quote, escaped = None, False
    for i, ch in enumerate(line):
        if escaped:
            escaped = False
        elif quote:
            if ch == quote:
                quote = None
            escaped = quote == '"' and ch == "\\"
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _yaml_mapping(text: str) -> Dict[str, Any]:
    """The YAML that config files are written in, read without PyYAML:
    nested block mappings by indentation, ``#`` comments, and scalar or
    flow-list values read by :func:`_parse_scalar` (a numeric string such
    as ``2e-4`` becomes a float here and a string under PyYAML; the merge
    coerces both to the default's type). A ``key:`` with nothing under it
    is null, as in YAML. Anything else (block lists, anchors, multi-line
    scalars) raises ``ValueError``."""
    root: Dict[str, Any] = {}
    stack = [(-1, root)]
    opened = []
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        body = line.lstrip(" ")
        if not body or body == "---":
            continue
        key, sep, rest = body.partition(":")
        if (not sep or body.startswith(("-", "&", "*", "|", ">", "[", "{"))
                or "\t" in line[:len(line) - len(body)]
                or rest.strip()[:1] in ("|", ">", "&", "*", "{")):
            raise ValueError(f"line {n}: not a 'key: value' line of a config file: {raw!r}")
        indent = len(line) - len(body)
        while indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        key = key.strip().strip("'\"")
        if rest.strip():
            value = rest.strip()
            if len(value) > 1 and value[0] == value[-1] == '"':
                parent[key] = json.loads(value)
            elif len(value) > 1 and value[0] == value[-1] == "'":
                parent[key] = value[1:-1]
            else:
                parent[key] = _parse_scalar(value)
        else:
            child: Dict[str, Any] = {}
            parent[key] = child
            stack.append((indent, child))
            opened.append((parent, key))
    for parent, key in reversed(opened):
        if parent[key] == {}:
            parent[key] = None
    return root


def _yaml_lines(tree: Dict[str, Any], pad: str):
    for key, value in tree.items():
        if isinstance(value, dict) and value:
            yield f"{pad}{key}:\n"
            yield from _yaml_lines(value, pad + "  ")
        else:
            yield f"{pad}{key}: {_yaml_value(value)}\n"


def _yaml_value(value: Any) -> str:
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_yaml_value(v) for v in value) + "]"
    if isinstance(value, bool):
        return "true" if value else "false"
    if value is None or value == {}:
        return "null"
    if isinstance(value, str):
        return json.dumps(value)
    text = repr(value)
    if isinstance(value, float) and "e" in text and "." not in text:
        text = text.replace("e", ".0e")    # YAML 1.1 (PyYAML) reads 1e-05 as a string
    return text


def _coerce(value: Any, old: Any, key: str) -> Any:
    """Validate/convert an override value against the default's type."""
    if old is None or value is None:
        return value
    # PyYAML (YAML 1.1) parses "2e-4" as a string; coerce numeric-looking
    # strings when the default is numeric (yacs does this via literal_eval).
    if isinstance(old, (int, float)) and not isinstance(old, bool) and isinstance(value, str):
        try:
            value = float(value)
        except ValueError:
            pass
    if isinstance(old, bool):
        if isinstance(value, bool):
            return value
        raise TypeError(f"Expected bool for {key}, got {value!r}")
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    if isinstance(old, (tuple, list)) and isinstance(value, (tuple, list)):
        return type(old)(value)
    if isinstance(old, int) and isinstance(value, float) and value.is_integer():
        return int(value)
    if not isinstance(value, type(old)) and not isinstance(old, type(value)):
        raise TypeError(f"Type mismatch for {key}: {type(old).__name__} vs {value!r}")
    return value
