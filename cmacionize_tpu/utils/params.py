"""Parameter files: YAML + physical units + used-value tracking.

Equivalent of the reference's ParameterFile/YAMLDictionary
(/root/reference/src/ParameterFile.hpp:103-160,
/root/reference/src/YAMLDictionary.hpp): values are addressed by
colon-separated paths ("SimulationBox:anchor"), may carry unit strings
("5. pc", "100. cm^-3"), every read records the value actually used
(including defaults) so the effective configuration can be dumped
(cf. the `.used-values` dump at
/root/reference/src/IonizationSimulation.cpp:218-226).

The document structure is read by :func:`yaml_load`, an in-repo reader for
the YAML subset the reference's YAMLDictionary accepts (indented maps,
``key: value`` scalars, ``[a, b]`` flow lists, ``- item`` sequences, quoted
scalars, ``#`` comments); plain scalars resolve to the same Python types
YAML 1.1 gives them.  Scalar coercion (ints, floats in "1e6" form,
booleans, unit quantities) happens at access time, matching the
reference's typed `get_value<T>` semantics.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Optional, Sequence, Tuple, Union

from cmacionize_tpu.utils.units import parse_quantity

_MISSING = object()

# YAML 1.1 plain-scalar resolution (the resolver tables of PyYAML's
# SafeLoader), restricted to the forms a parameter file can hold
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {
    **{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE",
                         "on", "On", "ON")},
    **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE",
                          "off", "Off", "OFF")},
}
_INT = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
    r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN))$")


def _resolve_plain(text: str) -> Any:
    """A plain (unquoted) scalar → None, bool, int, float or str."""
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        digits = text.replace("_", "")
        sign = -1 if digits.startswith("-") else 1
        body = digits.lstrip("+-")
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        if len(body) > 1 and body.startswith("0"):
            return sign * int(body, 8)
        return sign * int(body)
    if _FLOAT.match(text):
        body = text.replace("_", "").lower()
        if body.endswith("inf"):
            return -math.inf if body.startswith("-") else math.inf
        if body.endswith("nan"):
            return math.nan
        return float(body)
    return text


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment (one at line start or after whitespace, outside
    quotes) and trailing whitespace."""
    quote = None
    for i, char in enumerate(line):
        if quote:
            if char == quote:
                quote = None
        elif char in "'\"" and (i == 0 or line[i - 1] in " \t[,:"):
            quote = char
        elif char == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


_ESCAPES = {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/"}


def _scalar(text: str) -> Any:
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"':
        return re.sub(r"\\(.)", lambda m: _ESCAPES.get(m[1], m[0]),
                      text[1:-1])
    return _resolve_plain(text)


def _value(text: str) -> Any:
    """A value after ``key:`` or ``-``: a flow list or a scalar."""
    text = text.strip()
    if not text.startswith("["):
        return _scalar(text)
    if not text.endswith("]"):
        raise ValueError(f"unterminated flow list: {text!r}")
    items, item, quote = [], "", None
    for char in text[1:-1]:
        if quote:
            quote = None if char == quote else quote
        elif char in "'\"" and not item.strip():
            quote = char
        elif char in "[]{}":
            raise ValueError(f"nested flow collections: {text!r}")
        elif char == ",":
            items.append(item)
            item = ""
            continue
        item += char
    items.append(item)
    if len(items) == 1 and not item.strip():
        return []
    return [_scalar(entry) for entry in items]


def yaml_load(text: str) -> Any:
    """Parse a parameter document (the YAML subset described above).

    Returns a dict (or None for an empty document), equal to what
    ``yaml.safe_load`` gives for the same text.
    """
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        if "\t" in line[: len(line) - len(line.lstrip())]:
            raise ValueError(f"tab indentation: {raw!r}")
        lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    node, pos = _parse_block(lines, 0, lines[0][0])
    if pos != len(lines):
        raise ValueError(f"unexpected indentation: {lines[pos][1]!r}")
    return node


def _parse_block(lines, pos, indent):
    if lines[pos][1].startswith("- ") or lines[pos][1] == "-":
        out = []
        while pos < len(lines) and lines[pos][0] == indent and (
                lines[pos][1].startswith("- ") or lines[pos][1] == "-"):
            out.append(_value(lines[pos][1][1:]))
            pos += 1
        return out, pos
    out = {}
    while pos < len(lines) and lines[pos][0] == indent:
        content = lines[pos][1]
        key, sep, rest = content.partition(": ")
        if not sep:
            if not content.endswith(":"):
                raise ValueError(f"expected 'key: value': {content!r}")
            key, rest = content[:-1], ""
        key = _scalar(key)
        pos += 1
        if rest.strip():
            out[key] = _value(rest)
        elif pos < len(lines) and (
                lines[pos][0] > indent
                or (lines[pos][0] == indent
                    and lines[pos][1].startswith("- "))):
            out[key], pos = _parse_block(lines, pos, lines[pos][0])
        else:
            out[key] = None
    return out, pos


def _format_scalar(value: Any) -> str:
    if hasattr(value, "item"):  # numpy scalar
        value = value.item()
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        mantissa, e, exponent = text.partition("e")
        if "." not in mantissa:
            mantissa += ".0"
        if e and exponent[0] not in "+-":
            exponent = "+" + exponent
        return mantissa + (e + exponent if e else "")
    text = str(value)
    if _scalar(text) == text and text == text.strip() and not re.search(
            r"^[-#\[\]{}&*!|>%@`'\"?,]|: |\s#|:$", text):
        return text
    return "'" + text.replace("'", "''") + "'"


def yaml_dump(tree: dict, indent: int = 0) -> str:
    """Write a nested dict of scalars and lists as block YAML that
    :func:`yaml_load` (and any YAML reader) reads back to ``tree``."""
    out = []
    pad = " " * indent
    for key in sorted(tree, key=str):
        value = tree[key]
        name = _format_scalar(key)
        if isinstance(value, dict) and value:
            out.append(f"{pad}{name}:\n" + yaml_dump(value, indent + 2))
        elif isinstance(value, (list, tuple)):
            items = ", ".join(_format_scalar(v) for v in value)
            out.append(f"{pad}{name}: [{items}]\n")
        elif isinstance(value, dict):
            out.append(f"{pad}{name}: {{}}\n")
        else:
            out.append(f"{pad}{name}: {_format_scalar(value)}\n")
    return "".join(out)


def _coerce_number(value: Any) -> float:
    """Coerce YAML scalars to float, accepting "1e6"-style strings that
    YAML 1.1 parses as strings."""
    if isinstance(value, bool):
        raise ValueError(f"expected a number, got boolean {value!r}")
    if isinstance(value, (int, float)):
        return float(value)
    return float(str(value).strip())


def _coerce_bool(value: Any) -> bool:
    if isinstance(value, bool):
        return value
    text = str(value).strip().lower()
    if text in ("true", "yes", "on", "y", "1"):
        return True
    if text in ("false", "no", "off", "n", "0"):
        return False
    raise ValueError(f"cannot interpret {value!r} as a boolean")


class ParameterFile:
    """Typed, unit-aware access to a YAML parameter tree."""

    def __init__(self, source: Union[str, dict, None] = None):
        self.checksum = None
        if source is None:
            self._tree: dict = {}
            self.filename = None
        elif isinstance(source, dict):
            self._tree = source
            self.filename = None
        else:
            self.filename = source
            with open(source, "r") as handle:
                raw = handle.read()
            self._tree = yaml_load(raw) or {}
            # input provenance: the reference logs an MD5 checksum of every
            # parameter file it reads (ParameterFile.hpp:179, MD5Sum.hpp)
            import hashlib

            self.checksum = hashlib.md5(raw.encode()).hexdigest()
        # path -> value actually used (after defaults), for the used-values dump
        self._used: dict = {}

    # ------------------------------------------------------------------ raw
    def _lookup(self, path: str):
        node = self._tree
        for part in path.split(":"):
            if not isinstance(node, dict) or part not in node:
                return _MISSING
            node = node[part]
        return node

    def has_value(self, path: str) -> bool:
        return self._lookup(path) is not _MISSING

    # ---------------------------------------------------------------- typed
    def get_value(self, path: str, default: Any = _MISSING) -> Any:
        """Raw value (string/number/bool/list) with default recording."""
        value = self._lookup(path)
        if value is _MISSING:
            if default is _MISSING:
                raise KeyError(f"parameter {path!r} not found and no default given")
            value = default
        self._used[path] = value
        return value

    def get_string(self, path: str, default: Any = _MISSING) -> str:
        return str(self.get_value(path, default))

    def get_number(self, path: str, default: Any = _MISSING) -> float:
        return _coerce_number(self.get_value(path, default))

    def get_int(self, path: str, default: Any = _MISSING) -> int:
        return int(self.get_number(path, default))

    def get_bool(self, path: str, default: Any = _MISSING) -> bool:
        return _coerce_bool(self.get_value(path, default))

    def get_physical_value(
        self,
        path: str,
        quantity: Optional[str] = None,
        default: Any = _MISSING,
    ) -> float:
        """Value with units → SI float. ``default`` may itself carry units."""
        value = self.get_value(path, default)
        return parse_quantity(value, quantity)

    def get_physical_vector(
        self,
        path: str,
        quantity: Optional[str] = None,
        default: Any = _MISSING,
    ) -> Sequence[float]:
        value = self.get_value(path, default)
        if isinstance(value, str):
            value = [part.strip() for part in value.strip("[]").split(",")]
        return [parse_quantity(component, quantity) for component in value]

    def get_int_vector(self, path: str, default: Any = _MISSING):
        value = self.get_value(path, default)
        return [int(_coerce_number(component)) for component in value]

    def get_bool_vector(self, path: str, default: Any = _MISSING):
        value = self.get_value(path, default)
        return [_coerce_bool(component) for component in value]

    # ------------------------------------------------------------ used dump
    def used_values(self) -> dict:
        return dict(self._used)

    def write_used_values(self, filename: str) -> None:
        """Dump the effective configuration (every value read, incl. defaults)."""
        tree: dict = {}
        for path, value in sorted(self._used.items()):
            node = tree
            parts = path.split(":")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = value
        with open(filename, "w") as handle:
            handle.write(yaml_dump(tree))
