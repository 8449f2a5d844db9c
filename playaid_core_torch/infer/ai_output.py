"""``ai_output.yaml`` without a YAML package.

The runner's output is a tree of mappings (fighter -> frame -> field) with
string and integer keys and scalar leaves: strings, ints, floats, booleans
and None.  :func:`dumps` writes it as block-style YAML with sorted keys, as
``yaml.dump`` does, with every string double-quoted (JSON quoting, which is
valid YAML) and floats in PyYAML's spelling, so ``yaml.safe_load`` of the
text gives the tree back exactly.  :func:`loads` reads this subset back,
with or without PyYAML, and refuses any other YAML.
"""

from __future__ import annotations

import json
import math
import re

_INT = re.compile(r"-?[0-9]+$")


def _scalar(value):
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
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)  # PyYAML's floats need a dot
        return text
    if isinstance(value, str):
        return json.dumps(value, ensure_ascii=False)
    if hasattr(value, "item"):  # a numpy scalar
        return _scalar(value.item())
    raise TypeError(f"ai_output holds no {type(value).__name__} values")


def _key(key):
    if isinstance(key, bool) or not isinstance(key, (int, str)):
        raise TypeError(f"ai_output keys are ints or strings, got {key!r}")
    return _scalar(key)


def dumps(tree):
    """The tree as YAML text."""
    lines = []

    def emit(node, depth):
        for key in sorted(node):
            value = node[key]
            head = "  " * depth + _key(key) + ":"
            if isinstance(value, dict) and value:
                lines.append(head)
                emit(value, depth + 1)
            else:
                lines.append(head + " " + ("{}" if isinstance(value, dict) else _scalar(value)))

    if not tree:
        return "{}\n"
    emit(tree, 0)
    return "\n".join(lines) + "\n"


_JSON = json.JSONDecoder()
_SPECIAL = {"null": None, "true": True, "false": False,
            ".inf": math.inf, "-.inf": -math.inf, ".nan": math.nan}
_FLOAT = re.compile(r"-?[0-9]+\.[0-9]*(e[-+][0-9]+)?$")


def _quoted(text):
    """The double-quoted string at the start of text, and where it ends."""
    value, end = _JSON.raw_decode(text)
    if not isinstance(value, str):
        raise ValueError(f"not a quoted string: {text!r}")
    return value, end


def _parse_scalar(text):
    if text.startswith('"'):
        value, end = _quoted(text)
        if end == len(text):
            return value
    elif text == "{}":
        return {}
    elif text in _SPECIAL:
        return _SPECIAL[text]
    elif _INT.match(text):
        return int(text)
    elif _FLOAT.match(text):
        return float(text)
    raise ValueError(f"not a value that dumps writes: {text!r}")


def _parse_entry(body):
    """``key: value`` or ``key:`` -> (key, value text or "")."""
    if body.startswith('"'):
        key, end = _quoted(body)
    else:
        match = _INT.match(body.partition(":")[0])
        if match is None:
            raise ValueError(f"not a key that dumps writes: {body!r}")
        key, end = int(match.group()), match.end()
    rest = body[end:]
    if rest == ":":
        return key, ""
    if not rest.startswith(": ") or len(rest) == 2:
        raise ValueError(f"not a mapping entry: {body!r}")
    return key, rest[2:]


def loads(text):
    """Read what :func:`dumps` writes: block mappings indented two spaces a
    level, keys that are ints or double-quoted strings, scalar leaves.
    Raises ``ValueError`` on any line it does not parse."""
    if text.strip() == "{}":
        return {}
    root = {}
    stack = [root]  # the open mappings, one an indent level
    opened = False  # the last line opened a mapping, so the next is inside it
    for number, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        body = line.lstrip(" ")
        depth, odd = divmod(len(line) - len(body), 2)
        try:
            if odd or depth >= len(stack) or (opened and depth != len(stack) - 1):
                raise ValueError("indent")
            key, value = _parse_entry(body)
            parent = stack[depth]
            if key in parent:
                raise ValueError(f"key {key!r} twice")
        except ValueError as e:
            raise ValueError(f"ai_output line {number}: {line!r}: {e}") from None
        del stack[depth + 1:]
        opened = not value
        if opened:
            parent[key] = {}
            stack.append(parent[key])
        else:
            try:
                parent[key] = _parse_scalar(value)
            except ValueError as e:
                raise ValueError(f"ai_output line {number}: {line!r}: {e}") from None
    if opened:
        raise ValueError("ai_output ends with a mapping that holds nothing")
    return root


def write(path, tree):
    with open(path, "w", encoding="utf-8") as f:
        f.write(dumps(tree))


def read(path):
    """The tree that :func:`write` wrote to ``path``."""
    with open(path, encoding="utf-8") as f:
        return loads(f.read())
