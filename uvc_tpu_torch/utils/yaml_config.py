"""The YAML reader behind ``--config`` (``cli/flags.py::parse_with_config``).

``load(path)`` returns what ``yaml.safe_load(open(path))`` returns, for
the subset of YAML that a config file uses, without PyYAML (the H100's
machine has none).  The usual file is a timm ``args.yaml``, written by
``yaml.safe_dump(args.__dict__, default_flow_style=False)``.

The subset:

* one document, with an optional leading ``---`` (alone on its line, or
  with a comment) and an optional trailing ``...``;
* block mappings nested by indentation, block sequences (the indentless
  ``- item`` lines that ``safe_dump`` writes under a key included), and
  the compact ``- key: value`` and ``- - item`` forms;
* flow sequences and flow mappings, nested, over one or more lines;
* plain scalars (over several lines too, folded as PyYAML folds them),
  single-quoted scalars (``''`` for a quote) and double-quoted ones (every
  escape of PyYAML's scanner), ``#`` comments;
* duplicate keys, of which the last wins, and the empty file (``None``).

Scalars resolve as PyYAML's YAML 1.1 implicit resolvers and
``SafeConstructor`` resolve them: null, bool, int (binary, old-style
octal, decimal, hex, underscores, sexagesimal) and float (a dot, a signed
exponent, ``.inf`` / ``.nan``, sexagesimal).  So ``1e-3`` is the string
``'1e-3'``, ``1.0e-3`` is 0.001, ``yes`` is True, ``y`` is ``'y'`` and
``017`` is 15.

Everything else raises ``ValueError`` naming ``file:line:col``: anchors
and aliases, tags, block scalars (``|``, ``>``), complex keys (``?``),
merge keys (``<<``), directives, content on the ``---`` line, more
than one document, timestamps (PyYAML would return a ``date``, which no
flag takes), tabs outside a quoted scalar or a comment (PyYAML refuses
them too), a flow mapping's key that spans lines, a single-pair mapping
inside a flow sequence, and every document that PyYAML itself rejects.  The reader never returns a
value that PyYAML would not.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

# --- PyYAML 6.0's resolvers and constructors (yaml/resolver.py,
# Resolver.add_implicit_resolver; yaml/constructor.py, SafeConstructor),
# copied so that a scalar resolves to what safe_load makes of it.  The
# resolvers are tried in the order PyYAML registers them, among those
# registered for the scalar's first character.

_BOOL = re.compile(r'''^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$''', re.X)
_FLOAT = re.compile(r'''^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$''', re.X)
_INT = re.compile(r'''^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$''', re.X)
_MERGE = re.compile(r'^(?:<<)$')
_NULL = re.compile(r'''^(?: ~
                    |null|Null|NULL
                    | )$''', re.X)
_TIMESTAMP = re.compile(r'''^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$''',
                        re.X)
_VALUE = re.compile(r'^(?:=)$')

_BOOL_VALUES = {"yes": True, "no": False, "true": True, "false": False,
                "on": True, "off": False}

_INF = 1e300
while _INF != _INF * _INF:
    _INF *= _INF
_NAN = -_INF / _INF

# yaml/reader.py, Reader.NON_PRINTABLE
_NON_PRINTABLE = re.compile(
    '[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\uD7FF\uE000-\uFFFD'
    '\U00010000-\U0010ffff]')

# yaml/scanner.py, Scanner.ESCAPE_REPLACEMENTS and ESCAPE_CODES
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\x09", "\t": "\x09",
            "n": "\x0A", "v": "\x0B", "f": "\x0C", "r": "\x0D", "e": "\x1B",
            " ": "\x20", '"': '"', "\\": "\\", "/": "/", "N": "\x85",
            "_": "\xA0", "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
_HEX = set("0123456789abcdefABCDEF")

# characters that cannot start a plain scalar (yaml/scanner.py,
# Scanner.check_plain), and the line breaks PyYAML knows besides "\n"
_INDICATORS = "-?:,[]{}#&*!|>'\"%@`"
_OTHER_BREAKS = re.compile("[\r\x85\u2028\u2029]")
# a document marker: "---" or "..." at the start of a line, then a space,
# a tab or the line's end
_MARKER = re.compile(r"^(---|\.\.\.)(?=[ \t]|$)")
# PyYAML drops a possible simple key longer than this
_MAX_KEY = 1024


def _int(value: str) -> int:
    """SafeConstructor.construct_yaml_int"""
    value = value.replace("_", "")
    sign = +1
    if value[0] == "-":
        sign = -1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    elif value.startswith("0b"):
        return sign * int(value[2:], 2)
    elif value.startswith("0x"):
        return sign * int(value[2:], 16)
    elif value[0] == "0":
        return sign * int(value, 8)
    elif ":" in value:
        digits = [int(part) for part in value.split(":")]
        digits.reverse()
        base = 1
        value = 0
        for digit in digits:
            value += digit * base
            base *= 60
        return sign * value
    else:
        return sign * int(value)


def _float(value: str) -> float:
    """SafeConstructor.construct_yaml_float"""
    value = value.replace("_", "").lower()
    sign = +1
    if value[0] == "-":
        sign = -1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * _INF
    elif value == ".nan":
        return _NAN
    elif ":" in value:
        digits = [float(part) for part in value.split(":")]
        digits.reverse()
        base = 1
        value = 0.0
        for digit in digits:
            value += digit * base
            base *= 60
        return sign * value
    else:
        return sign * float(value)


class _Reader:
    """One document, as lines; a position is (line, column), both from 0.

    ``indent`` is PyYAML's ``Scanner.indent``: the column of the block
    collection a node sits in (-1 at the document's top).  A plain
    scalar's continuation lines must start right of it."""

    def __init__(self, text: str, name: str):
        self.name = name
        self.lines: List[str] = text.split("\n")
        self.end = len(self.lines)

    def fail(self, i: int, j: int, msg: str):
        raise ValueError(f"{self.name}:{i + 1}:{j + 1}: {msg}")

    # -- whitespace, comments, document markers -----------------------------

    def skip(self, i: int, j: int) -> int:
        """The column of the next token on line ``i`` from ``j``, or the
        line's length where only spaces and a comment are left."""
        line = self.lines[i]
        while j < len(line) and line[j] == " ":
            j += 1
        if j < len(line):
            if line[j] == "\t":
                self.fail(i, j, "a tab outside a quoted scalar or a comment")
            if line[j] == "#":
                return len(line)
        return j

    def next_content(self, i: int) -> Tuple[int, int]:
        """The first line from ``i`` on that holds a token, and the
        token's column; ``(self.end, 0)`` at the document's end."""
        while i < self.end:
            j = self.skip(i, 0)
            if j < len(self.lines[i]):
                return i, j
            i += 1
        return self.end, 0

    def document(self) -> Any:
        i, j = self.next_content(0)
        start = 0
        if i < self.end:
            line = self.lines[i]
            if line[j] == "%":
                self.fail(i, j, "directives are outside this reader's "
                          "subset")
            if j == 0 and _MARKER.match(line):
                if line.startswith("..."):
                    self.fail(i, 0, "a document end before any document")
                k = self.skip(i, 3)
                if k < len(line):
                    self.fail(i, k, "content on the '---' line is outside "
                              "this reader's subset")
                start = i + 1
        for k in range(start, len(self.lines)):
            if _MARKER.match(self.lines[k]):
                self.end = k
                if self.lines[k].startswith("---"):
                    self.fail(k, 0, "more than one document")
                break
        if self.end < len(self.lines):
            m = self.skip(self.end, 3)
            if m < len(self.lines[self.end]):
                self.fail(self.end, m, "content after the document's end")
            for k in range(self.end + 1, len(self.lines)):
                m = self.skip(k, 0)
                if m < len(self.lines[k]):
                    self.fail(k, m, "more than one document")
        i, j = self.next_content(start)
        if i >= self.end:
            return None
        value, i = self.block_node(i, j, -1)
        i, j = self.next_content(i)
        if i < self.end:
            self.fail(i, j, "content after the document's root node")
        return value

    # -- block context -------------------------------------------------------

    @staticmethod
    def _spaced(line: str, k: int) -> bool:
        """The character at ``k`` is a space or a tab, or the line ends."""
        return k >= len(line) or line[k] in " \t"

    def _entry_at(self, i: int, j: int) -> bool:
        return self.lines[i][j] == "-" and self._spaced(self.lines[i], j + 1)

    def block_node(self, i: int, j: int, indent: int) -> Tuple[Any, int]:
        """The node whose first token is at (i, j); returns it and the
        line after it."""
        if self._entry_at(i, j):
            return self.block_sequence(i, j)
        if self._is_key(i, j):
            return self.block_mapping(i, j)
        value, i, j, stop = self.inline(i, j, indent)
        self.line_end(i, j, stop)
        return value, i + 1

    def block_sequence(self, i: int, c: int) -> Tuple[list, int]:
        out = []
        while True:
            k = self.skip(i, c + 1)
            if k < len(self.lines[i]):
                value, i = self.block_node(i, k, c)
            else:
                ni, nc = self.next_content(i + 1)
                if ni < self.end and nc > c:
                    value, i = self.block_node(ni, nc, c)
                else:
                    value, i = None, i + 1
            out.append(value)
            i, col = self.next_content(i)
            # a line at another column, or no entry at this one, is for
            # the enclosing collection to take or refuse
            if i >= self.end or col != c or not self._entry_at(i, c):
                return out, i

    def block_mapping(self, i: int, c: int) -> Tuple[dict, int]:
        out = {}
        while True:
            key, j = self.key(i, c)
            k = self.skip(i, j)
            line = self.lines[i]
            if k < len(line):
                value, ei, ej, stop = self.inline(i, k, c)
                self.line_end(ei, ej, stop)
                i = ei + 1
            else:
                ni, nc = self.next_content(i + 1)
                if ni < self.end and nc > c:
                    value, i = self.block_node(ni, nc, c)
                elif ni < self.end and nc == c and self._entry_at(ni, c):
                    # the indentless sequence safe_dump writes under a key
                    value, i = self.block_sequence(ni, c)
                else:
                    value, i = None, i + 1
            out[key] = value
            i, col = self.next_content(i)
            if i >= self.end or col < c:
                return out, i
            if col > c:
                self.fail(i, col, "a line indented deeper than its "
                          "mapping's keys, where no value can start")

    def _is_key(self, i: int, j: int) -> bool:
        """A simple key starts at (i, j): a one-line scalar, then ':'."""
        line = self.lines[i]
        ch = line[j]
        if ch in "'\"":
            _, ei, ej = self.quoted(i, j)
            if ei != i:
                return False
            while ej < len(line) and line[ej] == " ":
                ej += 1
            return ej < len(line) and line[ej] == ":" \
                and self._spaced(line, ej + 1)
        if not self._plain_starts(line, j, flow=False):
            return False
        return self.plain_chunk(i, j, flow=False)[2] == "colon"

    def key(self, i: int, j: int) -> Tuple[Any, int]:
        """The key at (i, j) and the column after its ':'."""
        line = self.lines[i]
        if not self._is_key(i, j):
            if self._entry_at(i, j):
                self.fail(i, j, "a sequence entry where a mapping key was "
                          "expected")
            if line[j] == "?" and self._spaced(line, j + 1):
                self.fail(i, j, "complex keys ('?') are outside this "
                          "reader's subset")
            self.fail(i, j, "expected a 'key:' at this column")
        if line[j] in "'\"":
            key, _, k = self.quoted(i, j)
        else:
            end, k, _ = self.plain_chunk(i, j, flow=False)
            key = self.resolve(line[j:end], i, j)
        while line[k] == " ":
            k += 1
        if k - j > _MAX_KEY:
            self.fail(i, j, f"a key longer than {_MAX_KEY} characters")
        return key, k + 1

    def inline(self, i: int, j: int, indent: int):
        """A scalar or flow node at (i, j), where no block collection may
        start; returns (value, end line, end column, how a plain scalar
        stopped)."""
        line = self.lines[i]
        ch = line[j]
        if ch in "'\"":
            value, i, j = self.quoted(i, j)
            return value, i, j, None
        if ch in "[{":
            value, i, j = self.flow(i, j)
            return value, i, j, None
        self._refuse_start(i, j, flow=False)
        text, i, j, stop = self.plain(i, j, indent, flow=False)
        return self.resolve(text[0], text[1], text[2]), i, j, stop

    def line_end(self, i: int, j: int, stop: Optional[str]):
        """Only spaces and a comment may follow a value on its line."""
        if stop == "colon":
            self.fail(i, j, "mapping values are not allowed here")
        k = self.skip(i, j)
        if k < len(self.lines[i]):
            self.fail(i, k, f"unexpected {self.lines[i][k]!r} after a value")

    # -- scalars --------------------------------------------------------------

    def _plain_starts(self, line: str, j: int, flow: bool) -> bool:
        """yaml/scanner.py, Scanner.check_plain"""
        ch = line[j]
        return ch not in _INDICATORS + " \t" or (
            not self._spaced(line, j + 1)
            and (ch == "-" or (not flow and ch in "?:")))

    def _refuse_start(self, i: int, j: int, flow: bool):
        """Raises unless a plain scalar may start at (i, j)."""
        line = self.lines[i]
        ch = line[j]
        if self._plain_starts(line, j, flow):
            return
        if ch in "&*":
            self.fail(i, j, "anchors and aliases are outside this reader's "
                      "subset")
        if ch == "!":
            self.fail(i, j, "tags are outside this reader's subset")
        if ch in "|>":
            self.fail(i, j, "block scalars ('|', '>') are outside this "
                      "reader's subset")
        if ch == "?":
            self.fail(i, j, "complex keys ('?') are outside this reader's "
                      "subset")
        if ch == "-":
            self.fail(i, j, "sequence entries are not allowed here")
        if ch == ":":
            self.fail(i, j, "a mapping value without a key")
        self.fail(i, j, f"{ch!r} cannot start a value")

    def plain_chunk(self, i: int, j: int, flow: bool):
        """The part of a plain scalar on line ``i`` from ``j``: (end of its
        text, where scanning stopped, why: "eol", "comment", "colon" (a
        mapping value indicator) or "flow" (a flow indicator))."""
        line = self.lines[i]
        k = end = j
        while k < len(line):
            ch = line[k]
            if ch == " ":
                m = k
                while m < len(line) and line[m] == " ":
                    m += 1
                if m == len(line):
                    return end, m, "eol"
                if line[m] == "#":
                    return end, m, "comment"
                k = m
                continue
            if ch == "\t":
                self.fail(i, k, "a tab outside a quoted scalar or a comment")
            if ch == ":" and (self._spaced(line, k + 1)
                              or (flow and line[k + 1] in ",[]{}")):
                return end, k, "colon"
            if flow and ch in ",[]{}":
                return end, k, "flow"
            if flow and ch == "?":
                self.fail(i, k, "'?' inside a flow scalar is outside this "
                          "reader's subset")
            k += 1
            end = k
        return end, k, "eol"

    def plain(self, i: int, j: int, indent: int, flow: bool):
        """A plain scalar from (i, j), folded over its continuation lines
        as yaml/scanner.py's scan_plain folds them; returns ((text, line,
        column of its start), end line, end column, why it stopped)."""
        start = (i, j)
        end, k, stop = self.plain_chunk(i, j, flow)
        parts = [self.lines[i][j:end]]
        while stop == "eol":
            n = i + 1
            while n < self.end and not self.lines[n].strip(" "):
                n += 1
            if n >= self.end:
                break
            line = self.lines[n]
            col = len(line) - len(line.lstrip(" "))
            if line[col] == "#" or (not flow and col <= indent):
                break
            if line[col] == "\t":
                self.fail(n, col, "a tab outside a quoted scalar or a "
                          "comment")
            cend, ck, cstop = self.plain_chunk(n, col, flow)
            if cend == col:
                # nothing of the scalar on that line: it ends on line i
                break
            breaks = n - i - 1
            parts.append("\n" * breaks if breaks else " ")
            parts.append(line[col:cend])
            i, k, stop = n, ck, cstop
        return ("".join(parts),) + start, i, k, stop

    def quoted(self, i: int, j: int) -> Tuple[str, int, int]:
        """A single- or double-quoted scalar from (i, j), folded as
        yaml/scanner.py's scan_flow_scalar folds it; returns it and the
        position after its closing quote."""
        quote = self.lines[i][j]
        double = quote == '"'
        chunks = []
        k = j + 1
        while True:
            line = self.lines[i]
            while k < len(line):
                ch = line[k]
                if ch == quote:
                    if not double and line[k + 1:k + 2] == "'":
                        chunks.append("'")
                        k += 2
                        continue
                    return "".join(chunks), i, k + 1
                if double and ch == "\\":
                    if k + 1 == len(line):
                        # an escaped line break: no space, leading
                        # whitespace of the next line dropped
                        i, k, breaks = self._quoted_breaks(i + 1, j)
                        chunks.append("\n" * breaks)
                        line = self.lines[i]
                        continue
                    e = line[k + 1]
                    if e in _ESCAPES:
                        chunks.append(_ESCAPES[e])
                        k += 2
                    elif e in _ESCAPE_CODES:
                        n = _ESCAPE_CODES[e]
                        digits = line[k + 2:k + 2 + n]
                        if len(digits) != n or not set(digits) <= _HEX:
                            self.fail(i, k, f"expected {n} hexadecimal "
                                      f"digits after '\\{e}'")
                        chunks.append(chr(int(digits, 16)))
                        k += 2 + n
                    else:
                        self.fail(i, k, f"unknown escape '\\{e}'")
                    continue
                if ch in " \t":
                    m = k
                    while m < len(line) and line[m] in " \t":
                        m += 1
                    if m == len(line):
                        k = m
                        break
                    chunks.append(line[k:m])
                    k = m
                    continue
                chunks.append(ch)
                k += 1
            i, k, breaks = self._quoted_breaks(i + 1, j)
            chunks.append("\n" * breaks if breaks else " ")

    def _quoted_breaks(self, i: int, j0: int) -> Tuple[int, int, int]:
        """From line ``i`` inside a quoted scalar that started at column
        ``j0``: the next line with text, its first column after spaces and
        tabs, and the blank lines skipped."""
        breaks = 0
        start = i - 1
        while i < self.end:
            line = self.lines[i]
            m = 0
            while m < len(line) and line[m] in " \t":
                m += 1
            if m < len(line):
                return i, m, breaks
            breaks += 1
            i += 1
        self.fail(start, j0, "a quoted scalar with no closing quote before "
                  "the document's end")

    def resolve(self, text: str, i: int, j: int) -> Any:
        """A plain scalar's value (yaml/resolver.py's order)."""
        first = text[0]
        try:
            if first in "yYnNtTfFoO" and _BOOL.match(text):
                return _BOOL_VALUES[text.lower()]
            if first in "-+0123456789." and _FLOAT.match(text):
                return _float(text)
            if first in "-+0123456789" and _INT.match(text):
                return _int(text)
        except ValueError as e:
            # PyYAML raises here too ("0b_", "0x_")
            self.fail(i, j, f"{text!r} resolves to a number that does not "
                      f"parse ({e})")
        if first == "<" and _MERGE.match(text):
            self.fail(i, j, "merge keys ('<<') are outside this reader's "
                      "subset")
        if first in "~nN" and _NULL.match(text):
            return None
        if first in "0123456789" and _TIMESTAMP.match(text):
            self.fail(i, j, f"{text!r} is a timestamp (PyYAML returns a "
                      "date), outside this reader's subset")
        if first == "=" and _VALUE.match(text):
            self.fail(i, j, "'=' has no constructor in safe_load")
        return text

    # -- flow context ---------------------------------------------------------

    def flow_skip(self, i: int, j: int, opened: Tuple[int, int]):
        """The next token inside the flow collection opened at ``opened``,
        over line ends and comments."""
        while i < self.end:
            j = self.skip(i, j)
            if j < len(self.lines[i]):
                return i, j
            i, j = i + 1, 0
        self.fail(*opened, "a flow collection with no closing bracket "
                  "before the document's end")

    def flow(self, i: int, j: int) -> Tuple[Any, int, int]:
        """A flow sequence or mapping from (i, j); returns it and the
        position after its closing bracket."""
        opened = (i, j)
        mapping = self.lines[i][j] == "{"
        close = "}" if mapping else "]"
        out: Any = {} if mapping else []
        i, j = self.flow_skip(i, j + 1, opened)
        while True:
            if self.lines[i][j] == close:
                return out, i, j + 1
            if mapping:
                key, ki, i, j = self.flow_node(i, j)
                if ki != i or isinstance(key, (list, dict)):
                    self.fail(ki, 0, "a flow mapping's key must be a "
                              "scalar on one line")
                line = self.lines[i]
                while j < len(line) and line[j] == " ":
                    j += 1
                if j == len(line) or line[j] != ":":
                    i, j = self.flow_skip(i, j, opened)
                    if self.lines[i][j] == ":":
                        self.fail(i, j, "a ':' on another line than its key")
                value = None
                if self.lines[i][j] == ":":
                    i, j = self.flow_skip(i, j + 1, opened)
                    if self.lines[i][j] not in ",}":
                        value, _, i, j = self.flow_node(i, j)
                        i, j = self.flow_skip(i, j, opened)
                out[key] = value
            else:
                value, _, i, j = self.flow_node(i, j)
                i, j = self.flow_skip(i, j, opened)
                if self.lines[i][j] == ":":
                    self.fail(i, j, "a single-pair mapping inside a flow "
                              "sequence is outside this reader's subset")
                out.append(value)
            ch = self.lines[i][j]
            if ch == ",":
                i, j = self.flow_skip(i, j + 1, opened)
                if self.lines[i][j] == ",":
                    self.fail(i, j, "an empty entry in a flow collection")
            elif ch != close:
                self.fail(i, j, f"expected ',' or {close!r}, found {ch!r}")

    def flow_node(self, i: int, j: int):
        """A node inside a flow collection; returns (value, its first line,
        end line, end column)."""
        line = self.lines[i]
        ch = line[j]
        if ch in "[{":
            value, ei, ej = self.flow(i, j)
            return value, i, ei, ej
        if ch in "'\"":
            value, ei, ej = self.quoted(i, j)
            return value, i, ei, ej
        if ch in ",]}":
            self.fail(i, j, f"expected a value, found {ch!r}")
        self._refuse_start(i, j, flow=True)
        text, ei, ej, _ = self.plain(i, j, -1, flow=True)
        return self.resolve(*text), i, ei, ej


def loads(text: str, name: str = "<string>") -> Any:
    """``yaml.safe_load(text)`` on this module's subset; ``name`` leads
    each error's ``name:line:col``."""
    if text.startswith("\ufeff"):
        text = text[1:]
    for pattern, what in ((_NON_PRINTABLE, "a character YAML does not "
                           "allow"), (_OTHER_BREAKS, "a line break other "
                                      "than '\\n' or '\\r\\n'")):
        m = pattern.search(text.replace("\r\n", "\n"))
        if m:
            before = text.replace("\r\n", "\n")[:m.start()]
            line = before.count("\n")
            col = m.start() - (before.rfind("\n") + 1)
            raise ValueError(f"{name}:{line + 1}:{col + 1}: {what} "
                             f"({m.group()!r})")
    return _Reader(text.replace("\r\n", "\n"), name).document()


def load(path) -> Any:
    """``yaml.safe_load(open(path))`` on this module's subset."""
    with open(path, encoding="utf-8") as f:
        return loads(f.read(), str(path))
