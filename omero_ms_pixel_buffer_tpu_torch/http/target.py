"""The request line and target as the JAX app's aiohttp front reads them.

aiohttp parses the request line with llhttp, builds the URL with yarl and
routes on yarl's ``path_safe``; the port's front keeps its own copy of
those rules so that both fronts answer the same bytes the same way:

- **The request line.** llhttp takes only its known methods, written in
  capitals; a request target of printable ASCII; and the versions
  ``HTTP/0.9``, ``HTTP/1.0``, ``HTTP/1.1`` and ``HTTP/2.0``. A line
  without a version is HTTP/0.9. Anything else is a ``ParseError``, which
  the front answers with aiohttp's ``HTTP/1.0 400``, the parser's reason
  and the byte it stopped at.
- **The target** splits into path, query and fragment as aiohttp's
  parser splits it (``split_target``).
- **Percent-escapes** decode as yarl decodes them (``unquote``): a run of
  escapes that forms UTF-8 decodes, one that does not stays as written.
  ``request.path`` decodes everything; a route matches the path with
  ``%2F`` and ``%25`` kept (``path_safe``), and each captured group then
  decodes those two (``unquote_group``), so ``%2F`` never splits a
  segment. A query's ``+`` is a space.
"""

from __future__ import annotations

import codecs
from typing import List, Optional, Tuple
from urllib.parse import urlsplit

# llhttp's request methods (HTTP mode), as the JAX front's parser takes them
METHODS = frozenset((
    "DELETE", "GET", "HEAD", "POST", "PUT", "CONNECT", "OPTIONS", "TRACE", "COPY",
    "LOCK", "MKCOL", "MOVE", "PROPFIND", "PROPPATCH", "SEARCH", "UNLOCK", "BIND",
    "REBIND", "UNBIND", "ACL", "REPORT", "MKACTIVITY", "CHECKOUT", "MERGE", "M-SEARCH",
    "NOTIFY", "SUBSCRIBE", "UNSUBSCRIBE", "PATCH", "PURGE", "MKCALENDAR", "LINK",
    "UNLINK", "SOURCE", "QUERY",
))
# the rest of llhttp's method table (RTSP and the HTTP/2 preface): a name
# that walks into one of these fails where it leaves it
_OTHER_METHODS = ("DESCRIBE", "ANNOUNCE", "SETUP", "PLAY", "PAUSE", "TEARDOWN",
                  "GET_PARAMETER", "SET_PARAMETER", "REDIRECT", "RECORD", "FLUSH", "PRI")
VERSIONS = ("HTTP/0.9", "HTTP/1.0", "HTTP/1.1", "HTTP/2.0")
HTTP09 = "HTTP/0.9"
_HEX = frozenset("0123456789abcdefABCDEF")
_DIGITS = b"0123456789"


class ParseError(Exception):
    """A request the JAX front's parser refuses: ``body()`` is aiohttp's
    400 text, the reason, the offending line and a caret under the byte
    at ``pos``."""

    def __init__(self, reason: str, line: bytes, pos: int):
        super().__init__(reason)
        self.reason, self.line, self.pos = reason, line, pos

    def body(self) -> bytes:
        pointer = " " * (len(repr(self.line[:self.pos])) - 1) + "^"
        return f"{self.reason}:\n\n  {self.line!r}\n  {pointer}".encode()


def _method_end(line: bytes) -> int:
    """Where the method ends (the space after it), or ``ParseError`` as
    llhttp's method table answers: a name that leaves every method, or a
    known method not followed by a space."""
    text = line.decode("latin-1")
    known = [m for m in METHODS if text.startswith(m)]
    if known:
        end = max(len(m) for m in known)
        if line[end:end + 1] == b" ":
            return end
        raise ParseError("Expected space after method", line, end)
    pos = 0
    for name in (*METHODS, *_OTHER_METHODS):
        n = 0
        while n < min(len(name), len(text)) and name[n] == text[n]:
            n += 1
        pos = max(pos, n)
    raise ParseError("Invalid method encountered", line, pos)


def _check_target(line: bytes, start: int, target: bytes) -> None:
    """llhttp's checks of the request target's bytes."""
    first = target[:1]
    if not (first in (b"/", b"*") or first.isalpha()):
        raise ParseError("Unexpected start char in url", line, start)
    section = "path"
    for i, byte in enumerate(target):
        if byte == 0x3F and section == "path":  # '?'
            section = "query"
        elif byte == 0x23 and section != "fragment start":  # '#'
            section = "fragment start"
        elif byte == 0x09:
            raise ParseError("Invalid characters in url", line, start + i + 1)
        elif byte < 0x21 or byte > 0x7E:
            raise ParseError(f"Invalid char in url {section}", line, start + i)


def _check_version(line: bytes, vstart: int, version: bytes) -> None:
    """llhttp's checks of ``HTTP/<digit>.<digit>`` and the line's end."""
    if not version.startswith(b"HTTP/"):
        raise ParseError("Expected HTTP/, RTSP/ or ICE/", line, vstart)
    if version[5:6] not in [bytes([d]) for d in _DIGITS]:
        raise ParseError("Invalid major version", line, vstart + 5)
    if version[6:7] != b".":
        raise ParseError("Expected dot", line, vstart + 6)
    if version[7:8] not in [bytes([d]) for d in _DIGITS]:
        raise ParseError("Invalid minor version", line, vstart + 7)
    if version[:8].decode("ascii") not in VERSIONS:
        raise ParseError("Invalid HTTP version", line, vstart + 8)
    if len(version) > 8:
        raise ParseError("Expected CRLF after version", line, vstart + 8)


def parse_request_line(line: bytes) -> Tuple[str, str, str]:
    """(method, target, version) of one request line (CRLF stripped), or
    ``ParseError`` where llhttp refuses it."""
    end = _method_end(line)
    start = end + 1
    while line[start:start + 1] == b" ":
        start += 1
    target, _, rest = line[start:].partition(b" ")
    _check_target(line, start, target)
    vstart = start + len(target) + 1
    while rest.startswith(b" "):
        rest, vstart = rest[1:], vstart + 1
    if rest:
        _check_version(line, vstart, rest)
    return line[:end].decode("ascii"), target.decode("ascii"), (rest.decode("ascii")
                                                                  or HTTP09)


def split_target(target: str) -> Tuple[str, str]:
    """(raw path, raw query) of a request target, split as aiohttp's
    parser splits an origin-form target (its fragment dropped)."""
    if len(target) > 1 and target[0] == "/":
        i = target.find("?")
        if i == -1:
            return target.partition("#")[0], ""
        j = target.find("#", i + 2)
        return target[:i], target[i + 1:] if j == -1 else target[i + 1:j]
    parts = urlsplit(target)
    return parts.path or "/", parts.query


def unquote(value: str, keep: str = "", plus: bool = False) -> str:
    """yarl's percent-decoding. Consecutive escapes decode as UTF-8; an
    escape that cannot join a valid sequence stays as written. A decoded
    character in ``keep`` is re-escaped (upper-case hex); ``plus`` turns a
    literal ``+`` into a space."""
    if "%" not in value and not (plus and "+" in value):
        return value
    decoder = codecs.getincrementaldecoder("utf-8")()
    out: List[str] = []
    pending = ""  # the escapes the decoder holds, as written
    i, n = 0, len(value)
    while i < n:
        ch = value[i]
        if ch == "%" and i + 3 <= n and value[i + 1] in _HEX and value[i + 2] in _HEX:
            esc = value[i:i + 3]
            byte = bytes([int(esc[1:], 16)])
            i += 3
            try:
                text = decoder.decode(byte)
            except UnicodeDecodeError:
                out.append(pending)
                pending = ""
                decoder.reset()
                try:
                    text = decoder.decode(byte)
                except UnicodeDecodeError:
                    decoder.reset()
                    out.append(esc)
                    continue
            if not text:
                pending += esc
                continue
            pending = ""
            out.append(f"%{ord(text):02X}" if text in keep else text)
            continue
        if pending:
            out.append(pending)
            pending = ""
            decoder.reset()
        out.append(" " if plus and ch == "+" else ch)
        i += 1
    out.append(pending)
    return "".join(out)


def path_of(raw_path: str) -> str:
    """aiohttp's ``request.path``: every escape decoded."""
    return unquote(raw_path)


def path_safe(raw_path: str) -> str:
    """What aiohttp's router matches: the path decoded with ``%2F`` and
    ``%25`` kept."""
    return unquote(raw_path, keep="/%")


def unquote_group(value: str) -> str:
    """A captured route group, as aiohttp's ``match_info`` holds it."""
    if "%" not in value:
        return value
    return value.replace("%2F", "/").replace("%25", "%")


def match_groups(pattern, safe: str) -> Optional[Tuple[str, ...]]:
    """The decoded groups of ``pattern`` over a ``path_safe`` path, or
    None."""
    m = pattern.match(safe)
    if m is None:
        return None
    return tuple(unquote_group(g) for g in m.groups())


def query_pairs(raw_query: str) -> List[Tuple[str, str]]:
    """yarl's query pairs: every ``&`` segment, blank ones included, with
    ``+`` as a space."""
    if not raw_query:
        return []
    pairs = []
    for item in raw_query.split("&"):
        k, _, v = item.partition("=")
        pairs.append((unquote(k, plus=True), unquote(v, plus=True)))
    return pairs
