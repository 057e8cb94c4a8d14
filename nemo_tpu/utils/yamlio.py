"""Reader and writer for the YAML subset that Nemo configs use.

Covers block and flow mappings and sequences (including sequences
written at their parent key's indentation, as PyYAML emits them),
plain scalars resolved by the YAML 1.1 rules PyYAML applies (int,
float, bool, null; everything else a string), single- and
double-quoted strings, plain scalars continued on more-indented lines,
and comments.  Anchors, aliases, tags and block scalars (``|``, ``>``)
are not part of the subset and raise ``ValueError``.

``load`` of a config gives the same object ``yaml.safe_load`` gives;
``dump`` writes block-style text that both read back unchanged.
"""

import math
import re

_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                           "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False",
                                 "FALSE", "off", "Off", "OFF")})
_NULL = ("", "~", "null", "Null", "NULL")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(text, conv):
    value = 0
    for part in text.split(":"):
        value = value * 60 + conv(part)
    return value


def resolve(text):
    """A plain scalar's value under PyYAML's YAML 1.1 resolvers."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    return text


# -----------------------------------------------------------------------------
# Reading

def _fail(msg, text):
    raise ValueError("YAML subset: %s in %r" % (msg, text[:60]))


def _scan_quoted(s, i):
    """End index (exclusive) of the quoted scalar starting at s[i], or -1
    if it is not closed within s."""
    q = s[i]
    j = i + 1
    while j < len(s):
        c = s[j]
        if q == "'" and c == "'":
            if j + 1 < len(s) and s[j + 1] == "'":
                j += 2
                continue
            return j + 1
        if q == '"' and c == "\\":
            j += 2
            continue
        if q == '"' and c == '"':
            return j + 1
        j += 1
    return -1


def _fold(raw):
    """Line folding inside a quoted scalar: a single line break becomes a
    space, n+1 breaks become n newlines; leading and trailing white space
    of each line goes."""
    lines = raw.split("\n")
    if len(lines) == 1:
        return raw
    out = lines[0].rstrip(" \t")
    blanks = 0
    for line in lines[1:]:
        line = line.strip(" \t")
        if not line:
            blanks += 1
            continue
        out += ("\n" * blanks) if blanks else " "
        out += line
        blanks = 0
    return out + "\n" * blanks


def _unquote(tok):
    q, body = tok[0], tok[1:-1]
    if q == "'":
        return _fold(body).replace("''", "'")
    out = []
    i = 0
    # Fold first, protecting escaped line breaks
    body = re.sub(r"\\\n[ \t]*", "\x00ESC_NL\x00", body)
    body = _fold(body).replace("\x00ESC_NL\x00", "")
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        e = body[i + 1]
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            i += 2
        elif e in _HEX_ESCAPES:
            n = _HEX_ESCAPES[e]
            out.append(chr(int(body[i + 2:i + 2 + n], 16)))
            i += 2 + n
        else:
            _fail("unknown escape \\%s" % e, tok)
    return "".join(out)


def _strip_comment(s):
    """Drop a trailing comment (a '#' at the start or after white space,
    outside quotes).  Quotes are only tracked where a scalar can start."""
    i = 0
    while i < len(s):
        c = s[i]
        if c in "'\"" and (i == 0 or s[i - 1] in " \t[{,:-"):
            j = _scan_quoted(s, i)
            if j < 0:
                return s
            i = j
            continue
        if c == "#" and (i == 0 or s[i - 1] in " \t"):
            return s[:i].rstrip()
        i += 1
    return s.rstrip()


def _open_state(s):
    """(flow bracket depth, inside an unclosed quote) at the end of s."""
    depth = 0
    i = 0
    while i < len(s):
        c = s[i]
        if c in "'\"" and (i == 0 or s[i - 1] in " \t[{,:-"):
            j = _scan_quoted(s, i)
            if j < 0:
                return depth, True
            i = j
            continue
        if c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        i += 1
    return depth, False


class _Flow:
    """Recursive-descent parser for one flow value (which may also be a
    plain or quoted scalar)."""

    def __init__(self, s):
        self.s = s
        self.i = 0

    def ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t\n":
            self.i += 1

    def peek(self):
        self.ws()
        return self.s[self.i] if self.i < len(self.s) else ""

    def value(self, in_flow):
        c = self.peek()
        if c == "[":
            self.i += 1
            out = []
            while self.peek() != "]":
                out.append(self.entry_value())
                if self.peek() == ",":
                    self.i += 1
                elif self.peek() != "]":
                    _fail("expected ',' or ']'", self.s[self.i:])
            self.i += 1
            return out
        if c == "{":
            self.i += 1
            out = {}
            while self.peek() != "}":
                key = self.scalar(in_flow=True)
                if self.peek() == ":":
                    self.i += 1
                    val = None if self.peek() in ",}" else \
                        self.value(in_flow=True)
                else:
                    val = None
                out[key] = val
                if self.peek() == ",":
                    self.i += 1
                elif self.peek() != "}":
                    _fail("expected ',' or '}'", self.s[self.i:])
            self.i += 1
            return out
        return self.scalar(in_flow)

    def entry_value(self):
        """A flow-sequence entry; 'k: v' there is a one-pair mapping."""
        v = self.value(in_flow=True)
        if self.peek() == ":" and not isinstance(v, (list, dict)):
            self.i += 1
            return {v: None if self.peek() in ",]" else
                    self.value(in_flow=True)}
        return v

    def scalar(self, in_flow):
        c = self.peek()
        if c in "&*!|>":
            _fail("anchors, aliases, tags and block scalars are not "
                  "supported", self.s[self.i:])
        if c in "'\"":
            j = _scan_quoted(self.s, self.i)
            if j < 0:
                _fail("unclosed quote", self.s[self.i:])
            tok = self.s[self.i:j]
            self.i = j
            return _unquote(tok)
        start = self.i
        while self.i < len(self.s):
            ch = self.s[self.i]
            nxt = self.s[self.i + 1] if self.i + 1 < len(self.s) else " "
            if in_flow and ch in ",[]{}":
                break
            if ch == ":" and (nxt in " \t\n" or (in_flow and nxt in ",]}")):
                break
            self.i += 1
        return resolve(_fold(self.s[start:self.i]).strip())


def _parse_inline(text):
    """A value written on one logical line (flow collection or scalar)."""
    p = _Flow(text)
    v = p.value(in_flow=False)
    if p.peek():
        _fail("trailing text", text[p.i:])
    return v


def _split_key(text):
    """(key, rest) if text is a block mapping entry, else None."""
    p = _Flow(text)
    c = p.peek()
    if c in "[{":
        return None
    if c in "'\"":
        j = _scan_quoted(text, p.i)
        if j < 0:
            return None
        k = j
        while k < len(text) and text[k] in " \t":
            k += 1
        if k < len(text) and text[k] == ":" and \
                (k + 1 == len(text) or text[k + 1] in " \t"):
            return _unquote(text[p.i:j]), text[k + 1:].strip()
        return None
    m = re.search(r":(?:[ \t]|$)", text)
    if not m:
        return None
    return resolve(text[:m.start()].strip()), text[m.end():].strip()


class _Block:
    def __init__(self, text):
        self.lines = []           # [indent, content]
        pending = None
        for raw in text.replace("\r\n", "\n").split("\n"):
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                _fail("tab indentation", raw)
            if pending is not None:
                # continue an open flow collection or quoted scalar
                inq = _open_state(pending[1])[1]
                pending[1] += "\n" + (raw if inq else _strip_comment(raw))
                depth, inq = _open_state(pending[1])
                if depth <= 0 and not inq:
                    self.lines.append(pending)
                    pending = None
                continue
            body = _strip_comment(raw)
            if not body.strip() or body.strip() in ("---", "..."):
                continue
            if body.lstrip().startswith("%"):
                _fail("directives are not supported", body)
            entry = [len(body) - len(body.lstrip(" ")), body.strip()]
            depth, inq = _open_state(entry[1])
            if depth > 0 or inq:
                pending = entry
            else:
                self.lines.append(entry)
        if pending is not None:
            _fail("unclosed flow collection or quote", pending[1])
        self.i = 0

    def node(self, indent):
        """Parse the block node whose lines start at column ``indent``."""
        if self.i >= len(self.lines):
            return None
        text = self.lines[self.i][1]
        if text == "-" or text.startswith("- "):
            return self.sequence(indent)
        if _split_key(text) is not None:
            return self.mapping(indent)
        self.i += 1
        return self.continued(_parse_inline(text), text, indent - 1)

    def continued(self, value, text, parent_indent):
        """Fold more-indented continuation lines into a plain scalar."""
        if text[:1] in "[{'\"" or isinstance(value, (list, dict)):
            return value
        parts = [text]
        while self.i < len(self.lines) and \
                self.lines[self.i][0] > parent_indent:
            parts.append(self.lines[self.i][1])
            self.i += 1
        if len(parts) == 1:
            return value
        return resolve(" ".join(parts))

    def child(self, indent, allow_seq_at_indent):
        """The value node after a 'key:' or '-' with nothing after it."""
        if self.i >= len(self.lines):
            return None
        ind, text = self.lines[self.i]
        if ind > indent:
            return self.node(ind)
        if allow_seq_at_indent and ind == indent and \
                (text == "-" or text.startswith("- ")):
            return self.sequence(indent)
        return None

    def mapping(self, indent):
        out = {}
        while self.i < len(self.lines):
            ind, text = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                _fail("bad indentation", text)
            kv = _split_key(text)
            if kv is None:
                break
            key, rest = kv
            self.i += 1
            if rest:
                out[key] = self.continued(_parse_inline(rest), rest, indent)
            else:
                out[key] = self.child(indent, allow_seq_at_indent=True)
        return out

    def sequence(self, indent):
        out = []
        while self.i < len(self.lines):
            ind, text = self.lines[self.i]
            if ind != indent or not (text == "-" or text.startswith("- ")):
                if ind > indent:
                    _fail("bad indentation", text)
                break
            rest = text[1:].lstrip(" ")
            if not rest:
                self.i += 1
                out.append(self.child(indent, allow_seq_at_indent=False))
                continue
            # the item's content starts a node at its own column
            col = indent + len(text) - len(rest)
            self.lines[self.i] = [col, rest]
            out.append(self.node(col))
        return out


def load(stream):
    """Parse YAML text (or a readable stream) into Python objects."""
    text = stream.read() if hasattr(stream, "read") else stream
    block = _Block(text)
    if not block.lines:
        return None
    value = block.node(block.lines[0][0])
    if block.i != len(block.lines):
        _fail("unexpected content", block.lines[block.i][1])
    return value


# -----------------------------------------------------------------------------
# Writing

_PLAIN_BAD_START = set("-?:,[]{}#&*!|>'\"%@` \t")


def _scalar(v):
    if hasattr(v, "item") and not isinstance(v, (list, dict)):
        v = v.item()            # numpy scalar
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (math.inf, -math.inf):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v).lower()
        if "." not in r and "e" in r:
            r = r.replace("e", ".0e", 1)
        return r
    if not isinstance(v, str):
        raise TypeError("cannot write %r as YAML" % type(v))
    plain = (v and v[0] not in _PLAIN_BAD_START and v[-1] not in " \t"
             and ": " not in v and " #" not in v and not v.endswith(":")
             and not any(c in v for c in "[]{}")
             and v.isprintable() and resolve(v) == v
             and isinstance(resolve(v), str))
    if plain:
        return v
    if v.isprintable():
        return "'" + v.replace("'", "''") + "'"
    out = []
    for c in v:
        if c in '"\\':
            out.append("\\" + c)
        elif c == "\n":
            out.append("\\n")
        elif c == "\t":
            out.append("\\t")
        elif not c.isprintable():
            out.append("\\u%04x" % ord(c))
        else:
            out.append(c)
    return '"' + "".join(out) + '"'


def _lines(v, indent):
    pad = " " * indent
    if isinstance(v, dict):
        if not v:
            return None
        out = []
        for k, val in v.items():
            head = pad + _scalar(k) + ":"
            sub = _lines(val, indent + 2)
            if sub is None:
                out.append(head + " " + _inline(val))
            else:
                out.append(head)
                out.extend(sub)
        return out
    if isinstance(v, (list, tuple)):
        if not v:
            return None
        out = []
        for item in v:
            sub = _lines(item, indent + 2)
            if sub is None:
                out.append(pad + "- " + _inline(item))
            else:
                # first line of the nested node shares the '- ' line
                out.append(pad + "- " + sub[0][indent + 2:])
                out.extend(sub[1:])
        return out
    return None


def _inline(v):
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _scalar(v)


def dump(data):
    """Block-style YAML text for nested dicts, lists and scalars."""
    sub = _lines(data, 0)
    if sub is None:
        return _inline(data) + "\n"
    return "\n".join(sub) + "\n"
