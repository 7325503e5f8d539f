"""Grammar-constrained decoding: regex / JSON-schema -> token-mask automaton
(counterpart of ``mxnet_tpu/serve/grammar.py``).

A grammar is compiled ONCE into an alphabet-compressed DFA over the
tokenizer's vocabulary; from then on constraining a decode step costs two
int32 gathers on the tables' device, with no host round trip.

Host side (numpy and Python, as in the JAX package, line for line):

1. **Regex subset** (literals, classes ``[a-z]`` / ``[^..]``, ``.``,
   ``*`` ``+`` ``?`` ``{m}`` ``{m,n}`` ``{m,}``, ``|``, non-capturing
   groups, the usual escapes) parses to a range-labelled AST; JSON
   schemas (object/properties, array/items, string, integer, number,
   boolean, null, enum/const) lower to a canonical anchored regex first
   (:func:`schema_regex`).
2. **Thompson NFA** over character *ranges*.
3. **Alphabet compression**: every range boundary splits the codepoint
   space into segments, and the subset construction runs over segments.
4. **Subset-construction DFA**, capped at ``max_states`` (default
   :data:`GRAMMAR_MAX_STATES`, the JAX knob ``serve_grammar_max_states``'s
   default), then trimmed to coaccessible states: every reachable state
   can still reach an accept.
5. **Token automaton**: the DFA runs over every token's string (default
   token table ``chr(id)``), and tokens with equal state columns become
   one *token class*: the tables are ``cls [V] -> class`` and
   ``nxt [states, classes] -> state | -1``.

Device side: :func:`grammar_mask`, :func:`grammar_mask_multi` and
:func:`grammar_advance` are torch gathers on the tables' device. They take
int32 tables and return bool or int32, so they are the JAX functions' bits
on any device, and they never read a tensor back to the host, so a
CUDA-graph capture can hold them.

Compiled automata are cached content-addressed: an in-memory LRU of
:data:`GRAMMAR_MASK_CACHE` entries (the JAX knob ``serve_grammar_mask_cache``'s
default) and, when ``MXNET_GRAMMAR_CACHE_DIR`` is set, an on-disk layer
with the JAX package's key (:func:`grammar_key`), file format, payload hash
and eviction of a corrupt entry, so an entry written by either package is
read by the other.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import time
import warnings
from bisect import bisect_right
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as onp
import torch

from .. import metrics as _metrics
from ..base import MXNetError

__all__ = ["TokenGrammar", "compile_grammar", "schema_regex",
           "grammar_mask", "grammar_mask_multi", "grammar_advance",
           "identity_tables", "clear_grammar_cache", "GRAMMAR_MAX_STATES",
           "GRAMMAR_MASK_CACHE"]

#: default automaton state and token-class cap (the JAX knob
#: ``serve_grammar_max_states``'s default): the engine's per-slot tables
#: are [GRAMMAR_MAX_STATES, GRAMMAR_MAX_STATES]
GRAMMAR_MAX_STATES = 64
#: entries of the in-memory automaton cache (the JAX knob
#: ``serve_grammar_mask_cache``'s default)
GRAMMAR_MASK_CACHE = 64

_MAX_CHAR = 0x10FFFF

# ------------------------------------------------------------------ regex AST

_ESCAPES: Dict[str, List[Tuple[int, int]]] = {
    "d": [(0x30, 0x39)],
    "w": [(0x30, 0x39), (0x41, 0x5A), (0x5F, 0x5F), (0x61, 0x7A)],
    "s": [(0x09, 0x0D), (0x20, 0x20)],
    "n": [(0x0A, 0x0A)], "t": [(0x09, 0x09)], "r": [(0x0D, 0x0D)],
    "f": [(0x0C, 0x0C)], "v": [(0x0B, 0x0B)], "0": [(0x00, 0x00)],
}


def _normalize(ranges: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for lo, hi in sorted(ranges):
        if out and lo <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _complement(ranges: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    cur = 0
    for lo, hi in _normalize(ranges):
        if lo > cur:
            out.append((cur, lo - 1))
        cur = max(cur, hi + 1)
    if cur <= _MAX_CHAR:
        out.append((cur, _MAX_CHAR))
    return out


class _Parser:
    """Recursive-descent parser for the supported regex subset."""

    def __init__(self, src: str):
        self.src = src
        self.i = 0

    def _err(self, msg: str):
        raise MXNetError(f"grammar regex: {msg} at offset {self.i} in "
                         f"{self.src!r}")

    def peek(self) -> Optional[str]:
        return self.src[self.i] if self.i < len(self.src) else None

    def take(self) -> str:
        if self.i >= len(self.src):
            self._err("unexpected end of pattern")
        ch = self.src[self.i]
        self.i += 1
        return ch

    def parse(self):
        node = self.alt()
        if self.i != len(self.src):
            self._err(f"unexpected {self.src[self.i]!r}")
        return node

    def alt(self):
        branches = [self.cat()]
        while self.peek() == "|":
            self.take()
            branches.append(self.cat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def cat(self):
        parts = []
        while self.peek() not in (None, "|", ")"):
            parts.append(self.rep())
        if not parts:
            return ("eps",)
        return parts[0] if len(parts) == 1 else ("cat", parts)

    def rep(self):
        node = self.atom()
        while True:
            ch = self.peek()
            if ch == "*":
                self.take()
                node = ("rep", node, 0, None)
            elif ch == "+":
                self.take()
                node = ("rep", node, 1, None)
            elif ch == "?":
                self.take()
                node = ("rep", node, 0, 1)
            elif ch == "{":
                bounds = self._braces()
                if bounds is None:
                    break           # literal '{' — handled by atom later
                node = ("rep", node, bounds[0], bounds[1])
            else:
                break
        return node

    def _braces(self) -> Optional[Tuple[int, Optional[int]]]:
        j = self.src.find("}", self.i)
        if j < 0:
            return None
        body = self.src[self.i + 1:j]
        parts = body.split(",")
        if not all(p == "" or p.isdigit() for p in parts) \
                or len(parts) > 2 or not parts[0]:
            return None             # not a quantifier: '{' stays literal
        lo = int(parts[0])
        hi: Optional[int]
        if len(parts) == 1:
            hi = lo
        else:
            hi = int(parts[1]) if parts[1] else None
        if hi is not None and hi < lo:
            self._err(f"bad quantifier {{{body}}}")
        self.i = j + 1
        return lo, hi

    def atom(self):
        ch = self.take()
        if ch == "(":
            if self.peek() == "?":
                self.take()
                if self.take() != ":":
                    self._err("only non-capturing groups (?:...) are "
                              "supported")
            node = self.alt()
            if self.peek() != ")":
                self._err("unbalanced '('")
            self.take()
            return node
        if ch == "[":
            return ("lit", self.char_class())
        if ch == ".":
            return ("lit", [(0, _MAX_CHAR)])
        if ch == "\\":
            return ("lit", self.escape())
        if ch in ")*+?":
            self._err(f"dangling {ch!r}")
        return ("lit", [(ord(ch), ord(ch))])

    def escape(self) -> List[Tuple[int, int]]:
        ch = self.take()
        if ch in _ESCAPES:
            return list(_ESCAPES[ch])
        if ch in "DWS":
            return _complement(_ESCAPES[ch.lower()])
        if ch == "x":
            code = int(self.take() + self.take(), 16)
            return [(code, code)]
        if ch == "u":
            code = int("".join(self.take() for _ in range(4)), 16)
            return [(code, code)]
        return [(ord(ch), ord(ch))]

    def char_class(self) -> List[Tuple[int, int]]:
        neg = False
        if self.peek() == "^":
            self.take()
            neg = True
        ranges: List[Tuple[int, int]] = []
        first = True
        while True:
            ch = self.peek()
            if ch is None:
                self._err("unterminated character class")
            if ch == "]" and not first:
                self.take()
                break
            first = False
            if ch == "\\":
                self.take()
                ranges.extend(self.escape())
                continue
            self.take()
            lo = ord(ch)
            if (self.peek() == "-"
                    and self.src[self.i + 1:self.i + 2] not in ("", "]")):
                self.take()
                hi_ch = self.take()
                if hi_ch == "\\":
                    hi_r = self.escape()
                    if len(hi_r) != 1 or hi_r[0][0] != hi_r[0][1]:
                        self._err("class range endpoint must be a single "
                                  "character")
                    hi = hi_r[0][0]
                else:
                    hi = ord(hi_ch)
                if hi < lo:
                    self._err(f"reversed class range "
                              f"{chr(lo)!r}-{chr(hi)!r}")
                ranges.append((lo, hi))
            else:
                ranges.append((lo, lo))
        return _complement(ranges) if neg else _normalize(ranges)


# ------------------------------------------------------------- NFA -> DFA

class _NFA:
    def __init__(self):
        self.eps: List[List[int]] = []
        self.edges: List[List[Tuple[List[Tuple[int, int]], int]]] = []

    def new(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1


def _thompson(nfa: _NFA, node) -> Tuple[int, int]:
    kind = node[0]
    if kind == "eps":
        s = nfa.new()
        return s, s
    if kind == "lit":
        s, e = nfa.new(), nfa.new()
        nfa.edges[s].append((node[1], e))
        return s, e
    if kind == "cat":
        start = cur = nfa.new()
        for part in node[1]:
            s, e = _thompson(nfa, part)
            nfa.eps[cur].append(s)
            cur = e
        return start, cur
    if kind == "alt":
        s, e = nfa.new(), nfa.new()
        for branch in node[1]:
            bs, be = _thompson(nfa, branch)
            nfa.eps[s].append(bs)
            nfa.eps[be].append(e)
        return s, e
    if kind == "rep":
        _, sub, lo, hi = node
        start = cur = nfa.new()
        for _ in range(lo):
            s, e = _thompson(nfa, sub)
            nfa.eps[cur].append(s)
            cur = e
        if hi is None:
            q = nfa.new()
            nfa.eps[cur].append(q)
            s, e = _thompson(nfa, sub)
            nfa.eps[q].append(s)
            nfa.eps[e].append(q)
            cur = q
        else:
            for _ in range(hi - lo):
                s, e = _thompson(nfa, sub)
                q = nfa.new()
                nfa.eps[cur].append(s)
                nfa.eps[cur].append(q)     # skip this optional copy
                nfa.eps[e].append(q)
                cur = q
        return start, cur
    raise MXNetError(f"grammar: unknown AST node {kind!r}")


def _closure(nfa: _NFA, states) -> frozenset:
    seen = set(states)
    stack = list(states)
    while stack:
        for t in nfa.eps[stack.pop()]:
            if t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


def _regex_to_dfa(regex: str, max_states: int):
    """Parse + determinize. Returns ``(trans [N, nseg] int32, accept [N]
    bool, points)`` where ``points`` are the compressed-alphabet segment
    boundaries (``seg_of(c) = bisect_right(points, c) - 1``)."""
    ast = _Parser(regex).parse()
    nfa = _NFA()
    start, accept = _thompson(nfa, ast)

    pts = {0, _MAX_CHAR + 1}
    for edges in nfa.edges:
        for ranges, _t in edges:
            for lo, hi in ranges:
                pts.add(lo)
                pts.add(hi + 1)
    points = sorted(pts)
    nseg = len(points) - 1

    start_set = _closure(nfa, [start])
    index = {start_set: 0}
    rows: List[List[int]] = []
    acc: List[bool] = []
    work = [start_set]
    while work:
        cur = work.pop()
        i = index[cur]
        while len(rows) <= i:
            rows.append([])
            acc.append(False)
        acc[i] = accept in cur
        row = []
        for k in range(nseg):
            rep = points[k]
            nxt = set()
            for s in cur:
                for ranges, t in nfa.edges[s]:
                    if any(lo <= rep <= hi for lo, hi in ranges):
                        nxt.add(t)
            if not nxt:
                row.append(-1)
                continue
            tgt = _closure(nfa, nxt)
            j = index.get(tgt)
            if j is None:
                j = len(index)
                if j >= max_states:
                    raise MXNetError(
                        f"grammar automaton exceeds max_states="
                        f"{max_states}; simplify the grammar or raise "
                        "the serve_grammar_max_states knob")
                index[tgt] = j
                work.append(tgt)
            row.append(j)
        rows[i] = row

    trans = onp.asarray(rows, onp.int32).reshape(len(rows), nseg)
    accept_v = onp.asarray(acc, bool)

    # coaccessible trim: every surviving state can still reach accept,
    # so a constrained decode can never be steered into a dead end
    n = len(rows)
    rev: List[List[int]] = [[] for _ in range(n)]
    for i in range(n):
        for j in trans[i]:
            if j >= 0:
                rev[int(j)].append(i)
    keep = set(int(i) for i in onp.nonzero(accept_v)[0])
    stack = list(keep)
    while stack:
        for p in rev[stack.pop()]:
            if p not in keep:
                keep.add(p)
                stack.append(p)
    if 0 not in keep:
        raise MXNetError("grammar matches no string (empty language)")
    remap = {old: new for new, old in enumerate(sorted(keep))}
    trimmed = onp.full((len(keep), nseg), -1, onp.int32)
    for old, new in remap.items():
        for k in range(nseg):
            j = int(trans[old, k])
            trimmed[new, k] = remap.get(j, -1) if j >= 0 else -1
    return trimmed, accept_v[sorted(keep)], points


# ------------------------------------------------------------ token automaton

class TokenGrammar:
    """A compiled token-level grammar automaton.

    ``cls [V]`` maps token id -> token class; ``nxt [n_states,
    n_classes]`` maps (state, class) -> next state, ``-1`` = forbidden;
    ``accept [n_states]`` marks states where the string so far is a
    complete match (EOS becomes legal there). State 0 is the start.
    """

    def __init__(self, cls: onp.ndarray, nxt: onp.ndarray,
                 accept: onp.ndarray, vocab: int, key: str, source: str):
        self.cls = onp.asarray(cls, onp.int32)
        self.nxt = onp.asarray(nxt, onp.int32)
        self.accept = onp.asarray(accept, bool)
        self.vocab = int(vocab)
        self.key = key
        self.source = source
        self.n_states = int(self.nxt.shape[0])
        self.n_classes = int(self.nxt.shape[1])
        # per-state: does ANY vocab token continue the match? (states
        # where only EOS is legal fail this — the completion signal)
        self._live = (self.nxt >= 0).any(axis=1)

    # ------------------------------------------------------------- host side
    def advance(self, state: int, tok: int) -> int:
        """Next state after emitting ``tok`` (-1 = the grammar forbids
        it)."""
        if state < 0 or state >= self.n_states:
            return -1
        if tok < 0 or tok >= self.vocab:
            return -1
        return int(self.nxt[state, self.cls[tok]])

    def allowed(self, state: int) -> onp.ndarray:
        """Bool ``[V]`` mask of tokens legal in ``state`` (EOS excluded —
        callers add it when ``is_accept``)."""
        if state < 0 or state >= self.n_states:
            return onp.zeros(self.vocab, bool)
        return self.nxt[state][self.cls] >= 0

    def is_accept(self, state: int) -> bool:
        return 0 <= state < self.n_states and bool(self.accept[state])

    def has_live_token(self, state: int) -> bool:
        """True if any vocab token continues from ``state``."""
        return 0 <= state < self.n_states and bool(self._live[state])

    def first_allowed(self, state: int) -> int:
        """Lowest legal token id in ``state`` (-1 when only EOS is)."""
        if not self.has_live_token(state):
            return -1
        return int(onp.argmax(self.allowed(state)))

    def matches(self, tokens: Sequence[int],
                eos_token_id: Optional[int] = None) -> bool:
        """Does the (EOS-stripped) token sequence form a complete
        match?"""
        toks = list(tokens)
        if eos_token_id is not None and toks and toks[-1] == eos_token_id:
            toks = toks[:-1]
        q = 0
        for t in toks:
            q = self.advance(q, int(t))
            if q < 0:
                return False
        return self.is_accept(q)

    # ----------------------------------------------------------- device side
    def padded_tables(self, nmax: int, cmax: int
                      ) -> Tuple[onp.ndarray, onp.ndarray, onp.ndarray]:
        """``(cls [V], nxt [nmax, cmax], accept [nmax])`` padded with
        forbidden transitions — the fixed-shape per-slot rows the engine
        carries as data (one aval for every grammar, the zero-recompile
        contract)."""
        if self.n_states > nmax or self.n_classes > cmax:
            raise MXNetError(
                f"grammar ({self.n_states} states, {self.n_classes} "
                f"token classes) exceeds the engine's table shape "
                f"[{nmax}, {cmax}] (serve_grammar_max_states)")
        nxt = onp.full((nmax, cmax), -1, onp.int32)
        nxt[:self.n_states, :self.n_classes] = self.nxt
        acc = onp.zeros(nmax, bool)
        acc[:self.n_states] = self.accept
        return self.cls, nxt, acc

    @classmethod
    def identity(cls, vocab: int) -> "TokenGrammar":
        """The all-allowing grammar (unconstrained slots in a mixed
        batch): one state, one class, every token self-loops, always
        accepting."""
        return cls(onp.zeros(vocab, onp.int32),
                   onp.zeros((1, 1), onp.int32),
                   onp.ones(1, bool), vocab, key="identity",
                   source="identity")


def identity_tables(vocab: int, nmax: int, cmax: int):
    """Padded identity tables (see :meth:`TokenGrammar.identity`)."""
    return TokenGrammar.identity(vocab).padded_tables(nmax, cmax)


def _token_columns(trans: onp.ndarray, points: List[int],
                   tokens: Sequence[str]) -> onp.ndarray:
    """Run the char DFA over every token string, vectorized over states:
    column ``t`` is the state-to-state map of emitting token ``t``
    (``-1`` = forbidden from that state). Shape ``[n_states, V]``."""
    n = trans.shape[0]
    ident = onp.arange(n, dtype=onp.int32)
    cols = onp.empty((n, len(tokens)), onp.int32)
    for t, s in enumerate(tokens):
        col = ident
        for ch in s:
            seg = bisect_right(points, ord(ch)) - 1
            step = trans[:, seg]
            col = onp.where(col >= 0, step[onp.clip(col, 0, None)],
                            onp.int32(-1))
        cols[:, t] = col
    return cols


def _build_token_grammar(regex: str, vocab: int,
                         token_table: Optional[Sequence[str]],
                         max_states: int, key: str) -> TokenGrammar:
    trans, accept, points = _regex_to_dfa(regex, max_states)
    tokens = (token_table if token_table is not None
              else [chr(t) for t in range(vocab)])
    if len(tokens) != vocab:
        raise MXNetError(
            f"token_table has {len(tokens)} entries for vocab={vocab}")
    cols = _token_columns(trans, points, tokens)
    # token-class compression: tokens with identical state columns are
    # one class — the device table shrinks from [N, V] to [N, C]
    classes: Dict[bytes, int] = {}
    cls = onp.empty(vocab, onp.int32)
    class_cols: List[onp.ndarray] = []
    for t in range(vocab):
        sig = cols[:, t].tobytes()
        c = classes.get(sig)
        if c is None:
            c = len(classes)
            classes[sig] = c
            class_cols.append(cols[:, t])
        cls[t] = c
    if len(class_cols) > max_states:
        raise MXNetError(
            f"grammar needs {len(class_cols)} token classes, over the "
            f"serve_grammar_max_states={max_states} table cap; raise "
            "the knob or coarsen the grammar")
    nxt = onp.stack(class_cols, axis=1)
    return TokenGrammar(cls, nxt, accept, vocab, key=key, source=regex)


# ------------------------------------------------------------ schema -> regex

_REGEX_SPECIALS = set("\\^$.|?*+()[]{}")


def _rx_escape(text: str) -> str:
    return "".join("\\" + c if c in _REGEX_SPECIALS else c for c in text)


def _json_literal_regex(value: Any) -> str:
    return _rx_escape(json.dumps(value, separators=(",", ":"),
                                 sort_keys=True))


def schema_regex(schema: Dict[str, Any]) -> str:
    """Lower a restricted JSON-schema subset to the canonical anchored
    regex the automaton compiles: objects emit every declared property
    (declaration order, compact separators — the canonical serialization
    constrained generation produces), arrays honor min/maxItems, strings
    honor pattern/enum/min-maxLength."""
    if not isinstance(schema, dict):
        raise MXNetError(f"schema must be a dict, got {type(schema)}")
    if "enum" in schema:
        return "(?:" + "|".join(_json_literal_regex(v)
                                for v in schema["enum"]) + ")"
    if "const" in schema:
        return _json_literal_regex(schema["const"])
    typ = schema.get("type")
    if typ == "string":
        if "pattern" in schema:
            return '"(?:' + schema["pattern"] + ')"'
        lo = int(schema.get("minLength", 0))
        hi = schema.get("maxLength")
        body = '[^"\\\\]'
        if hi is None:
            rep = "*" if lo == 0 else f"{{{lo},}}"
        else:
            rep = f"{{{lo},{int(hi)}}}"
        return f'"{body}{rep}"'
    if typ == "integer":
        core = "(?:0|[1-9][0-9]*)"
        if schema.get("minimum", -1) >= 0:
            return core
        return "-?" + core
    if typ == "number":
        sign = "" if schema.get("minimum", -1) >= 0 else "-?"
        return sign + "(?:0|[1-9][0-9]*)(?:\\.[0-9]+)?"
    if typ == "boolean":
        return "(?:true|false)"
    if typ == "null":
        return "null"
    if typ == "object":
        props = schema.get("properties", {})
        if not props:
            return "\\{\\}"
        parts = [f'"{_rx_escape(k)}":{schema_regex(v)}'
                 for k, v in props.items()]
        return "\\{" + ",".join(parts) + "\\}"
    if typ == "array":
        item = schema_regex(schema.get("items", {"type": "null"}))
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems")
        if hi is None:
            tail = f"(?:,{item})*" if lo <= 1 else \
                f"(?:,{item}){{{lo - 1},}}"
        else:
            hi = int(hi)
            if hi < max(lo, 1):
                raise MXNetError("schema: maxItems < minItems")
            tail = f"(?:,{item}){{{max(lo - 1, 0)},{hi - 1}}}"
        body = f"{item}{tail}"
        if lo == 0:
            return f"\\[(?:{body})?\\]"
        return f"\\[{body}\\]"
    raise MXNetError(f"unsupported schema: {schema!r} (supported: "
                     "enum/const, string, integer, number, boolean, "
                     "null, object/properties, array/items)")


# ------------------------------------------------- content-addressed cache

_CACHE_FORMAT = "mxnet-grammar-cache"
_CACHE_VERSION = 1

_mem_cache: "OrderedDict[str, TokenGrammar]" = OrderedDict()
_mem_lock = threading.Lock()


def clear_grammar_cache():
    """Drop the in-memory automaton cache (tests)."""
    with _mem_lock:
        _mem_cache.clear()


def _mem_capacity() -> int:
    return GRAMMAR_MASK_CACHE


def grammar_key(regex: str, vocab: int, token_sig: str,
                max_states: int) -> str:
    doc = json.dumps({"format": _CACHE_FORMAT, "version": _CACHE_VERSION,
                      "regex": regex, "vocab": int(vocab),
                      "tokens": token_sig, "max_states": int(max_states)},
                     sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(doc.encode()).hexdigest()


def _disk_dir() -> Optional[str]:
    return os.environ.get("MXNET_GRAMMAR_CACHE_DIR") or None


def _disk_path(root: str, key: str) -> str:
    return os.path.join(root, f"{key}.grammar")


def _payload_hash(payload: Dict[str, Any]) -> str:
    return hashlib.sha256(json.dumps(payload, sort_keys=True,
                                     separators=(",", ":")).encode()
                          ).hexdigest()


def _disk_get(key: str) -> Optional[Dict[str, Any]]:
    root = _disk_dir()
    if root is None:
        return None
    path = _disk_path(root, key)
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        if (doc.get("format") != _CACHE_FORMAT
                or doc.get("version") != _CACHE_VERSION
                or doc.get("key") != key
                or _payload_hash(doc["payload"]) != doc.get(
                    "payload_sha256")):
            raise ValueError("stale or corrupt grammar cache entry")
        return doc["payload"]
    except FileNotFoundError:
        return None
    except (ValueError, KeyError, TypeError, OSError) as e:
        # corrupt entries evict to a miss — never poison the automaton
        warnings.warn(f"grammar cache: dropping corrupt entry {path}: {e}")
        try:
            os.unlink(path)
        except OSError:
            pass
        return None


def _disk_put(key: str, payload: Dict[str, Any]):
    root = _disk_dir()
    if root is None:
        return
    try:
        os.makedirs(root, exist_ok=True)
        doc = {"format": _CACHE_FORMAT, "version": _CACHE_VERSION,
               "key": key, "payload": payload,
               "payload_sha256": _payload_hash(payload)}
        fd, tmp = tempfile.mkstemp(dir=root, prefix=".tmp-",
                                   suffix=".grammar")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(doc, f)
            os.replace(tmp, _disk_path(root, key))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    except OSError as e:
        warnings.warn(f"grammar cache: write failed ({e}); continuing "
                      "uncached")


def compile_grammar(source, vocab: int, *,
                    token_table: Optional[Sequence[str]] = None,
                    max_states: Optional[int] = None,
                    cache: bool = True) -> TokenGrammar:
    """Compile a regex (``str``) or restricted JSON schema (``dict``)
    into a :class:`TokenGrammar` over a ``vocab``-sized token alphabet.

    ``token_table`` maps token id -> string; the default is the
    char-level identity (``chr(id)``). Results are cached
    content-addressed on (pattern, vocab, token-table hash, state cap):
    in-memory LRU of :data:`GRAMMAR_MASK_CACHE` entries, plus the optional
    ``MXNET_GRAMMAR_CACHE_DIR`` disk layer.
    """
    if isinstance(source, str):
        regex = source
    elif isinstance(source, dict):
        regex = schema_regex(source)
    else:
        raise MXNetError(
            f"grammar source must be a regex str or a JSON-schema dict, "
            f"got {type(source)}")
    vocab = int(vocab)
    if vocab < 1:
        raise MXNetError("grammar: vocab must be >= 1")
    if max_states is None:
        max_states = GRAMMAR_MAX_STATES
    token_sig = ("identity" if token_table is None else
                 hashlib.sha256("\x00".join(token_table).encode()
                                ).hexdigest())
    key = grammar_key(regex, vocab, token_sig, max_states)

    if cache:
        with _mem_lock:
            hit = _mem_cache.get(key)
            if hit is not None:
                _mem_cache.move_to_end(key)
                _metrics.GRAMMAR_MASK_CACHE_HITS.labels(tier="memory").inc()
                return hit
        payload = _disk_get(key)
        if payload is not None:
            gram = TokenGrammar(
                onp.asarray(payload["cls"], onp.int32),
                onp.asarray(payload["nxt"], onp.int32).reshape(
                    payload["n_states"], payload["n_classes"]),
                onp.asarray(payload["accept"], bool),
                vocab, key=key, source=regex)
            _metrics.GRAMMAR_MASK_CACHE_HITS.labels(tier="disk").inc()
            _mem_store(key, gram)
            return gram
        _metrics.GRAMMAR_MASK_CACHE_MISSES.inc()

    t0 = time.perf_counter()
    gram = _build_token_grammar(regex, vocab, token_table, max_states, key)
    _metrics.GRAMMAR_COMPILE_SECONDS.observe(time.perf_counter() - t0)
    if cache:
        _mem_store(key, gram)
        _disk_put(key, {
            "cls": gram.cls.tolist(),
            "nxt": gram.nxt.reshape(-1).tolist(),
            "accept": gram.accept.tolist(),
            "n_states": gram.n_states, "n_classes": gram.n_classes,
            "vocab": gram.vocab})
    return gram


def _mem_store(key: str, gram: TokenGrammar):
    cap = _mem_capacity()
    with _mem_lock:
        _mem_cache[key] = gram
        _mem_cache.move_to_end(key)
        while len(_mem_cache) > cap:
            _mem_cache.popitem(last=False)


# ------------------------------------------------------- device-side gathers

def _rows_of(gnxt, states):
    """``gnxt [B, N, C]`` rows at ``states`` (int64, clipped) -> [B, ..., C]
    for ``states`` [B] or [B, T]."""
    b, n, c = gnxt.shape
    idx = states.reshape(b, -1, 1).expand(b, states[0].numel(), c)
    return torch.gather(gnxt, 1, idx).reshape(*states.shape, c)


def grammar_mask(gcls, gnxt, gacc, gstate, geos):
    """Allowed-token mask: ``gcls [B, V]``, ``gnxt [B, N, C]``, ``gacc [B,
    N]``, ``gstate [B]``, ``geos [B]`` (eos id, -1 = none) -> bool ``[B,
    V]``. Two gathers: state row, then class lookup; EOS joins the mask in
    accepting states. The states are clipped to [0, N)."""
    b, v = gcls.shape
    state = gstate.long().clamp(0, gnxt.shape[1] - 1)
    row = _rows_of(gnxt, state)                                   # [B, C]
    ok = torch.gather(row, 1, gcls.long()) >= 0                   # [B, V]
    acc = torch.gather(gacc, 1, state[:, None])                   # [B, 1]
    iota = torch.arange(v, device=gcls.device)[None, :]
    eos = geos.long()[:, None]
    return ok | (acc & (eos >= 0) & (iota == eos))


def grammar_mask_multi(gcls, gnxt, gacc, gstates, geos):
    """Per-draft-position masks of the speculative verify: ``gstates [B,
    T]`` -> bool ``[B, T, V]`` (the same gathers, one more axis)."""
    b, v = gcls.shape
    t = gstates.shape[1]
    states = gstates.long().clamp(0, gnxt.shape[1] - 1)
    rows = _rows_of(gnxt, states)                                 # [B, T, C]
    idx = gcls.long()[:, None, :].expand(b, t, v)
    ok = torch.gather(rows, 2, idx) >= 0                          # [B, T, V]
    acc = torch.gather(gacc, 1, states)                           # [B, T]
    iota = torch.arange(v, device=gcls.device)[None, None, :]
    eos = geos.long()[:, None, None]
    return ok | (acc[:, :, None] & (eos >= 0) & (iota == eos))


def grammar_advance(gcls, gnxt, gstate, toks, geos):
    """Next per-row automaton state after emitting ``toks [B]``. EOS, and
    any token the grammar forbids (a discarded row), parks the state; the
    host ledger is authoritative and re-syncs at every read. Token ids
    index ``gcls`` as ``jnp.take_along_axis`` does: a negative id counts
    from the end, one outside [-V, V) parks."""
    v = gcls.shape[1]
    state = gstate.long().clamp(0, gnxt.shape[1] - 1)
    row = _rows_of(gnxt, state)                                   # [B, C]
    t = toks.long()
    t = torch.where(t < 0, t + v, t)
    inside = (t >= 0) & (t < v)
    c = torch.gather(gcls, 1, t.clamp(0, v - 1)[:, None]).long()  # [B, 1]
    q2 = torch.gather(row, 1, c)[:, 0]                            # [B]
    park = (toks.long() == geos.long()) | (q2 < 0) | ~inside
    return torch.where(park, gstate.long(), q2).to(torch.int32)
