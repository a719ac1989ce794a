"""Structured (constrained) decoding — JSON-schema / regex token masks.

Counterpart of ``paddle_tpu/serving/constrained.py`` (pure Python and
numpy, copied so the port imports nothing of the JAX package).

A constraint compiles to a byte-level DFA; the vocabulary is projected
onto it per state: token t is allowed in DFA state s iff walking t's
byte expansion from s never leaves the automaton. The resulting (V,)
bool mask becomes a tensor only at the engine's sampling call
(serving.sampling ``mask=``), so a masked row composes with
temperature/top-k/top-p exactly — the filter chain renormalizes over
the allowed set. The automaton itself advances HOST-side, one token per
emitted token, at request granularity (the same host/device split as
the block tables: per-token control state stays out of the model
step).

Layers:

- :func:`compile_regex` — a self-contained regex subset (literals,
  escapes, ``.``, character classes with ranges/negation, groups,
  alternation, ``* + ?`` and ``{m,n}``) → Thompson NFA → subset-
  construction DFA over bytes. No ``re`` involvement: ``re`` can only
  test complete strings, while masking needs PREFIX-liveness per state.
- :func:`schema_to_regex` — a practical JSON-schema subset (object with
  fixed ``properties`` (order = emission order), ``string``/
  ``integer``/``number``/``boolean``/``null``, ``enum``, nested
  objects, ``array`` with ``items``/``minItems``/``maxItems``) → a
  regex for the canonical compact serialization. ``json.loads`` of a
  completed match always succeeds and validates against the schema.
- :class:`TokenConstraint` — the shareable compiled artifact: DFA +
  per-(state) token-mask cache over a tokenizer's id→bytes table.
  :meth:`cursor` mints the per-request mutable state the engine holds
  (:class:`ConstraintCursor`: ``mask()`` / ``advance(tok)`` /
  ``finished``).

EOS is allowed exactly in ACCEPTING states; a cursor whose state
accepts and has no live continuation reports ``finished`` and the
engine stops the stream (finish_reason ``"stop"``) — so a constrained
request terminates when its JSON object closes even if the model would
happily keep going.
"""
from __future__ import annotations

import json
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np

__all__ = ["compile_regex", "schema_to_regex", "compile_constraint",
           "TokenConstraint", "ConstraintCursor", "Dfa"]


# ==========================================================================
# regex subset -> NFA (Thompson construction)
# ==========================================================================

_EPS = -1          # epsilon edge label
_ANY = -2          # "." — any byte except newline


class _Nfa:
    """Fragment with one start and one accept state; edges are
    (label, dst) lists where label is a frozenset of bytes, _EPS."""

    def __init__(self):
        self.edges: List[List[Tuple[object, int]]] = []

    def state(self) -> int:
        self.edges.append([])
        return len(self.edges) - 1


class _RegexParser:
    """Recursive-descent parser for the supported subset."""

    def __init__(self, pattern: str):
        self.pat = pattern
        self.i = 0
        self.nfa = _Nfa()

    def parse(self) -> Tuple[int, int]:
        start, accept = self._alternation()
        if self.i != len(self.pat):
            raise ValueError(
                f"regex: unexpected {self.pat[self.i]!r} at {self.i} "
                f"in {self.pat!r}")
        return start, accept

    # alternation := concat ('|' concat)*
    def _alternation(self) -> Tuple[int, int]:
        frags = [self._concat()]
        while self._peek() == "|":
            self.i += 1
            frags.append(self._concat())
        if len(frags) == 1:
            return frags[0]
        s, a = self.nfa.state(), self.nfa.state()
        for fs, fa in frags:
            self.nfa.edges[s].append((_EPS, fs))
            self.nfa.edges[fa].append((_EPS, a))
        return s, a

    def _concat(self) -> Tuple[int, int]:
        frags = []
        while self._peek() not in ("", "|", ")"):
            frags.append(self._quantified())
        if not frags:
            s = self.nfa.state()
            return s, s
        for (_, a1), (s2, _) in zip(frags, frags[1:]):
            self.nfa.edges[a1].append((_EPS, s2))
        return frags[0][0], frags[-1][1]

    def _quantified(self) -> Tuple[int, int]:
        frag = self._atom()
        while True:
            c = self._peek()
            if c == "*":
                self.i += 1
                frag = self._star(frag)
            elif c == "+":
                self.i += 1
                s2, a2 = self._copy(frag)
                star = self._star((s2, a2))
                self.nfa.edges[frag[1]].append((_EPS, star[0]))
                frag = (frag[0], star[1])
            elif c == "?":
                self.i += 1
                self.nfa.edges[frag[0]].append((_EPS, frag[1]))
            elif c == "{":
                frag = self._repeat(frag)
            else:
                return frag

    def _star(self, frag: Tuple[int, int]) -> Tuple[int, int]:
        fs, fa = frag
        s, a = self.nfa.state(), self.nfa.state()
        self.nfa.edges[s] += [(_EPS, fs), (_EPS, a)]
        self.nfa.edges[fa] += [(_EPS, fs), (_EPS, a)]
        return s, a

    def _repeat(self, frag: Tuple[int, int]) -> Tuple[int, int]:
        j = self.pat.index("}", self.i)
        spec = self.pat[self.i + 1:j]
        self.i = j + 1
        lo, _, hi = spec.partition(",")
        m = int(lo)
        n = m if not _ else (int(hi) if hi else None)
        if n is not None and (n < m or n > 256):
            raise ValueError(f"regex: bad repeat {{{spec}}}")
        # expand: m mandatory copies, then (n-m) optional (or a star)
        s = a = None
        for _k in range(m):
            fs, fa = self._copy(frag)
            if s is None:
                s, a = fs, fa
            else:
                self.nfa.edges[a].append((_EPS, fs))
                a = fa
        if n is None:
            tail = self._star(self._copy(frag))
        else:
            tail = None
            for _k in range(n - m):
                fs, fa = self._copy(frag)
                self.nfa.edges[fs].append((_EPS, fa))   # optional
                if tail is None:
                    tail = (fs, fa)
                else:
                    self.nfa.edges[tail[1]].append((_EPS, fs))
                    tail = (tail[0], fa)
        if tail is not None:
            if s is None:
                s, a = tail
            else:
                self.nfa.edges[a].append((_EPS, tail[0]))
                a = tail[1]
        if s is None:           # {0} / {0,0}
            s = a = self.nfa.state()
        return s, a

    def _copy(self, frag: Tuple[int, int]) -> Tuple[int, int]:
        """Deep-copy a fragment's reachable subgraph (quantifier
        expansion needs independent copies)."""
        fs, fa = frag
        seen: Dict[int, int] = {}
        stack = [fs]
        seen[fs] = self.nfa.state()
        while stack:
            old = stack.pop()
            for label, dst in list(self.nfa.edges[old]):
                if dst not in seen:
                    seen[dst] = self.nfa.state()
                    stack.append(dst)
                self.nfa.edges[seen[old]].append((label, seen[dst]))
        if fa not in seen:      # accept unreachable from start: isolated
            seen[fa] = self.nfa.state()
        return seen[fs], seen[fa]

    # atoms
    def _peek(self) -> str:
        return self.pat[self.i] if self.i < len(self.pat) else ""

    _ESCAPES = {"n": b"\n", "r": b"\r", "t": b"\t", "0": b"\0"}
    _CLASSES = {
        "d": frozenset(range(0x30, 0x3A)),
        "w": frozenset(list(range(0x30, 0x3A)) + list(range(0x41, 0x5B))
                       + list(range(0x61, 0x7B)) + [0x5F]),
        "s": frozenset(b" \t\r\n\f\v"),
    }

    def _atom(self) -> Tuple[int, int]:
        c = self._peek()
        if c == "(":
            self.i += 1
            frag = self._alternation()
            if self._peek() != ")":
                raise ValueError(f"regex: unbalanced '(' in {self.pat!r}")
            self.i += 1
            return frag
        if c == "[":
            return self._edge(self._char_class())
        if c == ".":
            self.i += 1
            return self._edge(frozenset(set(range(256)) - {0x0A}))
        if c == "\\":
            self.i += 1
            e = self._peek()
            self.i += 1
            if e in self._CLASSES:
                return self._edge(self._CLASSES[e])
            if e.upper() in self._CLASSES:   # \D \W \S
                return self._edge(
                    frozenset(set(range(256)) - self._CLASSES[e.lower()]))
            if e in self._ESCAPES:
                return self._edge(frozenset(self._ESCAPES[e]))
            if e == "x":
                byte = int(self.pat[self.i:self.i + 2], 16)
                self.i += 2
                return self._edge(frozenset({byte}))
            return self._edge(frozenset(e.encode("utf-8")) if len(
                e.encode("utf-8")) == 1 else None, literal=e)
        if c in ("*", "+", "?", "{", "}"):
            raise ValueError(f"regex: dangling {c!r} at {self.i}")
        self.i += 1
        return self._literal(c)

    def _literal(self, ch: str) -> Tuple[int, int]:
        data = ch.encode("utf-8")
        s = self.nfa.state()
        cur = s
        for b in data:
            nxt = self.nfa.state()
            self.nfa.edges[cur].append((frozenset({b}), nxt))
            cur = nxt
        return s, cur

    def _edge(self, byte_set, literal: Optional[str] = None):
        if byte_set is None:          # multi-byte escaped literal
            return self._literal(literal)
        s, a = self.nfa.state(), self.nfa.state()
        self.nfa.edges[s].append((byte_set, a))
        return s, a

    def _class_one(self):
        """One class member: ("class", byte_set) for shorthand escapes,
        ("chr", code_point) otherwise — shared by both ends of a
        range so ``[\\x00-\\x1f]`` parses."""
        c = self._peek()
        if c == "\\":
            self.i += 1
            e = self._peek()
            self.i += 1
            if e in self._CLASSES:
                return ("class", self._CLASSES[e])
            if e in self._ESCAPES:
                return ("chr", self._ESCAPES[e][0])
            if e == "x":
                v = int(self.pat[self.i:self.i + 2], 16)
                self.i += 2
                return ("chr", v)
            return ("chr", ord(e))
        self.i += 1
        return ("chr", ord(c))

    def _char_class(self) -> FrozenSet[int]:
        assert self._peek() == "["
        self.i += 1
        negate = self._peek() == "^"
        if negate:
            self.i += 1
        out: Set[int] = set()
        first = True
        while True:
            c = self._peek()
            if c == "":
                raise ValueError(f"regex: unbalanced '[' in {self.pat!r}")
            if c == "]" and not first:
                self.i += 1
                break
            first = False
            kind, val = self._class_one()
            if kind == "class":
                out |= val
                continue
            if self._peek() == "-" and self.i + 1 < len(self.pat) \
                    and self.pat[self.i + 1] != "]":
                self.i += 1
                k2, hi = self._class_one()
                if k2 == "class":
                    raise ValueError(
                        f"regex: class shorthand as range bound in "
                        f"{self.pat!r}")
                out |= set(range(val, hi + 1))
            else:
                out.add(val)
        if any(b > 255 for b in out):
            raise ValueError("regex: non-byte characters in class "
                             "(escape multibyte chars outside [])")
        return frozenset(set(range(256)) - out) if negate else frozenset(out)


# ==========================================================================
# NFA -> DFA (subset construction over bytes)
# ==========================================================================

class Dfa:
    """Byte-level DFA: ``trans[state]`` maps byte -> state;
    ``accepting`` is the set of match states. Every state is live
    (some path reaches an accepting state) — dead subsets are pruned at
    construction, so "no transition" already means "this byte kills the
    match"."""

    __slots__ = ("trans", "accepting", "start")

    def __init__(self, trans: List[Dict[int, int]], accepting: Set[int],
                 start: int):
        self.trans = trans
        self.accepting = accepting
        self.start = start

    @property
    def n_states(self) -> int:
        return len(self.trans)

    def matches(self, data: bytes) -> bool:
        s = self.start
        for b in data:
            s = self.trans[s].get(b)
            if s is None:
                return False
        return s in self.accepting


def _eps_closure(nfa: _Nfa, states: Set[int]) -> FrozenSet[int]:
    out = set(states)
    stack = list(states)
    while stack:
        s = stack.pop()
        for label, dst in nfa.edges[s]:
            if label == _EPS and dst not in out:
                out.add(dst)
                stack.append(dst)
    return frozenset(out)


def compile_regex(pattern: str, max_states: int = 4096) -> Dfa:
    """Compile the supported regex subset to a pruned byte DFA (full
    anchored match — the constraint is the WHOLE generated string)."""
    parser = _RegexParser(pattern)
    start, accept = parser.parse()
    nfa = parser.nfa
    d0 = _eps_closure(nfa, {start})
    ids: Dict[FrozenSet[int], int] = {d0: 0}
    trans: List[Dict[int, int]] = [{}]
    accepting: Set[int] = set()
    work = [d0]
    while work:
        cur = work.pop()
        ci = ids[cur]
        if accept in cur:
            accepting.add(ci)
        # group reachable byte edges
        by_byte: Dict[int, Set[int]] = {}
        for s in cur:
            for label, dst in nfa.edges[s]:
                if label == _EPS:
                    continue
                for b in label:
                    by_byte.setdefault(b, set()).add(dst)
        for b, dsts in by_byte.items():
            nxt = _eps_closure(nfa, dsts)
            if nxt not in ids:
                if len(ids) >= max_states:
                    raise ValueError(
                        f"regex {pattern!r}: DFA exceeds {max_states} states")
                ids[nxt] = len(ids)
                trans.append({})
                work.append(nxt)
            trans[ci][b] = ids[nxt]
    # prune dead states (no path to accepting): masking needs PREFIX
    # liveness, so "has a transition" must imply "can still match"
    alive: Set[int] = set(accepting)
    changed = True
    while changed:
        changed = False
        for i, edges in enumerate(trans):
            if i not in alive and any(d in alive for d in edges.values()):
                alive.add(i)
                changed = True
    if 0 not in alive:
        raise ValueError(f"regex {pattern!r} matches nothing")
    remap = {old: new for new, old in enumerate(sorted(alive))}
    pruned = [{b: remap[d] for b, d in trans[old].items() if d in alive}
              for old in sorted(alive)]
    return Dfa(pruned, {remap[a] for a in accepting if a in alive}, remap[0])


# ==========================================================================
# JSON schema -> regex (canonical compact serialization)
# ==========================================================================

_JSON_STR = r'"[^"\\\x00-\x1f]*"'
_JSON_INT = r"-?(0|[1-9][0-9]*)"
_JSON_NUM = _JSON_INT + r"(\.[0-9]+)?"


def _escape_literal(text: str) -> str:
    out = []
    for ch in text:
        if ch in r".[]{}()*+?|\^$-":
            out.append("\\" + ch)
        else:
            out.append(ch)
    return "".join(out)


def schema_to_regex(schema: dict, depth: int = 0) -> str:
    """JSON-schema subset → regex of the canonical COMPACT serialization
    (no whitespace, object keys in ``properties`` order, every listed
    property required). Completed matches json.loads cleanly and
    satisfy the schema's types."""
    if depth > 16:
        raise ValueError("json schema nests deeper than 16 levels")
    if "enum" in schema:
        alts = []
        for v in schema["enum"]:
            alts.append(_escape_literal(json.dumps(v, separators=(",", ":"))))
        return "(" + "|".join(alts) + ")"
    t = schema.get("type")
    if t == "string":
        pat = schema.get("pattern")
        if pat is not None:
            return '"' + pat + '"'
        lo = int(schema.get("minLength", 0))
        hi = schema.get("maxLength")
        body = r'[^"\\\x00-\x1f]'
        rep = f"{{{lo},{int(hi)}}}" if hi is not None else \
            (f"{{{lo},}}" if lo else "*")
        return '"' + body + rep + '"'
    if t == "integer":
        return _JSON_INT
    if t == "number":
        return _JSON_NUM
    if t == "boolean":
        return "(true|false)"
    if t == "null":
        return "null"
    if t == "array":
        item = schema_to_regex(schema.get("items", {"type": "integer"}),
                               depth + 1)
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems")
        if lo == 0:
            inner = f"({item}(,{item})*)?" if hi is None else \
                f"({item}(,{item}){{0,{int(hi) - 1}}})?"
        else:
            more = f"(,{item})*" if hi is None else \
                f"(,{item}){{{lo - 1},{int(hi) - 1}}}"
            inner = item + more
        return r"\[" + inner + r"\]"
    if t == "object" or "properties" in schema:
        props = schema.get("properties", {})
        if not props:
            return r"\{\}"
        parts = []
        for name, sub in props.items():
            parts.append('"' + _escape_literal(name) + '":'
                         + schema_to_regex(sub, depth + 1))
        return r"\{" + ",".join(parts) + r"\}"
    raise ValueError(f"unsupported json schema: {schema!r}")


# ==========================================================================
# token projection
# ==========================================================================

class TokenConstraint:
    """A compiled constraint shared across requests: the byte DFA plus a
    lazily-built per-state token mask over one vocabulary.

    ``token_table`` maps token id -> byte expansion (None for specials
    — always masked out except EOS, which is allowed in accepting
    states). Build one per (constraint, tokenizer) pair and mint a
    :class:`cursor` per request."""

    def __init__(self, dfa: Dfa, token_table: Sequence[Optional[bytes]],
                 eos_id: Optional[int] = None):
        self.dfa = dfa
        self.token_table = list(token_table)
        self.vocab_size = len(self.token_table)
        self.eos_id = eos_id
        self._masks: Dict[int, np.ndarray] = {}
        self._steps: Dict[Tuple[int, int], Optional[int]] = {}

    @classmethod
    def from_tokenizer(cls, dfa: Dfa, tokenizer, vocab_size: Optional[int]
                       = None) -> "TokenConstraint":
        """Project a ByteTokenizer-shaped vocabulary (``token_bytes`` +
        ``eos_id``) onto the DFA. ``vocab_size`` pads the mask out to
        the MODEL's vocab (ids past the tokenizer are never allowed)."""
        n = vocab_size if vocab_size is not None else tokenizer.vocab_size
        table = [tokenizer.token_bytes(t) if t < tokenizer.vocab_size
                 else None for t in range(n)]
        return cls(dfa, table, eos_id=tokenizer.eos_id)

    def _walk(self, state: int, data: bytes) -> Optional[int]:
        s = state
        for b in data:
            s = self.dfa.trans[s].get(b)
            if s is None:
                return None
        return s

    def step(self, state: int, tok: int) -> Optional[int]:
        """DFA state after emitting ``tok`` (None = dead/disallowed)."""
        key = (state, int(tok))
        hit = self._steps.get(key, False)
        if hit is not False:
            return hit
        data = self.token_table[int(tok)] if 0 <= tok < self.vocab_size \
            else None
        nxt = self._walk(state, data) if data is not None else None
        self._steps[key] = nxt
        return nxt

    def mask(self, state: int) -> np.ndarray:
        """(V,) bool: tokens whose byte expansion keeps the DFA alive
        from ``state``; EOS allowed iff ``state`` accepts."""
        m = self._masks.get(state)
        if m is None:
            m = np.zeros(self.vocab_size, bool)
            for t, data in enumerate(self.token_table):
                if data is not None and self._walk(state, data) is not None:
                    m[t] = True
            m.setflags(write=False)
            self._masks[state] = m
        if self.eos_id is not None and state in self.dfa.accepting:
            out = m.copy()
            out[self.eos_id] = True
            return out
        return m

    def cursor(self) -> "ConstraintCursor":
        return ConstraintCursor(self)


class ConstraintCursor:
    """Per-request automaton state the engine advances token by token.
    Owned by the scheduler thread; not thread-safe by design."""

    __slots__ = ("constraint", "state", "dead")

    def __init__(self, constraint: TokenConstraint):
        self.constraint = constraint
        self.state: int = constraint.dfa.start
        self.dead = False

    def mask(self) -> np.ndarray:
        return self.constraint.mask(self.state)

    def advance(self, tok: int) -> bool:
        """Consume one emitted token; False when it killed the match
        (possible only for tokens the mask never offered — EOS, or an
        unmasked escape-hatch path)."""
        if self.dead:
            return False
        if tok == self.constraint.eos_id:
            return self.state in self.constraint.dfa.accepting
        nxt = self.constraint.step(self.state, int(tok))
        if nxt is None:
            self.dead = True
            return False
        self.state = nxt
        return True

    @property
    def accepting(self) -> bool:
        return not self.dead and self.state in self.constraint.dfa.accepting

    @property
    def finished(self) -> bool:
        """Accepting with no live continuation — generation is complete
        (the engine evicts with finish_reason "stop")."""
        return self.accepting and not self.constraint.dfa.trans[self.state]


def compile_constraint(tokenizer=None, regex: Optional[str] = None,
                       json_schema: Optional[dict] = None,
                       vocab_size: Optional[int] = None) -> TokenConstraint:
    """One-stop constructor: exactly one of ``regex`` / ``json_schema``
    plus a tokenizer (ByteTokenizer surface) → a shareable
    :class:`TokenConstraint`."""
    if (regex is None) == (json_schema is None):
        raise ValueError("pass exactly one of regex / json_schema")
    if tokenizer is None:
        raise ValueError("compile_constraint needs the engine's tokenizer "
                         "(token ids must map to bytes)")
    pattern = regex if regex is not None else schema_to_regex(json_schema)
    return TokenConstraint.from_tokenizer(compile_regex(pattern), tokenizer,
                                          vocab_size=vocab_size)
