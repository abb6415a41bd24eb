"""Grammar-constrained decoding (``rbg_tpu/engine/grammar.py``, numpy
only; the port keeps its own copy). JSON mode (structured output).

Reference context: structured output is the signature feature of the
reference's flagship engine (SGLang — the "structured generation
language"); vLLM ships it as guided/JSON mode. Here it is a byte-level
JSON pushdown automaton lifted to token masks:

* ``JsonGrammar`` — immutable-state automaton over BYTES. ``advance``
  returns the next state or None (byte illegal); ``is_complete`` says a
  full JSON value has been consumed (EOS becomes legal).
* ``TokenGrammar`` — lifts a byte grammar over a token→bytes table:
  ``mask(state)`` marks every token whose full byte sequence is legal
  from ``state`` (plus EOS iff complete); ``advance_token`` folds a
  token's bytes into the state.

Engine integration (``rbg_tpu_torch/engine/engine.py``), two paths:

* **Device-resident tables** — finite-state grammars (the NFA family
  below) additionally compile to a dense token-level product automaton
  (``compile_token_table``: ``next_state[S, V]`` + ``legal[S, V]``,
  BFS capped by a state budget), uploaded once per (grammar, vocab);
  constrained rows then decode INSIDE the fused multi-step scan with
  zero per-token host syncs, bit-identical to the mask path.
* **Host-synced masks** — the pushdown ``JsonGrammar``, budget-exceeded
  grammars, and speculative mode decode through the spec-style
  host-synced step. Masks for drafted positions are computed host-side
  ALONG THE DRAFT PATH — the mask at position i+1 assumes drafts 0..i
  were accepted, which holds exactly for every accepted prefix, so
  grammar constraints and speculative decoding compose without
  approximation (a draft token the grammar forbids truncates the draft).

Complexity note: ``mask`` walks a precompiled byte-path TRIE over the
vocabulary (xgrammar-style): the automaton advances once per trie NODE,
so tokens sharing a prefix share the walk and an illegal first byte
prunes its whole subtree — O(legal byte paths) per step instead of
O(total vocab bytes). Masks are additionally memoized per automaton
state (states recur heavily: a long string interior, number digits, the
AFTER-value gap all map to one state each), so steady-state decoding
costs a dict hit + memcpy. Exactness is preserved — the probe loop
survives as ``_mask_probe`` and tests assert trie == probe on every
state they visit.
"""

from __future__ import annotations

import dataclasses
import json
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

# ---- JSON byte automaton ----
#
# State = (mode, stack, aux) — plain tuples, hashable, never mutated.
#   mode: one of the _M_* constants below
#   stack: tuple of b'{' / b'[' container markers
#   aux: mode-specific scalar (literal progress, number sub-state, …)

_WS = frozenset(b" \t\n\r")
_DIGITS = frozenset(b"0123456789")
_HEX = frozenset(b"0123456789abcdefABCDEF")

# modes
_VALUE = 0          # expecting a value
_STRING = 1         # inside a string (aux: 0 normal, 1 after backslash,
                    #                  2-5 unicode escape digits remaining)
_KEYSTR = 2         # inside an object key string (same aux)
_AFTER = 3          # after a complete value (expect , } ] or EOS at top)
_OBJ_KEY = 4        # inside {, expecting key string or }
_OBJ_COLON = 5      # after key, expecting :
_OBJ_NEXTKEY = 6    # after comma in object, expecting key string
_NUM = 7            # inside a number (aux: sub-state)
_LIT = 8            # inside true/false/null (aux: (literal, idx))

# number sub-states (aux for _NUM)
_N_MINUS = 0        # consumed '-', need first digit
_N_ZERO = 1         # consumed leading 0 (no more int digits)
_N_INT = 2          # in integer digits
_N_DOT = 3          # consumed '.', need fraction digit
_N_FRAC = 4         # in fraction digits
_N_E = 5            # consumed e/E, need sign or digit
_N_ESIGN = 6        # consumed exponent sign, need digit
_N_EXP = 7          # in exponent digits

_NUM_COMPLETE = {_N_ZERO, _N_INT, _N_FRAC, _N_EXP}

State = Tuple[int, tuple, object]


class JsonGrammar:
    def initial(self) -> State:
        return (_VALUE, (), None)

    # -- helpers --

    @staticmethod
    def _close(stack: tuple) -> State:
        """A value just completed; what comes next."""
        return (_AFTER, stack, None)

    def _open_value(self, b: int, stack: tuple,
                    aux: object) -> Optional[State]:
        # aux == "af" marks "first slot of an array" — the only VALUE
        # position where a closing ] is legal ([] yes, [1,] no).
        if b in _WS:
            return (_VALUE, stack, aux)
        if b == 0x7B:                                   # {
            return (_OBJ_KEY, stack + (b"{",), None)
        if b == 0x5B:                                   # [
            return (_VALUE, stack + (b"[",), "af")
        if b == 0x22:                                   # "
            return (_STRING, stack, 0)
        if b == 0x2D:                                   # -
            return (_NUM, stack, _N_MINUS)
        if b == 0x30:                                   # 0
            return (_NUM, stack, _N_ZERO)
        if b in _DIGITS:
            return (_NUM, stack, _N_INT)
        for lit in (b"true", b"false", b"null"):
            if b == lit[0]:
                return (_LIT, stack, (lit, 1))
        if (b == 0x5D and aux == "af"
                and stack and stack[-1] == b"["):       # ] — empty array
            return self._close(stack[:-1])
        return None

    def _string_step(self, mode: int, b: int, stack: tuple,
                     aux: int) -> Optional[State]:
        if aux == 1:                                     # after backslash
            if b in b'"\\/bfnrt':
                return (mode, stack, 0)
            if b == 0x75:                                # u
                return (mode, stack, 2)
            return None
        if aux >= 2:                                     # unicode digits
            if b in _HEX:
                return (mode, stack, 0 if aux == 5 else aux + 1)
            return None
        if b == 0x22:                                    # closing quote
            if mode == _KEYSTR:
                return (_OBJ_COLON, stack, None)
            return self._close(stack)
        if b == 0x5C:                                    # backslash
            return (mode, stack, 1)
        if b < 0x20:                                     # raw control char
            return None
        return (mode, stack, 0)                          # any other byte

    def _num_step(self, b: int, stack: tuple, aux: int) -> Optional[State]:
        if aux == _N_MINUS:
            if b == 0x30:
                return (_NUM, stack, _N_ZERO)
            if b in _DIGITS:
                return (_NUM, stack, _N_INT)
            return None
        if aux in (_N_ZERO, _N_INT):
            if aux == _N_INT and b in _DIGITS:
                return (_NUM, stack, _N_INT)
            if b == 0x2E:                                # .
                return (_NUM, stack, _N_DOT)
            if b in (0x65, 0x45):                        # e E
                return (_NUM, stack, _N_E)
            return self._after_number(b, stack)
        if aux == _N_DOT:
            return (_NUM, stack, _N_FRAC) if b in _DIGITS else None
        if aux == _N_FRAC:
            if b in _DIGITS:
                return (_NUM, stack, _N_FRAC)
            if b in (0x65, 0x45):
                return (_NUM, stack, _N_E)
            return self._after_number(b, stack)
        if aux == _N_E:
            if b in (0x2B, 0x2D):                        # + -
                return (_NUM, stack, _N_ESIGN)
            return (_NUM, stack, _N_EXP) if b in _DIGITS else None
        if aux == _N_ESIGN:
            return (_NUM, stack, _N_EXP) if b in _DIGITS else None
        if aux == _N_EXP:
            if b in _DIGITS:
                return (_NUM, stack, _N_EXP)
            return self._after_number(b, stack)
        return None

    def _after_number(self, b: int, stack: tuple) -> Optional[State]:
        """A number ended implicitly — re-dispatch the byte in AFTER."""
        return self.advance(self._close(stack), b)

    # -- public --

    def advance(self, state: State, b: int) -> Optional[State]:
        mode, stack, aux = state
        if mode == _VALUE:
            return self._open_value(b, stack, aux)
        if mode in (_STRING, _KEYSTR):
            return self._string_step(mode, b, stack, aux)
        if mode == _NUM:
            return self._num_step(b, stack, aux)
        if mode == _LIT:
            lit, i = aux
            if b == lit[i]:
                if i + 1 == len(lit):
                    return self._close(stack)
                return (_LIT, stack, (lit, i + 1))
            return None
        if mode == _AFTER:
            if b in _WS:
                return (_AFTER, stack, None)
            if stack:
                top = stack[-1]
                if b == 0x2C:                            # ,
                    if top == b"{":
                        return (_OBJ_NEXTKEY, stack, None)
                    return (_VALUE, stack, None)
                if b == 0x7D and top == b"{":            # }
                    return self._close(stack[:-1])
                if b == 0x5D and top == b"[":            # ]
                    return self._close(stack[:-1])
            return None
        if mode in (_OBJ_KEY, _OBJ_NEXTKEY):
            if b in _WS:
                return (mode, stack, None)
            if b == 0x22:
                return (_KEYSTR, stack, 0)
            if b == 0x7D and mode == _OBJ_KEY:           # } — empty object
                return self._close(stack[:-1])
            return None
        if mode == _OBJ_COLON:
            if b in _WS:
                return (mode, stack, None)
            if b == 0x3A:                                # :
                return (_VALUE, stack, None)
            return None
        return None

    def is_complete(self, state: State) -> bool:
        mode, stack, aux = state
        if stack:
            return False
        if mode == _AFTER:
            return True
        if mode == _NUM:
            return aux in _NUM_COMPLETE
        return False


class NfaGrammar:
    """Byte-level Thompson-NFA grammar base: compiles a tuple AST
    (``("lit", byte)``, ``("class", frozenset)``, ``("cat", [...])``,
    ``("alt", [...])``, ``("rep", node, lo, hi|None)``) and exposes the
    same ``initial``/``advance``/``is_complete`` contract as JsonGrammar —
    state is a frozenset of node ids (hashable), so the ``TokenGrammar``
    trie walk and packed mask cache apply unchanged. Subclasses build the
    AST (the regex parser, the JSON-Schema compiler)."""

    _MAX_NODES = 10_000
    # '.', negated classes, and negated escapes complement within ASCII:
    # bytes 0x80-0xFF are UTF-8 continuation/lead fragments, and making a
    # lone one legal would force-sample undecodable output. Non-ASCII
    # characters still match as LITERALS (their full byte sequence).
    _ASCII = frozenset(range(0x80))

    def __init__(self, ast):
        self._trans: List[dict] = []      # node -> {byte: [targets]}
        self._eps: List[list] = []        # node -> [targets]
        start, end = self._compile(ast)
        self._accept = end
        self._start_closure = self._closure({start})
        # Precompute eps-closures per node for fast advance.
        self._node_closure = [self._closure({n})
                              for n in range(len(self._trans))]

    # -- NFA construction --

    def _node(self) -> int:
        if len(self._trans) >= self._MAX_NODES:
            raise ValueError("grammar: pattern/schema too large")
        self._trans.append({})
        self._eps.append([])
        return len(self._trans) - 1

    def _compile(self, ast):
        """Returns (start, end) node ids; fresh nodes per call so ``rep``
        expansion can instantiate the body repeatedly."""
        kind = ast[0]
        if kind == "lit":
            s, e = self._node(), self._node()
            self._trans[s].setdefault(ast[1], [])
            self._trans[s][ast[1]].append(e)
            return s, e
        if kind == "class":
            s, e = self._node(), self._node()
            for b in ast[1]:
                self._trans[s].setdefault(b, []).append(e)
            return s, e
        if kind == "cat":
            if not ast[1]:
                s = self._node()
                return s, s
            s, e = self._compile(ast[1][0])
            for item in ast[1][1:]:
                s2, e2 = self._compile(item)
                self._eps[e].append(s2)
                e = e2
            return s, e
        if kind == "alt":
            s, e = self._node(), self._node()
            for branch in ast[1]:
                bs, be = self._compile(branch)
                self._eps[s].append(bs)
                self._eps[be].append(e)
            return s, e
        if kind == "rep":
            _, body, lo, hi = ast
            s = self._node()
            cur = s
            for _ in range(lo):
                bs, be = self._compile(body)
                self._eps[cur].append(bs)
                cur = be
            if hi is None:                      # unbounded tail: loop
                bs, be = self._compile(body)
                self._eps[cur].append(bs)
                self._eps[be].append(bs)
                end = self._node()
                self._eps[cur].append(end)
                self._eps[be].append(end)
                return s, end
            end = self._node()
            self._eps[cur].append(end)
            for _ in range(hi - lo):            # optional copies
                bs, be = self._compile(body)
                self._eps[cur].append(bs)
                self._eps[be].append(end)
                cur = be
            return s, end
        raise AssertionError(kind)

    def _closure(self, nodes) -> frozenset:
        out = set(nodes)
        stack = list(nodes)
        while stack:
            n = stack.pop()
            for t in self._eps[n]:
                if t not in out:
                    out.add(t)
                    stack.append(t)
        return frozenset(out)

    # -- AST helpers shared by subclasses --

    @staticmethod
    def _lit_bytes(bs: bytes):
        if len(bs) == 1:
            return ("lit", bs[0])
        return ("cat", [("lit", b) for b in bs])

    # -- the JsonGrammar-compatible contract --

    def initial(self) -> frozenset:
        return self._start_closure

    def advance(self, state, b: int):
        nxt = set()
        for n in state:
            for t in self._trans[n].get(b, ()):
                nxt |= self._node_closure[t]
        return frozenset(nxt) if nxt else None

    def is_complete(self, state) -> bool:
        return self._accept in state


class RegexGrammar(NfaGrammar):
    """Byte-level regex automaton for constrained decoding (the ``regex``
    sampling param — vLLM guided_regex / sglang regex analog). Compiles a
    practical, ASCII-oriented subset to a Thompson NFA.

    Supported syntax: literal characters (non-ASCII literals match their
    UTF-8 bytes in sequence), ``.`` (any byte except newline), escapes
    ``\\d \\w \\s \\n \\t \\r`` and literal-escapes (``\\. \\[`` …),
    character classes ``[a-z0-9_]`` with ranges and ``^`` negation (ASCII
    members only), grouping ``()``, alternation ``|``, and quantifiers
    ``* + ?`` / ``{m} {m,} {m,n}``. Matching is ANCHORED at both ends —
    the whole generated output must match, the only sensible contract for
    generation. EOS becomes legal exactly at accepting states."""

    def __init__(self, pattern: str):
        self.pattern = pattern
        super().__init__(self.parse_ast(pattern))

    @classmethod
    def parse_ast(cls, pattern: str):
        """Parse a pattern to the shared AST without building an NFA —
        the JSON-Schema compiler embeds string ``pattern`` constraints."""
        self = object.__new__(cls)
        ast, i = self._parse_alt(pattern, 0)
        if i != len(pattern):
            raise ValueError(f"regex: unexpected {pattern[i]!r} at {i}")
        return ast

    # -- parsing (recursive descent to a tuple AST) --

    def _parse_alt(self, p: str, i: int):
        branches = []
        node, i = self._parse_cat(p, i)
        branches.append(node)
        while i < len(p) and p[i] == "|":
            node, i = self._parse_cat(p, i + 1)
            branches.append(node)
        return (branches[0] if len(branches) == 1
                else ("alt", branches)), i

    def _parse_cat(self, p: str, i: int):
        items = []
        while i < len(p) and p[i] not in "|)":
            atom, i = self._parse_atom(p, i)
            atom, i = self._parse_quant(p, i, atom)
            items.append(atom)
        if len(items) == 1:
            return items[0], i
        return ("cat", items), i

    def _parse_atom(self, p: str, i: int):
        c = p[i]
        if c == "(":
            node, i = self._parse_alt(p, i + 1)
            if i >= len(p) or p[i] != ")":
                raise ValueError("regex: unbalanced '('")
            return node, i + 1
        if c == "[":
            return self._parse_class(p, i + 1)
        if c == ".":
            return ("class", self._ASCII - {0x0A}), i + 1
        if c == "\\":
            if i + 1 >= len(p):
                raise ValueError("regex: dangling backslash")
            return self._escape(p[i + 1]), i + 2
        if c in ")|*+?{":
            raise ValueError(f"regex: unexpected {c!r} at {i}")
        return self._literal(c), i + 1

    @staticmethod
    def _literal(c: str):
        bs = c.encode("utf-8")
        if len(bs) == 1:
            return ("lit", bs[0])
        return ("cat", [("lit", b) for b in bs])

    _ESCAPE_CLASSES = {
        "d": frozenset(b"0123456789"),
        "w": frozenset(b"abcdefghijklmnopqrstuvwxyz"
                       b"ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"),
        "s": frozenset(b" \t\n\r\f\v"),
    }
    _ESCAPE_LITERALS = {"n": 0x0A, "t": 0x09, "r": 0x0D}

    def _escape(self, c: str):
        if c in self._ESCAPE_CLASSES:
            return ("class", self._ESCAPE_CLASSES[c])
        if c.isupper() and c.lower() in self._ESCAPE_CLASSES:
            # Negated escapes complement within ASCII: bytes >= 0x80 are
            # UTF-8 fragments — legalizing a lone continuation byte would
            # let the engine emit invalid UTF-8 (see _ASCII note).
            return ("class",
                    self._ASCII - self._ESCAPE_CLASSES[c.lower()])
        if c in self._ESCAPE_LITERALS:
            return ("lit", self._ESCAPE_LITERALS[c])
        if c.isalnum():
            # \b \B \A \Z \G and friends carry regex SEMANTICS we don't
            # implement — silently compiling them as literal letters
            # would force-emit wrong output. Admission error instead.
            raise ValueError(f"regex: unsupported escape \\{c}")
        if ord(c) < 128:
            return ("lit", ord(c))   # escaped punctuation: literal
        raise ValueError(f"regex: unsupported escape \\{c}")

    def _parse_class(self, p: str, i: int):
        negate = i < len(p) and p[i] == "^"
        if negate:
            i += 1
        members = set()
        first = True
        while i < len(p) and (p[i] != "]" or first):
            first = False
            if p[i] == "\\":
                if i + 1 >= len(p):
                    raise ValueError("regex: dangling backslash in class")
                e = self._escape(p[i + 1])
                members |= (e[1] if e[0] == "class" else {e[1]})
                i += 2
                continue
            c = p[i]
            if ord(c) > 127:
                raise ValueError("regex: non-ASCII in character class")
            if i + 2 < len(p) and p[i + 1] == "-" and p[i + 2] != "]":
                hi = p[i + 2]
                if ord(hi) > 127 or ord(hi) < ord(c):
                    raise ValueError(f"regex: bad range {c}-{hi}")
                members |= set(range(ord(c), ord(hi) + 1))
                i += 3
            else:
                members.add(ord(c))
                i += 1
        if i >= len(p):
            raise ValueError("regex: unterminated '['")
        if negate:
            members = self._ASCII - members
        return ("class", frozenset(members)), i + 1

    def _parse_quant(self, p: str, i: int, atom):
        if i >= len(p):
            return atom, i
        c = p[i]
        if c == "*":
            return ("rep", atom, 0, None), i + 1
        if c == "+":
            return ("rep", atom, 1, None), i + 1
        if c == "?":
            return ("rep", atom, 0, 1), i + 1
        if c == "{":
            j = p.find("}", i)
            if j < 0:
                raise ValueError("regex: unterminated '{'")
            body = p[i + 1:j]
            try:
                if "," not in body:
                    lo = hi = int(body)
                else:
                    lo_s, hi_s = body.split(",", 1)
                    lo = int(lo_s)
                    hi = int(hi_s) if hi_s else None
            except ValueError:
                raise ValueError(f"regex: bad quantifier {{{body}}}") from None
            if hi is not None and hi < lo:
                raise ValueError(f"regex: bad quantifier {{{body}}}")
            return ("rep", atom, lo, hi), j + 1
        return atom, i

class JsonSchemaGrammar(NfaGrammar):
    """JSON-Schema-constrained output (xgrammar / vLLM guided_json /
    OpenAI ``response_format: json_schema`` analog): compiles a schema
    subset into the shared byte NFA, so the output both parses as JSON
    and validates against the schema. Emission is COMPACT JSON (no
    whitespace) — every property in declaration order.

    Supported keywords: ``type`` object (``properties`` all emitted, in
    order), string (``minLength``/``maxLength``/``pattern`` — the
    pattern uses the RegexGrammar subset), number, integer, boolean,
    null; ``enum``/``const`` of JSON scalars; array (``items``,
    ``minItems``/``maxItems``); ``anyOf``/``oneOf`` as alternation;
    nesting to depth 16. Unsupported keywords (``$ref``, ``allOf``,
    ``patternProperties``, …) raise ValueError at admission."""

    _MAX_DEPTH = 16
    _UNSUPPORTED = ("$ref", "allOf", "not", "patternProperties",
                    "if", "then", "else", "dependentSchemas")
    # Constraint keywords this compiler actually ENFORCES. Anything else
    # that could change which documents validate is rejected at admission
    # (a keyword silently ignored would emit output the client's schema
    # rejects — the worst possible structured-output failure).
    _HANDLED = frozenset({
        "type", "properties", "items", "minItems", "maxItems",
        "minLength", "maxLength", "pattern", "enum", "const",
        "anyOf", "oneOf", "required", "additionalProperties"})
    # Annotation keywords with no validation semantics: safe to ignore.
    _ANNOTATIONS = frozenset({
        "title", "description", "default", "examples", "$schema", "$id",
        "$comment", "deprecated", "readOnly", "writeOnly"})

    def __init__(self, schema: dict):
        if not isinstance(schema, dict):
            raise ValueError("json_schema must be an object")
        self.schema = schema
        super().__init__(self._value_ast(schema, 0))

    # -- AST builders --

    def _value_ast(self, schema, depth: int):
        if not isinstance(schema, dict):
            # Bool/None subschemas and other malformed shapes must be
            # ADMISSION errors (ValueError), never handler TypeErrors.
            raise ValueError(
                f"json_schema: subschema must be an object, got "
                f"{type(schema).__name__}")
        if depth > self._MAX_DEPTH:
            raise ValueError("json_schema: nesting too deep")
        for kw in self._UNSUPPORTED:
            if kw in schema:
                raise ValueError(f"json_schema: unsupported keyword {kw!r}")
        for kw in schema:
            if kw not in self._HANDLED and kw not in self._ANNOTATIONS:
                raise ValueError(
                    f"json_schema: unrecognized constraint keyword {kw!r}"
                    " — this compiler enforces "
                    f"{sorted(self._HANDLED)} and refuses to silently "
                    "ignore anything else")
        self._check_required(schema)
        if "const" in schema:
            return self._scalar_lit(schema["const"])
        if "enum" in schema:
            vals = schema["enum"]
            if not isinstance(vals, list) or not vals:
                raise ValueError("json_schema: enum must be a non-empty list")
            return ("alt", [self._scalar_lit(v) for v in vals])
        if "anyOf" in schema or "oneOf" in schema:
            subs = schema.get("anyOf") if "anyOf" in schema \
                else schema.get("oneOf")
            if not isinstance(subs, list) or not subs:
                raise ValueError(
                    "json_schema: anyOf/oneOf must be a non-empty list")
            return ("alt", [self._value_ast(s, depth + 1) for s in subs])
        t = schema.get("type")
        if isinstance(t, list):
            return ("alt", [self._value_ast({**schema, "type": one},
                                            depth + 1) for one in t])
        if t == "object":
            return self._object_ast(schema, depth)
        if t == "array":
            return self._array_ast(schema, depth)
        if t == "string":
            return self._string_ast(schema)
        if t == "integer":
            return self._number_ast(integer=True)
        if t == "number":
            return self._number_ast(integer=False)
        if t == "boolean":
            return ("alt", [self._lit_bytes(b"true"),
                            self._lit_bytes(b"false")])
        if t == "null":
            return self._lit_bytes(b"null")
        raise ValueError(f"json_schema: unsupported type {t!r}")

    @staticmethod
    def _check_required(schema: dict) -> None:
        """``required`` and ``additionalProperties`` are accepted exactly
        when the compiler's emission already satisfies them by
        construction (every declared property emitted, nothing else);
        shapes that would need real enforcement raise."""
        if "required" in schema:
            req = schema["required"]
            props = schema.get("properties") or {}
            if not isinstance(req, list) or not isinstance(props, dict) \
                    or not set(req) <= set(props):
                raise ValueError(
                    "json_schema: required must list declared properties "
                    "(all properties are always emitted, so anything else "
                    "is unsatisfiable)")
        if schema.get("additionalProperties", False) is not False:
            raise ValueError(
                "json_schema: additionalProperties must be false/absent — "
                "emission is closed over the declared properties")

    @staticmethod
    def _scalar_lit(v):
        if isinstance(v, (dict, list)):
            raise ValueError("json_schema: enum/const members must be "
                             "scalars")
        return NfaGrammar._lit_bytes(
            json.dumps(v, ensure_ascii=False,
                       separators=(",", ":")).encode("utf-8"))

    def _object_ast(self, schema: dict, depth: int):
        props = schema.get("properties") or {}
        if not isinstance(props, dict):
            raise ValueError("json_schema: properties must be an object")
        if not props:
            return self._lit_bytes(b"{}")
        parts = [self._lit_bytes(b"{")]
        for i, (key, sub) in enumerate(props.items()):
            if i:
                parts.append(("lit", 0x2C))                   # ,
            parts.append(self._lit_bytes(
                json.dumps(key, ensure_ascii=False).encode("utf-8")))
            parts.append(("lit", 0x3A))                       # :
            parts.append(self._value_ast(sub, depth + 1))
        parts.append(self._lit_bytes(b"}"))
        return ("cat", parts)

    def _array_ast(self, schema: dict, depth: int):
        # Missing "items" means "any value members" in JSON Schema — a
        # shape this subset cannot emit. Defaulting to array-of-strings
        # here would CONSTRAIN output to something the client's schema
        # never asked for (the silent-divergence failure this compiler
        # exists to refuse): raise at admission like every other
        # unsupported shape. An explicit null/bool items raises in
        # _value_ast.
        if "items" not in schema:
            raise ValueError(
                "json_schema: array without 'items' (any-value members) "
                "is unsupported — declare an item schema")
        item = self._value_ast(schema["items"], depth + 1)
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems")
        hi = int(hi) if hi is not None else None
        if lo < 0 or (hi is not None and hi < lo):
            raise ValueError("json_schema: bad minItems/maxItems")
        more = ("cat", [("lit", 0x2C), item])
        if lo == 0:
            nonempty = ("cat", [("lit", 0x5B), item,
                                ("rep", more, 0,
                                 None if hi is None else max(hi - 1, 0)),
                                ("lit", 0x5D)])
            if hi == 0:
                return self._lit_bytes(b"[]")
            return ("alt", [self._lit_bytes(b"[]"), nonempty])
        return ("cat", [("lit", 0x5B), item,
                        ("rep", more, lo - 1,
                         None if hi is None else hi - 1),
                        ("lit", 0x5D)])

    def _string_ast(self, schema: dict):
        if "pattern" in schema:
            # The pattern constrains the string CONTENT (anchored); the
            # compiler wraps it in quotes. Patterns that could match a
            # raw '"' or '\\' are the caller's foot-gun (same contract
            # as xgrammar).
            body = RegexGrammar.parse_ast(str(schema["pattern"]))
            return ("cat", [("lit", 0x22), body, ("lit", 0x22)])
        lo = int(schema.get("minLength", 0))
        hi = schema.get("maxLength")
        hi = int(hi) if hi is not None else None
        if lo < 0 or (hi is not None and hi < lo):
            raise ValueError("json_schema: bad minLength/maxLength")
        return ("cat", [("lit", 0x22),
                        ("rep", self._string_char(), lo, hi),
                        ("lit", 0x22)])

    @classmethod
    def _string_char(cls):
        """One JSON-string character: printable ASCII (minus quote and
        backslash), a JSON escape, or a STRICT multi-byte UTF-8 sequence
        (no overlongs, no surrogates — a mask must never force-sample
        bytes that cannot decode)."""
        ascii_ok = ("class", frozenset(range(0x20, 0x7F)) - {0x22, 0x5C})
        esc = ("cat", [("lit", 0x5C),
                       ("class", frozenset(b'"\\/bfnrt'))])
        uesc = ("cat", [("lit", 0x5C), ("lit", 0x75)]
               + [("class", frozenset(b"0123456789abcdefABCDEF"))] * 4)
        cont = ("class", frozenset(range(0x80, 0xC0)))
        two = ("cat", [("class", frozenset(range(0xC2, 0xE0))), cont])
        three = ("alt", [
            ("cat", [("lit", 0xE0),
                     ("class", frozenset(range(0xA0, 0xC0))), cont]),
            ("cat", [("class", frozenset(range(0xE1, 0xED))
                      | {0xEE, 0xEF}), cont, cont]),
            ("cat", [("lit", 0xED),
                     ("class", frozenset(range(0x80, 0xA0))), cont]),
        ])
        four = ("alt", [
            ("cat", [("lit", 0xF0),
                     ("class", frozenset(range(0x90, 0xC0))), cont, cont]),
            ("cat", [("class", frozenset(range(0xF1, 0xF4))),
                     cont, cont, cont]),
            ("cat", [("lit", 0xF4),
                     ("class", frozenset(range(0x80, 0x90))), cont, cont]),
        ])
        return ("alt", [ascii_ok, esc, uesc, two, three, four])

    @classmethod
    def _number_ast(cls, integer: bool):
        digit = ("class", frozenset(b"0123456789"))
        intpart = ("alt", [("lit", 0x30),
                           ("cat", [("class", frozenset(b"123456789")),
                                    ("rep", digit, 0, None)])])
        parts = [("rep", ("lit", 0x2D), 0, 1), intpart]
        if not integer:
            parts.append(("rep", ("cat", [("lit", 0x2E),
                                          ("rep", digit, 1, None)]), 0, 1))
            parts.append(("rep", ("cat", [
                ("class", frozenset(b"eE")),
                ("rep", ("class", frozenset(b"+-")), 0, 1),
                ("rep", digit, 1, None)]), 0, 1))
        return ("cat", parts)


class TokenTrie:
    """Byte-path trie over a token→bytes table, compiled once per
    tokenizer (the xgrammar move). Nodes are parallel lists:
    ``children[n]`` maps byte→child node, ``tokens[n]`` lists the token
    ids whose byte string ends at node n."""

    __slots__ = ("children", "tokens", "total_bytes")

    def __init__(self, token_bytes: List[Optional[bytes]]):
        self.children: List[dict] = [{}]
        self.tokens: List[list] = [[]]
        self.total_bytes = 0
        for tid, bs in enumerate(token_bytes):
            if not bs:
                continue
            self.total_bytes += len(bs)
            n = 0
            for b in bs:
                nxt = self.children[n].get(b)
                if nxt is None:
                    nxt = len(self.children)
                    self.children[n][b] = nxt
                    self.children.append({})
                    self.tokens.append([])
                n = nxt
            self.tokens[n].append(tid)


class TokenGrammar:
    """Lift a byte grammar over a token→bytes table.

    ``token_bytes[i]`` is the byte string token i appends, or None for
    tokens that must never appear inside constrained output (specials).
    ``eos_id`` is allowed exactly when the value is complete."""

    # Steady-state decoding revisits a few dozen states (string interior,
    # number digits, AFTER-gap, one per stack depth); masks are cached
    # bit-PACKED (V/8 bytes each) so even a full cache at a 100k vocab is
    # ~3 MB, not ~25 MB of bool arrays.
    MASK_CACHE_SIZE = 256

    def __init__(self, grammar, token_bytes: List[Optional[bytes]],
                 eos_id: Optional[int], trie: Optional[TokenTrie] = None):
        self.grammar = grammar
        self.token_bytes = token_bytes
        self.eos_id = eos_id
        self.V = len(token_bytes)
        # The trie depends only on the TOKENIZER — callers juggling many
        # grammars over one vocab (per-pattern regex cache) pass the one
        # shared instance instead of rebuilding O(vocab bytes) each time.
        self.trie = trie if trie is not None else TokenTrie(token_bytes)
        self._mask_cache: "OrderedDict[State, np.ndarray]" = OrderedDict()
        self.stats = {"mask_calls": 0, "mask_cache_hits": 0,
                      "advance_calls": 0}

    def initial(self) -> State:
        return self.grammar.initial()

    def advance_token(self, state: State, tok: int) -> Optional[State]:
        if tok == self.eos_id:
            return state if self.grammar.is_complete(state) else None
        bs = self.token_bytes[tok] if 0 <= tok < self.V else None
        if bs is None:
            return None
        for b in bs:
            state = self.grammar.advance(state, b)
            if state is None:
                return None
        return state

    def mask(self, state: State) -> np.ndarray:
        """[V] bool — tokens legal from ``state`` (EOS iff complete).
        Trie-walked and per-state memoized; callers own the returned
        array (a copy — masks are row-assigned into batch buffers)."""
        self.stats["mask_calls"] += 1
        cached = self._mask_cache.get(state)
        if cached is not None:
            self.stats["mask_cache_hits"] += 1
            self._mask_cache.move_to_end(state)
            return np.unpackbits(cached, count=self.V).astype(bool)
        out = np.zeros(self.V, bool)
        for toks, _ns in self._trie_walk(state):
            out[toks] = True
        if self.eos_id is not None and self.eos_id < self.V:
            out[self.eos_id] = self.grammar.is_complete(state)
        self._mask_cache[state] = np.packbits(out)
        if len(self._mask_cache) > self.MASK_CACHE_SIZE:
            self._mask_cache.popitem(last=False)
        return out

    def _trie_walk(self, state: State) -> List[Tuple[list, State]]:
        """(token ids, byte-grammar state) per trie node whose byte path
        is legal from ``state`` and ends at least one token. The SINGLE
        source of the legality walk: ``mask`` (which discards the states)
        and ``token_transitions`` (which keeps them) both consume it, so
        the table path's bit-identical-to-mask contract can't drift."""
        out: List[Tuple[list, State]] = []
        children = self.trie.children
        tokens = self.trie.tokens
        adv = self.grammar.advance
        n_adv = 0
        stack = [(0, state)]
        while stack:
            node, st = stack.pop()
            for b, child in children[node].items():
                n_adv += 1
                ns = adv(st, b)
                if ns is None:
                    continue
                toks = tokens[child]
                if toks:
                    out.append((toks, ns))
                if children[child]:
                    stack.append((child, ns))
        self.stats["advance_calls"] += n_adv
        return out

    def token_transitions(self, state: State) -> List[Tuple[int, State]]:
        """(token id, byte-grammar state after the token) for every
        non-special token legal from ``state``. EOS is NOT included (its
        transition is identity-on-complete; see ``advance_token``). The
        legal-token set is exactly ``mask(state)`` minus EOS — same walk,
        same trie (``_trie_walk``)."""
        return [(tid, ns) for toks, ns in self._trie_walk(state)
                for tid in toks]

    def _mask_probe(self, state: State) -> np.ndarray:
        """Reference implementation: probe every token's bytes from
        ``state``. O(total vocab bytes) — kept for exactness tests."""
        out = np.zeros(self.V, bool)
        adv = self.grammar.advance
        for i, bs in enumerate(self.token_bytes):
            if not bs:
                continue
            s = state
            ok = True
            for b in bs:
                s = adv(s, b)
                if s is None:
                    ok = False
                    break
            out[i] = ok
        if self.eos_id is not None and self.eos_id < self.V:
            out[self.eos_id] = self.grammar.is_complete(state)
        return out


@dataclasses.dataclass
class GrammarTable:
    """Token-level product automaton of (byte grammar × vocab), dense —
    the xgrammar-style device-resident form of a finite-state grammar.

    ``next_state[s, v]`` is the state after sampling token ``v`` in state
    ``s`` (−1 = illegal); ``legal[s, v]`` marks the tokens the grammar
    allows (EOS legal exactly at accepting states, where its transition is
    the identity — the engine finishes the row host-side, matching
    ``TokenGrammar.advance_token``'s keep-state-on-EOS contract). Row
    ``legal[s]`` equals the host path's ``mask(state)`` padded to the
    model vocab bit-for-bit: both come from the same trie walk, which is
    what makes fused table decode provably emit the host-synced stream.

    ``state_ids`` maps byte-grammar states to rows. It covers every state
    reachable from ``initial`` by WHOLE-token advances — the only states
    engine bookkeeping can ever hold (prefill, decode, PD injection, and
    preemption resume all advance token-at-a-time from initial)."""

    next_state: np.ndarray            # [S, V] int32, -1 = illegal
    legal: np.ndarray                 # [S, V] bool
    state_ids: Dict[State, int]       # byte-grammar state -> row
    initial_id: int = 0

    @property
    def num_states(self) -> int:
        return self.next_state.shape[0]

    @property
    def nbytes(self) -> int:
        return self.next_state.nbytes + self.legal.nbytes


def compile_token_table(tg: TokenGrammar, state_budget: int,
                        vocab_size: Optional[int] = None
                        ) -> Optional[GrammarTable]:
    """BFS the token-level automaton of ``tg`` into a ``GrammarTable``.

    Returns None when more than ``state_budget`` states are reachable —
    the caller keeps the host-synced mask path for that grammar. Intended
    for finite-state grammars (``NfaGrammar`` subclasses); a pushdown
    grammar (``JsonGrammar``) has unbounded reachable states and would
    simply exhaust the budget, so callers should gate on the grammar type
    and never pay the doomed BFS.

    ``vocab_size`` pads columns to the MODEL vocab (ids beyond the
    tokenizer's table are never legal — same contract as the engine's
    host-side ``_gmask`` padding). Memory: S × V × 5 bytes host-side
    (int32 + bool), uploaded once per (grammar, vocab) by the engine."""
    V = vocab_size if vocab_size is not None else tg.V
    g = tg.grammar
    init = tg.initial()
    states: List[State] = [init]
    ids: Dict[State, int] = {init: 0}
    rows_next: List[np.ndarray] = []
    rows_legal: List[np.ndarray] = []
    i = 0
    while i < len(states):
        st = states[i]
        nxt = np.full(V, -1, np.int32)
        legal = np.zeros(V, bool)
        for tok, ns in tg.token_transitions(st):
            if tok >= V:
                continue              # beyond the model vocab: never legal
            sid = ids.get(ns)
            if sid is None:
                if len(states) >= state_budget:
                    return None       # budget exceeded → host-synced path
                sid = len(states)
                ids[ns] = sid
                states.append(ns)
            nxt[tok] = sid
            legal[tok] = True
        if (tg.eos_id is not None and tg.eos_id < V
                and g.is_complete(st)):
            legal[tg.eos_id] = True
            nxt[tg.eos_id] = i        # EOS keeps the state; host finishes
        rows_next.append(nxt)
        rows_legal.append(legal)
        i += 1
    return GrammarTable(next_state=np.stack(rows_next),
                        legal=np.stack(rows_legal), state_ids=ids)


def token_bytes_for(tokenizer) -> List[Optional[bytes]]:
    """Build the token→bytes table for a tokenizer. The byte tokenizer
    maps id i (< 256) to byte i DIRECTLY — decode() would turn a lone
    UTF-8 continuation byte into U+FFFD and corrupt the table. Other
    tokenizers fall back to per-token decode (adequate for grammar
    probing; specials map to None)."""
    from rbg_tpu_torch.engine.tokenizer import ByteTokenizer

    vocab = tokenizer.vocab_size
    specials = {getattr(tokenizer, a, None)
                for a in ("bos_id", "eos_id", "pad_id")}
    table: List[Optional[bytes]] = []
    if isinstance(tokenizer, ByteTokenizer):
        for i in range(vocab):
            table.append(bytes([i]) if i < 256 and i not in specials
                         else None)
        return table
    for i in range(vocab):
        if i in specials:
            table.append(None)
            continue
        try:
            s = tokenizer.decode([i])
        except Exception:   # noqa: BLE001 — unknown id quirks → unusable
            table.append(None)
            continue
        table.append(s.encode("utf-8", errors="ignore") or None)
    return table
