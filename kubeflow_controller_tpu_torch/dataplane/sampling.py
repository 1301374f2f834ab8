"""Sampling subsystem: per-request sampling params and constrained decoding.

Counterpart of ``kubeflow_controller_tpu/dataplane/sampling.py`` (host
numpy code; the port keeps its own copy). This module is the host half
of the sampling subsystem; the device half lives in
``models/generate.py`` (``sample_step_slots`` — per-row
temperature/top-k/top-p filtering and a categorical draw under a
counter-based per-request key, ``ops/prng.py``). Here we define:

* :class:`SamplingParams` — the per-request knobs carried on
  ``serving_engine.Request``. ``temperature <= 0`` means greedy
  (argmax).

* The **RNG keying contract**: token ``i`` (0-based, counted over the
  *generated* stream, prompt excluded) of generation ``g`` of a request
  with seed ``s`` is drawn with key::

      fold_in(fold_in(PRNGKey(s), g), i)

  The key depends only on ``(seed, gen, position)`` — never on the step
  index, batch composition, slot id, or engine config — so a sampled
  stream is bit-reproducible across admission order, churn, slot
  shuffles and chunked vs exact prefill, and equals the JAX engine's
  stream for the same request.

* The **logit-mask hook**: a small incremental-automaton API
  (:class:`LogitMask`) applied before argmax/sample. Three walkers ship:
  :class:`TokenSetMask` (static allow-list), :class:`RegexTokenMask`
  (Thompson-NFA over a regex subset), and :class:`JsonTokenMask`
  (character-level pushdown automaton accepting exactly the JSON value
  grammar). Masks operate over a *token alphabet*: ``token_strs[t]`` is
  the text of token id ``t``. The repo has no tokenizer, so
  :func:`default_token_strs` maps token id ``t`` to the printable ASCII
  character ``chr(32 + t % 95)``.

The walkers are incremental: ``allowed(state)`` returns a boolean vocab
vector for the *next* token only, and ``advance(state, tok)`` consumes
the booked token. Allowed-vectors are memoised per automaton state, so
steady-state masking costs one dict lookup per token.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "SamplingParams",
    "LogitMask",
    "TokenSetMask",
    "RegexTokenMask",
    "JsonTokenMask",
    "default_token_strs",
    "make_mask",
]


# ---------------------------------------------------------------------------
# Sampling parameters
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    ``temperature <= 0`` selects greedy decoding (argmax); ``top_k == 0``
    and ``top_p >= 1`` disable the respective filters, mirroring
    ``models.generate._filter_logits``.  ``n`` requests that many
    parallel generations of the same prompt (prefill paid once; KV pages
    shared copy-on-write).  ``seed`` pins the RNG stream per the keying
    contract in the module docstring.  ``max_tokens``, when set,
    overrides the request's ``max_new_tokens``.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    n: int = 1
    seed: int = 0
    max_tokens: Optional[int] = None
    logit_mask: Optional["LogitMask"] = None

    def validate(self) -> None:
        if not np.isfinite(self.temperature) or self.temperature < 0.0:
            raise ValueError(
                f"temperature must be finite and >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.n < 1:
            raise ValueError(f"n must be >= 1, got {self.n}")
        if self.seed < 0:
            raise ValueError(f"seed must be >= 0, got {self.seed}")
        if self.max_tokens is not None and self.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {self.max_tokens}")

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


# ---------------------------------------------------------------------------
# Logit-mask hook
# ---------------------------------------------------------------------------


class LogitMask:
    """Incremental constrained-decoding automaton.

    The engine holds one opaque ``state`` per slot.  Before each sample
    it asks ``allowed(state)`` for a boolean ``[vocab]`` vector (tokens
    outside it get ``-inf`` logits); after booking token ``t`` it calls
    ``advance(state, t)``.  ``is_complete(state)`` reports whether the
    stream so far forms a complete utterance of the grammar — the eos
    token is only ever allowed at complete states.
    """

    vocab_size: int

    def init_state(self):
        raise NotImplementedError

    def allowed(self, state) -> np.ndarray:
        """Boolean ``[vocab_size]`` vector of next-token admissibility."""
        raise NotImplementedError

    def advance(self, state, token: int):
        raise NotImplementedError

    def is_complete(self, state) -> bool:
        raise NotImplementedError


class TokenSetMask(LogitMask):
    """Static allow-list: every emitted token must be in ``allowed_ids``.

    ``eos_id`` (if given) is always admissible, so constrained requests
    can terminate.  Stateless: any stream over the set is "complete".
    """

    def __init__(self, vocab_size: int, allowed_ids: Sequence[int],
                 eos_id: Optional[int] = None):
        self.vocab_size = int(vocab_size)
        vec = np.zeros(self.vocab_size, dtype=bool)
        ids = np.asarray(list(allowed_ids), dtype=np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.vocab_size):
            raise ValueError("allowed_ids out of vocab range")
        vec[ids] = True
        if eos_id is not None and eos_id >= 0:
            vec[eos_id] = True
        if not vec.any():
            raise ValueError("TokenSetMask must allow at least one token")
        self._vec = vec

    def init_state(self):
        return None

    def allowed(self, state) -> np.ndarray:
        return self._vec

    def advance(self, state, token: int):
        return state

    def is_complete(self, state) -> bool:
        return True


def default_token_strs(vocab_size: int) -> List[str]:
    """Token alphabet used when no tokenizer exists: id ``t`` reads as the
    printable ASCII character ``chr(32 + t % 95)``."""
    return [chr(32 + t % 95) for t in range(vocab_size)]


class _CharMask(LogitMask):
    """Shared machinery for character-automaton masks over a token
    alphabet.  Subclasses provide ``_initial()``, ``_feed(state, ch)``
    (``None`` = dead) and ``_accepting(state)``; states must be hashable.
    """

    def __init__(self, vocab_size: int, token_strs: Optional[Sequence[str]],
                 eos_id: Optional[int]):
        self.vocab_size = int(vocab_size)
        if token_strs is None:
            token_strs = default_token_strs(self.vocab_size)
        if len(token_strs) != self.vocab_size:
            raise ValueError("token_strs length must equal vocab_size")
        self._strs = list(token_strs)
        self._eos = int(eos_id) if eos_id is not None else -1
        self._mask_cache: Dict[object, np.ndarray] = {}

    # -- subclass hooks ----------------------------------------------------
    def _initial(self):
        raise NotImplementedError

    def _feed(self, state, ch: str):
        raise NotImplementedError

    def _accepting(self, state) -> bool:
        raise NotImplementedError

    # -- LogitMask API -----------------------------------------------------
    def init_state(self):
        return self._initial()

    def _feed_str(self, state, s: str):
        for ch in s:
            state = self._feed(state, ch)
            if state is None:
                return None
        return state

    def allowed(self, state) -> np.ndarray:
        vec = self._mask_cache.get(state)
        if vec is not None:
            return vec
        vec = np.zeros(self.vocab_size, dtype=bool)
        for t, s in enumerate(self._strs):
            if t == self._eos:
                continue
            if s and self._feed_str(state, s) is not None:
                vec[t] = True
        if self._eos >= 0 and self._accepting(state):
            vec[self._eos] = True
        if not vec.any() and self._eos >= 0:
            # Dead end the vocabulary cannot extend: allow termination
            # rather than sampling from an empty support.
            vec[self._eos] = True
        self._mask_cache[state] = vec
        return vec

    def advance(self, state, token: int):
        if token == self._eos:
            return state
        nxt = self._feed_str(state, self._strs[token])
        if nxt is None:
            raise ValueError(
                f"token {token} ({self._strs[token]!r}) is not admissible "
                "from the current grammar state")
        return nxt

    def is_complete(self, state) -> bool:
        return self._accepting(state)


# -- Regex subset: Thompson NFA ---------------------------------------------


class _RegexProgram:
    """Thompson construction over the subset: literals, ``.``,
    ``[...]``/``[^...]`` (with ranges), ``*``, ``+``, ``?``, ``|``, and
    ``(...)`` grouping.  Anchored at both ends (whole-string match)."""

    def __init__(self, pattern: str):
        self._pat = pattern
        self._pos = 0
        self._eps: Dict[int, List[int]] = {}
        # state -> list of (charset_or_None, dst); None matches any char
        self._edges: Dict[int, List[Tuple[Optional[FrozenSet[str]], int]]] = {}
        self._n = 0
        start, end = self._alt()
        if self._pos != len(pattern):
            raise ValueError(f"unexpected {pattern[self._pos]!r} at "
                             f"{self._pos} in regex {pattern!r}")
        self.accept = end
        self.start = self._closure(frozenset([start]))

    def _new(self) -> int:
        self._n += 1
        return self._n - 1

    def _link(self, a: int, b: int) -> None:
        self._eps.setdefault(a, []).append(b)

    def _edge(self, a: int, charset: Optional[FrozenSet[str]], b: int) -> None:
        self._edges.setdefault(a, []).append((charset, b))

    # grammar: alt := cat ('|' cat)* ; cat := rep* ; rep := atom [*+?]
    def _alt(self) -> Tuple[int, int]:
        s, e = self._cat()
        while self._pos < len(self._pat) and self._pat[self._pos] == "|":
            self._pos += 1
            s2, e2 = self._cat()
            ns, ne = self._new(), self._new()
            self._link(ns, s)
            self._link(ns, s2)
            self._link(e, ne)
            self._link(e2, ne)
            s, e = ns, ne
        return s, e

    def _cat(self) -> Tuple[int, int]:
        s = self._new()
        e = s
        while self._pos < len(self._pat) and self._pat[self._pos] not in "|)":
            s2, e2 = self._rep()
            self._link(e, s2)
            e = e2
        return s, e

    def _rep(self) -> Tuple[int, int]:
        s, e = self._atom()
        if self._pos < len(self._pat) and self._pat[self._pos] in "*+?":
            op = self._pat[self._pos]
            self._pos += 1
            ns, ne = self._new(), self._new()
            self._link(ns, s)
            if op in "*?":
                self._link(ns, ne)
            self._link(e, ne)
            if op in "*+":
                self._link(e, s)
            s, e = ns, ne
        return s, e

    def _atom(self) -> Tuple[int, int]:
        if self._pos >= len(self._pat):
            raise ValueError(f"regex {self._pat!r} ends mid-atom")
        ch = self._pat[self._pos]
        if ch == "(":
            self._pos += 1
            s, e = self._alt()
            if self._pos >= len(self._pat) or self._pat[self._pos] != ")":
                raise ValueError(f"unbalanced '(' in regex {self._pat!r}")
            self._pos += 1
            return s, e
        s, e = self._new(), self._new()
        if ch == "[":
            self._edge(s, self._charclass(), e)
        elif ch == ".":
            self._pos += 1
            self._edge(s, None, e)
        elif ch == "\\":
            if self._pos + 1 >= len(self._pat):
                raise ValueError("trailing backslash in regex")
            self._edge(s, frozenset(self._pat[self._pos + 1]), e)
            self._pos += 2
        elif ch in "*+?)":
            raise ValueError(f"misplaced {ch!r} in regex {self._pat!r}")
        else:
            self._edge(s, frozenset(ch), e)
            self._pos += 1
        return s, e

    def _charclass(self) -> Optional[FrozenSet[str]]:
        # self._pat[self._pos] == '['
        self._pos += 1
        negate = self._pos < len(self._pat) and self._pat[self._pos] == "^"
        if negate:
            self._pos += 1
        chars: set = set()
        while self._pos < len(self._pat) and self._pat[self._pos] != "]":
            c = self._pat[self._pos]
            if c == "\\" and self._pos + 1 < len(self._pat):
                self._pos += 1
                c = self._pat[self._pos]
            if (self._pos + 2 < len(self._pat)
                    and self._pat[self._pos + 1] == "-"
                    and self._pat[self._pos + 2] != "]"):
                lo, hi = ord(c), ord(self._pat[self._pos + 2])
                chars.update(chr(x) for x in range(lo, hi + 1))
                self._pos += 3
            else:
                chars.add(c)
                self._pos += 1
        if self._pos >= len(self._pat):
            raise ValueError(f"unbalanced '[' in regex {self._pat!r}")
        self._pos += 1  # ']'
        if negate:
            # Complement over printable ASCII — the default token alphabet.
            universe = {chr(x) for x in range(32, 127)}
            return frozenset(universe - chars)
        return frozenset(chars)

    def _closure(self, states: FrozenSet[int]) -> FrozenSet[int]:
        out = set(states)
        stack = list(states)
        while stack:
            s = stack.pop()
            for t in self._eps.get(s, ()):
                if t not in out:
                    out.add(t)
                    stack.append(t)
        return frozenset(out)

    def step(self, states: FrozenSet[int], ch: str) -> FrozenSet[int]:
        nxt = set()
        for s in states:
            for charset, dst in self._edges.get(s, ()):
                if charset is None or ch in charset:
                    nxt.add(dst)
        if not nxt:
            return frozenset()
        return self._closure(frozenset(nxt))


class RegexTokenMask(_CharMask):
    """Constrain the generated text to (a prefix-extensible path through)
    a regex.  A token is admissible iff appending its characters keeps
    the NFA alive; eos is admissible iff the text so far fully matches.
    """

    def __init__(self, pattern: str, vocab_size: int,
                 token_strs: Optional[Sequence[str]] = None,
                 eos_id: Optional[int] = None):
        super().__init__(vocab_size, token_strs, eos_id)
        self._nfa = _RegexProgram(pattern)

    def _initial(self):
        return self._nfa.start

    def _feed(self, state, ch):
        nxt = self._nfa.step(state, ch)
        return nxt if nxt else None

    def _accepting(self, state) -> bool:
        return self._nfa.accept in state


# -- JSON grammar: character-level pushdown automaton -----------------------

_WS = " \t\n\r"
_DIGITS = "0123456789"
# number modes in which the number read so far is already a valid literal
_NUM_DONE = ("N0", "ND", "NF", "NED")


class JsonTokenMask(_CharMask):
    """Constrain output to exactly one JSON value (RFC 8259 grammar,
    ``\\uXXXX`` escapes included).  State is ``(mode, stack, lit)`` where
    ``stack`` tracks open containers and ``lit`` the unread tail of a
    ``true``/``false``/``null`` literal or hex-escape countdown."""

    def __init__(self, vocab_size: int,
                 token_strs: Optional[Sequence[str]] = None,
                 eos_id: Optional[int] = None,
                 max_depth: int = 32):
        super().__init__(vocab_size, token_strs, eos_id)
        self._max_depth = max_depth

    def _initial(self):
        return ("V", (), "")

    def _accepting(self, state) -> bool:
        mode, stack, _ = state
        return not stack and (mode == "A" or mode in _NUM_DONE)

    def _feed(self, state, ch):  # noqa: C901 - one branch per PDA mode
        mode, stack, lit = state
        if mode in ("V", "V]"):
            if ch in _WS:
                return state
            if mode == "V]" and ch == "]":
                return ("A", stack[:-1], "")
            if ch == '"':
                return ("S", stack, "")
            if ch == "{":
                if len(stack) >= self._max_depth:
                    return None
                return ("K1", stack + ("{",), "")
            if ch == "[":
                if len(stack) >= self._max_depth:
                    return None
                return ("V]", stack + ("[",), "")
            if ch == "-":
                return ("NI", stack, "")
            if ch == "0":
                return ("N0", stack, "")
            if ch in "123456789":
                return ("ND", stack, "")
            if ch == "t":
                return ("L", stack, "rue")
            if ch == "f":
                return ("L", stack, "alse")
            if ch == "n":
                return ("L", stack, "ull")
            return None
        if mode == "L":
            if lit and ch == lit[0]:
                rest = lit[1:]
                return ("A", stack, "") if not rest else ("L", stack, rest)
            return None
        if mode in ("S", "KS"):
            if ch == '"':
                return ("A", stack, "") if mode == "S" else ("C", stack, "")
            if ch == "\\":
                return ("SE" if mode == "S" else "KSE", stack, "")
            if " " <= ch:  # no raw control characters inside strings
                return (mode, stack, "")
            return None
        if mode in ("SE", "KSE"):
            tgt = "S" if mode == "SE" else "KS"
            if ch == "u":
                return ("U" if tgt == "S" else "KU", stack, "4")
            if ch in '"\\/bfnrt':
                return (tgt, stack, "")
            return None
        if mode in ("U", "KU"):
            if ch in "0123456789abcdefABCDEF":
                n = int(lit) - 1
                tgt = "S" if mode == "U" else "KS"
                return (tgt, stack, "") if n == 0 else (mode, stack, str(n))
            return None
        if mode in ("K1", "K"):
            if ch in _WS:
                return state
            if ch == '"':
                return ("KS", stack, "")
            if mode == "K1" and ch == "}":
                return ("A", stack[:-1], "")
            return None
        if mode == "C":
            if ch in _WS:
                return state
            if ch == ":":
                return ("V", stack, "")
            return None
        if mode == "A":
            if ch in _WS:
                return state
            if stack:
                if stack[-1] == "{":
                    if ch == ",":
                        return ("K", stack, "")
                    if ch == "}":
                        return ("A", stack[:-1], "")
                else:
                    if ch == ",":
                        return ("V", stack, "")
                    if ch == "]":
                        return ("A", stack[:-1], "")
            return None
        # number modes
        if mode == "NI":
            if ch == "0":
                return ("N0", stack, "")
            if ch in "123456789":
                return ("ND", stack, "")
            return None
        if mode == "N0":
            if ch == ".":
                return ("NF0", stack, "")
            if ch in "eE":
                return ("NE", stack, "")
            return self._feed(("A", stack, ""), ch)
        if mode == "ND":
            if ch in _DIGITS:
                return ("ND", stack, "")
            if ch == ".":
                return ("NF0", stack, "")
            if ch in "eE":
                return ("NE", stack, "")
            return self._feed(("A", stack, ""), ch)
        if mode == "NF0":
            return ("NF", stack, "") if ch in _DIGITS else None
        if mode == "NF":
            if ch in _DIGITS:
                return ("NF", stack, "")
            if ch in "eE":
                return ("NE", stack, "")
            return self._feed(("A", stack, ""), ch)
        if mode == "NE":
            if ch in "+-":
                return ("NES", stack, "")
            return ("NED", stack, "") if ch in _DIGITS else None
        if mode == "NES":
            return ("NED", stack, "") if ch in _DIGITS else None
        if mode == "NED":
            if ch in _DIGITS:
                return ("NED", stack, "")
            return self._feed(("A", stack, ""), ch)
        return None


# ---------------------------------------------------------------------------
# Factory
# ---------------------------------------------------------------------------


def make_mask(spec: str, vocab_size: int,
              token_strs: Optional[Sequence[str]] = None,
              eos_id: Optional[int] = None) -> LogitMask:
    """Build a :class:`LogitMask` from a CLI-style spec string.

    * ``"json"`` — :class:`JsonTokenMask`
    * ``"re:<pattern>"`` — :class:`RegexTokenMask`
    * ``"set:1,2,3"`` — :class:`TokenSetMask` over the listed token ids
    """
    if spec == "json":
        return JsonTokenMask(vocab_size, token_strs, eos_id)
    if spec.startswith("re:"):
        return RegexTokenMask(spec[3:], vocab_size, token_strs, eos_id)
    if spec.startswith("set:"):
        try:
            ids = [int(x) for x in spec[4:].split(",") if x.strip()]
        except ValueError as e:
            raise ValueError(f"bad set spec {spec!r}: {e}") from None
        return TokenSetMask(vocab_size, ids, eos_id)
    raise ValueError(
        f"unknown grammar spec {spec!r} (expected 'json', 're:<pattern>', "
        "or 'set:<ids>')")
