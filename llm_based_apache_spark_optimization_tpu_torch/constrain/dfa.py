"""Regular-language machinery for the grammar-constrained decoder.

The constrained decoder needs the SQL subset as a *deterministic* automaton:
the per-step vocabulary mask is "which tokens keep the automaton alive from
the current state", and determinism is what makes that a single table row
per state instead of a frontier of possibilities. This module is the small,
dependency-free compiler that gets us there:

    AST combinators (Lit/Chars/Seq/Alt/Star/Opt)
      -> Thompson NFA (epsilon transitions, per-char edges)
      -> subset-construction DFA (dict transitions over the char alphabet)
      -> trim (reachable AND co-reachable states only)

plus `difference(a, b)` — the product construction for L(a) \\ L(b) — which
grammar.py uses to carve reserved keywords OUT of the identifier language
(otherwise `SELECT x FROM from` would be grammar-valid: `from` matches the
generic identifier regex, but every real SQL engine and the in-tree
reference parser treat it as a keyword). A trimmed DFA re-enters the
combinator algebra via `Auto`, so the keyword-free identifier automaton
plugs into the grammar like any other fragment.

Everything here is compile-time host code (runs once per grammar at load);
nothing runs on the device. The token-level tables the decode loops consume
are built on top of this in masks.py.

A copy of the JAX package's `constrain/dfa.py` (pure Python): the port
imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Tuple


# ------------------------------------------------------------------ AST ----


class Re:
    """Base class for regex AST nodes (combinator surface)."""

    __slots__ = ()


@dataclasses.dataclass(frozen=True)
class Lit(Re):
    """Exact literal string."""

    text: str


@dataclasses.dataclass(frozen=True)
class Chars(Re):
    """One character from a set."""

    chars: FrozenSet[str]

    def __init__(self, chars):
        object.__setattr__(self, "chars", frozenset(chars))


class Seq(Re):
    __slots__ = ("parts",)

    def __init__(self, *parts: Re):
        self.parts = tuple(parts)


class Alt(Re):
    __slots__ = ("parts",)

    def __init__(self, *parts: Re):
        self.parts = tuple(parts)


@dataclasses.dataclass(frozen=True)
class Star(Re):
    part: Re


@dataclasses.dataclass(frozen=True)
class Opt(Re):
    part: Re


def Plus(part: Re) -> Re:
    return Seq(part, Star(part))


@dataclasses.dataclass(frozen=True)
class Auto(Re):
    """Embed an already-compiled DFA as a fragment (e.g. the
    identifier-minus-keywords automaton from `difference`)."""

    dfa: "CharDfa"


# ------------------------------------------------------------------ DFA ----


@dataclasses.dataclass(frozen=True)
class CharDfa:
    """Deterministic automaton over single characters.

    `trans[s]` maps char -> next state; a missing char is the implicit dead
    sink. States are dense ints [0, num_states).
    """

    start: int
    accepting: FrozenSet[int]
    trans: Tuple[Dict[str, int], ...]

    @property
    def num_states(self) -> int:
        return len(self.trans)

    @property
    def alphabet(self) -> FrozenSet[str]:
        chars: set = set()
        for t in self.trans:
            chars.update(t)
        return frozenset(chars)

    def accepts(self, text: str) -> bool:
        s = self.start
        for ch in text:
            nxt = self.trans[s].get(ch)
            if nxt is None:
                return False
            s = nxt
        return s in self.accepting

    def live_after(self, text: str) -> bool:
        """True iff `text` is a prefix of SOME accepted string (the DFA is
        trimmed, so merely surviving the walk means a completion exists)."""
        s = self.start
        for ch in text:
            nxt = self.trans[s].get(ch)
            if nxt is None:
                return False
            s = nxt
        return True


# ----------------------------------------------------------------- NFA -----


class _Nfa:
    """Thompson NFA under construction: per-state epsilon sets and
    per-state {char: set(dst)} edges."""

    def __init__(self):
        self.eps: List[set] = []
        self.edges: List[Dict[str, set]] = []

    def state(self) -> int:
        self.eps.append(set())
        self.edges.append({})
        return len(self.eps) - 1

    def add_eps(self, a: int, b: int) -> None:
        self.eps[a].add(b)

    def add_edge(self, a: int, ch: str, b: int) -> None:
        self.edges[a].setdefault(ch, set()).add(b)

    def build(self, node: Re) -> Tuple[int, int]:
        """Compile `node` into a (start, end) fragment."""
        if isinstance(node, Lit):
            start = cur = self.state()
            for ch in node.text:
                nxt = self.state()
                self.add_edge(cur, ch, nxt)
                cur = nxt
            return start, cur
        if isinstance(node, Chars):
            if not node.chars:
                raise ValueError("empty character class")
            a, b = self.state(), self.state()
            for ch in node.chars:
                self.add_edge(a, ch, b)
            return a, b
        if isinstance(node, Seq):
            a = end = self.state()
            for part in node.parts:
                s, e = self.build(part)
                self.add_eps(end, s)
                end = e
            return a, end
        if isinstance(node, Alt):
            if not node.parts:
                raise ValueError("empty alternation")
            a, b = self.state(), self.state()
            for part in node.parts:
                s, e = self.build(part)
                self.add_eps(a, s)
                self.add_eps(e, b)
            return a, b
        if isinstance(node, Star):
            # Fresh start AND end states (full Thompson construction): the
            # returned end must have no outgoing char edges, or a parent
            # Opt/Seq's skip-epsilon would land on the loop state and admit
            # extra iterations of the starred characters ("FROM taxi3"
            # via a skipped LIMIT clause — caught by the schema grammar).
            s, e = self.build(node.part)
            a, b = self.state(), self.state()
            self.add_eps(a, s)
            self.add_eps(a, b)
            self.add_eps(e, s)
            self.add_eps(e, b)
            return a, b
        if isinstance(node, Opt):
            # Same discipline: fresh endpoints, never an epsilon welded
            # across a reused fragment state.
            s, e = self.build(node.part)
            a, b = self.state(), self.state()
            self.add_eps(a, s)
            self.add_eps(a, b)
            self.add_eps(e, b)
            return a, b
        if isinstance(node, Auto):
            dfa = node.dfa
            base = [self.state() for _ in range(dfa.num_states)]
            end = self.state()
            for i, t in enumerate(dfa.trans):
                for ch, j in t.items():
                    self.add_edge(base[i], ch, base[j])
            for acc in dfa.accepting:
                self.add_eps(base[acc], end)
            return base[dfa.start], end
        raise TypeError(f"not a regex node: {node!r}")

    def eps_closure(self, states: FrozenSet[int]) -> FrozenSet[int]:
        stack, seen = list(states), set(states)
        while stack:
            s = stack.pop()
            for t in self.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)


# ------------------------------------------------------------- compile -----


def compile_dfa(node: Re) -> CharDfa:
    """AST -> trimmed CharDfa (subset construction)."""
    nfa = _Nfa()
    start, accept = nfa.build(node)

    start_set = nfa.eps_closure(frozenset({start}))
    index: Dict[FrozenSet[int], int] = {start_set: 0}
    order = [start_set]
    trans: List[Dict[str, int]] = [{}]
    queue = [start_set]
    while queue:
        cur = queue.pop()
        i = index[cur]
        moves: Dict[str, set] = {}
        for s in cur:
            for ch, dsts in nfa.edges[s].items():
                moves.setdefault(ch, set()).update(dsts)
        for ch, dsts in moves.items():
            nxt = nfa.eps_closure(frozenset(dsts))
            j = index.get(nxt)
            if j is None:
                j = len(order)
                index[nxt] = j
                order.append(nxt)
                trans.append({})
                queue.append(nxt)
            trans[i][ch] = j
    accepting = frozenset(
        i for i, states in enumerate(order) if accept in states
    )
    return trim(CharDfa(start=0, accepting=accepting, trans=tuple(trans)))


def trim(dfa: CharDfa) -> CharDfa:
    """Keep only states reachable from start AND able to reach accepting
    (so surviving a walk == a completion exists — masks.py relies on it)."""
    n = dfa.num_states
    reach = {dfa.start}
    stack = [dfa.start]
    while stack:
        s = stack.pop()
        for j in dfa.trans[s].values():
            if j not in reach:
                reach.add(j)
                stack.append(j)
    # Co-reachability over reversed edges.
    rev: List[set] = [set() for _ in range(n)]
    for i, t in enumerate(dfa.trans):
        for j in t.values():
            rev[j].add(i)
    co = set(dfa.accepting)
    stack = list(co)
    while stack:
        s = stack.pop()
        for p in rev[s]:
            if p not in co:
                co.add(p)
                stack.append(p)
    keep = sorted(reach & co)
    if dfa.start not in keep:
        raise ValueError("grammar matches no string at all")
    remap = {old: new for new, old in enumerate(keep)}
    trans = tuple(
        {ch: remap[j] for ch, j in dfa.trans[old].items() if j in remap}
        for old in keep
    )
    return CharDfa(
        start=remap[dfa.start],
        accepting=frozenset(remap[s] for s in dfa.accepting if s in remap),
        trans=trans,
    )


def difference(a: CharDfa, b: CharDfa) -> CharDfa:
    """Trimmed DFA for L(a) \\ L(b) (product construction; `b` runs with an
    explicit dead sink so the product is total over a's alphabet)."""
    dead = b.num_states  # b's sink

    def b_step(s: int, ch: str) -> int:
        if s == dead:
            return dead
        return b.trans[s].get(ch, dead)

    index: Dict[Tuple[int, int], int] = {(a.start, b.start): 0}
    order = [(a.start, b.start)]
    trans: List[Dict[str, int]] = [{}]
    queue = [(a.start, b.start)]
    while queue:
        sa, sb = cur = queue.pop()
        i = index[cur]
        for ch, ja in a.trans[sa].items():
            nxt = (ja, b_step(sb, ch))
            j = index.get(nxt)
            if j is None:
                j = len(order)
                index[nxt] = j
                order.append(nxt)
                trans.append({})
                queue.append(nxt)
            trans[i][ch] = j
    accepting = frozenset(
        i for i, (sa, sb) in enumerate(order)
        if sa in a.accepting and sb not in b.accepting
    )
    return trim(CharDfa(start=0, accepting=accepting, trans=tuple(trans)))
