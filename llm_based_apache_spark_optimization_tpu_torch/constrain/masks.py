"""Token-level vocabulary masks: the char DFA lifted onto a tokenizer.

This is the layer the decode loops actually consume. Compilation happens
ONCE per (tokenizer, grammar, stop-ids) triple — cached in-module — and
produces four dense tables over DFA states S and tokenizer vocab V:

    mask[s, t]        True iff emitting token t from state s keeps the
                      automaton alive (a completion still exists)
    next_state[s, t]  the state after emitting t (frozen for dead pairs)
    dist[s]           tokens on the shortest path from s to an accepting
                      state (0 at accepting)
    need[s, t]        tokens required to FINISH if t is emitted now:
                      1 + dist[next] + 1 (one for t, the shortest path to
                      accept, one for the stop id), or exactly 1 for a
                      stop id at an accepting state; huge for dead pairs.
                      The decode-time mask is just `need <= remaining
                      budget` — a token that would start an identifier too
                      long to ever close is masked the moment it stops
                      fitting, which guarantees every constrained
                      completion is a COMPLETE parse (never a truncated
                      prefix) whenever max_new >= min_new_tokens.

Row 0 of every table is the reserved UNCONSTRAINED sentinel (all tokens
allowed, self-loop, dist 0): a state value of 0 means "no grammar", which
is what lets the continuous-batching scheduler serve mixed
constrained/unconstrained batches in one decode step — the per-slot state
is just an int32, and unconstrained slots sit at 0.

The numpy compiler (`compile_token_masks`, `CompiledMask`, `get_constraint`
and its LRU) is a copy of the JAX package's `constrain/masks.py`. The
device side is the port's own: `device_tables` keeps (next, need) at the
TOKENIZER's width on a torch device instead of padding them to the
model's logits width (a 26k-state grammar padded to a 32000-id vocabulary
is 6.7 GB; at a 259-id byte tokenizer it is 54 MB). A logits column at or
past the tokenizer's width follows the padded tables' rule without
storing it: allowed only in the sentinel row (need 1), and it freezes the
state. `allowed_tokens` and `advance_states` are the two per-step ops the
decode loops run (a gather and a compare; one gather), and
`fsm_advance_chain` threads per-position states through a drafted chain
for speculative decoding.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from .dfa import CharDfa
from .grammar import grammar_fingerprint, spark_sql_dfa

_INF = np.int64(1) << 40
#: The device need table's "never" (dead pairs), as in the padded tables.
NEED_NEVER = 2**30

#: Compile-count observability: tests assert precompute happens once per
#: (tokenizer, grammar) pair and NEVER in the decode loop.
COMPILE_COUNT = 0

_cache_lock = threading.Lock()
#: LRU-bounded: schema grammars arrive one per distinct uploaded CSV on a
#: long-running server, and each entry holds multi-MB [S, V] tables (plus
#: per-device copies) — unbounded growth would be a slow OOM. Eviction
#: only costs a recompile on a schema not seen for 16 schemas.
_CACHE_MAX = 16
_constraint_cache: "OrderedDict[tuple, CompiledMask]" = OrderedDict()


@dataclasses.dataclass
class CompiledMask:
    """Precomputed token tables for one (grammar, tokenizer, eos) triple.

    All arrays are host numpy, over S = char-DFA states + 1 (row 0 is the
    unconstrained sentinel) and V = tokenizer.vocab_size. `device_tables`
    moves (next, need) to a device (cached per device)."""

    fingerprint: str
    init_state: int                 # >= 1; 0 is the unconstrained sentinel
    mask: np.ndarray                # [S, V] bool
    next_state: np.ndarray          # [S, V] int32
    dist: np.ndarray                # [S] int64
    need: np.ndarray                # [S, V] int64 (tokens to finish via t)
    eos_ids: Tuple[int, ...]

    def __post_init__(self):
        self._device: Dict[str, Dict[str, torch.Tensor]] = {}

    @property
    def num_states(self) -> int:
        return self.mask.shape[0]

    @property
    def tok_vocab(self) -> int:
        return self.mask.shape[1]

    @property
    def min_new_tokens(self) -> int:
        """Smallest budget that can hold a complete parse + stop token."""
        return int(self.dist[self.init_state]) + 1

    def walk(self, token_ids: Iterable[int]) -> Optional[int]:
        """Host-side FSM advance (resumes, diagnostics, tests): final state
        after the ids, or None the moment a token leaves the language."""
        s = self.init_state
        for t in token_ids:
            t = int(t)
            if t >= self.tok_vocab or not self.mask[s, t]:
                return None
            s = int(self.next_state[s, t])
        return s

    def device_tables(self, vocab_size: int, device) -> Dict[str, torch.Tensor]:
        """(next, need) as int32 tensors [S, tokenizer vocab] on `device`,
        computed once per device and cached on the object. `vocab_size` is
        the model's logits width, which must hold the tokenizer's ids. The
        decode loops need ONLY these two: the per-step mask is
        `need[state] <= remaining` (`allowed_tokens`), which already
        implies aliveness (dead pairs carry NEED_NEVER)."""
        if vocab_size < self.tok_vocab:
            raise ValueError(
                f"model vocab {vocab_size} < tokenizer vocab {self.tok_vocab}"
            )
        dev = torch.device(device)
        cached = self._device.get(str(dev))
        if cached is not None:
            return cached
        need = np.minimum(self.need, NEED_NEVER).astype(np.int32)
        need[0, :] = 1  # sentinel row: everything allowed at any budget
        nxt = self.next_state.astype(np.int32)
        nxt[0, :] = 0
        tables = {"next": torch.from_numpy(nxt).to(dev),
                  "need": torch.from_numpy(need).to(dev)}
        self._device[str(dev)] = tables
        return tables


def table_bytes(tables: Dict[str, torch.Tensor]) -> int:
    """Device bytes of a (next, need) pair."""
    return sum(t.numel() * t.element_size() for t in tables.values())


def trivial_tables(device) -> Dict[str, torch.Tensor]:
    """Single-sentinel-row tables for a scheduler with no grammar
    installed: every slot sits at state 0, everything is allowed."""
    return {
        "next": torch.zeros((1, 1), dtype=torch.int32, device=device),
        "need": torch.ones((1, 1), dtype=torch.int32, device=device),
    }


def allowed_tokens(need_t: torch.Tensor, states: torch.Tensor,
                   rem: torch.Tensor, vocab: int) -> torch.Tensor:
    """[B, vocab] bool: token t is allowed in row b iff `need[states[b],
    t] <= rem[b]`. Columns at or past the table's width are allowed only
    in the sentinel row (state 0, need 1)."""
    rem = rem.reshape(-1, 1)
    ok = need_t[states.long()] <= rem
    width = need_t.shape[1]
    if vocab > width:
        tail = ((states.reshape(-1, 1) == 0) & (rem >= 1)).expand(-1, vocab - width)
        ok = torch.cat([ok, tail], dim=1)
    return ok


def _need_at(need_t: torch.Tensor, states: torch.Tensor,
            tok: torch.Tensor) -> torch.Tensor:
    """need[states[b], tok[b]] per row, NEED_NEVER (1 in the sentinel row)
    for ids at or past the table's width."""
    width = need_t.shape[1]
    tok = tok.long()
    got = need_t[states.long(), tok.clamp(max=width - 1)]
    past = torch.where(states == 0, 1, NEED_NEVER).to(got.dtype)
    return torch.where(tok < width, got, past)


def advance_states(next_t: torch.Tensor, states: torch.Tensor,
                   tok: torch.Tensor) -> torch.Tensor:
    """The state after each row emits its token: next[states, tok]; ids at
    or past the table's width freeze the state (they are masked)."""
    width = next_t.shape[1]
    tok = tok.long()
    moved = next_t[states.long(), tok.clamp(max=width - 1)]
    return torch.where(tok < width, moved, states.to(moved.dtype))


def fsm_advance_chain(next_t, need_t, states, chain, rem):
    """Vectorized multi-step FSM advance for a drafted token chain — the
    primitive that lets speculative decoding compose with the grammar.

    Given each row's committed state `states [B]`, a drafted chain
    `chain [B, D]`, and the row's remaining token budget `rem [B]` (budget
    left BEFORE the chain's first token), returns:

      per_pos [B, D+1]  per-position states: column 0 is the input state,
                        column j the state after accepting chain[:, :j]
      valid_len [B]     length of the longest chain prefix that is
                        grammar-valid AND budget-affordable at every
                        position — chain[:, j] passes iff
                        `need[state_j, tok] <= rem - j`, the exact mask
                        vanilla decode would apply at that step

    States FREEZE at the first rejected position, so columns past
    `valid_len` are well-defined junk a caller must not accept. Pure
    [state, token] gathers over the device tables, D gathers per round.
    Row 0 of the tables is the unconstrained sentinel, so mixed batches
    run this unchanged: sentinel rows accept any chain their budget
    affords."""
    d = chain.shape[1]
    s = states.to(torch.int32)
    per_pos = [s]
    ok = []
    for j in range(d):
        tok = chain[:, j]
        allowed = _need_at(need_t, s, tok) <= rem - j
        ok.append(allowed)
        s = torch.where(allowed, advance_states(next_t, s, tok), s)
        per_pos.append(s)
    okm = torch.stack(ok, dim=1).to(torch.int32)
    valid_len = torch.cumprod(okm, dim=1).sum(dim=1).to(torch.int32)
    return torch.stack(per_pos, dim=1), valid_len


def compile_token_masks(
    dfa: CharDfa,
    tokenizer,
    eos_ids: Iterable[int],
    fingerprint: str = "",
) -> CompiledMask:
    """Classify every tokenizer id against the char DFA and build the
    decode tables. Pure host precompute — the only pass that ever iterates
    the vocabulary."""
    global COMPILE_COUNT
    COMPILE_COUNT += 1

    n = dfa.num_states
    sink = n
    alphabet = sorted(dfa.alphabet)
    aidx = {ch: i for i, ch in enumerate(alphabet)}
    trans = np.full((n + 1, len(alphabet)), sink, np.int32)
    for s, t in enumerate(dfa.trans):
        for ch, j in t.items():
            trans[s, aidx[ch]] = j

    vocab = int(tokenizer.vocab_size)
    eos = tuple(sorted({int(e) for e in eos_ids if 0 <= int(e) < vocab}))
    if not eos:
        raise ValueError(
            "constrained decoding needs at least one stop id inside the "
            f"tokenizer vocabulary (got {tuple(eos_ids)!r}, vocab {vocab})"
        )

    # Vectorized classification: compose the char transition matrix over
    # each token's text for ALL states at once. f maps state-before ->
    # state-after; sink rows stay sink.
    next_c = np.full((n, vocab), -1, np.int32)
    identity = np.arange(n + 1, dtype=np.int32)
    for tid in range(vocab):
        text = tokenizer.decode([tid])
        if not text:
            continue  # specials (bos/pad/eos) have no char expansion
        cols = [aidx.get(ch) for ch in text]
        if any(c is None for c in cols):
            continue  # contains a char outside the grammar alphabet
        f = identity
        for c in cols:
            f = trans[f, c]
        live = f[:n]
        next_c[:, tid] = np.where(live == sink, -1, live)

    mask = next_c >= 0
    accepting = np.zeros(n, bool)
    accepting[list(dfa.accepting)] = True

    # Stop ids: allowed exactly at accepting states; the state self-loops
    # so anything decoded past the stop (overshoot rounds) stays closing.
    acc_idx = np.where(accepting)[0]
    for e in eos:
        mask[acc_idx, e] = True
        next_c[acc_idx, e] = acc_idx

    # Shortest token-distance to an accepting state (Bellman-Ford to a
    # fixpoint; the graph is tiny). Unreachable states keep _INF and every
    # edge into them is pruned below, so surviving transitions always
    # leave a path to completion.
    dist = np.where(accepting, np.int64(0), _INF)
    safe_next = np.clip(next_c, 0, None)
    while True:
        nd = np.where(mask, dist[safe_next], _INF)
        cand = 1 + nd.min(axis=1)
        new = np.minimum(dist, cand)
        if np.array_equal(new, dist):
            break
        dist = new
    live_state = dist < _INF
    mask &= live_state[safe_next]
    start_live = live_state[dfa.start]
    if not start_live:
        raise ValueError(
            "no token path from the grammar start to an accepting state — "
            "the tokenizer cannot spell this grammar"
        )

    # Tokens-to-finish table: emitting t costs 1 token, then the shortest
    # path to accept, then 1 stop id — except a stop id AT an accepting
    # state, which finishes in exactly its own 1 token. `need <= remaining`
    # is the whole decode-time mask (dead pairs carry ~INF), and it is what
    # makes the completion guarantee hold under ANY budget >=
    # min_new_tokens: a token whose completion no longer fits is masked
    # the moment that becomes true, not a step too late.
    need = np.where(mask, 2 + dist[safe_next], _INF)
    for e in eos:
        need[acc_idx, e] = 1

    # Freeze dead transitions on the state itself (they are masked out, but
    # a frozen target keeps any stray gather harmless), then prepend the
    # unconstrained sentinel as row 0 and shift real states by +1.
    states = np.arange(n, dtype=np.int32)[:, None]
    next_c = np.where(mask, next_c, states)

    full_mask = np.vstack([np.ones((1, vocab), bool), mask])
    full_next = np.vstack(
        [np.zeros((1, vocab), np.int32), (next_c + 1).astype(np.int32)]
    )
    full_need = np.vstack(
        [np.ones((1, vocab), np.int64), need]
    )
    full_dist = np.concatenate(
        [np.zeros(1, np.int64), np.where(live_state, dist, 0)]
    )
    return CompiledMask(
        fingerprint=fingerprint,
        init_state=dfa.start + 1,
        mask=full_mask,
        next_state=full_next,
        dist=full_dist,
        need=full_need,
        eos_ids=eos,
    )


#: Specs accepted by get_constraint: the well-known grammar name, or a
#: schema mapping {"table": ..., "columns": [...]}.
ConstraintSpec = Union[str, dict, CompiledMask]


def _normalize_spec(spec: ConstraintSpec) -> Tuple[str, Optional[str],
                                                   Optional[Tuple[str, ...]]]:
    if isinstance(spec, str):
        if spec != "spark_sql":
            raise ValueError(
                f"unknown constraint grammar {spec!r}; known: 'spark_sql'"
            )
        return grammar_fingerprint(), None, None
    if isinstance(spec, dict):
        table = spec.get("table")
        cols = spec.get("columns")
        if cols is not None and not cols:
            # An explicitly-empty column list would silently fall through
            # to the GENERIC grammar — the caller clearly meant to
            # schema-lock and must hear that nothing was locked.
            raise ValueError(
                "constrain 'columns' must be non-empty when given "
                "(omit the key for the generic grammar)"
            )
        columns = tuple(cols) if cols else None
        return grammar_fingerprint(table, columns), table, columns
    raise TypeError(f"bad constraint spec: {spec!r}")


def _tokenizer_key(tokenizer) -> tuple:
    """Cache identity for a tokenizer: an explicit `cache_key` attribute
    wins; otherwise class + vocab shape + special ids (exact for the
    in-tree byte tokenizer; documented-best-effort for external vocabs)."""
    explicit = getattr(tokenizer, "cache_key", None)
    if explicit is not None:
        return ("explicit", explicit)
    return (
        type(tokenizer).__name__,
        int(tokenizer.vocab_size),
        int(getattr(tokenizer, "bos_id", -1)),
        int(getattr(tokenizer, "eos_id", -1)),
        int(getattr(tokenizer, "pad_id", -1)),
    )


def get_constraint(
    spec: ConstraintSpec,
    tokenizer,
    eos_ids: Iterable[int],
) -> CompiledMask:
    """Resolve a constraint spec to compiled tables, compiling at most once
    per (tokenizer, grammar, stop-ids) triple for the process lifetime."""
    if isinstance(spec, CompiledMask):
        return spec
    fingerprint, table, columns = _normalize_spec(spec)
    vocab = int(tokenizer.vocab_size)
    eos = tuple(sorted({int(e) for e in eos_ids if 0 <= int(e) < vocab}))
    key = (_tokenizer_key(tokenizer), fingerprint, eos)
    with _cache_lock:
        cached = _constraint_cache.get(key)
        if cached is not None:
            _constraint_cache.move_to_end(key)  # LRU touch
            return cached
    compiled = compile_token_masks(
        spark_sql_dfa(table, columns), tokenizer, eos, fingerprint
    )
    # The serializable twin of the compiled tables, stamped so transports
    # and journals can ship the SPEC across a wire/spill and recompile on
    # the far side (serve/remote.py, serve/supervisor.py) — the tables
    # themselves are device-sized and never serialize.
    compiled.wire_spec = spec if isinstance(spec, (str, dict)) else None
    with _cache_lock:
        kept = _constraint_cache.setdefault(key, compiled)
        _constraint_cache.move_to_end(key)
        while len(_constraint_cache) > _CACHE_MAX:
            _constraint_cache.popitem(last=False)
        return kept
