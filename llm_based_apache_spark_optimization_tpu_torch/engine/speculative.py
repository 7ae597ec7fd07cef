"""Prompt-lookup speculative decoding: n-gram drafts, one-forward verify.

Counterpart of the JAX package's `engine/speculative.py`. NL->SQL output
copies column names, the table name and literals from the prompt, so the
next `draft_len` tokens are drafted by finding the latest earlier
occurrence of the current n-gram in (prompt + generated so far) and copying
what followed it; one forward of T = draft_len + 1 then verifies them all.
No draft model, no extra weights.

- Greedy verification is exact: the emitted tokens are vanilla greedy
  decode's, whatever the drafts were; bad drafts cost speed only.
- Sampled requests verify by rejection sampling (`rejection_sample_chain`):
  a draft is accepted iff a uniform draw lands under its target mass, and
  the first rejection resamples from the residual, so the emitted tokens
  are distributed exactly as vanilla sampling's. The draws come from the
  caller: the engine's `torch.Generator`, or the scheduler's per-request
  counter stream (`ops.sampling.verify_draws`).
- Rejected drafts leave K/V past the accepted point; the next round's
  window starts at the first unverified position and rewrites exactly those
  slots before any query can read them (engine/kvcache.py's invariant).

The engine's loop (`engine/generate.py`) and the scheduler's verify round
(`serve/scheduler.py`) run on the host, one verify forward a round, with
the per-row state on the device; both accept and commit a window through
`verify_commit`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..constrain.masks import advance_states, allowed_tokens, fsm_advance_chain
from ..ops.common import NEG_INF
from ..ops.sampling import apply_token_mask, filtered_runtime_logits

# Tokens of the trailing n-gram a draft is looked up by: the scheduler's,
# and the engine's default.
NGRAM = 3

# Cost of one T = D+1 verify forward relative to a T = 1 decode forward: a
# line in the draft length through two anchors. D = 0 is 1.0 by
# construction (a T = 1 "verify" is a decode step). D = 8 is measured by
# `chip_smoke.py`'s `verify_cost_anchor` at BENCH_1B, B = 8, bf16, random
# seed-0 weights: each reading the median wall of a T = 9 verify forward
# over that of a T = 1 decode forward. The anchor is the median of seven
# readings in three calls on an NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit: 1.1286, 1.0293, and 1.0437, 1.0956, 1.0958, 1.0400, 1.0054.
# Both forwards are host-dispatched, so the wider window adds little wall,
# and the readings move by 10% between calls.
VERIFY_COST_ANCHORS = ((0, 1.0), (8, 1.0437))
VERIFY_COST_CALIBRATION = (
    "linear in draft length, anchored at D=0 (=1.0 by construction) and "
    "D=8 (=1.0437, the median of seven readings by chip_smoke.py on an "
    "NVIDIA H100 80GB HBM3, 700.00 W: bench-1b, B=8, bf16, the median wall "
    "of a T=9 verify forward over a T=1 decode forward; readings "
    "1.0054-1.1286); other shapes and weight widths scale the slope by "
    "(unembed marginal / weight-stream fixed) cost relative to that anchor, "
    "an estimate checked at duckdb-nsql-7b, B=8 only (modelled 1.0132 / "
    "1.0527, measured 1.0205-1.0438 / 1.0281-1.2157 in two calls, with "
    "bf16 / int4 weights) and unverified at other shapes"
)


def _param_count(cfg) -> int:
    """Approximate parameter count from the architecture shape: the
    decode step's fixed cost is streaming these bytes."""
    d, f, n_layers = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    nh, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = d * nh * hd + 2 * d * kh * hd + nh * hd * d
    mlp = 3 * d * f
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    return emb + n_layers * (attn + mlp + 2 * d) + d


def infer_weight_bits(params) -> int:
    """Weight bits a parameter: 4 for an int4 tree (q4 block weights), 8
    for an int8 tree (q8 block weights), else the width of the params
    dtype."""
    blocks = params.get("blocks", params)
    if isinstance(blocks, dict):
        for key, bits in (("q4", 4), ("q8", 8)):
            if any(isinstance(v, dict) and key in v for v in blocks.values()):
                return bits
    return params["final_norm"].element_size() * 8


def verify_cost_ratio(draft_len: int, cfg=None, weight_bits: int = 16) -> float:
    """verify(T = draft_len + 1) / decode(T = 1) under the anchored line,
    scaled to the caller's model shape: the slope, the marginal cost of a
    window position, is dominated by the unembed (a V x D product a
    position), the fixed cost by the weight stream, so the slope scales
    with (vocab x hidden) / weight bytes relative to the anchor's shape
    (BENCH_1B, bf16). At least 1.0."""
    (d0, r0), (d1, r1) = VERIFY_COST_ANCHORS
    slope = (r1 - r0) / (d1 - d0)
    if cfg is not None:
        from ..models.configs import BENCH_1B

        def marg_over_fixed(c, bits):
            return (c.vocab_size * c.hidden_size) / (_param_count(c) * bits / 8)

        slope *= marg_over_fixed(cfg, weight_bits) / marg_over_fixed(BENCH_1B, 16)
    return max(1.0, r0 + slope * (draft_len - d0))


def ngram_draft(hist: torch.Tensor, hist_len: torch.Tensor, draft_len: int,
                ngram: int) -> torch.Tensor:
    """Draft [B, draft_len] int32 tokens by prompt lookup over the history
    `hist` [B, HT] (prompt + generated), of which `hist_len` [B] tokens
    are valid (the current token included).

    Each row takes its trailing `ngram` tokens, finds an earlier
    occurrence, and copies the `draft_len` tokens that followed it: the
    latest match whose whole copy window is written history, else the
    earliest match (a late match near the tail has little to copy). No
    match drafts the tail. Reads are clamped into the row as JAX's
    dynamic_slice clamps them, and drafted positions at or past `hist_len`
    are pinned to token 0: past it sits what an earlier occupant of a
    scheduler slot left there, and sampled verification's tokens depend on
    the drafts. Device ops only: nothing synchronises."""
    ht = hist.shape[1]
    dev = hist.device
    hlen = hist_len.long()
    nw = ht - ngram + 1
    jn = torch.arange(ngram, device=dev)
    s_start = (hlen - ngram).clamp(0, ht - ngram)
    suffix = torch.gather(hist, 1, s_start[:, None] + jn[None, :])  # [B, n]
    windows = hist.unfold(1, ngram, 1)                               # [B, nw, n]
    match = (windows == suffix[:, None, :]).all(dim=-1)
    idx = torch.arange(nw, device=dev)[None, :]
    valid = match & (idx < (hlen - ngram)[:, None])
    full = valid & (idx <= (hlen - ngram - draft_len)[:, None])
    last_full = (nw - 1) - torch.argmax(full.flip(1).to(torch.uint8), dim=1)
    first_any = torch.argmax(valid.to(torch.uint8), dim=1)
    m = torch.where(full.any(dim=1), last_full, first_any)
    start = torch.where(valid.any(dim=1), m + ngram, hlen)
    jd = torch.arange(draft_len, device=dev)[None, :]
    out = torch.gather(hist, 1, start.clamp(0, ht - draft_len)[:, None] + jd)
    pos = start[:, None] + jd
    return torch.where(pos < hlen[:, None], out, 0).to(torch.int32)


def rejection_sample_chain(filt: torch.Tensor, drafts: torch.Tensor,
                           u: torch.Tensor, noise: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Speculative rejection sampling for deterministic drafts.

    `filt` [B, D+1, V] are the verify window's filtered target logits
    (`ops.sampling.filtered_runtime_logits`, grammar-masked first where
    vanilla decode masks), so softmax(filt[:, j]) is the distribution a
    vanilla step would draw token j from. `drafts` [B, D]; `u` [B, D]
    uniforms in [0, 1) for the accept tests; `noise` [B, V] uniforms in
    (0, 1) for one Gumbel-max draw, independent of `u`.

    A draft d is a delta proposal, so it is accepted with probability
    p(d) (iff u < p(d); a masked draft has p(d) = 0 and always rejects),
    and the first rejection draws from p with d removed, renormalised:
    P(emit t) = p(d) 1[t = d] + (1 - p(d)) p(t) 1[t != d] / (1 - p(d)) =
    p(t). Chained over the longest accepted prefix, with a bonus draw from
    p_D when every draft accepts, the emitted tokens are a sample of the
    target process. A fully masked position (past the budget horizon)
    rejects with certainty (`alive`): softmax of an all-NEG_INF row is
    uniform, not zero.

    Returns (acc [B] in [0, D], extra [B]): emit drafts[:acc] then extra
    (`emit_chain`)."""
    b, d1, v = filt.shape
    d = d1 - 1
    filt = filt.float()
    p = torch.softmax(filt, dim=-1)
    alive = filt.amax(dim=-1) > NEG_INF * 0.5                     # [B, D+1]
    dr = drafts.long()
    p_draft = torch.gather(p[:, :d], 2, dr[..., None])[..., 0] * alive[:, :d]
    accept = (u < p_draft).to(torch.int32)
    acc = torch.cumprod(accept, dim=1).sum(dim=1)                  # [B]
    rows = torch.arange(b, device=filt.device)
    final = filt[rows, acc]                                        # [B, V]
    rej = torch.cat([dr, dr[:, :1]], dim=1)[rows, acc]
    drop = (acc < d)[:, None] & (torch.arange(v, device=filt.device)[None, :]
                                 == rej[:, None])
    final = torch.where(drop, NEG_INF, final)
    extra = torch.argmax(final - torch.log(-torch.log(noise)), dim=-1)
    return acc.to(torch.int32), extra.to(torch.int32)


def emit_chain(drafts: torch.Tensor, acc: torch.Tensor, extra: torch.Tensor,
               pad_id: int) -> torch.Tensor:
    """The emitted window [B, D+1] of `rejection_sample_chain`'s (acc,
    extra): the accepted draft prefix, then `extra` at position acc, pad
    beyond."""
    b, d = drafts.shape
    jd = torch.arange(d + 1, device=drafts.device)[None, :]
    chain = torch.cat([drafts.to(torch.int32),
                       torch.full((b, 1), pad_id, dtype=torch.int32,
                                  device=drafts.device)], dim=1)
    a = acc.long()[:, None]
    return torch.where(jd < a, chain,
                       torch.where(jd == a, extra.to(torch.int32)[:, None],
                                   pad_id)).to(torch.int32)


def verify_commit(logits: torch.Tensor, drafts: torch.Tensor, cur: torch.Tensor,
                  rem: torch.Tensor, limit: torch.Tensor, pad_id: int, *,
                  stop_ids: Sequence[int] = (), tables=None,
                  cstates: Optional[torch.Tensor] = None, knobs=None, draws=None):
    """Acceptance and commit of one verify window (JAX `_build_spec_decode`'s
    round and `make_speculative_generate_fn`'s loop body), on the device.

    `logits` [B, D+1, V] are the window's target logits, `drafts` [B, D]
    its drafts and `cur` [B] the rows' current tokens. `rem` [B] is the
    budget left at window position 0: with the grammar `tables` (the
    constraint's device tables) and the rows' FSM `cstates`, each position
    is masked with its own state and the budget left there and acceptance
    stops at the first grammar-rejected draft (`fsm_advance_chain`);
    without, positions past the budget allow nothing (the sentinel grammar
    row's mask), so acceptance stops at the budget. Greedy rows accept the
    drafts equal to the argmax chain. With `knobs` (temps, topps, topks
    [B]) and `draws` (u [B, D], noise [B, V]), rows of temperature > 0
    accept by `rejection_sample_chain` instead.

    A row keeps at most `limit` [B] tokens (0: the row emits nothing) and,
    with `stop_ids`, nothing past its first stop id. Returns (emitted [B,
    D+1], pad past n_emit; n_emit [B]; the current tokens after the round;
    the FSM states after the kept prefix (the last kept token advances from
    its own position's state; rejected drafts never move it), None without
    tables)."""
    b, d1, vocab = logits.shape
    d = d1 - 1
    dev = logits.device
    jd = torch.arange(d1, device=dev)[None, :]
    left = rem[:, None] - jd  # budget left at each window position
    if tables is not None:
        pstates, vlen = fsm_advance_chain(tables["next"], tables["need"], cstates,
                                          drafts, rem)
        allowed = allowed_tokens(tables["need"], pstates.reshape(-1), left.reshape(-1),
                                 vocab)
        logits = apply_token_mask(logits, allowed.reshape(b, d1, vocab))
    else:
        logits = apply_token_mask(logits, (left >= 1)[..., None])
        vlen = rem.clamp(0, d)
    chain = torch.argmax(logits, dim=-1).to(torch.int32)
    eq = (drafts == chain[:, :d]) & (jd[:, :d] < vlen[:, None])
    n_acc = torch.cumprod(eq.to(torch.int32), dim=1).sum(dim=1) + 1
    if knobs is not None:
        temps, topps, topks = knobs
        greedy_rows = temps <= 0.0
        filt = filtered_runtime_logits(logits, temps[:, None], topps[:, None],
                                       topks[:, None])
        acc_s, extra = rejection_sample_chain(filt, drafts, *draws)
        chain = torch.where(greedy_rows[:, None], chain,
                            emit_chain(drafts, acc_s, extra, pad_id))
        n_acc = torch.where(greedy_rows, n_acc, acc_s + 1)
    keep = jd < torch.minimum(n_acc, limit)[:, None]
    if stop_ids:
        stops = torch.isin(chain, torch.tensor(list(stop_ids), dtype=chain.dtype,
                                                device=dev)).to(torch.int32)
        keep = keep & (torch.cumsum(stops, dim=1) - stops == 0)
    n_emit = keep.sum(dim=1)
    emitted = torch.where(keep, chain, pad_id).to(torch.int32)
    rows = torch.arange(b, device=dev)
    last = (n_emit - 1).clamp(min=0)
    last_tok = emitted[rows, last]
    if tables is not None:
        cstates = torch.where(n_emit > 0, advance_states(tables["next"],
                                                         pstates[rows, last], last_tok),
                              cstates)
    return emitted, n_emit, torch.where(n_emit > 0, last_tok, cur), cstates
