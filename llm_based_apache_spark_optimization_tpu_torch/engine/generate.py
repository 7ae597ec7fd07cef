"""Autoregressive generation: batched prefill, then a decode loop.

Counterpart of the JAX package's `engine/generate.py` (same contract): the
prompts are right-padded to a bucketed length and prefilled in one forward
that unembeds only each row's last real token; the first token is sampled
from those logits; then one forward per step decodes every row at its own
position, with per-row stop handling, an early exit once every row has
stopped, and a step budget no larger than the bucketed cap the cache was
sized for. The loop runs on the host, one eager forward per step.

With `kv_layout="paged"` the prefill runs over a prompt-sized contiguous
cache, `pack_prefill_pages` moves its K/V into pool pages with identity
per-row tables, and every decode step writes and reads through the tables
(the paged forward: the fused page-write and ragged paged attention
kernels on the card).

With `kv_quant="int8"` the prefill fills the compute-dtype cache, then
`quantize_cache` converts it once to the int8 cache (int8 values plus one
f32 scale per slot), and every decode step writes and reads that cache (the
quantized flash decode kernel on the card); with the paged layout
`pack_prefill_pages(kv_quant="int8")` quantizes into the int8 pool.

With `speculative_draft=D` (engine/speculative.py) each round drafts D
tokens a row by prompt lookup over the row's history (prompt + generated)
and verifies them with one forward of T = D + 1 over the cache (any
layout; the contiguous int8 cache is refused, as in the JAX package):
greedy rows accept the longest prefix of drafts equal to the argmax chain,
sampled rows verify by rejection sampling with draws from the request's
generator, and each row emits 1..D+1 tokens a round. Under a grammar the
drafts advance the FSM position by position (`fsm_advance_chain`), every
window position is masked with its own state and budget, acceptance stops
at the grammar-valid prefix, and the committed state is the one after the
accepted prefix. `last_spec_rounds` counts the verify forwards.

With a `mesh` (parallel/) each rank holds its block of the params
(`shard_params` of the whole tree it is given, or a tree loaded straight to
the mesh) and allocates its block of the cache: its dp rows (the batch is
padded with one-token rows to a multiple of dp and sliced back), a tp-th of
the KV heads and, with sp > 1, an sp-th of the slots. Every rank of the
mesh calls `generate` with the same arguments (SPMD); under an entry point
only rank 0 does, and it posts the call to the others over the step
channel (`parallel/spmd.py`) once `spmd.drive` is on. With sp > 1 the
prompt pads to a multiple of sp and the prefill runs ring attention into a
cache whose slots are split over sp (`models.llama.SpSlotCache`, JAX's
`cache_spec`); the contiguous layout's decode reads those slots through the
partial-softmax combine. The paged layout follows JAX's
`paged_pool_spec`: the prompt-sized transient is all-gathered over sp (what
GSPMD does implicitly in JAX), packed into a pool whole on every sp rank,
and each sp rank then runs the same paged decode or verify windows through
the tp path's kernels. Every rank returns every row.

With a grammar `constraint` (a compiled `constrain.CompiledMask`), the first
token is masked to the tokens whose completion fits the whole budget
(`need[init] <= budget`) and every step to `need[state] <= budget - step`;
each row's FSM state advances with its token and freezes once the row has
stopped, so every completion parses whenever the budget is at least the
grammar's `min_new_tokens`.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import torch

from .. import resolve_device
from ..models.configs import LlamaConfig
from ..models.llama import _UNROLL_MAX_T, Params, SpSlotCache, forward, fuse_blocks
from ..ops.common import all_gather, all_gather_object
from ..ops.quant import quantize_cache
from ..ops.sampling import (
    SamplingParams,
    apply_token_mask,
    sample,
)
from .kvcache import bucket_len, init_cache
from .paged_kv import default_page_size, pack_prefill_pages
from .speculative import NGRAM, ngram_draft, verify_commit


def _is_stop(tok: torch.Tensor, stop_ids: Tuple[int, ...]) -> torch.Tensor:
    hit = torch.zeros(tok.shape, dtype=torch.bool, device=tok.device)
    for s in stop_ids:
        hit = hit | (tok == s)
    return hit


class InferenceEngine:
    """Ragged python prompts -> ragged completions, on one device.

    `device` defaults to CUDA and must hold `params`. `last_stats` describes
    the last `generate`: seconds to the first token (`ttft_s`, prefill and
    first sample, synchronised), the number of forward calls (one prefill
    plus the decode steps or verify rounds), the padded prompt length and
    the batch. `speculative_draft` > 0 verifies that many prompt-lookup
    drafts a round (`speculative_ngram`-token lookups); `last_spec_rounds`
    is then the last call's number of verify rounds (None without).
    `fuse_matmuls=True` runs the fused tree (`models/llama.fuse_blocks`):
    one matmul for Q|K|V (MHA) or K|V (GQA) and one for gate|up. `mesh`
    shards it (module docstring); the device is then the mesh rank's."""

    def __init__(
        self,
        cfg: LlamaConfig,
        params: Params,
        stop_ids: Optional[Sequence[int]] = None,
        prompt_bucket: int = 128,
        new_bucket: int = 64,
        device=None,
        kv_layout: str = "contiguous",
        kv_page_size: Optional[int] = None,
        kv_quant: Optional[str] = None,
        speculative_draft: int = 0,
        speculative_ngram: int = NGRAM,
        fuse_matmuls: bool = False,
        mesh=None,
    ):
        if kv_layout not in ("contiguous", "paged"):
            raise ValueError(
                f"kv_layout must be 'contiguous' or 'paged', got {kv_layout!r}"
            )
        if kv_quant not in (None, "int8"):
            raise ValueError(f"kv_quant must be None or 'int8', got {kv_quant!r}")
        if kv_quant and speculative_draft and kv_layout != "paged":
            raise ValueError(
                "kv_quant and speculative_draft cannot combine on the "
                "contiguous layout: the speculative verify loop streams "
                "the bf16 cache (use kv_layout='paged')")
        if speculative_draft and not 1 <= speculative_draft <= _UNROLL_MAX_T - 1:
            raise ValueError(
                f"draft_len must be in [1, {_UNROLL_MAX_T - 1}] (the verify "
                f"window T = draft_len + 1 must take the small-T path), got "
                f"{speculative_draft}")
        if speculative_ngram < 1:
            raise ValueError(f"ngram must be >= 1, got {speculative_ngram}")
        self.speculative_draft = int(speculative_draft)
        self.speculative_ngram = int(speculative_ngram)
        self.last_spec_rounds: Optional[int] = None
        self.kv_layout = kv_layout
        self.kv_quant = kv_quant
        self.kv_page_size = (int(kv_page_size or default_page_size())
                             if kv_layout == "paged" else 0)
        self.cfg = cfg
        self.mesh = mesh
        self._kv_cfg = cfg
        if mesh is not None:
            from ..parallel.sharding import shard_params

            if device is not None and torch.device(device).type != mesh.device.type:
                raise ValueError(f"device {device} is not the mesh rank's "
                                 f"{mesh.device}")
            device = mesh.device
            params = shard_params(params, cfg, mesh)
            self._kv_cfg = mesh.local_cfg(cfg)
        self.device = resolve_device(device)
        if params["final_norm"].device.type != self.device.type:
            raise ValueError(
                f"params are on {params['final_norm'].device}, engine on "
                f"{self.device}"
            )
        if fuse_matmuls:
            # One stacked matmul for the projections sharing an input
            # (models/llama.fuse_blocks); `self.params` is the fused tree.
            params = fuse_blocks(params)
        self.params = params
        self.stop_ids = tuple(stop_ids) if stop_ids is not None else cfg.stop_ids
        # A bucket as large as the whole context would leave no decode room
        # after bucketing even a short prompt; cap at half the context.
        self.prompt_bucket = min(prompt_bucket, max(1, cfg.max_seq_len // 2))
        self.new_bucket = max(1, new_bucket)
        self.last_stats: dict = {}
        if mesh is not None:  # last: a follower's step loop may drive it at once
            self._mesh_id = mesh.register(self)

    def padded_prompt_len(self, n: int) -> int:
        """Device-side prompt length for an n-token prompt: bucketed, then
        on an sp mesh padded so each sp rank takes an equal block through
        the ring."""
        t = bucket_len(n, self.prompt_bucket)
        if self.mesh is not None:
            t += -t % self.mesh.shape["sp"]
        return t

    @torch.inference_mode()
    def generate(
        self,
        prompts: List[List[int]],
        max_new_tokens: int = 256,
        sampling: SamplingParams = SamplingParams(),
        seed: int = 0,
        constraint=None,
    ) -> List[List[int]]:
        mesh = self.mesh
        if mesh is not None and mesh.driving and mesh.is_primary:
            from ..parallel import spmd

            with mesh.lock:
                spmd.post(mesh, self._mesh_id, "generate", prompts,
                          max_new_tokens, sampling, seed, constraint)
                return self._generate(prompts, max_new_tokens, sampling, seed,
                                      constraint)
        return self._generate(prompts, max_new_tokens, sampling, seed, constraint)

    def _generate(self, prompts, max_new_tokens, sampling, seed, constraint):
        if not prompts or not all(prompts):
            raise ValueError("generate needs at least one non-empty prompt")
        if constraint is not None and max_new_tokens < constraint.min_new_tokens:
            raise ValueError(
                f"max_new_tokens={max_new_tokens} cannot hold a complete "
                f"constrained parse (grammar needs >= "
                f"{constraint.min_new_tokens} tokens incl. the stop id)"
            )
        cfg, dev, mesh = self.cfg, self.device, self.mesh
        t0 = time.perf_counter()
        b_all = len(prompts)
        t = self.padded_prompt_len(max(len(p) for p in prompts))
        if t + max_new_tokens > cfg.max_seq_len:
            raise ValueError(
                f"bucketed prompt ({t}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds model context max_seq_len={cfg.max_seq_len}"
            )
        sp = dp = 1
        if mesh is not None:
            sp, dp = mesh.shape["sp"], mesh.shape["dp"]
            # The batch axis shards over dp: pad with one-token rows to a
            # multiple of dp (sliced off below), keep this rank's rows.
            padded = list(prompts) + [[cfg.bos_id]] * (-b_all % dp)
            per = len(padded) // dp
            prompts = padded[mesh.coords["dp"] * per:(mesh.coords["dp"] + 1) * per]
        b = len(prompts)
        tokens = torch.tensor(
            [p + [cfg.pad_id] * (t - len(p)) for p in prompts],
            dtype=torch.int32, device=dev,
        )
        lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                               device=dev)
        # The cache is sized for the bucketed cap; the loop stops at the
        # budget (<= cap).
        cap = min(bucket_len(int(max_new_tokens), self.new_bucket),
                  cfg.max_seq_len - t)
        budget = min(int(max_new_tokens), cap)
        paged = self.kv_layout == "paged"
        d1 = self.speculative_draft + 1 if self.speculative_draft else 0
        # Paged: a prompt-sized transient cache, packed into pages below. A
        # speculative loop's cache spans one verify window more.
        s_cache = t if paged else t + cap + d1
        if sp > 1:  # this rank's sp-th of the slots
            s_cache = -(-(s_cache + -s_cache % 8) // sp)
        cache = init_cache(self._kv_cfg, b, s_cache,
                           dtype=self.params["final_norm"].dtype, device=dev)
        if sp > 1:
            cache = SpSlotCache(cache)
        positions = torch.arange(t, dtype=torch.int32, device=dev)[None].expand(b, t)
        gen = None
        if not sampling.is_greedy:
            gen = torch.Generator(device=dev).manual_seed(seed)

        logits, cache = forward(cfg, self.params, tokens, positions, cache,
                                logit_indices=lengths - 1, mesh=mesh,
                                attn_impl="ring" if sp > 1 else None)
        first_logits = logits[:, 0]
        tabs = cstate = None
        if constraint is not None:
            from ..constrain import advance_states, allowed_tokens

            tabs = constraint.device_tables(cfg.vocab_size, dev)
            cstate = torch.full((b,), constraint.init_state, dtype=torch.int32,
                                device=dev)
            # The first token is constrained too: allowed iff the tokens it
            # commits to (itself, the shortest completion after it, the
            # stop id) fit the whole budget.
            first_logits = apply_token_mask(first_logits, allowed_tokens(
                tabs["need"], cstate, torch.full_like(cstate, budget),
                cfg.vocab_size))
        cur = sample(first_logits, sampling, gen)
        if constraint is not None:
            cstate = advance_states(tabs["next"], cstate, cur)
        done = _is_stop(cur, self.stop_ids)
        finished = bool(done.all())  # synchronises: the first token exists
        ttft = time.perf_counter() - t0
        if paged:
            if sp > 1:
                # The pool is whole on every sp rank: gather the transient's
                # slots, keep the prompt's t.
                cache = {n: all_gather(cache[n], mesh, "sp", dim=3)[:, :, :, :t]
                         for n in ("k", "v")}
            ps = self.kv_page_size
            cache = pack_prefill_pages(cache, ps, -(-(t + cap + d1) // ps),
                                       kv_quant=self.kv_quant)
        elif self.kv_quant:
            cache = quantize_cache(cache["k"], cache["v"])
            if sp > 1:
                cache = SpSlotCache(cache)
        if self.speculative_draft:
            out_t, forwards = self._speculative_loop(
                cache, tokens, lengths, cur, done, cstate, tabs, budget, cap,
                sampling, gen)
            self.last_spec_rounds = forwards - 1
        else:
            out_t, forwards = self._decode_loop(
                cache, lengths, cur, done, finished, cstate, tabs, budget,
                sampling, gen)
            self.last_spec_rounds = None
        stops = _is_stop(out_t, self.stop_ids)
        gen_lens = torch.where(
            stops.any(dim=1),
            stops.int().argmax(dim=1) + 1,
            torch.full((b,), budget, dtype=torch.int64, device=dev),
        )
        out_l, lens_l = out_t.tolist(), gen_lens.tolist()
        self.last_stats = {
            "ttft_s": ttft,
            "forward_calls": forwards,
            "decode_steps": forwards - 1,
            "prompt_len": t,
            "batch": b_all,
        }
        rows = [out_l[i][: lens_l[i]] for i in range(b)]
        if dp > 1:
            # Every rank returns every row: the dp ranks' rows in dp order.
            parts = all_gather_object((mesh.coords, rows), mesh)
            rows = [r for c, part in parts if c["sp"] == 0 and c["tp"] == 0
                    for r in part]
        return rows[:b_all]

    def _decode_loop(self, cache, lengths, cur, done, finished, cstate, tabs,
                     budget, sampling, gen):
        """One T = 1 forward a step until every row stopped or the budget
        is spent. Returns (tokens [B, steps], forward calls)."""
        cfg = self.cfg
        if tabs is not None:
            from ..constrain import advance_states, allowed_tokens
        out = [cur]
        pos = lengths.clone()
        pad = torch.tensor(cfg.pad_id, dtype=torch.int32, device=cur.device)
        step = 1
        while step < budget and not finished:
            logits, cache = forward(cfg, self.params, cur[:, None], pos[:, None],
                                    cache, mesh=self.mesh)
            step_logits = logits[:, 0]
            if tabs is not None:
                # Allowed iff its completion still fits the remaining
                # budget: a gather and a compare a step.
                step_logits = apply_token_mask(step_logits, allowed_tokens(
                    tabs["need"], cstate, torch.full_like(cstate, budget - step),
                    cfg.vocab_size))
            nxt = sample(step_logits, sampling, gen)
            nxt = torch.where(done, pad, nxt)
            if tabs is not None:
                # Finished rows freeze their state: their pad fill must not
                # walk the FSM.
                cstate = torch.where(done, cstate,
                                     advance_states(tabs["next"], cstate, nxt))
            done = done | _is_stop(nxt, self.stop_ids)
            out.append(nxt)
            cur, pos, step = nxt, pos + 1, step + 1
            finished = bool(done.all())
        return torch.stack(out, dim=1), step

    def _speculative_loop(self, cache, tokens, lengths, cur, done, cstate, tabs,
                          budget, cap, sampling, gen):
        """Verify rounds (JAX `make_speculative_generate_fn`'s loop body, one
        host-dispatched forward a round, accepted and committed by
        `verify_commit`) until every row stopped or spent its budget.
        Returns (tokens [B, cap], forward calls: the prefill plus the verify
        rounds)."""
        cfg, dev = self.cfg, self.device
        D, pad_id = self.speculative_draft, cfg.pad_id
        d1 = D + 1
        b = tokens.shape[0]
        # History: prompt + generated per row, generated tokens landing
        # right after the row's real prompt (the pad gap to the bucket sits
        # in no n-gram window a draft can win).
        rows = torch.arange(b, device=dev)
        hist = torch.cat([tokens, torch.full((b, cap + d1), pad_id,
                                             dtype=torch.int32, device=dev)], 1)
        hist[rows, lengths.long()] = cur
        out = torch.full((b, cap + d1), pad_id, dtype=torch.int32, device=dev)
        out[:, 0] = cur
        done = done | (budget <= 1)
        glen = torch.ones(b, dtype=torch.int64, device=dev)
        hlen = lengths.long() + 1
        pos = lengths.long()
        jd = torch.arange(d1, device=dev)[None, :]
        knobs = None
        if not sampling.is_greedy:
            knobs = tuple(torch.full((b,), x, device=dev) for x in (
                sampling.temperature, sampling.top_p, sampling.top_k))
        rounds = 0
        while not bool(done.all()):
            drafts = ngram_draft(hist, hlen, D, self.speculative_ngram)   # [B, D]
            verify = torch.cat([cur[:, None], drafts], dim=1)             # [B, D+1]
            logits, cache = forward(cfg, self.params, verify,
                                    (pos[:, None] + jd).to(torch.int32), cache,
                                    mesh=self.mesh)
            draws = None
            if knobs is not None:
                draws = (torch.rand((b, D), generator=gen, device=dev),
                         torch.rand((b, logits.shape[-1]), generator=gen, device=dev))
            emitted, n_emit, cur, cstate = verify_commit(
                logits, drafts, cur, budget - glen, torch.where(done, 0, budget - glen),
                pad_id, stop_ids=self.stop_ids, tables=tabs, cstates=cstate,
                knobs=knobs, draws=draws)
            out.scatter_(1, glen[:, None] + jd, emitted)
            hist.scatter_(1, hlen[:, None] + jd, emitted)
            glen, hlen, pos = glen + n_emit, hlen + n_emit, pos + n_emit
            # A row that kept a stop id kept it last.
            done = done | ((n_emit > 0) & _is_stop(cur, self.stop_ids)) | (glen >= budget)
            rounds += 1
        return out[:, :cap], rounds + 1
