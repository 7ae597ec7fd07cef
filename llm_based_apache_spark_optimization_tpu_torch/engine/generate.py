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
quantized flash decode kernel on the card).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import torch

from .. import resolve_device
from ..models.configs import LlamaConfig
from ..models.llama import Params, forward
from ..ops.quant import quantize_cache
from ..ops.sampling import SamplingParams, sample
from .kvcache import bucket_len, init_cache
from .paged_kv import default_page_size, pack_prefill_pages


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
    plus the decode steps), the padded prompt length and the batch."""

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
    ):
        if kv_layout not in ("contiguous", "paged"):
            raise ValueError(
                f"kv_layout must be 'contiguous' or 'paged', got {kv_layout!r}"
            )
        if kv_quant not in (None, "int8"):
            raise ValueError(f"kv_quant must be None or 'int8', got {kv_quant!r}")
        if kv_quant and kv_layout == "paged":
            raise ValueError(
                "kv_quant with the engine's paged layout is not ported (ROADMAP "
                "A10; the layout itself is queued for removal, A4): the int8 "
                "paged pool serves through the scheduler")
        self.kv_layout = kv_layout
        self.kv_quant = kv_quant
        self.kv_page_size = (int(kv_page_size or default_page_size())
                             if kv_layout == "paged" else 0)
        self.cfg = cfg
        self.device = resolve_device(device)
        if params["final_norm"].device.type != self.device.type:
            raise ValueError(
                f"params are on {params['final_norm'].device}, engine on "
                f"{self.device}"
            )
        self.params = params
        self.stop_ids = tuple(stop_ids) if stop_ids is not None else cfg.stop_ids
        # A bucket as large as the whole context would leave no decode room
        # after bucketing even a short prompt; cap at half the context.
        self.prompt_bucket = min(prompt_bucket, max(1, cfg.max_seq_len // 2))
        self.new_bucket = max(1, new_bucket)
        self.last_stats: dict = {}

    def padded_prompt_len(self, n: int) -> int:
        """Device-side prompt length for an n-token prompt."""
        return bucket_len(n, self.prompt_bucket)

    @torch.inference_mode()
    def generate(
        self,
        prompts: List[List[int]],
        max_new_tokens: int = 256,
        sampling: SamplingParams = SamplingParams(),
        seed: int = 0,
    ) -> List[List[int]]:
        if not prompts or not all(prompts):
            raise ValueError("generate needs at least one non-empty prompt")
        cfg, dev = self.cfg, self.device
        t0 = time.perf_counter()
        b = len(prompts)
        t = self.padded_prompt_len(max(len(p) for p in prompts))
        if t + max_new_tokens > cfg.max_seq_len:
            raise ValueError(
                f"bucketed prompt ({t}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds model context max_seq_len={cfg.max_seq_len}"
            )
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
        # Paged: a prompt-sized transient cache, packed into pages below.
        cache = init_cache(cfg, b, t if paged else t + cap,
                           dtype=self.params["final_norm"].dtype, device=dev)
        positions = torch.arange(t, dtype=torch.int32, device=dev)[None].expand(b, t)
        gen = None
        if not sampling.is_greedy:
            gen = torch.Generator(device=dev).manual_seed(seed)

        logits, cache = forward(cfg, self.params, tokens, positions, cache,
                                logit_indices=lengths - 1)
        cur = sample(logits[:, 0], sampling, gen)
        done = _is_stop(cur, self.stop_ids)
        out = [cur]
        finished = bool(done.all())  # synchronises: the first token exists
        ttft = time.perf_counter() - t0
        if paged:
            ps = self.kv_page_size
            cache = pack_prefill_pages(cache, ps, -(-(t + cap) // ps))
        elif self.kv_quant:
            cache = quantize_cache(cache["k"], cache["v"])
        pos = lengths.clone()
        pad = torch.tensor(cfg.pad_id, dtype=torch.int32, device=dev)
        step = 1
        while step < budget and not finished:
            logits, cache = forward(cfg, self.params, cur[:, None], pos[:, None],
                                    cache)
            nxt = sample(logits[:, 0], sampling, gen)
            nxt = torch.where(done, pad, nxt)
            done = done | _is_stop(nxt, self.stop_ids)
            out.append(nxt)
            cur, pos, step = nxt, pos + 1, step + 1
            finished = bool(done.all())

        out_t = torch.stack(out, dim=1)  # [B, steps]
        stops = _is_stop(out_t, self.stop_ids)
        gen_lens = torch.where(
            stops.any(dim=1),
            stops.int().argmax(dim=1) + 1,
            torch.full((b,), budget, dtype=torch.int64, device=dev),
        )
        out_l, lens_l = out_t.tolist(), gen_lens.tolist()
        self.last_stats = {
            "ttft_s": ttft,
            "forward_calls": step,
            "decode_steps": step - 1,
            "prompt_len": t,
            "batch": b,
        }
        return [out_l[i][: lens_l[i]] for i in range(b)]
