"""Analytic roofline model: per-phase FLOPs, HBM bytes, and peaks.

A copy of the JAX package's `utils/perfmodel.py` over the port's KV
layouts (`engine/kvcache.cache_bytes`, `engine/paged_kv.page_bytes`), with
one row added to the peak table: the NVIDIA H100 (SXM) the port serves on.

- `peak_for(device_kind, quant)` — the chip table (bf16/int8 TFLOP/s + HBM
  GB/s) matched by substring of the device name, with a CPU fallback:
  unknown device kinds get nominal host peaks (LSOT_PEAK_TFLOPS /
  LSOT_PEAK_HBM_GBS override them), so MFU/HBM-util are always defined
  and the CPU tests exercise the same code path a card does. The
  scheduler passes `torch.cuda.get_device_name(device)` on the card.
- per-phase work models (`flops_per_token`, `prefill_flops`,
  `decode_step_bytes`, `kv_bytes`, `draft_bytes`) over the model config:
  prefill, decode, draft, verify.
- `PerfModel` — the live ledger: the scheduler builds one at construction
  and stamps every harvested round with achieved MFU, HBM-bandwidth
  utilization, and a compute-vs-memory-bound verdict.

FLOP model: 2·P per token for the dense matmuls plus 4·S·L·heads·head_dim
for the attention score/value contractions at context S. Decode HBM bytes
per step: the full weight set streamed once plus the K/V cache read at the
current context.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Tuple

__all__ = [
    "PEAKS",
    "PerfModel",
    "cpu_fallback_peaks",
    "decode_step_bytes",
    "draft_bytes",
    "flops_per_token",
    "kv_bytes",
    "peak_for",
    "prefill_flops",
    "verdict",
]

# Peak specs by chip for MFU / bandwidth accounting: substring of
# device_kind (lowercased) -> (bf16 TFLOP/s, int8 TOP/s, HBM GB/s). The
# TPU rows are the JAX package's, unchanged.
PEAKS: Dict[str, Tuple[float, float, float]] = {
    "v6": (918.0, 1836.0, 1640.0),
    "v5e": (197.0, 394.0, 819.0),
    "v5 lite": (197.0, 394.0, 819.0),
    "v5p": (459.0, 918.0, 2765.0),
    "v4": (275.0, 275.0, 1228.0),
    # NVIDIA H100 SXM datasheet: 989 TFLOP/s dense bf16, 3350 GB/s HBM3.
    # The int8 column is the bf16 rate, not the card's 1979 int8 TOP/s:
    # `quant="int8"` is chosen for any weight_bits <= 8 (int4 included),
    # and the port's int8 and int4 matmul kernels convert the weights to
    # bf16 in registers and multiply on the bf16 tensor cores.
    "h100": (989.0, 989.0, 3350.0),
}


def cpu_fallback_peaks() -> Tuple[float, float]:
    """Nominal host peaks for unknown device kinds (the CPU fixture):
    (FLOP/s, bytes/s). Overridable via LSOT_PEAK_TFLOPS /
    LSOT_PEAK_HBM_GBS so an operator benchmarking an unlisted chip can
    still get honest utilization numbers. Defaults are a generic server
    host (0.2 TFLOP/s, 50 GB/s) — on the CPU fixture the VERDICT and the
    trend are the signal, not the absolute MFU."""
    try:
        tf = float(os.environ.get("LSOT_PEAK_TFLOPS", "0.2"))
    except ValueError:
        tf = 0.2
    try:
        bw = float(os.environ.get("LSOT_PEAK_HBM_GBS", "50.0"))
    except ValueError:
        bw = 50.0
    return max(tf, 1e-9) * 1e12, max(bw, 1e-9) * 1e9


def peak_for(device_kind: str, quant: str = "") -> Tuple[float, float]:
    """(peak FLOP/s, peak HBM bytes/s) for a device kind; int8 weights
    ride the int8 TOP/s column. Unknown kinds (CPU, new chips) fall back
    to `cpu_fallback_peaks()` — never None, so every ledger entry carries
    a defined MFU/HBM-util."""
    dk = (device_kind or "").lower()
    for key, (bf16_tf, int8_tf, bw) in PEAKS.items():
        if key in dk:
            return (int8_tf if quant == "int8" else bf16_tf) * 1e12, bw * 1e9
    return cpu_fallback_peaks()


# ------------------------------------------------------------- work models


def attn_flops_per_token_per_ctx(cfg) -> int:
    """Attention score+value contraction FLOPs for ONE token attending to
    ONE context position: 4 · L · heads · head_dim (2 matmul FLOPs each
    for QK^T and PV)."""
    return 4 * cfg.num_layers * cfg.num_heads * cfg.head_dim


def flops_per_token(cfg, ctx: int) -> int:
    """Dense-stack + attention FLOPs for one generated token at context
    length `ctx` — bench `_detail`'s `flops_per_tok`, shared."""
    return 2 * cfg.num_params + attn_flops_per_token_per_ctx(cfg) * ctx


def prefill_flops(cfg, rows: int, tokens: int,
                  ctx_avg: Optional[int] = None) -> int:
    """FLOPs of one prefill forward: `rows` sequences × `tokens` each,
    attending on average to `ctx_avg` positions (a chunk starting at s0
    averages s0 + tokens/2; a from-zero prefill averages tokens/2 — the
    default, matching bench's `prefill_flops`)."""
    if ctx_avg is None:
        ctx_avg = tokens // 2
    return rows * tokens * (
        2 * cfg.num_params + attn_flops_per_token_per_ctx(cfg) * ctx_avg
    )


def kv_bytes(cfg, rows: int, ctx: int, *, itemsize: int = 2,
             kv_quant: Optional[str] = None, kv_layout: str = "contiguous",
             page_size: Optional[int] = None) -> int:
    """HBM bytes of the K/V state one decode step READS for `rows`
    sequences at context `ctx` — priced at the layout actually serving:

    - contiguous bf16/f32: `engine/kvcache.cache_bytes` (sublane
      rounding included — the bytes the device truly allocates/streams);
    - contiguous int8: int8 values + the per-slot f32 scales
      (cache_bytes at itemsize 1 + the scale rows), bench's 7b pricing;
    - paged: mapped pages only (`pages_for_tokens × page_bytes` per
      row) — the ragged kernel's kv_lens clamp means dead pages are
      never streamed, and `page_bytes` prices the int8-page layout
      (values + per-position scales) exactly like the pool allocator.
    """
    from ..engine.kvcache import cache_bytes

    if kv_layout == "paged":
        from ..engine.paged_kv import page_bytes, pages_for_tokens

        ps = page_size or 64
        return rows * pages_for_tokens(max(1, ctx), ps) * page_bytes(
            cfg, ps, itemsize, kv_quant
        )
    if kv_quant == "int8":
        return (cache_bytes(cfg, rows, ctx, 1)
                + cache_bytes(cfg, rows, ctx, 4) // cfg.head_dim)
    return cache_bytes(cfg, rows, ctx, itemsize)


def decode_step_bytes(cfg, rows: int, ctx: int, param_bytes: int, *,
                      itemsize: int = 2, kv_quant: Optional[str] = None,
                      kv_layout: str = "contiguous",
                      page_size: Optional[int] = None, tp: int = 1) -> int:
    """HBM bytes ONE decode step streams: the full weight shard plus the
    K/V read at context `ctx` (KV heads shard over tp alongside the
    weights, so per-device bytes divide)."""
    return (param_bytes + kv_bytes(
        cfg, rows, ctx, itemsize=itemsize, kv_quant=kv_quant,
        kv_layout=kv_layout, page_size=page_size,
    )) // max(1, tp)


def draft_bytes(cfg, rows: int, draft: int, hist_len: int) -> int:
    """HBM bytes of one prompt-lookup DRAFT pass: the on-device int32
    token-history gather (rows × hist_len reads to find the copy window,
    rows × draft writes). Drafting is table lookups — effectively zero
    FLOPs — so the phase is priced in bytes only; it exists so the
    four-phase model (prefill/decode/draft/verify) is complete, and so a
    model-based draft (ROADMAP) has a slot to grow into."""
    return 4 * rows * (hist_len + draft)


def verdict(mfu: float, hbm_util: float) -> str:
    """Which roof binds: a round running closer to the compute ceiling
    than the bandwidth ceiling is compute-bound (prefill's profile),
    closer to bandwidth is memory-bound (decode's). Ties break to
    memory-bound — the serving default for token-at-a-time decode."""
    return "compute-bound" if mfu > hbm_util else "memory-bound"


# ---------------------------------------------------------------- the model


class PerfModel:
    """Live per-round roofline ledger for one scheduler replica.

    Construction captures everything immutable — model shape, weight
    bytes/bits, KV layout/dtype pricing, tp, device peaks — so a
    per-round attribution is a handful of float multiplies.
    `round_attribution` is PURE (same inputs → same outputs; the
    flight-record reconciliation test recomputes records through it);
    `observe` additionally folds the attribution into per-phase EWMAs
    behind a tiny lock for the /metrics `serving.perf` view."""

    #: EWMA weight for the per-phase running view (recent rounds
    #: dominate; one slow round doesn't erase an hour of signal).
    ALPHA = 0.2

    PHASES = ("prefill", "decode", "draft", "verify")

    def __init__(self, cfg, *, param_bytes: int, weight_bits: int = 16,
                 kv_itemsize: int = 2, kv_quant: Optional[str] = None,
                 kv_layout: str = "contiguous",
                 page_size: Optional[int] = None, tp: int = 1,
                 device_kind: str = ""):
        self.cfg = cfg
        self.param_bytes = int(param_bytes)
        self.weight_bits = int(weight_bits)
        self.kv_itemsize = int(kv_itemsize)
        self.kv_quant = kv_quant
        self.kv_layout = kv_layout
        self.page_size = page_size
        self.tp = max(1, int(tp))
        self.device_kind = device_kind
        quant = "int8" if self.weight_bits <= 8 else ""
        self.peak_flops, self.peak_bw = peak_for(device_kind, quant)
        # Precomputed pricing coefficients: the per-round stamp runs on
        # the scheduler hot path inside the _obs_overhead <1% budget, so
        # phase_work must be pure arithmetic — no imports, no generic
        # helpers. Each closed form EQUALS the module-level function it
        # mirrors (kv_bytes / flops_per_token) bit for bit; a unit test
        # pins the equality across layouts/quants.
        self._two_p = 2 * cfg.num_params
        self._attn = attn_flops_per_token_per_ctx(cfg)
        if kv_layout == "paged":
            from ..engine.paged_kv import page_bytes

            self._ps = int(page_size or 64)
            self._page_b = page_bytes(cfg, self._ps, kv_itemsize, kv_quant)
            self._kv_per_pos = 0
        else:
            self._ps = 0
            self._page_b = 0
            lkh = 2 * cfg.num_layers * cfg.num_kv_heads
            if kv_quant == "int8":
                # int8 values + f32 per-position scales (the exact
                # cache_bytes(.,1) + cache_bytes(.,4)//head_dim split).
                self._kv_per_pos = lkh * cfg.head_dim + lkh * 4
            else:
                self._kv_per_pos = lkh * cfg.head_dim * kv_itemsize
        self._lock = threading.Lock()
        self._phases: Dict[str, Dict[str, float]] = {}
        # Prefill dispatches accumulate between harvests (the loop issues
        # chunks asynchronously and never times them individually); the
        # harvest flushes the pile against the inter-harvest wall.
        self._pending_prefill_flops = 0.0
        self._pending_prefill_bytes = 0.0

    # ------------------------------------------------------------- pricing

    def _kv_read_bytes(self, rows: int, ctx: int) -> int:
        """Hot-path twin of module-level `kv_bytes` (same closed form,
        precomputed coefficients — the equality is unit-tested)."""
        if self._page_b:
            ctx = max(1, ctx)
            return rows * ((ctx + self._ps - 1) // self._ps) * self._page_b
        return rows * (ctx + (-ctx % 8)) * self._kv_per_pos

    def phase_work(self, phase: str, *, rows: int, tokens: int,
                   ctx: int) -> Tuple[float, float]:
        """(FLOPs, HBM bytes) of one `phase` pass: `rows` sequences,
        `tokens` new positions each, at average context `ctx`. Decode is
        `tokens` steps each streaming weights+KV; verify is ONE forward
        over a tokens-wide window (weights stream once); prefill is one
        chunk forward; draft is the history gather."""
        if phase == "draft":
            return 0.0, float(4 * rows * (ctx + tokens))
        per_pass = (self.param_bytes
                    + self._kv_read_bytes(rows, ctx)) / self.tp
        if phase == "decode":
            flops = rows * tokens * (self._two_p + self._attn * ctx)
            return float(flops), float(tokens * per_pass)
        if phase == "verify":
            flops = rows * tokens * (self._two_p + self._attn * ctx)
            return float(flops), float(per_pass)
        if phase == "prefill":
            return (float(rows * tokens * (self._two_p + self._attn * ctx)),
                    float(per_pass))
        raise ValueError(f"unknown phase {phase!r}; choices {self.PHASES}")

    def round_attribution(self, phase: str, *, rows: int, tokens: int,
                          ctx: int, wall_s: float) -> Dict[str, float]:
        """One round's ledger entry: achieved TFLOP/s and GB/s, MFU,
        HBM-bandwidth utilization, and the binding-roof verdict. Pure —
        the tier-1 reconciliation test recomputes flight records through
        this exact function."""
        flops, hbm = self.phase_work(phase, rows=rows, tokens=tokens,
                                     ctx=ctx)
        if wall_s <= 0:
            return {"flops": flops, "hbm_bytes": hbm, "tflops": 0.0,
                    "gbs": 0.0, "mfu": 0.0, "hbm_util": 0.0,
                    "bound": "memory-bound"}
        flop_s, byte_s = flops / wall_s, hbm / wall_s
        mfu = flop_s / self.peak_flops
        util = byte_s / self.peak_bw
        return {
            "flops": flops,
            "hbm_bytes": hbm,
            "tflops": round(flop_s / 1e12, 4),
            "gbs": round(byte_s / 1e9, 2),
            "mfu": round(mfu, 6),
            "hbm_util": round(util, 6),
            "bound": verdict(mfu, util),
        }

    def mixed_attribution(self, *, rows: int, dec_tokens: int, dec_ctx: int,
                          pre_rows: int, pre_tokens: int, pre_ctx: int,
                          wall_s: float) -> Dict[str, float]:
        """One UNIFIED RAGGED round's ledger entry: the launch
        did the decode/verify rows' work AND `pre_rows` prompt chunks in
        the same program, so both phases' analytic work sums over ONE
        measured wall. Pure like round_attribution — the flight-record
        reconciliation test recomputes mixed records through this exact
        function (dec_tokens > 1 is a vanilla chunk round: `dec_tokens`
        weight streams; dec_tokens == draft+1 with one stream is the
        verify shape, which rides the decode pricing here because the
        scan steps dominate and the record keeps the raw inputs either
        way)."""
        d_flops, d_hbm = self.phase_work("decode", rows=rows,
                                         tokens=dec_tokens, ctx=dec_ctx)
        p_flops, p_hbm = self.phase_work("prefill", rows=pre_rows,
                                         tokens=pre_tokens, ctx=pre_ctx)
        flops, hbm = d_flops + p_flops, d_hbm + p_hbm
        if wall_s <= 0:
            return {"flops": flops, "hbm_bytes": hbm, "tflops": 0.0,
                    "gbs": 0.0, "mfu": 0.0, "hbm_util": 0.0,
                    "bound": "memory-bound"}
        flop_s, byte_s = flops / wall_s, hbm / wall_s
        mfu = flop_s / self.peak_flops
        util = byte_s / self.peak_bw
        return {
            "flops": flops,
            "hbm_bytes": hbm,
            "tflops": round(flop_s / 1e12, 4),
            "gbs": round(byte_s / 1e9, 2),
            "mfu": round(mfu, 6),
            "hbm_util": round(util, 6),
            "bound": verdict(mfu, util),
        }

    def observe_mixed(self, *, rows: int, dec_tokens: int, dec_ctx: int,
                      pre_rows: int, pre_tokens: int, pre_ctx: int,
                      wall_s: float) -> Dict[str, float]:
        """mixed_attribution + fold into a dedicated "mixed" EWMA key —
        stats() iterates the phase dict, so the mixed view appears beside
        prefill/decode the first time a ragged round harvests and never
        perturbs the alternating phases' EWMAs."""
        att = self.mixed_attribution(
            rows=rows, dec_tokens=dec_tokens, dec_ctx=dec_ctx,
            pre_rows=pre_rows, pre_tokens=pre_tokens, pre_ctx=pre_ctx,
            wall_s=wall_s,
        )
        self._fold("mixed", att)
        return att

    def prefill_saved(self, tokens: int) -> Tuple[float, float]:
        """(FLOPs, seconds) a prefix-cache hit of `tokens` reused tokens
        SAVED: the one-row prefill forward those tokens would have cost
        (average attention context tokens/2 — the from-zero prefill
        convention shared with `prefill_flops`), priced at whichever roof
        binds that forward. Pure float math — the admission path stamps
        it per hit inside the same <1%-of-cadence budget the flight
        record rides."""
        if tokens <= 0:
            return 0.0, 0.0
        flops, hbm = self.phase_work("prefill", rows=1, tokens=tokens,
                                     ctx=tokens // 2)
        return flops, max(flops / self.peak_flops, hbm / self.peak_bw)

    # ------------------------------------------------------------- ledger

    def note_prefill(self, *, rows: int, tokens: int, ctx: int) -> None:
        """Accumulate one dispatched prefill chunk's analytic work; the
        next harvested round flushes the pile against the measured
        inter-harvest wall (chunks dispatch asynchronously — there is no
        honest per-chunk wall without the device profiler, which is what
        /debug/profile is for)."""
        flops, hbm = self.phase_work("prefill", rows=rows, tokens=tokens,
                                     ctx=ctx)
        with self._lock:
            self._pending_prefill_flops += flops
            self._pending_prefill_bytes += hbm

    def flush_prefill(self, interval_s: float) -> Optional[Dict[str, float]]:
        """Attribute accumulated prefill work over the inter-harvest
        interval; None when no chunk was dispatched since the last
        flush."""
        with self._lock:
            flops = self._pending_prefill_flops
            hbm = self._pending_prefill_bytes
            self._pending_prefill_flops = 0.0
            self._pending_prefill_bytes = 0.0
        if flops <= 0 and hbm <= 0:
            return None
        if interval_s <= 0:
            return None
        mfu = flops / interval_s / self.peak_flops
        util = hbm / interval_s / self.peak_bw
        att = {
            "flops": flops, "hbm_bytes": hbm,
            "tflops": round(flops / interval_s / 1e12, 4),
            "gbs": round(hbm / interval_s / 1e9, 2),
            "mfu": round(mfu, 6), "hbm_util": round(util, 6),
            "bound": verdict(mfu, util),
        }
        self._fold("prefill", att)
        return att

    def observe(self, phase: str, *, rows: int, tokens: int, ctx: int,
                wall_s: float) -> Dict[str, float]:
        """round_attribution + fold into the per-phase running view."""
        att = self.round_attribution(phase, rows=rows, tokens=tokens,
                                     ctx=ctx, wall_s=wall_s)
        self._fold(phase, att)
        return att

    def _fold(self, phase: str, att: Dict[str, float]) -> None:
        # Hot path (once per harvested round): no rounding here — the
        # stats() read rounds for presentation.
        a = self.ALPHA
        b = 1.0 - a
        with self._lock:
            ph = self._phases.get(phase)
            if ph is None:
                self._phases[phase] = {
                    "mfu": att["mfu"], "hbm_util": att["hbm_util"],
                    "tflops": att["tflops"], "gbs": att["gbs"],
                    "rounds": 1,
                }
            else:
                ph["mfu"] = b * ph["mfu"] + a * att["mfu"]
                ph["hbm_util"] = b * ph["hbm_util"] + a * att["hbm_util"]
                ph["tflops"] = b * ph["tflops"] + a * att["tflops"]
                ph["gbs"] = b * ph["gbs"] + a * att["gbs"]
                ph["rounds"] += 1

    def stats(self) -> Dict[str, object]:
        """The /metrics `serving.perf` payload: the model's pricing
        assumptions + per-phase EWMAs of the live roofline position."""
        with self._lock:
            phases = {
                k: {"mfu": round(v["mfu"], 6),
                    "hbm_util": round(v["hbm_util"], 6),
                    "tflops": round(v["tflops"], 4),
                    "gbs": round(v["gbs"], 2),
                    "rounds": v["rounds"],
                    "bound": verdict(v["mfu"], v["hbm_util"])}
                for k, v in self._phases.items()
            }
        return {
            "device_kind": self.device_kind,
            "peak_tflops": round(self.peak_flops / 1e12, 3),
            "peak_hbm_gbs": round(self.peak_bw / 1e9, 1),
            "param_bytes": self.param_bytes,
            "weight_bits": self.weight_bits,
            "kv_quant": self.kv_quant or "",
            "kv_layout": self.kv_layout,
            "tp": self.tp,
            "phases": phases,
        }
