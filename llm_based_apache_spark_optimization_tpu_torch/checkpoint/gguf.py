"""GGUF checkpoint loading and export: llama.cpp model blobs <-> the param tree.

Counterpart of the JAX package's `checkpoint/gguf.py`. GGUF is the weight
format of the reference's model zoo (Ollama stores `duckdb-nsql`,
`llama3.2` and `mistral` as GGUF blobs run by llama.cpp). Reading goes
through the port's C++ parser and dequantizer (native/gguf.cpp, built with
g++ at first use); this module maps llama.cpp tensor names onto the param
tree:

    token_embd.weight            [V, D]   -> embed
    blk.{i}.attn_q.weight        [N*H, D] -> blocks.wq[i]  (T, unpermute)
    blk.{i}.attn_k.weight        [K*H, D] -> blocks.wk[i]  (T, unpermute)
    blk.{i}.attn_v.weight        [K*H, D] -> blocks.wv[i]  (T)
    blk.{i}.attn_output.weight   [D, N*H] -> blocks.wo[i]  (T)
    blk.{i}.ffn_gate.weight      [F, D]   -> blocks.wg[i]  (T)
    blk.{i}.ffn_up.weight        [F, D]   -> blocks.wu[i]  (T)
    blk.{i}.ffn_down.weight      [D, F]   -> blocks.wd[i]  (T)
    blk.{i}.attn_norm.weight     [D]      -> blocks.ln_attn[i]
    blk.{i}.ffn_norm.weight      [D]      -> blocks.ln_mlp[i]
    output_norm.weight           [D]      -> final_norm
    output.weight                [V, D]   -> lm_head (absent when tied)

(T): GGUF keeps torch-Linear [out, in] memory order; the port computes
x @ W. (unpermute): llama.cpp's HF->GGUF converter reorders Q/K rows per
head from HF's split-half rope layout to GGML's interleaved pairs;
`ops/rope.py` uses the HF convention, so rows are permuted back on load
(and forward on export). Without it the model runs with degraded attention.

`write_gguf` is the inverse (f32 / f16 / q8_0 / q4_0 / q6_k). Its quantizers
are the JAX package's arithmetic vectorized over blocks and write the same
bytes: q8_0 and q4_0 in torch on the device the tensor lives on (the card,
in serving), q6_k with numpy on the host. The file is written one tensor at
a time.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.configs import LlamaConfig, RopeFreqFactors
from .hf import place_leaf, resolve_load_device

__all__ = ["config_from_gguf", "load_gguf_checkpoint", "write_gguf"]

_F32, _F16, _Q4_0, _Q8_0, _Q6_K = 0, 1, 2, 8, 14
_QUANT_IDS = {"f32": _F32, "f16": _F16, "q4_0": _Q4_0, "q8_0": _Q8_0,
              "q6_k": _Q6_K}
#: bytes a quantized block takes, and the elements it holds
_BLOCK = {"q8_0": (34, 32), "q4_0": (18, 32), "q6_k": (210, 256)}


# ---------------------------------------------------------------------------
# Q/K rope-layout permutation (see module docstring).

def _unpermute_qk(w: np.ndarray, n_head: int) -> np.ndarray:
    """GGUF (interleaved-pair) row order -> HF (split-half). w: [n_head*hd, in]
    (a numpy array or a torch tensor)."""
    rows, cols = w.shape
    hd = rows // n_head
    return w.reshape(n_head, hd // 2, 2, cols).swapaxes(1, 2).reshape(rows, cols)


def _permute_qk(w: np.ndarray, n_head: int) -> np.ndarray:
    """HF row order -> GGUF (inverse of _unpermute_qk; numpy or torch)."""
    rows, cols = w.shape
    hd = rows // n_head
    return w.reshape(n_head, 2, hd // 2, cols).swapaxes(1, 2).reshape(rows, cols)


# ---------------------------------------------------------------------------
# Reading

def config_from_gguf(reader, name: Optional[str] = None) -> LlamaConfig:
    """Build a LlamaConfig from GGUF `llama.*` metadata keys.

    llama-3.x rope scaling travels as a `rope_freqs.weight` tensor (per-dim
    inverse-frequency divisors), not as metadata; when present it loads as
    `RopeFreqFactors`."""
    def num(key, default=None):
        v = reader.meta_num(key)
        if v is None:
            if default is None:
                raise KeyError(f"GGUF metadata missing {key}")
            return default
        return v

    arch = reader.meta_str("general.architecture") or "llama"
    heads = int(num(f"{arch}.attention.head_count"))
    d = int(num(f"{arch}.embedding_length"))
    vocab, d_emb = reader.shape("token_embd.weight")
    if d_emb != d:
        raise ValueError(f"embedding_length {d} != token_embd dim {d_emb}")
    scaling = None
    if "rope_freqs.weight" in reader.tensor_names:
        scaling = RopeFreqFactors(
            tuple(float(x) for x in reader.tensor_f32("rope_freqs.weight")))
    return LlamaConfig(
        name=name or reader.meta_str("general.name") or "gguf-model",
        vocab_size=int(vocab),
        hidden_size=d,
        intermediate_size=int(num(f"{arch}.feed_forward_length")),
        num_layers=int(num(f"{arch}.block_count")),
        num_heads=heads,
        num_kv_heads=int(num(f"{arch}.attention.head_count_kv", heads)),
        head_dim=int(num(f"{arch}.attention.key_length", d // heads)),
        max_seq_len=int(num(f"{arch}.context_length", 4096)),
        rope_theta=float(num(f"{arch}.rope.freq_base", 10000.0)),
        rope_scaling=scaling,
        norm_eps=float(num(f"{arch}.attention.layer_norm_rms_epsilon", 1e-5)),
        tie_embeddings="output.weight" not in reader.tensor_names,
        sliding_window=int(num(f"{arch}.attention.sliding_window", 0)) or None,
        bos_id=int(num("tokenizer.ggml.bos_token_id", 1)),
        eos_id=int(num("tokenizer.ggml.eos_token_id", 2)),
        pad_id=int(num("tokenizer.ggml.padding_token_id", 0)),
    )


def load_gguf_checkpoint(
    path,
    cfg: Optional[LlamaConfig] = None,
    dtype: Optional[torch.dtype] = None,
    device=None,
    mesh=None,
) -> Tuple[LlamaConfig, Dict[str, Any]]:
    """Load a GGUF blob into (config, param tree) on `device` (default
    CUDA); mirrors `load_hf_checkpoint`, a `mesh` included. Quantized
    tensors dequantize to f32 in C++ and land as `dtype` (default bf16),
    one stacked parameter at a time."""
    from ..native import GGUFReader

    dtype = dtype or torch.bfloat16
    dev = resolve_load_device(device, mesh)

    with GGUFReader(path) as r:
        if cfg is None:
            cfg = config_from_gguf(r)
        if mesh is not None:
            from ..parallel.sharding import validate_tp

            validate_tp(cfg, mesh.shape["tp"])

        def stack(name: str, tmpl: str, transpose: bool, unpermute_heads: int = 0):
            mats = []
            for i in range(cfg.num_layers):
                t = r.tensor_f32(tmpl.format(i=i))
                mats.append(_unpermute_qk(t, unpermute_heads) if unpermute_heads else t)
            return place_leaf(name, torch.from_numpy(np.stack(mats, axis=0)),
                              dtype, dev, mesh, transpose)

        def put(name: str, a: np.ndarray) -> torch.Tensor:
            return place_leaf(name, torch.from_numpy(a), dtype, dev, mesh)

        params: Dict[str, Any] = {
            "embed": put("embed", r.tensor_f32("token_embd.weight")),
            "blocks": {
                "wq": stack("wq", "blk.{i}.attn_q.weight", True, cfg.num_heads),
                "wk": stack("wk", "blk.{i}.attn_k.weight", True, cfg.num_kv_heads),
                "wv": stack("wv", "blk.{i}.attn_v.weight", True),
                "wo": stack("wo", "blk.{i}.attn_output.weight", True),
                "wg": stack("wg", "blk.{i}.ffn_gate.weight", True),
                "wu": stack("wu", "blk.{i}.ffn_up.weight", True),
                "wd": stack("wd", "blk.{i}.ffn_down.weight", True),
                "ln_attn": stack("ln_attn", "blk.{i}.attn_norm.weight", False),
                "ln_mlp": stack("ln_mlp", "blk.{i}.ffn_norm.weight", False),
            },
            "final_norm": put("final_norm", r.tensor_f32("output_norm.weight")),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = put("lm_head", r.tensor_f32("output.weight"))
    return cfg, params


# ---------------------------------------------------------------------------
# Writing

def _f16_bytes(a: np.ndarray) -> np.ndarray:
    """[n] float16 -> [n, 2] little-endian bytes."""
    return a.astype("<f2").view(np.uint8).reshape(-1, 2)


def _quantize_q(t: torch.Tensor, quant: str) -> bytes:
    """q8_0 / q4_0 blocks of 32 on `t`'s device (f32 arithmetic, IEEE
    division, round half to even, as numpy's), moved to the host as bytes."""
    blocks = t.reshape(-1, 32)
    if quant == "q8_0":
        # Per-block absmax/127 scale, stored f16; dequant uses the f16
        # value, so quantize against the rounded scale.
        scale16 = (blocks.abs().amax(dim=1) / 127.0).half()
        s = scale16.float()
        s = torch.where(s == 0, torch.ones_like(s), s)
        q = torch.clamp(torch.round(blocks / s[:, None]), -127, 127).to(torch.int8)
        out = torch.cat([scale16.view(torch.uint8).reshape(-1, 2),
                         q.view(torch.uint8)], dim=1)
    else:
        # d = signed-max / -8, q = round(x/d) + 8 in [0, 15]; low nibbles
        # hold elements 0..15, high nibbles 16..31.
        m = blocks.gather(1, blocks.abs().argmax(dim=1, keepdim=True))[:, 0]
        d16 = (m / -8.0).half()
        df = d16.float()
        df = torch.where(df == 0, torch.ones_like(df), df)
        q = torch.clamp(torch.round(blocks / df[:, None]) + 8, 0, 15).to(torch.uint8)
        out = torch.cat([d16.view(torch.uint8).reshape(-1, 2),
                         q[:, :16] | (q[:, 16:] << 4)], dim=1)
    return out.cpu().numpy().tobytes()


def _quantize(t: torch.Tensor, quant: str) -> bytes:
    """Serialize an f32 tensor in the given GGML dtype's data layout: the
    JAX package's per-block arithmetic, run over all blocks at once."""
    if quant in ("q8_0", "q4_0"):
        if t.numel() % 32:
            raise ValueError(f"{quant} needs a multiple of 32 elements")
        return _quantize_q(t.contiguous(), quant)
    flat = t.reshape(-1).cpu().numpy()
    if quant == "f32":
        return flat.astype("<f4").tobytes()
    if quant == "f16":
        return flat.astype("<f2").tobytes()
    nbytes, per = _BLOCK[quant]
    if flat.size % per:
        raise ValueError(f"{quant} needs a multiple of {per} elements")
    # q6_k: 256-element super-blocks of 16 sub-blocks: ql[128] low nibbles,
    # qh[64] high 2-bit planes, 16 int8 sub-block scales, f16 super scale;
    # element e = d * sc8[e // 16] * (q6 - 32), q6 in [0, 63].
    sub = flat.reshape(-1, 16, 16)
    s = np.abs(sub).max(axis=2) / 31.0
    d16 = (s.max(axis=1) / 127.0).astype(np.float16)
    d = d16.astype(np.float32)
    zero = d == 0
    d16[zero] = 1.0
    d[zero] = 1.0
    sc8 = np.clip(np.rint(s / d[:, None]), -128, 127).astype(np.int8)
    eff = d[:, None] * sc8.astype(np.float32)
    eff_safe = np.where(eff == 0, 1.0, eff)
    q = np.clip(np.rint(sub / eff_safe[:, :, None]) + 32, 0, 63).astype(
        np.uint8).reshape(-1, 2, 4, 32)  # [block, half, quarter, 32]
    q1, q2, q3, q4 = (q[:, :, j] for j in range(4))
    ql = np.concatenate([(q1 & 0x0F) | ((q3 & 0x0F) << 4),
                         (q2 & 0x0F) | ((q4 & 0x0F) << 4)], axis=2)
    qh = (q1 >> 4) | ((q2 >> 4) << 2) | ((q3 >> 4) << 4) | ((q4 >> 4) << 6)
    nb = q.shape[0]
    return np.concatenate([
        ql.astype(np.uint8).reshape(nb, 128), qh.astype(np.uint8).reshape(nb, 64),
        sc8.view(np.uint8), _f16_bytes(d16),
    ], axis=1).tobytes()


def _nbytes(n: int, quant: str) -> int:
    if quant in ("f32", "f16"):
        return n * (4 if quant == "f32" else 2)
    size, per = _BLOCK[quant]
    return n // per * size


def _kv_str(key: str, val: str) -> bytes:
    kb, vb = key.encode(), val.encode()
    return (struct.pack("<Q", len(kb)) + kb + struct.pack("<I", 8)
            + struct.pack("<Q", len(vb)) + vb)


def _kv_u32(key: str, val: int) -> bytes:
    kb = key.encode()
    return struct.pack("<Q", len(kb)) + kb + struct.pack("<II", 4, val)


def _kv_f32(key: str, val: float) -> bytes:
    kb = key.encode()
    return struct.pack("<Q", len(kb)) + kb + struct.pack("<If", 6, val)


def write_gguf(cfg: LlamaConfig, params: Dict[str, Any], path,
               quant: str = "f16") -> None:
    """Export the param tree as a GGUF v3 blob.

    `quant` applies to the 2-D matmul weights and the embeddings; norms stay
    f32 (llama.cpp convention). The tensor directory is computed from the
    shapes first; each tensor is then quantized where it lives, moved to
    the host and written on its own."""
    if quant not in _QUANT_IDS:
        raise ValueError(f"quant must be one of {sorted(_QUANT_IDS)}")

    def host(x: torch.Tensor, transpose=False, permute_heads=0):
        def get() -> torch.Tensor:
            # Transpose, permute and quantize where the tensor lives (the
            # card, in serving).
            t = x.detach().to(torch.float32)
            if transpose:
                t = t.T
            if permute_heads:
                t = _permute_qk(t, permute_heads)
            return t.contiguous()
        shape = tuple(x.shape[::-1]) if transpose else tuple(x.shape)
        return shape, get

    # name -> ((shape [out, in] or [d], fetch), quant kind)
    tensors: Dict[str, Tuple[Tuple, str]] = {
        "token_embd.weight": (host(params["embed"]), quant),
        "output_norm.weight": (host(params["final_norm"]), "f32"),
    }
    if cfg.rope_scaling is not None:
        # llama.cpp convention: scaling ships as the per-dim divisor tensor
        # (see config_from_gguf).
        from ..ops.rope import freq_factors_for

        ff = freq_factors_for(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
        tensors["rope_freqs.weight"] = (host(ff), "f32")
    if not cfg.tie_embeddings:
        tensors["output.weight"] = (host(params["lm_head"]), quant)
    b = params["blocks"]
    for i in range(cfg.num_layers):
        p = f"blk.{i}."
        tensors[p + "attn_q.weight"] = (host(b["wq"][i], True, cfg.num_heads), quant)
        tensors[p + "attn_k.weight"] = (host(b["wk"][i], True, cfg.num_kv_heads), quant)
        tensors[p + "attn_v.weight"] = (host(b["wv"][i], True), quant)
        tensors[p + "attn_output.weight"] = (host(b["wo"][i], True), quant)
        tensors[p + "ffn_gate.weight"] = (host(b["wg"][i], True), quant)
        tensors[p + "ffn_up.weight"] = (host(b["wu"][i], True), quant)
        tensors[p + "ffn_down.weight"] = (host(b["wd"][i], True), quant)
        tensors[p + "attn_norm.weight"] = (host(b["ln_attn"][i]), "f32")
        tensors[p + "ffn_norm.weight"] = (host(b["ln_mlp"][i]), "f32")

    kvs = [
        _kv_str("general.architecture", "llama"),
        _kv_str("general.name", cfg.name),
        _kv_u32("general.alignment", 32),
        _kv_u32("llama.block_count", cfg.num_layers),
        _kv_u32("llama.embedding_length", cfg.hidden_size),
        _kv_u32("llama.feed_forward_length", cfg.intermediate_size),
        _kv_u32("llama.attention.head_count", cfg.num_heads),
        _kv_u32("llama.attention.head_count_kv", cfg.num_kv_heads),
        _kv_u32("llama.attention.key_length", cfg.head_dim),
        _kv_u32("llama.context_length", cfg.max_seq_len),
        _kv_f32("llama.rope.freq_base", cfg.rope_theta),
        _kv_f32("llama.attention.layer_norm_rms_epsilon", cfg.norm_eps),
        _kv_u32("tokenizer.ggml.bos_token_id", cfg.bos_id),
        _kv_u32("tokenizer.ggml.eos_token_id", cfg.eos_id),
        _kv_u32("tokenizer.ggml.padding_token_id", cfg.pad_id),
    ]
    if cfg.sliding_window is not None:
        kvs.append(_kv_u32("llama.attention.sliding_window", cfg.sliding_window))

    infos = bytearray()
    offset = 0
    for name, ((shape, _), kind) in tensors.items():
        nb = name.encode()
        dims = tuple(reversed(shape))  # GGUF order: innermost first
        infos += struct.pack("<Q", len(nb)) + nb
        infos += struct.pack("<I", len(dims))
        for d in dims:
            infos += struct.pack("<Q", d)
        infos += struct.pack("<IQ", _QUANT_IDS[kind], offset)
        offset += _nbytes(int(np.prod(shape)), kind)
        offset += -offset % 32  # next tensor starts 32-aligned

    header = b"GGUF" + struct.pack("<IQQ", 3, len(tensors), len(kvs))
    meta = header + b"".join(kvs) + bytes(infos)
    with open(path, "wb") as f:
        f.write(meta)
        f.write(b"\x00" * (-len(meta) % 32))
        for (_, get), kind in tensors.values():
            data = _quantize(get(), kind)
            f.write(data)
            f.write(b"\x00" * (-len(data) % 32))
