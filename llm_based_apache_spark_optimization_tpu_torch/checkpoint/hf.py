"""HF-format Llama checkpoint loading: safetensors -> the stacked param tree.

Counterpart of the JAX package's `checkpoint/hf.py`. Name map (HF
`LlamaForCausalLM` / `MistralForCausalLM` state dict -> ours):

    model.embed_tokens.weight                  [V, D]    -> embed          [V, D]
    model.layers.{i}.self_attn.q_proj.weight   [N*H, D]  -> blocks.wq[i]   [D, N*H]  (T)
    model.layers.{i}.self_attn.k_proj.weight   [K*H, D]  -> blocks.wk[i]   [D, K*H]  (T)
    model.layers.{i}.self_attn.v_proj.weight   [K*H, D]  -> blocks.wv[i]   [D, K*H]  (T)
    model.layers.{i}.self_attn.o_proj.weight   [D, N*H]  -> blocks.wo[i]   [N*H, D]  (T)
    model.layers.{i}.mlp.gate_proj.weight      [F, D]    -> blocks.wg[i]   [D, F]    (T)
    model.layers.{i}.mlp.up_proj.weight        [F, D]    -> blocks.wu[i]   [D, F]    (T)
    model.layers.{i}.mlp.down_proj.weight      [D, F]    -> blocks.wd[i]   [F, D]    (T)
    model.layers.{i}.input_layernorm.weight    [D]       -> blocks.ln_attn[i]
    model.layers.{i}.post_attention_layernorm  [D]       -> blocks.ln_mlp[i]
    model.norm.weight                          [D]       -> final_norm
    lm_head.weight                             [V, D]    -> lm_head (absent if tied)

(T) = torch Linear stores [out, in]; the port's matmuls compute x @ W, so
weights transpose on load. Rope needs no permutation: HF uses the
split-half rotation layout and so does `ops/rope.py`.

The safetensors files are read by the port's own reader
(checkpoint/safetensors.py), sharded checkpoints through
`model.safetensors.index.json`. Each stacked parameter is read, cast and
placed on `device` on its own, so peak host memory stays at about one
stacked parameter.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from .. import resolve_device
from ..models.configs import LlamaConfig, RopeScaling
from .safetensors import SafetensorsFile, save_file

__all__ = ["config_from_hf", "load_hf_checkpoint", "save_hf_checkpoint"]


def config_from_hf(hf: Dict[str, Any], name: str = "hf-model") -> LlamaConfig:
    """Build a LlamaConfig from an HF `config.json` dict."""
    scaling = None
    rs = hf.get("rope_scaling") or None
    if rs and rs.get("rope_type", rs.get("type")) == "llama3":
        scaling = RopeScaling(
            factor=rs.get("factor", 8.0),
            low_freq_factor=rs.get("low_freq_factor", 1.0),
            high_freq_factor=rs.get("high_freq_factor", 4.0),
            original_max_position_embeddings=rs.get(
                "original_max_position_embeddings", 8192
            ),
        )
    heads = hf["num_attention_heads"]
    eos = hf.get("eos_token_id", 2)
    extra_stops: tuple = ()
    if isinstance(eos, list):
        # llama-3.x ships a LIST of stop ids (e.g. [128001, 128008, 128009]);
        # chat turns end at <|eot_id|>, so the whole list must reach the
        # stop set, not just the first entry.
        extra_stops = tuple(int(e) for e in eos[1:])
        eos = eos[0]
    return LlamaConfig(
        name=name,
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=heads,
        num_kv_heads=hf.get("num_key_value_heads", heads),
        head_dim=hf.get("head_dim") or hf["hidden_size"] // heads,
        max_seq_len=hf.get("max_position_embeddings", 4096),
        rope_theta=hf.get("rope_theta", 10000.0),
        rope_scaling=scaling,
        norm_eps=hf.get("rms_norm_eps", 1e-5),
        tie_embeddings=hf.get("tie_word_embeddings", False),
        sliding_window=hf.get("sliding_window"),
        bos_id=hf.get("bos_token_id", 1),
        eos_id=eos,
        pad_id=hf.get("pad_token_id") or 0,
        extra_stop_ids=extra_stops,
    )


class _ShardedReader:
    """Tensor name -> CPU tensor over one or many .safetensors files."""

    def __init__(self, ckpt_dir: Path):
        index = ckpt_dir / "model.safetensors.index.json"
        self._open: Dict[Path, SafetensorsFile] = {}
        if index.exists():
            weight_map = json.loads(index.read_text())["weight_map"]
            self._files = {n: ckpt_dir / f for n, f in weight_map.items()}
        else:
            single = sorted(ckpt_dir.glob("*.safetensors"))
            if not single:
                raise FileNotFoundError(f"no .safetensors under {ckpt_dir}")
            self._files = {}
            for f in single:
                for n in self._file(f).keys():
                    self._files[n] = f

    def _file(self, f: Path) -> SafetensorsFile:
        if f not in self._open:
            self._open[f] = SafetensorsFile(f)
        return self._open[f]

    def __contains__(self, name: str) -> bool:
        return name in self._files

    def get(self, name: str) -> torch.Tensor:
        return self._file(self._files[name]).get(name)


def place(t: torch.Tensor, dtype: torch.dtype, device: torch.device,
          transpose: bool = False) -> torch.Tensor:
    """A host tensor as `dtype` on `device`, its last two axes swapped with
    `transpose` (torch-Linear [out, in] -> the port's [in, out]): moved in
    its stored dtype, then transposed and cast where it landed."""
    t = t.to(device)
    if transpose:
        t = t.transpose(-1, -2)
    return t.to(dtype).contiguous()


def resolve_load_device(device, mesh=None) -> torch.device:
    """The one device a checkpoint loads onto: the mesh rank's under a
    `mesh` (each rank loads its own block), else `device`. A sharded load
    names its mesh; a list of several devices is not one."""
    if mesh is not None:
        return mesh.device
    if isinstance(device, (list, tuple)):
        if len(device) > 1:
            raise ValueError(
                "a checkpoint loads onto one device, or onto a mesh: pass "
                "mesh=parallel.make_mesh(...) for a sharded load")
        device = device[0] if device else None
    return resolve_device(device)


def place_leaf(name: str, t: torch.Tensor, dtype: torch.dtype,
               device: torch.device, mesh, transpose: bool = False) -> torch.Tensor:
    """Leaf `name` of the params tree from host tensor `t`, as `place` puts
    it. Under a `mesh` only this rank's block (parallel/sharding.py): cut
    from the host tensor, transposed first, so only the block reaches the
    device."""
    if mesh is not None:
        from ..parallel.sharding import block, leaf_spec

        if transpose:
            t = t.transpose(-1, -2)
        t, transpose = block(t, leaf_spec(name), mesh), False
    return place(t, dtype, device, transpose)


def load_hf_checkpoint(
    ckpt_dir,
    cfg: Optional[LlamaConfig] = None,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
    mesh=None,
) -> tuple:
    """Load an HF-format directory into (config, param tree) on `device`
    (default CUDA). `cfg=None` infers the architecture from the directory's
    config.json. Under a `mesh` each rank keeps only its block of every
    tensor (parallel/sharding.py), on its own device: the tree is the one
    `shard_params` would give."""
    ckpt_dir = Path(ckpt_dir)
    dev = resolve_load_device(device, mesh)
    if cfg is None:
        hf_cfg = json.loads((ckpt_dir / "config.json").read_text())
        cfg = config_from_hf(hf_cfg, name=ckpt_dir.name)
    if mesh is not None:
        from ..parallel.sharding import validate_tp

        validate_tp(cfg, mesh.shape["tp"])
    r = _ShardedReader(ckpt_dir)

    def put(t: torch.Tensor, name: str) -> torch.Tensor:
        return place_leaf(name, t, dtype, dev, mesh)

    def stack(tmpl: str, transpose: bool, name: str) -> torch.Tensor:
        mats = [r.get(tmpl.format(i=i)) for i in range(cfg.num_layers)]
        return place_leaf(name, torch.stack(mats), dtype, dev, mesh, transpose)

    p = "model.layers.{i}."
    names = {
        "wq": (p + "self_attn.q_proj.weight", True),
        "wk": (p + "self_attn.k_proj.weight", True),
        "wv": (p + "self_attn.v_proj.weight", True),
        "wo": (p + "self_attn.o_proj.weight", True),
        "wg": (p + "mlp.gate_proj.weight", True),
        "wu": (p + "mlp.up_proj.weight", True),
        "wd": (p + "mlp.down_proj.weight", True),
        "ln_attn": (p + "input_layernorm.weight", False),
        "ln_mlp": (p + "post_attention_layernorm.weight", False),
    }
    params: Dict[str, Any] = {
        "embed": put(r.get("model.embed_tokens.weight"), "embed"),
        "blocks": {k: stack(n, t, k) for k, (n, t) in names.items()},
        "final_norm": put(r.get("model.norm.weight"), "final_norm"),
    }
    if not cfg.tie_embeddings:
        name = ("lm_head.weight" if "lm_head.weight" in r
                else "model.embed_tokens.weight")  # some exports tie implicitly
        params["lm_head"] = put(r.get(name), "lm_head")
    return cfg, params


def save_hf_checkpoint(cfg: LlamaConfig, params: Dict[str, Any], out_dir) -> None:
    """Write the param tree out in HF single-file safetensors format, in f32
    as the JAX package's writer does (the inverse of `load_hf_checkpoint`).
    One tensor at a time reaches the host."""
    from ..ops.quant import is_q4tensor

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    b = params["blocks"]
    if any(is_q4tensor(w) for w in b.values()):
        raise ValueError("save_hf_checkpoint takes a float param tree, not int4")
    tensors: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": params["embed"],
        "model.norm.weight": params["final_norm"],
    }
    if not cfg.tie_embeddings:
        tensors["lm_head.weight"] = params["lm_head"]
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        tensors[p + "self_attn.q_proj.weight"] = b["wq"][i].T
        tensors[p + "self_attn.k_proj.weight"] = b["wk"][i].T
        tensors[p + "self_attn.v_proj.weight"] = b["wv"][i].T
        tensors[p + "self_attn.o_proj.weight"] = b["wo"][i].T
        tensors[p + "mlp.gate_proj.weight"] = b["wg"][i].T
        tensors[p + "mlp.up_proj.weight"] = b["wu"][i].T
        tensors[p + "mlp.down_proj.weight"] = b["wd"][i].T
        tensors[p + "input_layernorm.weight"] = b["ln_attn"][i]
        tensors[p + "post_attention_layernorm.weight"] = b["ln_mlp"][i]
    save_file(tensors, out_dir / "model.safetensors", metadata={"format": "pt"},
              dtype=torch.float32)

    hf_cfg = {
        "architectures": ["LlamaForCausalLM"],
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim,
        "max_position_embeddings": cfg.max_seq_len,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.norm_eps,
        "tie_word_embeddings": cfg.tie_embeddings,
        "bos_token_id": cfg.bos_id,
        "eos_token_id": (
            [cfg.eos_id, *cfg.extra_stop_ids] if cfg.extra_stop_ids
            else cfg.eos_id
        ),
        "pad_token_id": cfg.pad_id,
    }
    if cfg.sliding_window is not None:
        hf_cfg["sliding_window"] = cfg.sliding_window
        hf_cfg["architectures"] = ["MistralForCausalLM"]
    if cfg.rope_scaling is not None and not isinstance(cfg.rope_scaling,
                                                       RopeScaling):
        # RopeFreqFactors (GGUF-loaded explicit divisors) has no config.json
        # representation; dropping it would reload with unscaled rope.
        raise ValueError(
            f"{cfg.name}: rope scaling of type "
            f"{type(cfg.rope_scaling).__name__} cannot be represented in an "
            "HF config.json — export this model with checkpoint.write_gguf "
            "(which bakes it into rope_freqs.weight)"
        )
    if isinstance(cfg.rope_scaling, RopeScaling):
        s = cfg.rope_scaling
        hf_cfg["rope_scaling"] = {
            "rope_type": "llama3",
            "factor": s.factor,
            "low_freq_factor": s.low_freq_factor,
            "high_freq_factor": s.high_freq_factor,
            "original_max_position_embeddings": s.original_max_position_embeddings,
        }
    (out_dir / "config.json").write_text(json.dumps(hf_cfg, indent=2))
