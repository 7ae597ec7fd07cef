"""The port's one-command runbook vs the JAX package's: twins of
tests/test_runbook.py.

A checkpoint the test writes itself (JAX's TINY f32 tree through JAX's HF
writer, with a WordLevel tokenizer.json beside it) goes through both
runbooks: weights -> the native cache -> scheduler backends -> the eval
suite -> the markdown report, whose tables must be equal apart from
wall-clock fields. The port's first run converts and fills its cache, the
second restores from it, a touched weight file reconverts; the cache key
and the config sidecar equal JAX's. `--tp 2` runs the port's runbook over
a gloo group of two ranks (rank 0 writes the report, rank 1 follows), with
the same report as one rank.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import pytest

from llm_based_apache_spark_optimization_tpu import runbook as jax_runbook
from llm_based_apache_spark_optimization_tpu.checkpoint import save_hf_checkpoint
from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
from llm_based_apache_spark_optimization_tpu_torch import runbook
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
from llm_based_apache_spark_optimization_tpu_torch.models.configs import RopeFreqFactors
from torch_spmd import run_group

tokenizers = pytest.importorskip("tokenizers")

_WALL = re.compile(r"\d+\.\d+")


def norm(text: str) -> str:
    """The report without its wall-clock fields (latencies, tok/s, the
    roofline shares, TTFT and queue-wait lines, the timestamp) and platform
    line."""
    out = []
    for line in text.splitlines():
        if re.search(r"TTFT|queue wait|platform|generated \d", line, re.I):
            continue
        if re.search(r"latency|tok/s|Throughput|cadence|MFU", line, re.I) or " s |" in line:
            line = _WALL.sub("#", line)
            line = re.sub(r"\*\*[^*]+\*\* \(avg #", "** (avg #", line)
        out.append(line)
    return "\n".join(out)


def _write_word_tokenizer(ckpt_dir, words: str) -> None:
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    vocab = {"<s>": 1, "</s>": 2, "[UNK]": 0}
    for i, w in enumerate(words.split()):
        vocab[w] = 3 + i
    tok = Tokenizer(WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = Whitespace()
    tok.save(str(ckpt_dir / "tokenizer.json"))


@pytest.fixture(scope="module")
def fixture_ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("runbook_ckpt")
    save_hf_checkpoint(JAX_TINY, jax_init(JAX_TINY, jax.random.key(3), dtype=jnp.float32),
                       root)
    _write_word_tokenizer(root, "select from where count sum vendor fare table schema")
    return root


def _argv(ckpt, cache, out, *extra):
    return ["--sql-model", str(ckpt), "--cache-dir", str(cache),
            "--max-new-tokens", "8", "--max-seq", "2048", "--slots", "2",
            "-o", str(out), "--cpu", *extra]


def test_runbook_one_command_report_and_cache(fixture_ckpt, tmp_path, capsys):
    """Convert + cache, restore, and reconvert after a weight file changes;
    the smoke report's tables equal JAX's runbook's over the same files."""
    cache = tmp_path / "cache"
    out = tmp_path / "EVAL.md"
    runbook.main(_argv(fixture_ckpt, cache, out, "--limit-cases", "1"))
    text = out.read_text()
    assert "Four-query suite — per query" in text
    assert "duckdb-nsql" in text and "llama3.2" in text
    cached = list(cache.iterdir())
    assert len(cached) == 1 and (cached[0] / "config.json").exists()
    jout = tmp_path / "JAX.md"
    jax_runbook.main(_argv(fixture_ckpt, tmp_path / "jcache", jout, "--limit-cases", "1"))
    assert norm(text) == norm(jout.read_text())
    # The cache directory's name (the source's identity) is JAX's.
    assert [p.name for p in cached] == [p.name for p in (tmp_path / "jcache").iterdir()]

    capsys.readouterr()
    out2 = tmp_path / "EVAL2.md"
    runbook.main(_argv(fixture_ckpt, cache, out2, "--limit-cases", "1"))
    assert "restored native cache" in capsys.readouterr().out
    assert norm(out2.read_text()) == norm(text)

    os.utime(fixture_ckpt / "model.safetensors")
    runbook.main(_argv(fixture_ckpt, cache, tmp_path / "EVAL3.md", "--limit-cases", "1"))
    assert "converted + cached" in capsys.readouterr().out


def test_runbook_full_report_has_config_table(fixture_ckpt, tmp_path):
    """Without --limit-cases the report carries the BASELINE config table
    with each row's mesh (the service's: tp=1)."""
    out = tmp_path / "EVAL.md"
    runbook.main(_argv(fixture_ckpt, tmp_path / "cache", out))
    text = out.read_text()
    assert "## BASELINE configs" in text and "| Config | Mesh |" in text
    assert "Q4" in text


def test_runbook_over_transformers_written_checkpoint(tmp_path):
    """Weights in -> report out over a checkpoint written by HF
    `transformers` itself (save_pretrained), not the in-tree writer."""
    torch = pytest.importorskip("torch")
    transformers = pytest.importorskip("transformers")

    torch.manual_seed(0)
    hf_cfg = transformers.LlamaConfig(
        vocab_size=96, hidden_size=32, intermediate_size=48,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rope_theta=10000.0,
        bos_token_id=1, eos_token_id=2, pad_token_id=0,
    )
    model = transformers.LlamaForCausalLM(hf_cfg).eval().float()
    ckpt = tmp_path / "hf"
    model.save_pretrained(ckpt, safe_serialization=True)
    _write_word_tokenizer(ckpt, "select from where count sum vendor fare")
    out = tmp_path / "EVAL.md"
    runbook.main(_argv(ckpt, tmp_path / "cache", out, "--limit-cases", "1"))
    assert "Four-query suite — per query" in out.read_text()


def test_runbook_cfg_json_roundtrip():
    """The cache sidecar round-trips every config field, both rope-scaling
    representations and the stop ids, and equals JAX's sidecar."""
    cfg = dataclasses.replace(TINY, extra_stop_ids=(7, 9))
    assert runbook._cfg_load(runbook._cfg_dump(cfg)) == cfg
    assert runbook._cfg_dump(cfg) == jax_runbook._cfg_dump(
        dataclasses.replace(JAX_TINY, extra_stop_ids=(7, 9)))
    cfg2 = dataclasses.replace(TINY, rope_scaling=RopeFreqFactors((1.0, 2.0, 4.0, 8.0)))
    assert runbook._cfg_load(runbook._cfg_dump(cfg2)) == cfg2


def test_runbook_speculative_flag(fixture_ckpt, tmp_path):
    """--speculative N reaches the scheduler and the engine backends; the
    engine path refuses it beside --kv-int8, as JAX does."""
    out = tmp_path / "SPEC.md"
    runbook.main(_argv(fixture_ckpt, tmp_path / "cache", out, "--speculative", "4",
                       "--limit-cases", "1"))
    assert "Four-query suite — per query" in out.read_text()
    out2 = tmp_path / "SPEC_ENG.md"
    runbook.main(_argv(fixture_ckpt, tmp_path / "cache", out2, "--no-scheduler",
                       "--speculative", "4", "--limit-cases", "1"))
    assert "Four-query suite — per query" in out2.read_text()
    with pytest.raises(SystemExit, match="kv-int8"):
        runbook.main(_argv(fixture_ckpt, tmp_path / "cache", tmp_path / "x.md",
                           "--no-scheduler", "--speculative", "4", "--kv-int8"))


def test_runbook_documented_invocations_parse():
    """The docstring's invocations stay dry-runnable, with JAX's flags."""
    ap = runbook.build_parser()
    smoke = ap.parse_args(["--sql-model", "/weights/duckdb-nsql-7b",
                           "--limit-cases", "1", "-o", "SMOKE.md"])
    assert smoke.limit_cases == 1 and smoke.out == "SMOKE.md"
    full = ap.parse_args(["--sql-model", "/weights/duckdb-nsql-7b",
                          "--error-model", "/weights/llama3.2-3b",
                          "--int8", "--kv-int8", "--speculative", "4", "-o", "EVAL.md"])
    assert full.int8 and full.kv_int8 and full.speculative == 4
    assert full.limit_cases is None
    tp4 = ap.parse_args(["--sql-model", "/weights/duckdb-nsql-7b", "--int4", "--tp", "4"])
    assert tp4.int4 and tp4.tp == 4

    def flags(p):
        return sorted((a.dest, a.default) for a in p._actions)

    assert flags(ap) == flags(jax_runbook.build_parser())


def test_runbook_limit_cases_smoke_mode(fixture_ckpt, tmp_path):
    out = tmp_path / "SMOKE.md"
    runbook.main(_argv(fixture_ckpt, tmp_path / "cache", out, "--limit-cases", "1"))
    text = out.read_text()
    assert "Q1" in text and "Q2" not in text
    assert "## BASELINE configs" not in text
    with pytest.raises(SystemExit, match="limit-cases"):
        runbook.main(_argv(fixture_ckpt, tmp_path / "cache", out, "--limit-cases", "0"))


def test_runbook_tp2_over_two_ranks(fixture_ckpt, tmp_path):
    """`--tp 2` on a group of two gloo ranks: each rank restores its block
    of the cache, rank 0 writes the report (mesh tp=2) and rank 1 follows;
    the tables equal one rank's."""
    one = tmp_path / "ONE.md"
    runbook.main(_argv(fixture_ckpt, tmp_path / "cache1", one, "--limit-cases", "1"))
    out = tmp_path / "TP2.md"
    argv = _argv(fixture_ckpt, tmp_path / "cache2", out, "--limit-cases", "1", "--tp", "2")
    text, follower = run_group(2, "runbook_group", tmp_path / "grp",
                               {"argv": argv, "out": str(out)})
    assert follower is None
    assert "tp=2" in text
    assert norm(text.replace("tp=2", "tp=1")) == norm(one.read_text())
