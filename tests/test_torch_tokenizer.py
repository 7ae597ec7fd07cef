"""The port's tokenizers against the JAX package's: byte-level BPE trains,
encodes and decodes the same on tests/test_tokenizer.py's corpora, a BPE file
saved by either package loads in the other, and `HFTokenizer` over a
`tokenizer.json` written here gives the same ids, text and stop ids
(`eos_ids`) as JAX's."""

import pytest

from llm_based_apache_spark_optimization_tpu.tokenizer import (
    BPETokenizer as JaxBPE,
)
from llm_based_apache_spark_optimization_tpu.tokenizer import HFTokenizer as JaxHF
from llm_based_apache_spark_optimization_tpu.tokenizer import train_bpe as jax_train
from llm_based_apache_spark_optimization_tpu_torch.tokenizer import (
    BPETokenizer,
    HFTokenizer,
    train_bpe,
)

CORPORA = {
    "sql": (["SELECT * FROM taxi", "SELECT VendorID FROM taxi",
             "SELECT SUM(total_amount) FROM taxi"] * 4, 32),
    "fox": (["the quick brown fox"] * 8, 16),
    "ascii": (["ascii only"] * 4, 8),
}
TEXTS = ["SELECT AVG(trip_distance) FROM taxi", "the quick brown fox jumps",
         "日本語 ¿ñ?", "", "SELECT * FROM taxi"]


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_bpe_train_encode_decode_match_jax(corpus):
    texts, merges = CORPORA[corpus]
    want, got = jax_train(texts, num_merges=merges), train_bpe(texts, num_merges=merges)
    assert got.merges == want.merges and got.vocab_size == want.vocab_size
    for text in TEXTS:
        for bos in (True, False):
            assert got.encode(text, add_bos=bos) == want.encode(text, add_bos=bos)
        assert got.decode(got.encode(text)) == want.decode(want.encode(text)) == text


def test_bpe_merge_priority_is_rank_order():
    a, b, c = 3 + ord("a"), 3 + ord("b"), 3 + ord("c")
    tok = BPETokenizer([(a, b), (259, c)])
    assert tok.encode("abc", add_bos=False) == [260]
    assert tok.decode([260]) == "abc"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bpe_files_load_in_the_other_package(tmp_path, writer):
    texts, n = CORPORA["sql"]
    trained = jax_train(texts, num_merges=n, n_special=8)
    merges = sorted(trained.merges, key=trained.merges.get)
    special = dict(n_special=8, pad_id=3, bos_id=5, eos_id=6)
    src = (JaxBPE if writer == "jax" else BPETokenizer)(merges, **special)
    path = tmp_path / "bpe.json"
    src.save(path)
    dst = (BPETokenizer if writer == "jax" else JaxBPE).load(path)
    assert (dst.pad_id, dst.bos_id, dst.eos_id, dst.n_special) == (3, 5, 6, 8)
    assert dst.merges == src.merges
    for text in TEXTS:
        assert dst.encode(text) == src.encode(text)


def write_tokenizer_json(path, kind: str) -> None:
    """A real tokenizer.json: a WordLevel vocabulary with llama-3 style
    special tokens, or a byte-level BPE trained on the SQL corpus."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    if kind == "wordlevel":
        vocab = {"[UNK]": 0, "<|begin_of_text|>": 1, "<|end_of_text|>": 2,
                 "<|eot_id|>": 3, "<|eom_id|>": 4}
        for i, w in enumerate("select from where count sum vendor fare taxi".split()):
            vocab[w] = 5 + i
        tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
        tok.pre_tokenizer = pre_tokenizers.Whitespace()
    else:
        tok = Tokenizer(models.BPE())
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
        tok.decoder = decoders.ByteLevel()
        trainer = trainers.BpeTrainer(
            vocab_size=300, special_tokens=["<unk>", "<s>", "</s>"],
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
        tok.train_from_iterator(CORPORA["sql"][0] * 4, trainer)
    tok.save(str(path))


@pytest.mark.parametrize("kind", ["wordlevel", "bytelevel_bpe"])
def test_hf_tokenizer_matches_jax(tmp_path, kind):
    pytest.importorskip("tokenizers")
    write_tokenizer_json(tmp_path / "tokenizer.json", kind)
    want, got = JaxHF(str(tmp_path)), HFTokenizer(str(tmp_path))
    assert (got.bos_id, got.eos_id, got.pad_id) == (want.bos_id, want.eos_id, want.pad_id)
    assert got.eos_ids == want.eos_ids and got.vocab_size == want.vocab_size
    for text in ["select sum fare from taxi", "SELECT VendorID FROM taxi", ""]:
        for bos in (True, False):
            assert got.encode(text, add_bos=bos) == want.encode(text, add_bos=bos)
        ids = got.encode(text)
        assert got.decode(ids) == want.decode(ids)
    if kind == "wordlevel":
        assert got.eos_ids == (2, 3, 4)


def test_hf_tokenizer_without_the_package_raises(tmp_path, monkeypatch):
    """No substitute tokenizer: without `tokenizers` the adapter raises and
    names the package."""
    import sys

    monkeypatch.setitem(sys.modules, "tokenizers", None)
    with pytest.raises(RuntimeError, match="tokenizers"):
        HFTokenizer(str(tmp_path))
