"""The port's text library (native/bpe.cpp, native/csvscan.cpp) against the
JAX package's native layer and the Python passes.

The shapes are tests/test_native.py's: trained merges, long inputs and
random bytes for the BPE encoder; its CSV fixture and randomized CSVs for
the scanner. Each is held to the JAX package's result, to its own Python
pass, and the callers (`BPETokenizer.encode`, `SQLiteBackend.load_csv`) are
shown to go through the C++ side. `LSOT_NO_NATIVE=1` takes the Python
passes; a failed build raises.
"""

from __future__ import annotations

import csv
import os
import random

import pytest

from llm_based_apache_spark_optimization_tpu import native as jnative
from llm_based_apache_spark_optimization_tpu.sql.sqlite_backend import (
    SQLiteBackend as JSQLiteBackend,
)
from llm_based_apache_spark_optimization_tpu.tokenizer import BPETokenizer as JBPE
from llm_based_apache_spark_optimization_tpu_torch import native
from llm_based_apache_spark_optimization_tpu_torch.sql import sqlite_backend
from llm_based_apache_spark_optimization_tpu_torch.sql.sqlite_backend import (
    SQLiteBackend,
    _infer_dtype,
)
from llm_based_apache_spark_optimization_tpu_torch.tokenizer.bpe import (
    BPETokenizer,
    train_bpe,
)

PORT = os.path.dirname(os.path.abspath(native.__file__))

CORPUS = [
    "SELECT * FROM temp_view WHERE passenger_count > 2",
    "SELECT vendor_id, SUM(fare_amount) FROM temp_view GROUP BY vendor_id",
    "the quick brown fox jumps over the lazy dog",
    "ßßß unicode ÿ mixed 日本語 text",
]


@pytest.fixture(scope="module")
def trained():
    return train_bpe(CORPUS * 4, num_merges=80)


def ordered_merges(tok):
    return sorted(tok.merges, key=lambda p: tok.merges[p])


def bpe_inputs(kind):
    if kind == "corpus":
        return CORPUS + ["", "a", "SELECT COUNT(*) FROM t;", "日本語だけ"]
    if kind == "long":
        return [" ".join(CORPUS) * 12]  # ~2.4k characters, past any prompt chunk
    rng = random.Random(11)
    return [bytes(rng.randrange(256) for _ in range(rng.randint(1, 600)))
            .decode("utf-8", errors="replace") for _ in range(12)]


def test_text_library_builds_from_the_ports_sources():
    """libtext.so builds from the port's copies (no file of the JAX
    package's native/ directory, no include of its header) and binds."""
    lib = native.load_text()
    assert os.path.exists(native.TEXT_LIB) and lib.lsot_csv_scan is not None
    cpp = [f for f in native.TEXT_SOURCES if f.endswith(".cpp")]
    cmd = native.build_command(native.TEXT_LIB, *cpp)
    paths = [a[2:] if a.startswith("-I") else a for a in cmd[1:]
             if a.startswith("-I") or a.endswith(".cpp")]
    assert len(paths) == 3 and all(os.path.abspath(p).startswith(PORT) for p in paths)
    for src in native.TEXT_SOURCES:
        assert os.path.abspath(src).startswith(PORT + os.sep)
        text = open(src, encoding="utf-8").read()
        assert "lsot_native.h" not in text
        assert "llm_based_apache_spark_optimization_tpu/" not in text


@pytest.mark.parametrize("kind", ["corpus", "long", "random_bytes"])
def test_bpe_ids_equal_jax_native_and_python(trained, kind):
    """The port's C++ ids equal its Python loop's, JAX's C++ encoder's and
    JAX's Python loop's, through `encode` and the raw merge."""
    merges = ordered_merges(trained)
    jtok = JBPE(merges, n_special=trained.n_special)
    assert trained._native is not None and jtok._native is not None
    for text in bpe_inputs(kind):
        data = text.encode("utf-8")
        py = trained._merge([trained.n_special + b for b in data])
        nat = trained._native.encode_bytes(data)
        assert nat == py, f"port C++ vs Python on {text[:40]!r}"
        assert jtok._native.encode_bytes(data) == nat
        assert jtok._merge([jtok.n_special + b for b in data]) == nat
        assert trained.encode(text) == jtok.encode(text)
        assert trained.decode(trained.encode(text, add_bos=False)) == \
            jtok.decode(jtok.encode(text, add_bos=False))


def test_bpe_save_load_keeps_the_native_encoder(trained, tmp_path):
    trained.save(tmp_path / "bpe.json")
    back = BPETokenizer.load(tmp_path / "bpe.json")
    assert back._native is not None
    for text in CORPUS:
        assert back.encode(text) == trained.encode(text)
        assert back.decode(back.encode(text, add_bos=False)) == text


def py_infer(path):
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = list(reader)
    return [_infer_dtype([r[i] if i < len(r) else "" for r in rows])
            for i in range(len(header))], len(rows)


FIXTURE = (
    "id,big,price,when,label,mixed,empty,signed\n"
    '1,3000000000,1.5,2024-01-02,abc,"quoted, comma",,+5\n'
    '2,1,2e3,2024-01-02 10:30,"multi\nline",7,,-2147483648\n'
    "3,-4000000000,.5,2024-01-02T10:30:45.123,x,2024-01-01,,  12  \n"
)


def test_csv_scan_fixture_equals_jax_and_python(tmp_path):
    p = tmp_path / "t.csv"
    p.write_text(FIXTURE)
    got = native.csv_scan(p)
    assert got is not None
    assert got == jnative.csv_scan(p)
    assert got == py_infer(p)
    assert got[0] == ["int", "bigint", "double", "timestamp", "string", "string",
                      "string", "bigint"]


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_csv_scan_randomized_equals_jax_and_python(tmp_path, seed):
    rng = random.Random(seed)
    pools = [
        lambda: str(rng.randint(-10, 10)),
        lambda: str(rng.randint(-2**40, 2**40)),
        lambda: f"{rng.uniform(-5, 5):.3f}",
        lambda: f"{rng.uniform(-5, 5):.2e}",
        lambda: "2023-05-0%d" % rng.randint(1, 9),
        lambda: "2023-05-01 12:3%d" % rng.randint(0, 9),
        lambda: rng.choice(["abc", "NaN", "inf", "", "  ", "1.2.3", "0x1f",
                            "1_000", "1_0.5", "١٢٣", "٣.٥", "1 "]),
    ]
    for trial in range(5):
        n_cols = rng.randint(1, 6)
        col_pools = [rng.choice(pools) for _ in range(n_cols)]
        lines = [",".join(f"c{i}" for i in range(n_cols))]
        lines += [",".join(g() for g in col_pools) for _ in range(30)]
        p = tmp_path / f"r{trial}.csv"
        p.write_text("\n".join(lines) + "\n")
        got = native.csv_scan(p)
        assert got is not None, trial
        assert got == jnative.csv_scan(p), (trial, p.read_text())
        assert got == py_infer(p), (trial, p.read_text())


def test_sqlite_backend_takes_the_scanners_dtypes(tmp_path, monkeypatch):
    """`load_csv` calls the scanner and takes its dtypes when its column
    count equals the header's; on a ragged file (a row wider than the
    header: the scanner refuses) it takes the Python pass, as JAX's does."""
    calls = []
    real = native.csv_scan

    def spy(path, *a):
        calls.append(str(path))
        return real(path, *a)

    monkeypatch.setattr(native, "csv_scan", spy)
    p = tmp_path / "d.csv"
    p.write_text("a,b,c\n1,x,2.5\n2,y,3\n")
    schema = SQLiteBackend().load_csv(str(p))
    assert calls == [str(p)]
    assert schema.dtypes == ("int", "string", "double")
    jschema = JSQLiteBackend().load_csv(str(p))
    assert (schema.columns, schema.dtypes) == (jschema.columns, jschema.dtypes)
    ragged = tmp_path / "ragged.csv"
    ragged.write_text("a,b\n1,2,3\n4,5\n")
    assert real(ragged) is None and jnative.csv_scan(ragged) is None
    got, want = (b().load_csv(str(ragged)) for b in (SQLiteBackend, JSQLiteBackend))
    assert (got.columns, got.dtypes) == (want.columns, want.dtypes)


def test_no_native_takes_the_python_passes(tmp_path, monkeypatch, trained):
    """`LSOT_NO_NATIVE=1`: no C++ encoder, no scan; the Python passes give
    the same ids and dtypes."""
    p = tmp_path / "t.csv"
    p.write_text(FIXTURE)
    want_dtypes = native.csv_scan(p)[0]
    monkeypatch.setenv("LSOT_NO_NATIVE", "1")
    tok = BPETokenizer(ordered_merges(trained), n_special=trained.n_special)
    assert tok._native is None and native.csv_scan(p) is None
    for text in CORPUS:
        assert tok.encode(text) == trained.encode(text)
    seen = []
    monkeypatch.setattr(sqlite_backend, "_infer_dtype",
                        lambda vals: seen.append(1) or _infer_dtype(vals))
    assert list(SQLiteBackend().load_csv(str(p)).dtypes) == want_dtypes
    assert len(seen) == 8


def test_failed_text_build_raises(monkeypatch, tmp_path, trained):
    """No silent Python pass: when g++ cannot build libtext.so, the
    encoder and the scanner raise."""
    monkeypatch.delenv("LSOT_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "_text_lib", None)
    monkeypatch.setattr(native, "TEXT_LIB", str(tmp_path / "libtext.so"))
    monkeypatch.setattr(native, "build_command", lambda out, *cpp: [
        "g++", "-x", "c++", "/nonexistent.cpp", "-o", out])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        BPETokenizer(ordered_merges(trained), n_special=trained.n_special)
    p = tmp_path / "t.csv"
    p.write_text(FIXTURE)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.csv_scan(p)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        SQLiteBackend().load_csv(str(p))
