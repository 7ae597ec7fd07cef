"""The port stands alone: it imports neither jax nor the JAX package, and its
entry points never fall back to the CPU on their own."""

import ast
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "llm_based_apache_spark_optimization_tpu_torch"
BANNED = ("jax", "llm_based_apache_spark_optimization_tpu")

CHILD = textwrap.dedent(f"""
    import importlib, importlib.abc, pkgutil, sys

    BANNED = {BANNED!r}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BANNED):
                raise ImportError(f"blocked import of {{name}}")
            return None

    sys.meta_path.insert(0, Block())
    import {PORT} as pkg

    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    assert not [m for m in sys.modules if m.split(".")[0] in BANNED]
    print("imported", len(names))

    import torch
    from {PORT}.convert import params_from_jax
    from {PORT}.engine.kvcache import init_cache
    from {PORT}.models import TINY
    from {PORT}.models.llama import init_params
    from {PORT}.engine.paged_kv import init_page_pool
    from {PORT}.serve.scheduler import ContinuousBatchingScheduler

    assert not torch.cuda.is_available()
    cpu_params = init_params(TINY, device="cpu")  # an explicit CPU request runs
    for call in (lambda: init_params(TINY), lambda: init_cache(TINY, 1, 8),
                 lambda: params_from_jax({{}}),
                 lambda: init_page_pool(TINY, 2, 8),
                 lambda: ContinuousBatchingScheduler(TINY, cpu_params)):
        try:
            call()
        except RuntimeError as e:
            assert "no CUDA device" in str(e)
        else:
            raise AssertionError("an entry point ran without CUDA and no device")
    ContinuousBatchingScheduler(TINY, cpu_params, device="cpu")
    print("ok")
""")


def test_port_imports_without_jax_and_needs_an_explicit_cpu():
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", CHILD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
    assert int(res.stdout.split()[1]) >= 30  # every module was walked


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_file_names_jax_or_the_jax_package():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, dirs, fs in os.walk(os.path.join(ROOT, PORT)):
        dirs[:] = [x for x in dirs if x != "build"]  # kernel build outputs
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    bad = [(f, m) for f in files for m in _imports(f)
           if any(m == b or m.startswith(b + ".") for b in BANNED)]
    assert not bad
