"""The ctypes bindings of the port's CUDA kernels against their C entry
points, on the CPU.

Each wrapper binds `extern "C" int <name>(...)` of `csrc/<name>.cu` with an
argument-type list (`_ARGTYPES`, `_Q_ARGTYPES`); a list that drifts from
the C signature passes garbage to the kernel, and the CPU tests never launch
one. So each signature is read from its source and held against its list,
parameter by parameter."""

import ctypes
import os
import re

import pytest

from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import attention
from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import int4mm
from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import int8mm
from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import paged_attention
from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import paged_write
from llm_based_apache_spark_optimization_tpu_torch.ops.kernels._build import CSRC, sources

BINDINGS = {
    "flash_gqa_attention": attention._ARGTYPES,
    "flash_gqa_attention_quantized": attention._Q_ARGTYPES,
    "ragged_paged_attention": paged_attention._ARGTYPES,
    "ragged_paged_attention_quantized": paged_attention._Q_ARGTYPES,
    "fused_page_write": paged_write._ARGTYPES,
    "fused_page_write_quantized": paged_write._Q_ARGTYPES,
    "int4_matmul": int4mm._ARGTYPES,
    "int8_matmul": int8mm._ARGTYPES,
}
C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
           "long long": ctypes.c_longlong, "float": ctypes.c_float}


def c_signature(name):
    """The parameter types of `extern "C" int name(...)` in csrc/name.cu."""
    with open(os.path.join(CSRC, f"{name}.cu"), encoding="utf-8") as f:
        src = f.read()
    found = re.findall(r'extern "C" int (\w+)\((.*?)\)\s*\{', src, re.S)
    assert [n for n, _ in found] == [name], f"csrc/{name}.cu exports {found}"
    types = []
    for param in found[0][1].split(","):
        words = " ".join(param.split()).replace(" *", "*")
        types.append(re.sub(r"\s*\w+$", "", words))  # drop the parameter's name
    return types


def test_every_source_has_a_binding():
    assert sorted(BINDINGS) == sources()


@pytest.mark.parametrize("name", sorted(BINDINGS))
def test_argtypes_match_the_c_signature(name):
    types = c_signature(name)
    unknown = [t for t in types if t not in C_TYPES]
    assert not unknown, f"{name}: C types without a ctypes twin: {unknown}"
    assert [C_TYPES[t] for t in types] == list(BINDINGS[name]), (
        f"{name}: C takes {types}")


def test_table_prefetch_limit_matches_the_kernel():
    """The wrapper asks the page write kernel to prefetch a row's table
    only up to the kernel's own limit (two entries a lane of a warp; the
    kernel refuses a larger one), and only for the copy: the int8 pool
    loads its entry while it quantizes."""
    with open(os.path.join(CSRC, "page_write.cuh"), encoding="utf-8") as f:
        limit = int(re.search(r"kPrefetchPages = (\d+);", f.read()).group(1))
    assert paged_write.TABLE_PREFETCH_PAGES == limit == 64
    rule = paged_write.table_prefetch
    assert rule(16, False) and rule(limit, False) and not rule(limit + 1, False)
    assert not rule(16, True) and not rule(limit, True)


def test_int8_matmul_constants_match_the_kernel():
    """The wrapper's routes, layouts and tile sizes are the kernel's: the
    decode column tiles and the vd decode block, the wgmma kernel's row
    tiles N and column tile, the split's k step, the f32 GEMV's tile."""
    with open(os.path.join(CSRC, "int8_matmul.cu"), encoding="utf-8") as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))

    def array(name):
        body = re.search(rf"\b{name}\[\] = \{{([\d, ]+)\}};", src).group(1)
        return tuple(int(v) for v in body.split(","))

    assert int8mm.GEMV_MAX_ROWS == const("kMaxRows") == 8
    assert int8mm.ROUTE_ROWS["decode"][1] == const("kMaxRows")
    assert int8mm._GEMV_COLS == const("kGemvBN")
    assert int8mm.LAYOUTS == {"io": const("kIO"), "vd": const("kVD")}
    assert int8mm._ROUTES == {"gemv": const("kRouteGemv"), "decode": const("kRouteDecode"),
                              "wgmma": const("kRouteWgmma")}
    assert int8mm.DECODE_COLS == array("kDecCols")
    assert int8mm._DECODE_VD_COLS == const("kDecVdCols")
    assert int8mm.WGMMA_ROWS == array("kWgRows")
    assert int8mm._WGMMA_COLS == const("kWgBN")
    assert int8mm.K_STEP["decode"] == int8mm.K_STEP["wgmma"] == const("kKStep")
