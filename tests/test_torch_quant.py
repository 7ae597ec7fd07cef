"""The port's quantized ops vs the JAX package's, on the CPU.

- the quantizers (`tp_safe_group`, `quantize_weight_int4`,
  `dequantize_weight_int4`, `quantize_params_int4`, `quantize_kv`,
  `quantize_cache`, `unpack_nibbles`) bit for bit;
- the int4 matmul's plain version vs JAX's `int4_matmul` (Pallas, in
  interpret mode as the JAX tests run it on the CPU) at groups of 86, 32 and
  128 and R = 1, 8, 130: within 1e-5 of max |out| in f32 (only the order of
  the f32 sums differs) and 1e-2 in bf16 (outputs rounded to bf16, one ulp
  up to 2**-7 of the largest);
- the quantized decode attention's and the quantized ragged paged
  attention's plain versions vs JAX's kernels (interpret) and goldens
  (`gqa_attention_quantized`, `paged_attention_reference_quantized`),
  within 1e-5 in f32: the kernels dequantize K/V before the dots, the
  goldens scale after them, which moves only f32 rounding;
- the quantizing page write's plain version vs
  `paged_write_reference_quantized`, bit for bit, and vs JAX's kernel in
  interpret mode: int8 values bit for bit, scales within one f32 ulp. The
  interpreted TPU kernel's `max / 127` differs from the reference's true
  division in the last bit for a few percent of slots (the reference, which
  the port and its CUDA kernel follow, is the TPU kernel's stated contract);
- `params_from_jax` on an int4 tree, bit for bit.
Inputs come from numpy seeds and pass between the packages as numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
from llm_based_apache_spark_optimization_tpu.ops import quant as jq
from llm_based_apache_spark_optimization_tpu.ops.attention import (
    attention_mask as jax_mask,
)
from llm_based_apache_spark_optimization_tpu.ops.attention import (
    gqa_attention_quantized as jax_gqa_q,
)
from llm_based_apache_spark_optimization_tpu.ops.pallas.attention import (
    flash_gqa_attention_quantized as jax_flash_q,
)
from llm_based_apache_spark_optimization_tpu.ops.pallas.int4mm import (
    int4_matmul as jax_int4_matmul,
)
from llm_based_apache_spark_optimization_tpu.ops.pallas.int4mm import (
    unpack_nibbles as jax_unpack,
)
from llm_based_apache_spark_optimization_tpu.ops.pallas.paged_attention import (
    gather_page_scales as jax_gather_scales,
)
from llm_based_apache_spark_optimization_tpu.ops.pallas.paged_attention import (
    paged_attention_reference_quantized as jax_paged_ref_q,
)
from llm_based_apache_spark_optimization_tpu.ops.pallas.paged_attention import (
    ragged_paged_attention_quantized as jax_ragged_q,
)
from llm_based_apache_spark_optimization_tpu.ops.pallas.paged_write import (
    fused_page_write_quantized as jax_write_q,
)
from llm_based_apache_spark_optimization_tpu.ops.pallas.paged_write import (
    paged_write_reference_quantized as jax_write_ref_q,
)
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.ops import quant
from llm_based_apache_spark_optimization_tpu_torch.ops.attention import (
    attention_mask,
    gqa_attention_quantized,
)
from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
    LAUNCHES,
    flash_gqa_attention_quantized,
    flash_gqa_attention_quantized_plain,
    fused_page_write_quantized,
    fused_page_write_quantized_plain,
    gather_page_scales,
    int4_matmul,
    int4_matmul_plain,
    int8_matmul_plain,
    ragged_paged_attention_quantized,
    ragged_paged_attention_quantized_plain,
)

ATOL = 1e-5


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def i32(x):
    return torch.from_numpy(np.asarray(x, np.int32).copy())


def j32(x):
    return None if x is None else jnp.asarray(x, jnp.int32)


def q8(x):
    """A K or V array quantized by JAX: (int8 values, f32 scales) as numpy."""
    q = jq.quantize_kv(jnp.asarray(x))
    return np.asarray(q["q8"]), np.asarray(q["s"])


@pytest.mark.parametrize("n_in,want", [(11008, 86), (4096, 128), (3072, 128),
                                       (8192, 128), (64, 8), (32, 4), (30, 30)])
def test_tp_safe_group_matches_jax(n_in, want):
    assert quant.tp_safe_group(n_in) == jq.tp_safe_group(n_in) == want


@pytest.mark.parametrize("shape,group", [((688, 48), 86), ((2, 64, 32), 32),
                                         ((256, 16), 128), ((8, 24), 8)])
def test_int4_quantizers_are_bit_exact(rng, shape, group):
    w = rng.normal(size=shape).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero column takes scale 1
    want = jq.quantize_weight_int4(jnp.asarray(w), group)
    got = quant.quantize_weight_int4(t(w), group)
    assert got["q4"].dtype == torch.uint8 and got["s4"].dtype == torch.float32
    np.testing.assert_array_equal(got["q4"].numpy(), np.asarray(want["q4"]))
    np.testing.assert_array_equal(got["s4"].numpy(), np.asarray(want["s4"]))
    np.testing.assert_array_equal(quant.unpack_nibbles(got["q4"]).numpy(),
                                  np.asarray(jax_unpack(want["q4"])))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        deq = quant.dequantize_weight_int4(got, dt)
        ref = jq.dequantize_weight_int4(want, jdt)
        np.testing.assert_array_equal(deq.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))
    with pytest.raises(ValueError, match="even group"):
        quant.quantize_weight_int4(t(w), 7)


def test_quantize_params_int4_is_bit_exact():
    jp = jax_init(JAX_TINY, jax.random.key(0), dtype=jnp.float32)
    want = jq.quantize_params_int4(jp, group=32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    got = quant.quantize_params_int4(tp, group=32)
    for name in quant.QUANT_KEYS:
        assert quant.is_q4tensor(got["blocks"][name])
        for leaf in ("q4", "s4"):
            np.testing.assert_array_equal(got["blocks"][name][leaf].numpy(),
                                          np.asarray(want["blocks"][name][leaf]))
    np.testing.assert_array_equal(got["blocks"]["ln_attn"].numpy(),
                                  np.asarray(want["blocks"]["ln_attn"]))
    assert set(got["blocks"]) == set(want["blocks"])


def test_params_from_jax_carries_an_int4_tree_bit_for_bit():
    jp = jq.quantize_params_int4(
        jax_init(JAX_TINY, jax.random.key(1), dtype=jnp.float32), group=32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    for name in quant.QUANT_KEYS:
        for leaf, dtype in (("q4", torch.uint8), ("s4", torch.float32)):
            got = tp["blocks"][name][leaf]
            assert got.dtype == dtype
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(jp["blocks"][name][leaf]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_and_cache_are_bit_exact(rng, dtype):
    x = (rng.normal(size=(3, 2, 20, 16)) * rng.uniform(0.01, 50, size=(3, 2, 20, 1)))
    x = x.astype(np.float32)
    x[0, 0, 3] = 0.0  # an all-zero slot takes scale 1
    jx = jnp.asarray(x).astype(dtype)
    tx = t(x).to(getattr(torch, dtype))
    want, got = jq.quantize_kv(jx), quant.quantize_kv(tx)
    np.testing.assert_array_equal(got["q8"].numpy(), np.asarray(want["q8"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    assert got["s"][0, 0, 3] == 1.0
    want_c, got_c = jq.quantize_cache(jx, jx[::-1]), quant.quantize_cache(tx, tx.flip(0))
    for name in ("k8", "ks", "v8", "vs"):
        np.testing.assert_array_equal(got_c[name].numpy(), np.asarray(want_c[name]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 8, 130])
@pytest.mark.parametrize("n_in,n_out,group", [(688, 128, 86), (256, 48, 32),
                                              (512, 64, 128)])
def test_int4_matmul_plain_matches_jax(rng, dtype, rows, n_in, n_out, group):
    w = jq.quantize_weight_int4(
        jnp.asarray(rng.normal(size=(n_in, n_out)).astype(np.float32) * n_in ** -0.5),
        group)
    x = rng.normal(size=(rows, n_in)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jax_int4_matmul(jx, w["q4"], w["s4"], interpret=True)
                      .astype(jnp.float32))
    tx = t(x).to(getattr(torch, dtype))
    q4, s4 = t(np.asarray(w["q4"])), t(np.asarray(w["s4"]))
    before = dict(LAUNCHES)
    got = int4_matmul_plain(tx, q4, s4)
    assert got.dtype == tx.dtype and got.shape == (rows, n_out)
    tol = (1e-5 if dtype == "float32" else 1e-2) * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    np.testing.assert_array_equal(int4_matmul(tx, q4, s4).float().numpy(),
                                  got.float().numpy())
    assert LAUNCHES == before  # the CPU path never counts a kernel launch


@pytest.mark.parametrize("rows,n_in,n_out,blocks", [
    (1, 4096, 4096, 264), (8, 11008, 4096, 264), (8, 4096, 11008, 264),
    (4, 4096, 1024, 228), (8, 256, 64, 264), (9, 4096, 4096, 264)])
def test_int4_split_plan_covers_the_contraction_axis(rows, n_in, n_out, blocks):
    """The cluster plan of the decode and rows kernels: at R <= 8 every
    packed row in exactly one split, at most 8 splits (one portable
    cluster), each split at least 64 packed rows and a multiple of 8, and no
    more blocks of 128 columns than about `blocks`; above 8 rows, no split."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels.int4mm import split_plan

    splits, per = split_plan(rows, n_in, n_out, blocks)
    n_pk = n_in // 2
    assert (splits - 1) * per < n_pk <= splits * per
    if rows > 8:
        assert (splits, per) == (1, n_pk)
    else:
        assert 1 < splits <= 8 and per >= 64 and per % 8 == 0
        assert (splits - 1) * -(-n_out // 128) < blocks


@pytest.mark.parametrize("rows,dtype,route", [
    (1, torch.bfloat16, "decode"), (4, torch.bfloat16, "decode"),
    (8, torch.bfloat16, "decode"), (9, torch.bfloat16, "prefill"),
    (16, torch.bfloat16, "prefill"), (1024, torch.bfloat16, "prefill"),
    (1, torch.float32, "rows"), (8, torch.float32, "rows"), (131, torch.float32, "rows")])
def test_int4_route_crosses_over_at_eight_rows(rows, dtype, route):
    """One rule picks the kernel: bf16 decode up to 8 rows (the mma's n),
    bf16 prefill above, the scalar rows kernel for f32; only the first and
    the last split the contraction axis, and only up to 8 rows."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels.int4mm import (
        DECODE_MAX_ROWS,
        int4_route,
        split_plan,
    )

    assert int4_route(rows, dtype) == route
    splits, _ = split_plan(rows, 4096, 4096, 528)
    assert (splits > 1) == (rows <= DECODE_MAX_ROWS)


@pytest.mark.parametrize("b,kh,s_virt,sms,want", [
    (1, 32, 448, 132, 8),    # 7B engine decode, one request (cache of 448)
    (4, 32, 512, 132, 3),    # 7B engine decode, the batch of four
    (8, 32, 1024, 132, 2),   # 7B paged decode: 8 slots, tables of 16 pages of 64
    (1, 8, 320, 132, 8),     # 3B engine decode
    (8, 8, 1024, 132, 6),    # 3B paged decode
    (8, 8, 384, 132, 6),     # 1B (H = 64) paged decode, pages of 16
    (1, 32, 40, 132, 3),     # S_virt < 16 * 8: no split shorter than 16 slots
    (3, 8, 100, 132, 7),
    (2, 2, 1, 132, 1),
    (16, 32, 1024, 132, 1),  # 512 rows fill a wave unsplit
    (64, 32, 4096, 132, 1),
    (8, 32, 1024, 114, 1),   # 342 blocks a wave on 114 SMs: 256 rows stay unsplit
    (4, 32, 512, 114, 3),
    (1, 32, 448, 114, 8),
    (4, 32, 512, 264, 6),    # twice the SMs, twice the splits (up to 8)
    (8, 32, 1024, 264, 3),
    (1, 32, 448, 8, 1),      # 24 blocks a wave on a small card: no split
])
def test_decode_split_plan_fills_the_card_in_whole_runs(b, kh, s_virt, sms, want):
    """The cluster size of a decode launch: 1..8 (one portable cluster), no
    split shorter than one 16-slot run of the longest row the cache holds,
    and the launch nearest one wave of three blocks an SM of the card; the
    7B engine's decode (B = 1, K = 32) reaches 132 blocks and more on an
    H100's 132 SMs."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import decode_split_plan

    splits = decode_split_plan(b, kh, s_virt, 1, sms)
    assert splits == want
    assert 1 <= splits <= 8
    assert splits == 1 or 16 * (splits - 1) < s_virt
    assert splits == 1 or b * kh * splits <= 3 * sms + b * kh / 2
    if sms == 132:
        assert splits == 1 or b * kh * (splits - 1) < 512
        if (b, kh) == (1, 32):
            assert b * kh * splits >= 132 or s_virt < 16 * 8


@pytest.mark.parametrize("t,tile", [(1, False), (2, True), (8, True), (32, True)])
def test_decode_split_plan_routes_windows_to_the_tile_kernel(t, tile):
    """T == 1 runs the split-KV kernel (splits >= 1); a query window (T > 1)
    runs the tile kernel (0), at every shape."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import decode_split_plan

    for b, kh, s_virt in ((1, 32, 448), (8, 32, 1024), (4, 8, 320)):
        assert (decode_split_plan(b, kh, s_virt, t, 132) == 0) == tile


def test_mm_routes_tensors_and_q4_trees(rng):
    x = t(rng.normal(size=(2, 3, 64)).astype(np.float32))
    w = t(rng.normal(size=(64, 32)).astype(np.float32))
    np.testing.assert_array_equal(quant.mm(x, w).numpy(), (x @ w).numpy())
    w4 = quant.quantize_weight_int4(w, 32)
    np.testing.assert_array_equal(
        quant.mm(x, w4).numpy(),
        int4_matmul_plain(x.reshape(6, 64), w4["q4"], w4["s4"]).reshape(2, 3, 32).numpy())
    # A q8 tree now routes to the int8 matmul (its plain version here).
    w8 = quant.quantize_weight(w)
    np.testing.assert_array_equal(
        quant.mm(x, w8).numpy(),
        int8_matmul_plain(x.reshape(6, 64), w8["q8"], w8["s"]).reshape(2, 3, 32).numpy())
    with pytest.raises(TypeError):
        quant.mm(x, {"q3": w})


def test_quantized_decode_attention_matches_jax(rng):
    """Decode rows at several positions, a parked row (kv_lens = 0) and a
    window: the port's plain version and wrapper vs JAX's kernel (interpret)
    and vs the golden, which both packages also hold against each other."""
    b, n, kh, s, h = 3, 4, 2, 40, 16
    q = rng.normal(size=(b, 1, n, h)).astype(np.float32)
    k8, ks = q8(rng.normal(size=(b, kh, s, h)).astype(np.float32))
    v8, vs = q8(rng.normal(size=(b, kh, s, h)).astype(np.float32))
    pos = np.asarray([[5], [s - 1], [22]])
    for window, kvl in ((None, None), (8, None), (None, [6, 0, 23]), (None, [1, 7, 0]),
                        (3, None)):
        jargs = (jnp.asarray(q), jnp.asarray(k8), jnp.asarray(ks), jnp.asarray(v8),
                 jnp.asarray(vs), j32(pos), window, j32(kvl))
        want = np.asarray(jax_flash_q(*jargs, interpret=True))
        targs = (t(q), t(k8), t(ks), t(v8), t(vs), i32(pos), window,
                 None if kvl is None else i32(kvl))
        got = flash_gqa_attention_quantized_plain(*targs).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)
        np.testing.assert_array_equal(flash_gqa_attention_quantized(*targs).numpy(), got)
        if kvl is None:
            jmask = jax_mask(j32(pos), s, window)
            golden = np.asarray(jax_gqa_q(*jargs[:5], jmask))
            np.testing.assert_allclose(got, golden, atol=ATOL)
            mine = gqa_attention_quantized(*targs[:5], attention_mask(i32(pos), s, window))
            np.testing.assert_allclose(mine.numpy(), golden, atol=ATOL)
        else:
            for bi in np.flatnonzero(np.asarray(kvl) == 0):
                assert np.abs(got[bi]).max() == 0.0
    with pytest.raises(ValueError, match="T=1"):
        flash_gqa_attention_quantized(t(np.zeros((1, 2, n, h), np.float32)),
                                      *(x[:1] for x in targs[1:5]), i32([[0, 1]]))


@pytest.mark.parametrize("g", [1, 4])
def test_quantized_decode_attention_edges_match_jax(rng, g):
    """The split decode kernel's edges at G = 1 and 4: live lengths of 1
    and 7 slots (fewer than the splits), kv_lens = 0 beside a full row, a
    window that hides all but the last 4 slots. The port's plain version and
    wrapper, with NaN in every dead slot's scales, vs JAX's kernel
    (interpret) on the clean cache."""
    b, kh, s, h = 4, 2, 48, 16
    q = rng.normal(size=(b, 1, g * kh, h)).astype(np.float32)
    k8, ks = q8(rng.normal(size=(b, kh, s, h)).astype(np.float32))
    v8, vs = q8(rng.normal(size=(b, kh, s, h)).astype(np.float32))
    pos = np.asarray([[0], [6], [30], [s - 1]])
    for window, kvl in ((None, [1, 7, 0, s]), (4, None), (None, None)):
        jargs = (jnp.asarray(q), jnp.asarray(k8), jnp.asarray(ks), jnp.asarray(v8),
                 jnp.asarray(vs), j32(pos), window, j32(kvl))
        want = np.asarray(jax_flash_q(*jargs, interpret=True))
        live = pos[:, 0] + 1 if kvl is None else np.asarray(kvl)
        dead = np.arange(s)[None, :] >= live[:, None]              # [B, S]
        ks_nan, vs_nan = ks.copy(), vs.copy()
        ks_nan[np.broadcast_to(dead[:, None], ks.shape)] = np.nan
        vs_nan[np.broadcast_to(dead[:, None], vs.shape)] = np.nan
        targs = (t(q), t(k8), t(ks_nan), t(v8), t(vs_nan), i32(pos), window,
                 None if kvl is None else i32(kvl))
        got = flash_gqa_attention_quantized_plain(*targs).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=ATOL)
        np.testing.assert_array_equal(flash_gqa_attention_quantized(*targs).numpy(), got)
        for bi in np.flatnonzero(live == 0):
            assert np.abs(got[bi]).max() == 0.0


@pytest.mark.parametrize("g", [1, 4])
def test_quantized_ragged_paged_decode_edges_match_jax(rng, g):
    """The split decode kernel's edges over the int8 pool at G = 1 and 4:
    rows of 1 and 7 live slots, a parked row (kv_lens = 0, all sentinel)
    beside a full row, then a window that hides all but the last 3 slots;
    NaN scales on every page no table maps. The port's plain version and
    wrapper vs JAX's kernel (interpret) and reference."""
    b, kh, h, ps, np_tab, pool_pages = 4, 2, 16, 8, 4, 16
    kp, kps = q8(rng.normal(size=(pool_pages, kh, ps, h)).astype(np.float32))
    vp, vps = q8(rng.normal(size=(pool_pages, kh, ps, h)).astype(np.float32))
    s_virt = np_tab * ps
    kvl = np.asarray([1, 7, 0, s_virt])
    pos = np.asarray([[0], [6], [s_virt - 1], [s_virt - 1]])
    perm = rng.permutation(pool_pages - 2)
    tab = np.full((b, np_tab), pool_pages)
    tab[0, 0], tab[1, 0] = perm[0], perm[1]
    tab[3] = perm[2:2 + np_tab]
    q = rng.normal(size=(b, 1, kh * g, h)).astype(np.float32)
    mapped = np.zeros(pool_pages, bool)
    mapped[tab[tab < pool_pages]] = True
    kps_nan, vps_nan = kps.copy(), vps.copy()
    kps_nan[~mapped] = vps_nan[~mapped] = np.nan
    for window in (None, 3):
        jargs = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(kps), jnp.asarray(vp),
                 jnp.asarray(vps), j32(tab), j32(pos), window, j32(kvl), None)
        want_k = np.asarray(jax_ragged_q(*jargs, interpret=True))
        want_r = np.asarray(jax_paged_ref_q(*jargs))
        targs = (t(q), t(kp), t(kps_nan), t(vp), t(vps_nan), i32(tab), i32(pos),
                 window, i32(kvl), None)
        got = ragged_paged_attention_quantized_plain(*targs).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want_k, atol=ATOL)
        np.testing.assert_allclose(got, want_r, atol=ATOL)
        np.testing.assert_array_equal(ragged_paged_attention_quantized(*targs).numpy(), got)
        assert np.abs(got[2]).max() == 0.0


@pytest.mark.parametrize("T", [1, 4])
def test_quantized_ragged_paged_matches_jax(rng, T):
    """Permuted tables with a sentinel entry, ragged q_lens, a parked row,
    NaN scales on a page no table maps: the port's plain version and wrapper
    vs JAX's kernel (interpret) and reference."""
    b, kh, g, h, ps, np_tab, pool_pages = 4, 2, 2, 8, 8, 4, 18
    kp, kps = q8(rng.normal(size=(pool_pages, kh, ps, h)).astype(np.float32))
    vp, vps = q8(rng.normal(size=(pool_pages, kh, ps, h)).astype(np.float32))
    tab = np.stack([rng.permutation(pool_pages - 1)[:np_tab] for _ in range(b)])
    tab[1, -1] = pool_pages
    s_virt = np_tab * ps
    q_lens = np.asarray([T, max(1, T // 2), T, 0])
    starts = np.asarray([3, 10, s_virt - T, 0])
    pos = np.full((b, T), s_virt - 1)
    for bi in range(b):
        pos[bi, : q_lens[bi]] = starts[bi] + np.arange(q_lens[bi])
    kvl = starts + q_lens
    kvl[3] = 0
    q = rng.normal(size=(b, T, kh * g, h)).astype(np.float32)
    jargs = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(kps), jnp.asarray(vp),
             jnp.asarray(vps), j32(tab), j32(pos), None, j32(kvl), j32(q_lens))
    want_k = np.asarray(jax_ragged_q(*jargs, interpret=True))
    want_r = np.asarray(jax_paged_ref_q(*jargs))
    kps_nan, vps_nan = kps.copy(), vps.copy()
    kps_nan[pool_pages - 1] = vps_nan[pool_pages - 1] = np.nan  # never mapped
    targs = (t(q), t(kp), t(kps_nan), t(vp), t(vps_nan), i32(tab), i32(pos), None,
             i32(kvl), i32(q_lens))
    before = dict(LAUNCHES)
    got = ragged_paged_attention_quantized_plain(*targs).numpy()
    np.testing.assert_allclose(got, want_k, atol=ATOL)
    np.testing.assert_allclose(got, want_r, atol=ATOL)
    np.testing.assert_array_equal(ragged_paged_attention_quantized(*targs).numpy(), got)
    assert LAUNCHES == before
    for bi in range(b):
        assert np.abs(got[bi, q_lens[bi]:]).max(initial=0.0) == 0.0
    np.testing.assert_array_equal(
        gather_page_scales(t(kps), i32(tab)).numpy(),
        np.asarray(jax_gather_scales(jnp.asarray(kps), j32(tab))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_q_lens", [False, True])
def test_quantized_page_write_is_bit_exact(rng, dtype, with_q_lens):
    """An unmapped row, a past-the-row position, q_lens drops and an
    all-zero sliver: the port's write (plain and wrapper) equals JAX's
    reference bit for bit, in place, and JAX's interpreted kernel up to one
    ulp in the scales (module docstring)."""
    L, P, kh, ps, h, b, T, np_tab, layer = 2, 9, 2, 8, 8, 3, 3, 4, 1
    kp, kps = q8(rng.normal(size=(L, P, kh, ps, h)).astype(np.float32))
    vp, vps = q8(rng.normal(size=(L, P, kh, ps, h)).astype(np.float32))
    k_new = rng.normal(size=(b, T, kh, h)).astype(np.float32)
    v_new = rng.normal(size=(b, T, kh, h)).astype(np.float32)
    k_new[0, 1, 0] = 0.0
    tab = np.stack([rng.permutation(P)[:np_tab] for _ in range(b)])
    tab[2, :] = P  # row 2 fully unmapped (parked slot)
    pos = np.asarray([[0, 1, 2], [np_tab * ps - 2, np_tab * ps - 1, np_tab * ps],
                      [5, 6, 7]])
    q_lens = np.asarray([2, 3, 1]) if with_q_lens else None
    jpools = [jnp.asarray(a) for a in (kp, kps, vp, vps)]
    jk, jv = jnp.asarray(k_new).astype(dtype), jnp.asarray(v_new).astype(dtype)
    want = jax_write_q(*jpools, jk, jv, j32(pos), j32(tab), layer, q_lens=j32(q_lens),
                       interpret=True)
    want_r = jax_write_ref_q(*jpools, jk, jv, j32(pos), j32(tab), layer, j32(q_lens))
    tk, tv = t(k_new).to(getattr(torch, dtype)), t(v_new).to(getattr(torch, dtype))
    for fn in (fused_page_write_quantized_plain, fused_page_write_quantized):
        pools = [t(a) for a in (kp, kps, vp, vps)]
        ret = fn(*pools, tk, tv, i32(pos), i32(tab), layer,
                 None if q_lens is None else i32(q_lens))
        assert ret is None
        for i, (got, w, wr) in enumerate(zip(pools, want, want_r)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(wr))
            if i % 2:  # scales
                np.testing.assert_array_max_ulp(got.numpy(), np.asarray(w), maxulp=1)
            else:
                np.testing.assert_array_equal(got.numpy(), np.asarray(w))
        np.testing.assert_array_equal(pools[0][0].numpy(), kp[0])  # other layer untouched
