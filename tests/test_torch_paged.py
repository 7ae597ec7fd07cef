"""The port's paged KV path vs the JAX package's, on the CPU in f32 (TINY).

- the plain ragged paged attention vs JAX's `ragged_paged_attention` (run in
  interpret mode on the CPU, as tests/test_paged_kv.py runs it) and vs
  `paged_attention_reference`, within 1e-5 (f32; only the order of sums
  differs);
- the plain fused page write vs `paged_write_reference`, bit for bit;
- `PageAllocator` and `pack_prefill_pages` vs JAX's;
- the paged forward's logits vs JAX's paged forward (xla impl), 1e-5;
- the paged engine's greedy tokens vs JAX's paged engine and the port's
  contiguous engine, token for token;
- the int8 pool: sizing and layout vs JAX's, and the paged forward over it
  (int4 weights, the quantizing write, the quantized read) vs JAX's paged
  forward, logits within 1e-5 and the written pages within one int8 step.
Inputs come from numpy seeds and pass between the packages as numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_based_apache_spark_optimization_tpu.engine.generate import (
    InferenceEngine as JaxEngine,
)
from llm_based_apache_spark_optimization_tpu.engine.paged_kv import (
    PageAllocator as JaxAllocator,
)
from llm_based_apache_spark_optimization_tpu.engine.paged_kv import (
    init_page_pool as jax_init_pool,
)
from llm_based_apache_spark_optimization_tpu.engine.paged_kv import (
    pack_prefill_pages as jax_pack,
)
from llm_based_apache_spark_optimization_tpu.engine.paged_kv import (
    page_bytes as jax_page_bytes,
)
from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
from llm_based_apache_spark_optimization_tpu.models.llama import forward as jax_forward
from llm_based_apache_spark_optimization_tpu.ops.pallas import (
    paged_attention_reference,
    paged_write_reference,
)
from llm_based_apache_spark_optimization_tpu.ops.pallas import (
    ragged_paged_attention as jax_ragged,
)
from llm_based_apache_spark_optimization_tpu.ops.quant import (
    quantize_params_int4 as jax_q4,
)
from llm_based_apache_spark_optimization_tpu.ops.quant import quantize_kv as jax_qkv
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine
from llm_based_apache_spark_optimization_tpu_torch.engine.paged_kv import (
    PageAccountingError,
    PageAllocator,
    init_page_pool,
    pack_prefill_pages,
    page_bytes,
    pages_for_budget,
    pages_for_tokens,
)
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
from llm_based_apache_spark_optimization_tpu_torch.models.llama import forward
from llm_based_apache_spark_optimization_tpu_torch.ops.quant import quantize_params_int4
from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
    LAUNCHES,
    fused_page_write,
    fused_page_write_plain,
    ragged_paged_attention,
    ragged_paged_attention_plain,
)

ATOL = 1e-5


def t(x, dtype=None):
    return torch.from_numpy(np.array(x, copy=True)).to(dtype or torch.float32)


def i32(x):
    return torch.from_numpy(np.asarray(x, np.int32).copy())


def check_attention(q, kp, vp, tab, pos, kvl=None, qlens=None, window=None):
    """Port plain and wrapper vs JAX kernel (interpret) and reference."""
    jargs = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
             jnp.asarray(tab, jnp.int32), jnp.asarray(pos, jnp.int32), window,
             None if kvl is None else jnp.asarray(kvl, jnp.int32),
             None if qlens is None else jnp.asarray(qlens, jnp.int32))
    want_k = np.asarray(jax_ragged(*jargs, interpret=True))
    want_r = np.asarray(paged_attention_reference(*jargs))
    targs = (t(q), t(kp), t(vp), i32(tab), i32(pos), window,
             None if kvl is None else i32(kvl),
             None if qlens is None else i32(qlens))
    before = dict(LAUNCHES)
    got = ragged_paged_attention_plain(*targs).numpy()
    np.testing.assert_allclose(got, want_k, atol=ATOL)
    np.testing.assert_allclose(got, want_r, atol=ATOL)
    np.testing.assert_array_equal(ragged_paged_attention(*targs).numpy(), got)
    assert LAUNCHES == before  # the CPU path never counts a kernel launch
    return got


@pytest.mark.parametrize("ps,np_tab", [(16, 4), (8, 7)])
def test_ragged_paged_matches_jax(rng, ps, np_tab):
    b, kh, g, h, pool_pages = 3, 2, 2, 8, 11
    kp = rng.normal(size=(pool_pages, kh, ps, h)).astype(np.float32)
    vp = rng.normal(size=(pool_pages, kh, ps, h)).astype(np.float32)
    tab = np.stack([rng.permutation(pool_pages)[:np_tab] for _ in range(b)])
    tab[0, -1] = pool_pages  # unmapped sentinel past the live region
    q = rng.normal(size=(b, 1, kh * g, h)).astype(np.float32)
    s_virt = np_tab * ps
    pos = np.asarray([[ps // 2], [s_virt - ps - 1], [s_virt - 1]])
    check_attention(q, kp, vp, tab, pos, pos[:, 0] + 1)
    check_attention(q, kp, vp, tab, pos, window=ps)  # default kv_lens + window


def test_ragged_paged_kv_lens_truncates_and_parks(rng):
    """Output depends only on the first kv_lens positions (dead pages and
    the dead tail of the last live page are scribbled, NaN included), and
    kv_lens = 0 parks a row (exact zeros)."""
    b, kh, g, h, ps, pool_pages = 2, 2, 2, 8, 8, 9
    kp = rng.normal(size=(pool_pages, kh, ps, h)).astype(np.float32)
    vp = rng.normal(size=(pool_pages, kh, ps, h)).astype(np.float32)
    tab = np.asarray([[0, 1, 2, 3], [4, 5, 6, 7]])
    q = rng.normal(size=(b, 1, kh * g, h)).astype(np.float32)
    pos = np.asarray([[10], [10]])
    base = check_attention(q, kp, vp, tab, pos, [11, 11])
    kp2, vp2 = kp.copy(), vp.copy()
    for row in tab:
        kp2[row[2:]], vp2[row[2:]] = 99.0, -99.0
        kp2[row[1], :, 3:], vp2[row[1], :, 3:] = 99.0, -99.0
    np.testing.assert_array_equal(
        check_attention(q, kp2, vp2, tab, pos, [11, 11]), base)
    kp2[8] = vp2[8] = np.nan  # a page no table maps
    tab2 = tab.copy()
    tab2[:, 3] = pool_pages - 1
    np.testing.assert_array_equal(ragged_paged_attention_plain(
        t(q), t(kp2), t(vp2), i32(tab2), i32(pos), None, i32([11, 11])).numpy(),
        base)
    parked = check_attention(q, kp, vp, tab, pos, [0, 11])
    assert np.abs(parked[0]).max() == 0.0
    np.testing.assert_array_equal(parked[1], base[1])


@pytest.mark.parametrize("T", [1, 4, 8])
def test_ragged_windows_with_q_lens(rng, T):
    """Ragged windows: decode, mid-size and full rows, a q_len = 0 row, a
    sentinel entry and kv_lens clamped mid-page; dead columns are exact
    zeros."""
    b, kh, g, h, ps, np_tab, pool_pages = 5, 2, 2, 8, 8, 4, 24
    s_virt = np_tab * ps
    kp = rng.normal(size=(pool_pages, kh, ps, h)).astype(np.float32)
    vp = rng.normal(size=(pool_pages, kh, ps, h)).astype(np.float32)
    tab = np.stack([rng.permutation(pool_pages)[:np_tab] for _ in range(b)])
    tab[1, -1] = pool_pages
    q_lens = np.asarray([1, min(T, max(1, T // 2)), T, int(rng.integers(1, T + 1)), 0])
    starts = np.asarray([int(rng.integers(0, s_virt - ql)) if ql else 0
                         for ql in q_lens])
    pos = np.full((b, T), s_virt - 1)  # dead-column junk
    for bi in range(b):
        pos[bi, : q_lens[bi]] = starts[bi] + np.arange(q_lens[bi])
    kvl = starts + q_lens
    kvl[3] = max(1, int(kvl[3]) - int(rng.integers(0, min(kvl[3], ps))))
    kvl[4] = 0
    q = rng.normal(size=(b, T, kh * g, h)).astype(np.float32)
    out = check_attention(q, kp, vp, tab, pos, kvl, q_lens)
    for bi in range(b):
        assert np.abs(out[bi, q_lens[bi]:]).max(initial=0.0) == 0.0
    assert np.abs(out[4]).max() == 0.0


def test_window_bound_is_validated():
    q = torch.zeros((1, 33, 32, 8))
    pool = torch.zeros((2, 2, 8, 8))
    with pytest.raises(ValueError, match="1 <= T\\*G <= 512"):
        ragged_paged_attention(q, pool, pool, torch.zeros((1, 1), dtype=torch.int32),
                               torch.zeros((1, 33), dtype=torch.int32))


@pytest.mark.parametrize("with_q_lens", [False, True])
def test_fused_page_write_matches_reference_bitwise(rng, with_q_lens):
    """An unmapped row, a past-the-row position and q_lens drops: the
    port's write (plain and wrapper) equals `paged_write_reference` bit for
    bit, in place."""
    L, P, kh, ps, h, b, T, np_tab, layer = 2, 9, 2, 8, 8, 3, 3, 4, 1
    kp = rng.normal(size=(L, P, kh, ps, h)).astype(np.float32)
    vp = rng.normal(size=(L, P, kh, ps, h)).astype(np.float32)
    k_new = rng.normal(size=(b, T, kh, h)).astype(np.float32)
    v_new = rng.normal(size=(b, T, kh, h)).astype(np.float32)
    tab = np.stack([rng.permutation(P)[:np_tab] for _ in range(b)])
    tab[2, :] = P  # row 2 fully unmapped (parked slot)
    pos = np.asarray([[0, 1, 2], [np_tab * ps - 2, np_tab * ps - 1, np_tab * ps],
                      [5, 6, 7]])
    q_lens = np.asarray([2, 3, 1]) if with_q_lens else None
    jq = None if q_lens is None else jnp.asarray(q_lens, jnp.int32)
    jtab, jpos = jnp.asarray(tab, jnp.int32), jnp.asarray(pos, jnp.int32)
    want_k = np.asarray(paged_write_reference(jnp.asarray(kp), jnp.asarray(k_new),
                                              jpos, jtab, layer, jq))
    want_v = np.asarray(paged_write_reference(jnp.asarray(vp), jnp.asarray(v_new),
                                              jpos, jtab, layer, jq))
    for fn in (fused_page_write_plain, fused_page_write):
        tk, tv = t(kp), t(vp)
        ret = fn(tk, tv, t(k_new), t(v_new), i32(pos), i32(tab), layer,
                 None if q_lens is None else i32(q_lens))
        assert ret is None
        np.testing.assert_array_equal(tk.numpy(), want_k)
        np.testing.assert_array_equal(tv.numpy(), want_v)
        np.testing.assert_array_equal(tk[0].numpy(), kp[0])  # other layer untouched


def test_allocator_matches_jax_on_a_random_op_sequence(rng):
    ours, ref = PageAllocator(12, 8), JaxAllocator(12, 8)
    held = []
    for _ in range(400):
        op = int(rng.integers(0, 6))
        n = int(rng.integers(1, 4))
        if op == 0:
            a, r = ours.alloc(n), ref.alloc(n)
            assert a == r
            held += a or []
        elif op == 1 and held:
            pg = [held.pop(int(rng.integers(0, len(held))))]
            assert ours.release(pg) == ref.release(pg)
        elif op == 2 and held:
            pg = held[int(rng.integers(0, len(held)))]
            ours.share([pg], count=bool(n % 2))
            ref.share([pg], count=bool(n % 2))
            held.append(pg)
            ours.prefix_hold([pg])
            ref.prefix_hold([pg])
        elif op == 3 and held:
            i = int(rng.integers(0, len(held)))
            a, r = ours.cow(held[i]), ref.cow(held[i])
            assert a == r
            if a is not None:
                held[i] = a
        elif op == 4:
            ours.note_cow()
            ref.note_cow()
            ours.note_shares(n)
            ref.note_shares(n)
        elif op == 5:
            ours.withhold(n % 3)
            ref.withhold(n % 3)
        ours.check()
        assert list(ours._free) == list(ref._free)
        assert ours._ref == ref._ref
        assert ours.stats() == ref.stats()
    with pytest.raises(PageAccountingError):
        ours.release([next(p for p in range(12) if ours.refcount(p) == 0)])


def test_pool_sizing_and_pack_match_jax(rng):
    cfg = TINY
    assert pages_for_tokens(16, 16) == 1 and pages_for_tokens(17, 16) == 2
    pb = page_bytes(cfg, 16, itemsize=4)
    pool = init_page_pool(cfg, 5, 16, torch.float32, device="cpu")
    assert pool["kp"].numel() * 4 + pool["vp"].numel() * 4 == 5 * pb
    assert pages_for_budget(cfg, 5 * pb - 1, 16, 4) == 4
    with pytest.raises(ValueError, match="multiple of 8"):
        init_page_pool(cfg, 4, 12, device="cpu")
    shape = (cfg.num_layers, 3, cfg.num_kv_heads, 20, cfg.head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    want = jax_pack({"k": jnp.asarray(k), "v": jnp.asarray(v)}, 8, 4)
    got = pack_prefill_pages({"k": t(k), "v": t(v)}, 8, 4)
    for name in ("kp", "vp", "ptab"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    with pytest.raises(ValueError, match="pages_per_row"):
        pack_prefill_pages({"k": t(k), "v": t(v)}, 8, 2)


@pytest.fixture(scope="module")
def both():
    jp = jax_init(JAX_TINY, jax.random.key(0), dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("T", [1, 4])
def test_paged_forward_logits_match_jax(both, rng, T):
    """A decode step (T=1) and a ragged T=4 window through the paged
    forward: logits of live columns vs JAX's paged forward (xla impl), and
    the pools after the writes, on the same pool and tables."""
    jp, tp = both
    cfg = TINY
    b, ps, np_tab, pool_pages = 3, 8, 4, 14
    shape = (cfg.num_layers, pool_pages, cfg.num_kv_heads, ps, cfg.head_dim)
    kp = rng.normal(size=shape).astype(np.float32)
    vp = rng.normal(size=shape).astype(np.float32)
    tab = np.stack([rng.permutation(pool_pages)[:np_tab] for _ in range(b)])
    tab[2, 3] = pool_pages
    starts = np.asarray([5, 17, 9])
    pos = starts[:, None] + np.arange(T)
    q_lens = np.asarray([T, max(1, T - 2), T])
    tokens = rng.integers(0, cfg.vocab_size, size=(b, T))
    jcache = {"kp": jnp.asarray(kp), "vp": jnp.asarray(vp),
              "ptab": jnp.asarray(tab, jnp.int32)}
    want, jnew = jax_forward(JAX_TINY, jp, jnp.asarray(tokens, jnp.int32),
                             jnp.asarray(pos, jnp.int32), jcache, attn_impl="xla",
                             q_lens=jnp.asarray(q_lens, jnp.int32))
    tcache = {"kp": t(kp), "vp": t(vp), "ptab": i32(tab)}
    got, _ = forward(cfg, tp, i32(tokens), i32(pos), tcache, q_lens=i32(q_lens))
    for bi in range(b):
        np.testing.assert_allclose(got[bi, : q_lens[bi]].numpy(),
                                   np.asarray(want)[bi, : q_lens[bi]], atol=ATOL)
    np.testing.assert_allclose(tcache["kp"].numpy(), np.asarray(jnew["kp"]), atol=ATOL)
    np.testing.assert_allclose(tcache["vp"].numpy(), np.asarray(jnew["vp"]), atol=ATOL)
    with pytest.raises(ValueError, match="T <= 32"):
        forward(cfg, tp, torch.zeros((1, 33), dtype=torch.int32),
                torch.zeros((1, 33), dtype=torch.int32), tcache)


@pytest.mark.parametrize("stop_ids", [(-1,), (2, 182, 264)])
def test_paged_engine_greedy_matches_jax_and_contiguous(both, stop_ids):
    jp, tp = both
    prompts = [[1, 5, 9], [1, 7], [1, 3, 4, 8, 10], [1, 11, 12, 13]]
    want = JaxEngine(JAX_TINY, jp, stop_ids=stop_ids, prompt_bucket=8,
                     kv_layout="paged", kv_page_size=8).generate(prompts, 6)
    paged = InferenceEngine(TINY, tp, stop_ids=stop_ids, prompt_bucket=8,
                            kv_layout="paged", kv_page_size=8, device="cpu")
    contiguous = InferenceEngine(TINY, tp, stop_ids=stop_ids, prompt_bucket=8,
                                 device="cpu")
    got = paged.generate(prompts, 6)
    assert got == want
    assert got == contiguous.generate(prompts, 6)
    with pytest.raises(ValueError, match="kv_layout"):
        InferenceEngine(TINY, tp, kv_layout="sideways", device="cpu")


def test_int8_pool_sizing_matches_jax():
    cfg = TINY
    for ps in (8, 16, 64):
        assert page_bytes(cfg, ps, 4, "int8") == jax_page_bytes(JAX_TINY, ps, 4, "int8")
    pb = page_bytes(cfg, 16, 4, "int8")
    assert pb == 2 * cfg.num_layers * cfg.num_kv_heads * 16 * (cfg.head_dim + 4)
    assert pages_for_budget(cfg, 7 * pb, 16, 4, "int8") == 7
    assert pages_for_budget(cfg, 7 * pb, 16, 4, "int8") > pages_for_budget(
        cfg, 7 * pb, 16, 4)
    pool = init_page_pool(cfg, 5, 16, torch.float32, device="cpu", kv_quant="int8")
    want = jax_init_pool(JAX_TINY, 5, 16, jnp.float32, kv_quant="int8")
    assert set(pool) == set(want)
    for name, arr in pool.items():
        assert tuple(arr.shape) == want[name].shape
        np.testing.assert_array_equal(arr.numpy(), np.asarray(want[name]))
    assert sum(a.numel() * a.element_size() for a in pool.values()) == 5 * pb
    with pytest.raises(ValueError, match="kv_quant"):
        init_page_pool(cfg, 5, 16, device="cpu", kv_quant="fp8")


@pytest.mark.parametrize("T", [1, 4])
def test_int8_paged_forward_logits_match_jax(both, rng, T):
    """A decode step (T=1) and a ragged T=4 window over the int8 pool, with
    int4 block weights: logits of live columns vs JAX's paged forward (xla
    impl: the reference write and read), and the pools after the writes."""
    jp, tp = both
    jp4, tp4 = jax_q4(jp, group=32), quantize_params_int4(tp, group=32)
    cfg = TINY
    b, ps, np_tab, pool_pages = 3, 8, 4, 14
    shape = (cfg.num_layers, pool_pages, cfg.num_kv_heads, ps, cfg.head_dim)
    kq = jax_qkv(jnp.asarray(rng.normal(size=shape).astype(np.float32)))
    vq = jax_qkv(jnp.asarray(rng.normal(size=shape).astype(np.float32)))
    tab = np.stack([rng.permutation(pool_pages)[:np_tab] for _ in range(b)])
    tab[2, 3] = pool_pages
    starts = np.asarray([5, 17, 9])
    pos = starts[:, None] + np.arange(T)
    q_lens = np.asarray([T, max(1, T - 2), T])
    tokens = rng.integers(0, cfg.vocab_size, size=(b, T))
    jcache = {"kp": kq["q8"], "kps": kq["s"], "vp": vq["q8"], "vps": vq["s"],
              "ptab": jnp.asarray(tab, jnp.int32)}
    want, jnew = jax_forward(JAX_TINY, jp4, jnp.asarray(tokens, jnp.int32),
                             jnp.asarray(pos, jnp.int32), jcache, attn_impl="xla",
                             q_lens=jnp.asarray(q_lens, jnp.int32))
    tcache = {"kp": t(kq["q8"], torch.int8), "kps": t(kq["s"]),
              "vp": t(vq["q8"], torch.int8), "vps": t(vq["s"]), "ptab": i32(tab)}
    got, _ = forward(cfg, tp4, i32(tokens), i32(pos), tcache, q_lens=i32(q_lens))
    for bi in range(b):
        np.testing.assert_allclose(got[bi, : q_lens[bi]].numpy(),
                                   np.asarray(want)[bi, : q_lens[bi]], atol=ATOL)
    for name, tol in (("kp", 1), ("vp", 1), ("kps", ATOL), ("vps", ATOL)):
        np.testing.assert_allclose(tcache[name].numpy().astype(np.float32),
                                   np.asarray(jnew[name]).astype(np.float32),
                                   atol=tol, rtol=0)
