"""Batch-invariant serving (``EngineConfig.batch_invariant``): a row's
bits do not depend on the rows beside it. A forward called with
``rows=True`` keeps the residual rows padded to a multiple of
``ops/rows.ROWS`` and runs every product and RMSNorm in calls of exactly
ROWS rows (``ops/rows.py``, ``ops/norms.py``); a pack's one-token rows take
the decode kernel (``one_token_rows``), kernel B splits a KV block between
two warps whatever its tile's fill, and kernels A and C split a row's walk
by its own length only. Every other caller keeps the default forwards.

On the CPU the rows body is held against rbg_tpu's forwards and the
default body on the same weights (with Qwen2-style attention biases), and
the engine's switch against the default engine's tokens. The card tests
are marked ``cuda`` and skip without one: bits across batches, and the
rows body on the card against the CPU port in float32. They import no JAX
(the card's machine has none; the tests against rbg_tpu skip there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_batch_invariance.py
"""

import numpy as np
import pytest
import torch

from rbg_tpu_torch.models import llama
from rbg_tpu_torch.models.config import get_config
from rbg_tpu_torch.models.convert import params_from_numpy
from rbg_tpu_torch.ops import norms
from rbg_tpu_torch.ops.ragged_paged_attention import one_token_rows
from rbg_tpu_torch.ops.rows import ROWS, mm, pad_rows, unpad_rows

ATOL = 1e-4     # float32 on the CPU, as tests/test_torch_model.py


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _biases(cfg, seed: int = 5, scale: float = 0.5) -> dict:
    """Qwen2-style q/k/v biases [L, heads * hd], float32 numpy, so the rows
    body's bias path is held too."""
    rng = np.random.RandomState(seed)
    L, hd = cfg.num_layers, cfg.head_dim_
    return {name: (rng.randn(L, heads * hd) * scale).astype(np.float32)
            for name, heads in (("bq", cfg.num_heads), ("bk", cfg.num_kv_heads),
                                ("bv", cfg.num_kv_heads))}


@pytest.fixture(scope="module")
def ref():
    """rbg_tpu's forwards and tiny's seed-0 weights with biases: (forward
    functions, JAX tree, port tree)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from rbg_tpu.models import get_config as j_get_config, init_params as j_init
    from rbg_tpu.models.llama import forward_paged, forward_ragged

    tree = jax.tree.map(np.asarray, j_init(j_get_config("tiny"), jax.random.key(0)))
    tree = dict(tree, blocks=dict(tree["blocks"], **_biases(get_config("tiny"))))
    return ((forward_paged, forward_ragged, j_get_config("tiny"), jnp.asarray),
            jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, get_config("tiny"), "cpu"))


# ---- the CPU: helpers, refusals ------------------------------------------------


@pytest.mark.parametrize("M", [1, ROWS - 1, ROWS, ROWS + 1, 3 * ROWS + 5])
def test_pad_rows_fill_whole_blocks_with_zero_rows(M):
    x = torch.randn(M, 2, 24)
    xp = pad_rows(x[:, 0].contiguous())
    assert xp.shape == (-(-M // ROWS) * ROWS, 24) and xp.is_contiguous()
    assert torch.equal(xp[:M], x[:, 0]) and not xp[M:].any()
    if M % 3 == 0:
        assert torch.equal(unpad_rows(xp, (3, M // 3)), x[:, 0].reshape(3, M // 3, 24))


@pytest.mark.parametrize("M", [1, ROWS, 2 * ROWS + 7])
def test_row_blocks_compute_the_one_call_function(M):
    """``mm`` and RMSNorm with ``rows`` over padded rows give the one-call
    values on the real rows (the CPU's order may differ in the last bits)."""
    g = torch.Generator().manual_seed(M)
    x = torch.randn(M, 48, generator=g)
    w = torch.randn(48, 40, generator=g)
    wt = torch.rand(48, generator=g) + 0.5
    xp = pad_rows(x)
    torch.testing.assert_close(mm(xp, w)[:M], x @ w, rtol=1e-5, atol=1e-5)
    assert not mm(xp, w)[M:].any()
    torch.testing.assert_close(norms.rms_norm(xp, wt, rows=True)[:M],
                               norms.rms_norm(x, wt), rtol=1e-6, atol=1e-6)


def test_one_token_rows_split_the_pack():
    """Row 0 decodes, row 1 prefills 3 tokens, row 2 ends its prompt with
    one token, then two pads (position -1, row id 0)."""
    pos = np.array([[40, 7, 8, 9, 12, -1, -1]], np.int32)
    rid = np.array([0, 1, 1, 1, 2, 0, 0], np.int32)
    tok, rows, rest = one_token_rows(pos, rid, [0, 2], "cpu")
    assert tok.tolist() == [0, 4] and rows.tolist() == [0, 2]
    assert rest.dtype == torch.int32
    assert rest.tolist() == [[-1, 7, 8, 9, -1, -1, -1]]


def test_rows_refused_without_a_body():
    """MLA, MoE, LoRA rows and a mesh have no batch-invariant body: the
    forwards and the engine refuse them before any launch."""
    from rbg_tpu_torch.engine.config import EngineConfig
    from rbg_tpu_torch.engine.engine import Engine

    for name in ("tiny-mla", "tiny-moe"):
        with pytest.raises(ValueError):
            llama._check_rows(get_config(name), True)
    cfg = get_config("tiny")
    llama._check_rows(cfg, True)
    llama._check_rows(get_config("deepseek-v2-lite"), False)
    with pytest.raises(ValueError):
        llama._check_rows(cfg, True, lora={})
    with pytest.raises(ValueError):
        llama._check_rows(cfg, True, par=object())
    eng = Engine(EngineConfig(batch_invariant=True, num_pages=16), device="cpu")
    with pytest.raises(ValueError, match="LoRA"):
        eng.load_lora("a", {"wq": (np.zeros((2, 128, 4), np.float32),
                                   np.zeros((2, 4, 128), np.float32))})


# ---- the CPU: the rows body against rbg_tpu and the default body ----------------


def _pool(cfg, NP, page, rng):
    shape = (cfg.num_layers, NP, page, cfg.num_kv_heads, cfg.head_dim_)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("rows", [False, True])
def test_forward_paged_and_windows_match_jax(ref, rows):
    """A decode step (T = 1) and a block of T = 4 with a pad over a pool
    holding earlier context, biased weights: logits and pools equal
    rbg_tpu's; the layer windows chained one layer at a time and the head
    give forward_paged's logits."""
    (j_forward_paged, _, jcfg, jnp_asarray), jp, tp = ref
    cfg = get_config("tiny")
    rng = np.random.RandomState(0)
    page, B = 8, 2
    kp, vp = _pool(cfg, B * 4 + 1, page, rng)
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    for T in (1, 4):
        tok = rng.randint(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
        start = np.asarray([[9], [20]], np.int32)
        pos = (start + np.arange(T)[None]).astype(np.int32)
        mask = np.ones((B, T), bool)
        mask[1, -1] = False
        kvl = (start[:, 0] + mask.sum(1)).astype(np.int32)
        jl, jk, jv, _, _ = j_forward_paged(
            jp, jcfg, *map(jnp_asarray, (tok, pos, mask, kvl, table, kp, vp)),
            use_pallas="never")
        args = tuple(map(torch.from_numpy, (tok, pos, mask, kvl, table)))
        tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
        tl = llama.forward_paged(tp, cfg, *args, tk, tv, rows=rows)
        np.testing.assert_allclose(tl.numpy()[mask], np.asarray(jl)[mask],
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)

        wk, wv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
        x = llama._embed(tp, cfg, args[0])
        for lo in range(cfg.num_layers):
            x = llama.forward_paged_window(tp, cfg, lo, lo + 1, x, *args[1:], wk, wv,
                                           rows=rows)
        assert x.shape == (B, T, cfg.hidden_size)
        wl = llama._head(tp, cfg, x, rows=rows)
        np.testing.assert_allclose(wl.numpy()[mask], tl.numpy()[mask], atol=ATOL, rtol=0)
        assert torch.equal(wk, tk) and torch.equal(wv, tv)


@pytest.mark.parametrize("rows", [False, True])
def test_forward_ragged_matches_jax(ref, rows):
    """A unified-step pack: a prefill chunk of row 0, a decode token of
    row 1, a prefill chunk of row 2, then pads (row 0, position -1)."""
    (_, j_forward_ragged, jcfg, jnp_asarray), jp, tp = ref
    cfg = get_config("tiny")
    rng = np.random.RandomState(1)
    page, P, R = 8, 4, 3
    kp, vp = _pool(cfg, R * P + 1, page, rng)
    table = (np.arange(R * P) + 1).reshape(R, P).astype(np.int32)
    rid = np.asarray([0] * 5 + [1] + [2] * 6 + [0] * 4, np.int32)
    pos = np.asarray([list(range(0, 5)) + [17] + list(range(8, 14)) + [-1] * 4],
                     np.int32)
    mask = pos >= 0
    kvl = np.asarray([5, 18, 14], np.int32)
    tok = rng.randint(0, cfg.vocab_size, size=(1, rid.shape[0])).astype(np.int32)
    jl, jk, jv, _, _ = j_forward_ragged(
        jp, jcfg, *map(jnp_asarray, (tok, pos, mask, rid, kvl, table, kp, vp)),
        use_pallas="never", max_q_len=8)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tl = llama.forward_ragged(tp, cfg, *map(torch.from_numpy, (tok, pos, mask, rid, kvl,
                                                               table)), tk, tv,
                              max_q_len=8, rows=rows,
                              one_token=one_token_rows(pos, rid, [1], "cpu"))
    np.testing.assert_allclose(tl.numpy()[mask], np.asarray(jl)[mask],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)


def test_batch_invariant_engine_gives_the_default_tokens():
    """tiny on the CPU: a batch-invariant engine's greedy tokens, ragged
    steps and split prefill alike, equal the default engine's."""
    from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
    from rbg_tpu_torch.engine.engine import Engine

    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 256, size=n).tolist() for n in (5, 40, 17, 1)]
    sp = SamplingParams(max_new_tokens=6)
    base = dict(num_pages=64, page_size=8, prefill_chunk=16, max_batch=4)
    want = Engine(EngineConfig(**base), device="cpu").generate(prompts, sp)
    for ragged in ("auto", "off"):
        eng = Engine(EngineConfig(batch_invariant=True, ragged=ragged, **base),
                     device="cpu")
        assert eng.rows
        assert eng.generate(prompts, sp) == want, ragged


# ---- the card ------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(4096, 1024), (14336, 4096), (4096, 4096)])
def test_products_keep_each_rows_bits(dev, K, N):
    """cuBLAS alone gives other bits at another row count (split-K at few
    rows); ``mm`` over padded rows gives each row the bits of the largest
    call's row."""
    g = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(K, N, device=dev, dtype=torch.bfloat16, generator=g) * 0.02
    x = torch.randn(600, K, device=dev, dtype=torch.bfloat16, generator=g)
    with torch.no_grad():
        full = mm(pad_rows(x), w)
        for m in (1, 2, 3, 5, 16, ROWS - 1, ROWS, ROWS + 1, 599):
            assert torch.equal(mm(pad_rows(x[:m]), w)[:m], full[:m]), m


@pytest.mark.cuda
def test_rms_norm_keeps_each_rows_bits(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(300, 1, 4096, device=dev, dtype=torch.bfloat16, generator=g) * 3
    wt = torch.rand(4096, device=dev, dtype=torch.bfloat16, generator=g) + 0.5
    with torch.no_grad():
        full = norms.rms_norm(pad_rows(x), wt, rows=True)
        for m in (1, 4, 17, ROWS, ROWS + 3):
            assert torch.equal(norms.rms_norm(pad_rows(x[:m]), wt, rows=True)[:m],
                               full[:m]), m
    torch.testing.assert_close(full[:300].float(), norms._rms_norm(x, wt, 1e-5)[:, 0].float(),
                               rtol=2 ** -7, atol=1e-3)


def _kv_pool(dev, KV=8, hd=128, page=8, NP=800, P=300, rows=8, seed=2):
    g = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randn(NP, page, KV, hd, device=dev, dtype=torch.bfloat16, generator=g)
    v = torch.randn(NP, page, KV, hd, device=dev, dtype=torch.bfloat16, generator=g)
    table = torch.stack([torch.randperm(NP - 1, device=dev, generator=g)[:P] + 1
                         for _ in range(rows)]).int()
    q = torch.randn(2400, KV * 4, hd, device=dev, dtype=torch.bfloat16, generator=g)
    return k, v, table, q


def _pack(dev, q, table, rows_spec):
    """rows_spec: [(table row, first position, tokens, kv_len)] → the
    ragged pack's q, page table, positions, kv_lens and row ids."""
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    qs, pos, rid = [], [], []
    for i, (tr, p0, n, _) in enumerate(rows_spec):
        qs.append(q[p0:p0 + n] + tr)
        pos += list(range(p0, p0 + n))
        rid += [i] * n
    return (torch.cat(qs)[None], torch.stack([table[tr] for tr, *_ in rows_spec]),
            i32([pos]), i32([kl for *_, kl in rows_spec]), i32(rid))


@pytest.mark.cuda
def test_ragged_tile_fill_and_one_token_rows_keep_bits(dev):
    """Kernel B with ``invariant``: a prefill chunk cut at another token
    gives its common tokens the same bits; a one-token row routed to the
    decode kernel gives the bits of a decode step, alone or beside a
    prefill row."""
    from rbg_tpu_torch.ops.paged_attention import paged_attention
    from rbg_tpu_torch.ops.ragged_paged_attention import ragged_paged_attention

    k, v, table, q = _kv_pool(dev)

    def ragged(spec, one=()):
        qp, tab, pos, lens, rid = _pack(dev, q, table, spec)
        ot = (one_token_rows(pos.cpu().numpy(), rid.cpu().numpy(), list(one), dev)
              if one else None)
        return ragged_paged_attention(qp, k, v, tab, pos, lens, rid, use_kernels="always",
                                      invariant=True, one_token=ot)[0]

    for lo, kl in ((64, 80), (1000, 1040)):
        full = ragged([(0, lo, 16, kl)])
        assert torch.equal(ragged([(0, lo + 8, 8, kl)]), full[8:]), lo
        assert torch.equal(ragged([(1, 0, 16, 16), (0, lo + 3, 13, kl)])[16:], full[3:])
    for kl in (49, 1100, 2040):
        qd = (q[kl - 1] + 0)[None, None]
        i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
        step = paged_attention(qd, k, v, table[:1], i32([[kl - 1]]), i32([kl]),
                               use_kernels="always", invariant=True)[0, 0]
        assert torch.equal(ragged([(0, kl - 1, 1, kl)], one=[0])[0], step), kl
        assert torch.equal(ragged([(1, 0, 16, 16), (0, kl - 1, 1, kl)], one=[1])[16], step)


@pytest.mark.cuda
@pytest.mark.parametrize("kl", [80, 1100, 2040])
def test_decode_rows_keep_bits_in_any_batch(dev, kl):
    from rbg_tpu_torch.ops.paged_attention import paged_attention

    k, v, table, q = _kv_pool(dev)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731

    def decode(lens):
        qd = torch.stack([q[n - 1] + i for i, n in enumerate(lens)])[:, None]
        pos = i32([[n - 1] for n in lens])
        return paged_attention(qd, k, v, table[:len(lens)], pos, i32(lens),
                               use_kernels="always", invariant=True)[:, 0]

    one = decode([kl])[0]
    for others in ([500], [500, 1500, 90], [300 + 200 * i for i in range(7)]):
        assert torch.equal(decode([kl] + others)[0], one), others


def _card_model(dev):
    """tiny in bf16 with biases on the card (the port's seed-0 init), and
    the same weights in float32 on the CPU."""
    cfg = get_config("tiny", dtype="bfloat16")
    p = llama.init_params(cfg, seed=0, device="cpu")
    p["blocks"].update({k: torch.from_numpy(v).to(torch.bfloat16)
                        for k, v in _biases(cfg).items()})
    f32 = {k: v.float() for k, v in p.items() if k != "blocks"}
    f32["blocks"] = {k: v.float() for k, v in p["blocks"].items()}
    params = {k: v.to(dev) for k, v in p.items() if k != "blocks"}
    params["blocks"] = {k: v.to(dev) for k, v in p["blocks"].items()}
    return cfg, params, get_config("tiny"), f32


@pytest.mark.cuda
def test_forwards_keep_each_rows_logits(dev):
    """A bf16 dense model with biases at tiny widths: a row's decode-step
    logits are the same alone, in a batch of 5, and through the layer
    windows the PD decode worker chains; a row's prefill logits the same
    alone and in a ragged pack beside another row."""
    from rbg_tpu_torch.engine.kvcache import PagedKVCache

    cfg, params, _, _ = _card_model(dev)
    c = PagedKVCache.create(cfg, 64, 8, device=dev)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    prompts = [[(7 * r + 3 * j) % 250 + 1 for j in range(20 + 3 * r)] for r in range(5)]
    tables = [list(range(1 + 6 * r, 7 + 6 * r)) for r in range(5)]

    def ragged(rows):
        tok, pos, rid = [], [], []
        for i, r in enumerate(rows):
            tok += prompts[r]
            pos += list(range(len(prompts[r])))
            rid += [i] * len(prompts[r])
        T = len(tok)
        return llama.forward_ragged(
            params, cfg, torch.tensor([tok], device=dev), i32([pos]),
            torch.ones(1, T, dtype=torch.bool, device=dev), i32(rid),
            i32([len(prompts[r]) for r in rows]), i32([tables[r] for r in rows]),
            c.k_pages, c.v_pages, rows=True)[0]

    alone = ragged([0])
    both = ragged([1, 0])
    assert torch.equal(both[len(prompts[1]):], alone)
    ragged([2, 3, 4])

    def decode(rows):
        B = len(rows)
        return llama.forward_paged(
            params, cfg, torch.tensor([[prompts[r][-1]] for r in rows], device=dev),
            i32([[len(prompts[r])] for r in rows]),
            torch.ones(B, 1, dtype=torch.bool, device=dev),
            i32([len(prompts[r]) + 1 for r in rows]), i32([tables[r] for r in rows]),
            c.k_pages, c.v_pages, rows=True)[:, 0]

    one = decode([0])[0]
    assert torch.equal(decode([3, 1, 0, 4, 2])[2], one)
    x = llama._embed(params, cfg, torch.tensor([[prompts[0][-1]]], device=dev))
    args = (i32([[len(prompts[0])]]), torch.ones(1, 1, dtype=torch.bool, device=dev),
            i32([len(prompts[0]) + 1]), i32([tables[0]]), c.k_pages, c.v_pages)
    for lo in range(0, cfg.num_layers):
        x = llama.forward_paged_window(params, cfg, lo, lo + 1, x, *args, rows=True)
    assert torch.equal(llama._head(params, cfg, x, rows=True)[0, 0], one)


# bf16 logits against float32 ones, tiny with biases (logits up to ~0.7):
# the port's bf16 rows body on the CPU reads at most 0.0046 from its float32
# body; without the biases the logits move by ~0.24 (checked below, so the
# bound catches a lost bias, and a lost norm or residual by far).
CARD_ATOL = 0.03


@pytest.mark.cuda
def test_rows_forwards_on_the_card_match_the_cpu_port(dev):
    """The rows body on the card (kernels A and B with ``invariant``, the
    products and norms in ROWS-row calls, bf16) against the default body on
    the CPU in float32 on the same weights: forward_ragged over a mixed
    pack, then forward_paged's decode step and the chained layer windows
    over the pools it wrote, and a T = 4 block of forward_paged."""
    from rbg_tpu_torch.engine.kvcache import PagedKVCache

    cfg, params, cfg32, p32 = _card_model(dev)
    rng = np.random.RandomState(7)
    lens = [30, 1, 45, 12]
    tok = [rng.randint(1, 256, size=n).tolist() for n in lens]
    table = np.arange(1, 1 + 4 * 8, dtype=np.int32).reshape(4, 8)
    rid = np.concatenate([[i] * n for i, n in enumerate(lens)]).astype(np.int32)
    pos = np.concatenate([np.arange(n) for n in lens])[None].astype(np.int32)
    flat = np.concatenate(tok)[None].astype(np.int32)
    kvl = np.asarray(lens, np.int32)
    caches = {d: PagedKVCache.create(c, 40, 8, device=d)
              for d, c in (("cuda", cfg), ("cpu", cfg32))}
    nobias = dict(p32, blocks={k: v for k, v in p32["blocks"].items()
                               if k not in ("bq", "bk", "bv")})

    def run(fn, d, *a, **kw):
        out = fn(*a, **kw)
        return out.float().cpu() if d == "cuda" else out

    def both(fn, host_args, **kw):
        got = {}
        for d, c, p, rows in (("cuda", cfg, params, True), ("cpu", cfg32, p32, False)):
            a = [torch.from_numpy(h).to(d) for h in host_args]
            cache = caches[d]
            got[d] = run(fn, d, p, c, *a, cache.k_pages, cache.v_pages, rows=rows, **kw)
        return got

    def close(got, what):
        err = (got["cuda"] - got["cpu"]).abs().max().item()
        assert err <= CARD_ATOL, (what, err)

    got = both(llama.forward_ragged, (flat, pos, pos >= 0, rid, kvl, table),
               max_q_len=64,
               one_token=one_token_rows(pos, rid, [1], dev))
    close(got, "ragged")
    step = (np.asarray([[t[-1]] for t in tok], np.int32), kvl[:, None].copy(),
            np.ones((4, 1), bool), kvl + 1, table)
    # The CPU's float32 decode step on a copy of its pools, for the windows.
    snap = (caches["cpu"].k_pages.clone(), caches["cpu"].v_pages.clone())
    snap_d = (caches["cuda"].k_pages.clone(), caches["cuda"].v_pages.clone())
    got = both(llama.forward_paged, step)
    close(got, "decode")
    lost = llama.forward_paged(nobias, cfg32, *map(torch.from_numpy, step),
                               snap[0].clone(), snap[1].clone())
    assert (lost - got["cpu"]).abs().max().item() > 5 * CARD_ATOL
    x = llama._embed(params, cfg, torch.from_numpy(step[0]).to(dev))
    a = [torch.from_numpy(h).to(dev) for h in step[1:]]
    for lo in range(cfg.num_layers):
        x = llama.forward_paged_window(params, cfg, lo, lo + 1, x, *a, *snap_d, rows=True)
    close({"cuda": llama._head(params, cfg, x, rows=True).float().cpu(),
           "cpu": got["cpu"]}, "windows")
    blk = (np.asarray([t[:4] for t in tok[:1]] * 2, np.int32),
           np.asarray([[50, 51, 52, 53], [60, 61, 62, 63]], np.int32),
           np.asarray([[1, 1, 1, 1], [1, 1, 1, 0]], bool),
           np.asarray([54, 63], np.int32), table[2:4])
    got = both(llama.forward_paged, blk)
    m = torch.from_numpy(blk[2])
    close({d: got[d][m] for d in got}, "block")
