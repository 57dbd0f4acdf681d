"""Sequence-sharded long-context decode (``repro_torch.distributed.decode``)
on the CPU over gloo, against the JAX package, in float32.

Held:

- ``lse_combine_decode`` (each shard's partial state, one gather, the
  merge) over 2, 3 and 4 in-process shards equals JAX's
  ``lse_combine_decode`` on a 1-device mesh (as ``tests/
  test_distributed.py`` runs it) to 2e-5, with shards that hold no
  visible key, at G = 1 and G = 2;
- the partial decode's plain version is the whole decode's split, and
  the rank merge weighs a shard with no visible key 0;
- per-shard one-token inserts at positions 0, S/N - 1, S/N and S - 1 and
  a chunk straddling a shard boundary, concatenated, are bitwise JAX's
  ``full_insert`` / ``full_insert_chunk`` on the whole cache; both raise
  IndexError past the capacity;
- 2 ranks (one spawn, ``ranks``) serving phi3-mini's smoke variant with
  FA caches cut at ``min_seq`` 64 and ``max_len`` 256 (shards of 128
  slots), chunk 16: ``generate`` router-driven, mixed and all-FA, B = 1
  and B = 2, a prompt whose decode crosses the shard boundary and one
  that ends on it, give JAX's single-device tokens and routing, with
  logits within 1e-5 of the largest of the port's single-device run
  (JAX's ``generate`` returns none); a decode step makes one gather a
  sharded FA layer of B·Hq·(D + 1) fp32 and no all-reduce; the global
  KV bytes are JAX's and a rank holds half of the FA bytes; a
  capacity below ``min_seq`` or one the ranks do not divide stays whole;
- ``tp=`` with ``seq_shard``, the slot pool, a prefix store, an xa
  request and a duo override raise ValueError; a world-1 group is the
  identity.

The ranks run in a thread while a worker process makes the JAX runs and
this process the single-device port runs.
"""
import functools
import multiprocessing as mp
import threading
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.distributed import decode as DD  # noqa: E402
from repro_torch.distributed import group as G  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.decode_attention_partial import \
    decode_attention_partial_bh  # noqa: E402
from repro_torch.kernels.decode_merge_ranks import \
    decode_merge_ranks_bh  # noqa: E402
from repro_torch.serve import kv_cache as TKC  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

ARCH = "phi3-mini-3.8b"
MAX_LEN, MIN_SEQ, CH, N_GEN = 256, 64, 16, 12
SHARD = MAX_LEN // 2
# (routing, batch, prompt length): 120 + 12 steps cross the shard
# boundary at 128; a 128-token prompt ends on it
CASES = (("router", 1, 120), ("mixed", 1, 120), ("fa", 1, SHARD),
         ("router", 2, 100), ("mixed", 2, 100))
PROMPT_SEED = 7  # router-driven: FA at a layer, p_fa > 1e-3 from 0.5
REL = 1e-5
TIMEOUT = 60.0


def _override(cfg, routing):
    if routing == "router":
        return None
    if routing == "mixed":
        return tuple("fa" if i % 2 == 0 else "sa"
                     for i in range(cfg.num_layers))
    return (routing,) * cfg.num_layers


@functools.lru_cache(maxsize=None)
def _model():
    """(JAX config, port config, JAX params, port params, prompts by
    case) of phi3-mini's smoke variant."""
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.configs import smoke_variant as jax_smoke
    from repro.models import model as JMD
    jcfg = jax_smoke(jax_get_config(ARCH))
    tcfg = smoke_variant(get_config(ARCH))
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              "cpu")
    rng = np.random.default_rng(PROMPT_SEED)
    prompts = {(b, n): rng.integers(0, tcfg.vocab_size, (b, n))
               for b, n in sorted({(b, n) for _, b, n in CASES})}
    return jcfg, tcfg, jparams, tparams, prompts


def _generate(eng, cfg, prompts, tp):
    out = {}
    for routing, b, n in CASES:
        if tp is not None:
            tp.reset_counts()
        g = eng.generate(prompts[b, n], N_GEN,
                         routing_override=_override(cfg, routing))
        out[routing, b, n] = dict(
            tokens=g.tokens, routing=g.routing, logits=g.logits.numpy(),
            final=g.final_logits.numpy(), kv_bytes=g.kv_bytes,
            kv_shard_bytes=g.kv_shard_bytes,
            collectives=None if tp is None else (
                tp.gather_calls, tp.gather_bytes, tp.bcast_calls,
                tp.reduce_calls))
    return out


def _cache_types(eng, cfg, prompt):
    job = eng.prefill_chunked(prompt, _override(cfg, "fa"))
    return [type(c).__name__ for c in job.caches]


def _rank_cases(group, cfg, params, prompts):
    """Every engine case on one rank."""
    torch.set_num_threads(1)
    eng = ServeEngine(params, cfg, max_len=MAX_LEN, prefill_chunk=CH,
                      device="cpu", seq_shard=group, min_seq=MIN_SEQ)
    out = {"gen": _generate(eng, cfg, prompts, group)}
    out["types"] = _cache_types(eng, cfg, prompts[1, 120])
    whole = {}
    for name, kw in (("short", dict(max_len=MAX_LEN, min_seq=MAX_LEN + 1)),
                     ("odd", dict(max_len=MAX_LEN - 1, min_seq=MIN_SEQ))):
        e = ServeEngine(params, cfg, prefill_chunk=CH, device="cpu",
                        seq_shard=group, **kw)
        group.reset_counts()
        g = e.generate(prompts[1, 120], 4)
        whole[name] = (_cache_types(e, cfg, prompts[1, 120]),
                       group.gather_calls, g.tokens)
    out["whole"] = whole
    return out


def _jax_runs(batch):
    """JAX's single-device ``generate`` of the cases of ``batch`` rows
    (a worker)."""
    import jax
    jax.config.update("jax_default_matmul_precision", "highest")
    from repro.serve import ServeEngine as JaxEngine
    jcfg, _, jparams, _, prompts = _model()
    eng = JaxEngine(jparams, jcfg, max_len=MAX_LEN, prefill_chunk=CH)
    out = {}
    for routing, b, n in CASES:
        if b != batch:
            continue
        g = eng.generate(prompts[b, n], N_GEN,
                         routing_override=_override(jcfg, routing))
        out[routing, b, n] = (np.asarray(g.tokens), g.routing, g.p_fa,
                              g.kv_bytes)
    return out


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        for v in tree:
            yield from _leaves(v)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ranks": [each rank's results], "jax": ..., "single": ...}: the
    JAX runs in two worker processes (by batch), started first, the 2
    ranks spawned once over gloo from a thread, and the single-device
    port runs here meanwhile."""
    root = tmp_path_factory.mktemp("seq")
    ranks, errors = [], []

    def run_ranks(cfg, params, prompts):
        try:
            ranks.extend(G.launch(
                _rank_cases, 2, "gloo", args=(cfg, params, prompts),
                init_method=f"file://{root / 'store'}", device="cpu",
                timeout=TIMEOUT))
        except Exception as e:  # re-raised below
            errors.append(e)

    with ProcessPoolExecutor(2, mp_context=mp.get_context("spawn")) as pool:
        futures = [pool.submit(_jax_runs, b) for b in (1, 2)]
        _, cfg, _, params, prompts = _model()
        for t in _leaves(params):  # pickled in place for the ranks: first
            t.share_memory_()
        thread = threading.Thread(target=run_ranks,
                                  args=(cfg, params, prompts))
        thread.start()
        try:
            eng = ServeEngine(params, cfg, max_len=MAX_LEN,
                              prefill_chunk=CH, device="cpu")
            single = _generate(eng, cfg, prompts, None)
            jax_out = {k: v for f in futures for k, v in f.result().items()}
        finally:
            thread.join()
    if errors:
        raise errors[0]
    return {"ranks": ranks, "jax": jax_out, "single": single}


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# The decode's two halves against JAX's lse_combine_decode
# ---------------------------------------------------------------------------

class _Loopback:
    """A stand-in group for in-process shards: ``all_gather`` records
    the rank's buffer and returns the ``parts`` given (every rank's)."""

    def __init__(self, rank, world, parts=None):
        self.rank, self.world, self.parts, self.sent = rank, world, parts, None

    def all_gather(self, x):
        self.sent = x.clone()
        return x[None] if self.parts is None else torch.stack(self.parts)


def _shard_caches(k, v, n, groups):
    """k / v (B, Hkv, S, D) as n ``SeqShardKV`` shards."""
    S = k.shape[2]
    out = []
    for r in range(n):
        a, b = TKC.seq_shard_range(S, n, r)
        out.append(TKC.SeqShardKV(
            k=k[:, :, a:b].clone(), v=v[:, :, a:b].clone(),
            positions=torch.arange(a, b, dtype=torch.int32),
            length=torch.full((k.shape[0],), S, dtype=torch.int32),
            start=a, group=groups[r]))
    return out


LSE_B, LSE_HKV, LSE_S, LSE_D = 2, 2, 96, 16


@functools.lru_cache(maxsize=None)
def _jax_combine(G_, cur):
    """(q, k, v, JAX's ``lse_combine_decode`` on a 1-device mesh) at G_
    query heads a KV head, visible keys [0, cur]."""
    import jax.numpy as jnp
    from repro.distributed.decode import lse_combine_decode as jax_combine
    from repro.launch.mesh import make_debug_mesh
    rng = np.random.default_rng(10 * G_ + cur)
    B, Hkv, S, D = LSE_B, LSE_HKV, LSE_S, LSE_D
    q = rng.normal(size=(B, Hkv * G_, 1, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    want = np.asarray(jax_combine(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.arange(S) <= cur, make_debug_mesh(1, 1), ("data",)))
    return q, k, v, want


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("G_", [1, 2])
@pytest.mark.parametrize("cur", [40, 70])
def test_lse_combine_matches_jax(n, G_, cur):
    q, k, v, want = _jax_combine(G_, cur)
    B, Hq, S, D = LSE_B, LSE_HKV * G_, LSE_S, LSE_D
    tq, tk, tv = (torch.as_tensor(x) for x in (q, k, v))
    first = [_Loopback(r, n) for r in range(n)]
    for cache in _shard_caches(tk, tv, n, first):
        DD.lse_combine_decode(tq, cache, cur)  # records its buffer
    parts = [g.sent for g in first]
    # a shard wholly past cur holds no visible key: its lse is -1e30
    lse = torch.stack([p[B * Hq * D:] for p in parts])
    dead = [r for r in range(n) if r * (S // n) > cur]
    assert dead or cur == 70
    assert all(bool((lse[r] == -1e30).all()) for r in dead)
    for r, cache in enumerate(_shard_caches(
            tk, tv, n, [_Loopback(r, n, parts) for r in range(n)])):
        got = DD.lse_combine_decode(tq, cache, cur).numpy()
        assert got.shape == want.shape
        assert float(np.abs(got - want).max()) < 2e-5, (n, r)


def test_partial_state_is_the_whole_decode_split():
    """Two halves of a cache's partial states merge to the plain decode
    of the whole; each o is normalized and lse is base 2."""
    g = torch.Generator().manual_seed(0)
    BH, BHkv, L, D = 6, 3, 200, 16
    q, k, v = (torch.randn(s, generator=g) for s in ((BH, 1, D),
                                                     (BHkv, L, D),
                                                     (BHkv, L, D)))
    pos = torch.arange(L, dtype=torch.int32)
    halves = [decode_attention_partial_bh(
        q, k[:, a:a + 100].contiguous(), v[:, a:a + 100].contiguous(),
        pos[a:a + 100].contiguous(), 150) for a in (0, 100)]
    o = decode_merge_ranks_bh(torch.stack([h[0] for h in halves]),
                              torch.stack([h[1] for h in halves]),
                              torch.float32)
    want = ref.decode_attention_ref(q, k, v, pos, 150)[:, 0]
    torch.testing.assert_close(o, want, rtol=0, atol=2e-6)
    s = torch.einsum("hgd,hkd->hgk", q.reshape(BHkv, 2, D), k[:, :100])
    lse2 = torch.logsumexp(s * D ** -0.5, -1).reshape(BH) / np.log(2)
    torch.testing.assert_close(halves[0][1], lse2, rtol=0, atol=1e-5)


def test_merge_weighs_a_dead_rank_zero():
    o = torch.randn(3, 4, 32)
    lse = torch.tensor([[5.0] * 4, [-1e30] * 4, [4.0] * 4])
    got = decode_merge_ranks_bh(o, lse, torch.float32)
    w = torch.tensor([1.0, 2.0 ** -1])
    want = (w[0] * o[0] + w[1] * o[2]) / w.sum()
    torch.testing.assert_close(got, want)


def test_entries_refuse_bad_operands():
    q = torch.zeros(4, 1, 16)
    k = torch.zeros(2, 64, 16)
    pos = torch.arange(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="positions"):
        decode_attention_partial_bh(q, k, k, pos[:10], 5)
    with pytest.raises(ValueError, match="out must be"):
        decode_attention_partial_bh(q, k, k, pos, 5,
                                    out=(torch.zeros(4, 8), torch.zeros(4)))
    with pytest.raises(ValueError, match="o_parts"):
        decode_merge_ranks_bh(torch.zeros(2, 4, 16), torch.zeros(2, 3),
                              torch.float32)
    with pytest.raises(ValueError, match="float32"):
        decode_merge_ranks_bh(torch.zeros(2, 4, 16, dtype=torch.float64),
                              torch.zeros(2, 4), torch.float32)


# ---------------------------------------------------------------------------
# Inserts against JAX's whole-cache inserts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 4])
def test_sharded_inserts_are_jax_full_inserts(n):
    import jax.numpy as jnp
    from repro.serve import kv_cache as JKC
    rng = np.random.default_rng(n)
    B, H, S, D = 2, 2, 96, 8
    Ls = S // n
    jc = JKC.FullKV(k=jnp.zeros((B, H, S, D)), v=jnp.zeros((B, H, S, D)),
                    length=jnp.zeros((B,), jnp.int32))
    shards = _shard_caches(torch.zeros(B, H, S, D), torch.zeros(B, H, S, D),
                           n, [_Loopback(r, n) for r in range(n)])
    for pos in (0, Ls - 1, Ls, S - 1):
        kn, vn = (rng.normal(size=(B, H, 1, D)).astype(np.float32)
                  for _ in range(2))
        jc = JKC.full_insert(jc, jnp.asarray(kn), jnp.asarray(vn),
                             jnp.int32(pos))
        for c in shards:
            DD.sharded_seq_insert(c, torch.as_tensor(kn),
                                  torch.as_tensor(vn), pos)
    start, C = Ls - 3, 7  # over the first boundary
    kn, vn = (rng.normal(size=(B, H, C, D)).astype(np.float32)
              for _ in range(2))
    jc = JKC.full_insert_chunk(jc, jnp.asarray(kn), jnp.asarray(vn),
                               jnp.int32(start))
    for c in shards:
        DD.sharded_seq_insert_chunk(c, torch.as_tensor(kn),
                                    torch.as_tensor(vn), start)
    for name in ("k", "v"):
        got = torch.cat([getattr(c, name) for c in shards], dim=2).numpy()
        assert np.array_equal(got, np.asarray(getattr(jc, name)))
    for c in shards:
        assert c.length.tolist() == np.asarray(jc.length).tolist()
        with pytest.raises(IndexError):
            DD.sharded_seq_insert(c, torch.zeros(B, H, 1, D),
                                  torch.zeros(B, H, 1, D), S)
        with pytest.raises(IndexError):
            DD.sharded_seq_insert_chunk(c, torch.zeros(B, H, 4, D),
                                        torch.zeros(B, H, 4, D), S - 3)
        with pytest.raises(TypeError):
            DD.sharded_seq_insert(c, torch.zeros(B, H, 1, D),
                                  torch.zeros(B, H, 1, D),
                                  torch.zeros(B, dtype=torch.int32))


def test_shard_rule_and_ranges():
    assert TKC.seq_shardable(8192, 4) and not TKC.seq_shardable(8190, 4)
    assert not TKC.seq_shardable(4096, 4)  # below JAX's min_seq
    assert not TKC.seq_shardable(8192, 1)
    assert TKC.seq_shard_range(12, 3, 2) == (8, 12)
    with pytest.raises(ValueError, match="divide"):
        TKC.seq_shard_range(10, 3, 0)


# ---------------------------------------------------------------------------
# The engine on 2 ranks against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=[f"{r}-B{b}-S{n}"
                                             for r, b, n in CASES])
def test_generate_matches_jax(runs, case):
    jtoks, jrouting, jp_fa, _ = runs["jax"][case]
    one = runs["single"][case]
    if case[0] == "router":
        assert np.all(np.abs(jp_fa - 0.5) > 1e-3), jp_fa
    assert np.array_equal(one["tokens"], jtoks)
    for res in runs["ranks"]:
        got = res["gen"][case]
        assert got["routing"] == jrouting == one["routing"]
        assert np.array_equal(got["tokens"], jtoks)
        assert _rel(got["logits"], one["logits"]) < REL
        assert _rel(got["final"], one["final"]) < REL


@pytest.mark.parametrize("case", CASES, ids=[f"{r}-B{b}-S{n}"
                                             for r, b, n in CASES])
def test_decode_collectives_and_bytes(runs, case):
    """One gather of B·Hq·(D + 1) fp32 a sharded FA layer a step, no
    all-reduce, a prefill broadcast of k and one of v a FA layer from
    each rank with a live part on every chunk past the first; the global
    KV bytes JAX's and one device's, a rank's FA bytes half of them."""
    _, cfg, _, _, _ = _model()
    _, b, n = case
    one = runs["single"][case]
    assert one["kv_bytes"] == runs["jax"][case][3]
    for res in runs["ranks"]:
        got = res["gen"][case]
        n_fa = sum(p == "fa" for p in got["routing"])
        gathers, nbytes, bcasts, reduces = got["collectives"]
        assert n_fa and gathers == N_GEN * n_fa
        assert nbytes == gathers * b * cfg.num_heads * (cfg.head_dim + 1) * 4
        assert reduces == 0
        starts = range(CH, n, CH)  # chunk 16 divides every prompt here
        assert bcasts == sum(2 * n_fa * -(-s // SHARD) for s in starts)
        fa = n_fa * 2 * b * cfg.num_kv_heads * MAX_LEN * cfg.head_dim * 4
        assert got["kv_bytes"] == one["kv_bytes"]
        assert one["kv_shard_bytes"] == one["kv_bytes"]
        assert got["kv_shard_bytes"] == one["kv_bytes"] - fa // 2


def test_short_or_indivisible_capacity_stays_whole(runs):
    for res in runs["ranks"]:
        assert "SeqShardKV" in res["types"]
        for name, (types, gathers, tokens) in res["whole"].items():
            assert "SeqShardKV" not in types and "FullKV" in types, name
            assert gathers == 0, name
        assert np.array_equal(res["whole"]["short"][2],
                              res["whole"]["odd"][2])


# ---------------------------------------------------------------------------
# Refusals and the identity at world 1
# ---------------------------------------------------------------------------

def _fake_group(world=2, rank=0):
    return G.TPGroup(rank=rank, world=world, backend="gloo",
                     device=torch.device("cpu"))


def test_refusals():
    _, cfg, _, params, prompts = _model()
    g = _fake_group()
    with pytest.raises(ValueError, match="seq_shard with tp"):
        ServeEngine(params, cfg, max_len=MAX_LEN, device="cpu", tp=g,
                    seq_shard=g)
    with pytest.raises(ValueError, match="prefix store"):
        ServeEngine(params, cfg, max_len=MAX_LEN, device="cpu",
                    seq_shard=g, prefix_cache_mb=64)
    eng = ServeEngine(params, cfg, max_len=MAX_LEN, prefill_chunk=CH,
                      device="cpu", seq_shard=g, min_seq=MIN_SEQ)
    with pytest.raises(ValueError, match="continuous batching"):
        eng.submit(Request(rid=0, tokens=prompts[1, 120][0], n_steps=2))
    with pytest.raises(ValueError, match="duo head-split"):
        eng.generate(prompts[1, 120], 2,
                     routing_override=(("duo", 1),) * cfg.num_layers)
    xa = ServeEngine(params, cfg.replace(flux=cfg.flux.replace(
        sa_mode="xa")), max_len=MAX_LEN, prefill_chunk=CH, device="cpu",
        seq_shard=g, min_seq=MIN_SEQ)
    with pytest.raises(ValueError, match="the xa SA mode"):
        xa.generate(prompts[1, 120], 2)
    # the first reason the chunked path declines, not the SA mode
    xa_whole = ServeEngine(params, xa.cfg, max_len=MAX_LEN,
                           prefill_chunk=None, device="cpu", seq_shard=g,
                           min_seq=MIN_SEQ)
    with pytest.raises(ValueError, match=r"\(prefill_chunk unset\)"):
        xa_whole.generate(prompts[1, 120], 2)


def test_world_one_group_is_the_identity():
    _, cfg, _, params, prompts = _model()
    g1 = G.init_tp(1, 0, None, None, "cpu")
    x = torch.ones(3)
    assert g1.all_gather(x).shape == (1, 3) and g1.gather_calls == 0
    assert g1.broadcast(x, 0) is x and g1.bcast_calls == 0
    runs = []
    for seq in (None, g1):
        eng = ServeEngine(params, cfg, max_len=MAX_LEN, prefill_chunk=CH,
                          device="cpu", seq_shard=seq, min_seq=MIN_SEQ)
        assert "SeqShardKV" not in _cache_types(eng, cfg, prompts[1, 120])
        runs.append(eng.generate(prompts[1, 120], 4))
    assert np.array_equal(runs[0].tokens, runs[1].tokens)
    assert torch.equal(runs[0].logits, runs[1].logits)
    assert torch.equal(runs[0].final_logits, runs[1].final_logits)
    assert runs[0].kv_bytes == runs[1].kv_bytes == runs[1].kv_shard_bytes
