"""Tensor-parallel serving of the MoE, MLA, Mamba and encoder archs
(``repro_torch.distributed`` with ``models/moe.py``'s single reduce,
``mla_out``'s, the encoder's and the cross attention's) on the CPU over
gloo, against the JAX package's single-device ``ServeEngine`` and the
port's own single-device path, on the same weights (``params_from_jax``),
in float32, on the smoke variants of granite-moe-3b-a800m (MoE, 4 heads
over 2), deepseek-v2-236b (MLA + MoE with a shared expert), mamba2-780m
(Mamba blocks alone), jamba-1.5-large-398b (7 Mamba blocks and one
routed attention layer, MoE on the even layers) and whisper-tiny (2
encoder + 2 decoder layers with cross attention).

The JAX package's mesh path cannot run here (``tests/conftest.py`` pins
one device); its own tests hold it token-identical to its single-device
engine, which is the reference here. Held:

- TP = 2 on all five, router-driven and under the alternating override:
  ``generate`` (chunk 16; whisper's encoder frames take the monolithic
  path) gives JAX's tokens and routing, and first and last logits within
  1e-5 (relative to the largest) of the port's single-device run; the
  router's p_fa is asserted more than 1e-3 from 0.5 and every MoE gate's
  k-th probability more than MOE_MARGIN above its (k+1)-th on these
  prompts, so a reduction-order change cannot flip a decision unseen;
- a drain with staggered arrivals, a priority arrival and a preemption at
  TP = 2 for the four archs the slot pool serves (whisper's it refuses):
  JAX's statuses, tokens and preemption counts;
- at TP = 4 the weight layout only (below): 4 more ranks and a widened
  variant's JAX engine would cost the whole suite more time than it has;
- a warm prefix admission bitwise equal to the cold one, the tokens
  equal to the single-device port's and the store's stats (bytes,
  evictions) equal to its store's, for deepseek (a latent cache) and
  jamba (Mamba states beside one attention layer's k / v);
- a decode step's collectives, per layer: one at an attention or MLA
  layer, one at its FFN or MoE, one at a cross attention, none at a
  Mamba block, each of (B, 1, d_model), at two cache lengths;
- the memory ledger's global bytes equal the single-device pool's: a
  rank's k / v counted ``world`` times, latent and Mamba state once;
- ``shard_params_tp`` then concatenation gives the params back bitwise
  (``experts/down`` cut on its F axis, 1) at TP = 2 on all five and at
  TP = 4 on granite widened to 8 heads over 4 KV heads and on
  deepseek's smoke variant (one head a rank), ``params_are_local`` and
  ``global_param_bytes`` on every arch, ``init_params_tp`` draws the
  shares of ``init_params`` (the encoder's layers included);
- every full config passes ``check_tp_supported`` at TP = 2, an MLA
  model with fewer KV heads than ranks too (its cache has none), and
  whisper-tiny's 6 heads at TP = 4 raise ValueError.

The ranks are spawned once (``runs``): each runs every scenario and
hands its results back; the JAX runs go to two worker
processes, and this process makes the single-device port runs while
they run.
"""
import functools
import multiprocessing as mp
import threading
from concurrent.futures import ProcessPoolExecutor
from contextlib import contextmanager

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread: as fast at these small shapes, and it leaves the other
# cores to the test processes running beside this one (and to the ranks)
torch.set_num_threads(1)

from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.distributed import group as G  # noqa: E402
from repro_torch.distributed import pool_sharding as PSH  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.slo import STATUS_OK  # noqa: E402
# the scenarios and helpers the dense archs' file holds them with
from test_torch_tp import (_drain, _leaves, _override, _prefix,  # noqa: E402
                           _rel, _unshard)

ARCHS = {"granite": "granite-moe-3b-a800m", "deepseek": "deepseek-v2-236b",
         "mamba2": "mamba2-780m", "jamba": "jamba-1.5-large-398b",
         "whisper": "whisper-tiny"}
# variant → (arch, config replacements); the widened granite is held in
# the layout tests only
VARIANTS = {**{name: (name, {}) for name in ARCHS},
            "granite_wide": ("granite", dict(num_heads=8, num_kv_heads=4))}
WORLD = 2
ROUTINGS = ("router", "mixed")
# (arch, routing) of the generate runs; the archs of the drains (the slot
# pool refuses an encoder) and of the prefix runs
GEN_RUNS = [(v, r) for v in ARCHS for r in ROUTINGS]
DRAINS = ("granite", "deepseek", "mamba2", "jamba")
PREFIXES = ("deepseek", "jamba")
B, S, N, CH, MAX_LEN = 2, 40, 12, 16, 64
DRAIN_LENS = (20, 28, 9, 24)
PREFIX_S = 40  # a B = 1 prompt: boundaries at 16 and 32
REL = 1e-5
MARGIN = 1e-3  # the router's p_fa from 0.5
# the k-th gate probability over the (k+1)-th: a reduce point moves the
# residual by about 1e-7 relative here, so a gap this wide cannot flip
MOE_MARGIN = 1e-5
TIMEOUT = 60.0  # a diverged rank fails a collective instead of hanging


@functools.lru_cache(maxsize=None)
def _variant(name):
    """(JAX config, port config, JAX params, port params, prompts) of a
    variant: the same ``replace`` on both packages' smoke configs, the
    JAX package's weights. Prompts: "gen" (B, S), "drain" the four drain
    prompts and the priority arrival's, "prefix" (1, PREFIX_S), and
    whisper's "frames" (B, E, d)."""
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.configs import smoke_variant as jax_smoke
    from repro.models import model as JMD
    arch, kw = VARIANTS[name]
    jcfg = jax_smoke(jax_get_config(ARCHS[arch])).replace(**kw)
    tcfg = smoke_variant(get_config(ARCHS[arch])).replace(**kw)
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              "cpu")
    # seed 3: every router-driven variant's p_fa is > 1e-3 from 0.5
    rng = np.random.default_rng(3)
    prompts = {"gen": rng.integers(0, tcfg.vocab_size, (B, S)),
               "drain": [rng.integers(0, tcfg.vocab_size, n)
                         for n in DRAIN_LENS + (17,)],
               "prefix": rng.integers(0, tcfg.vocab_size, (1, PREFIX_S))}
    if tcfg.num_encoder_layers:
        prompts["frames"] = rng.standard_normal(
            (B, tcfg.encoder_ctx, tcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jparams, tparams, prompts


# ---------------------------------------------------------------------------
# The scenarios: run on every rank of a group, or with tp=None
# ---------------------------------------------------------------------------

def _generate(cfg, params, prompts, routing, tp):
    eng = ServeEngine(params, cfg, max_len=MAX_LEN, prefill_chunk=CH,
                      device="cpu", tp=tp)
    gen = eng.generate(prompts["gen"], N,
                       routing_override=_override(cfg, routing),
                       encoder_frames=prompts.get("frames"))
    return dict(tokens=gen.tokens, routing=gen.routing, p_fa=gen.p_fa,
                logits=gen.logits.numpy(),
                final=gen.final_logits.numpy(), kv_bytes=gen.kv_bytes)


def _port_drain(cfg, params, prompts, tp):
    eng = ServeEngine(params, cfg, max_len=MAX_LEN, prefill_chunk=CH,
                      device="cpu", memory_ledger=True, tp=tp)
    out, sched = _drain(eng, cfg, prompts["drain"], Request)
    rep = eng.ledger_report()
    (pool,) = sched.pools.values()
    return dict(
        done={rid: (f.status, f.tokens.tolist(), f.metrics.preemptions)
              for rid, f in out.items()},
        stats=rep["kv_cache_stats"],
        reconciliation=rep["reconciliation"],
        head_shard_bytes=PSH.head_sharded_bytes(pool.caches))


def _collectives(cfg, params, prompts, tp):
    """The all-reduces of 3 decode steps after an admission (chunked;
    monolithic with whisper's encoder output), at two cache lengths."""
    eng = ServeEngine(params, cfg, max_len=MAX_LEN, prefill_chunk=CH,
                      device="cpu", tp=tp)
    ov = _override(cfg, "mixed")
    out = []
    for S_ in (16, S):
        toks = prompts["gen"][:, :S_]
        enc_out = None
        if "frames" in prompts:
            with SH.tensor_parallel(tp):
                enc_out = TMD.encode(eng.params, eng.model_cfg,
                                     torch.as_tensor(prompts["frames"]))
            pf, _, caches, _ = eng.prefill_route_repack(toks, ov,
                                                        enc_out=enc_out)
            logits = pf.logits
        else:
            job = eng.prefill_chunked(toks, ov)
            logits, caches = job.logits, job.caches
        tp.reset_counts()
        with SH.tensor_parallel(tp):
            TMD.decode_many(eng.params, eng.model_cfg, logits, caches, S_,
                            n_steps=3, enc_out=enc_out)
        out.append((tp.reduce_calls, tp.reduce_bytes))
    return out


def _rank_scenarios(group, inputs):
    """Every scenario on one rank."""
    torch.set_num_threads(1)
    out = {}
    for name, routing in GEN_RUNS:
        cfg, params, prompts = inputs[name]
        out["gen", name, routing] = _generate(cfg, params, prompts, routing,
                                              group)
    for name in DRAINS:
        out["drain", name] = _port_drain(*inputs[name], group)
    for name in ARCHS:
        out["collectives", name] = _collectives(*inputs[name], group)
    for name in PREFIXES:
        cfg, params, prompts = inputs[name]
        out["prefix", name] = _prefix(cfg, params, prompts["prefix"], group)
    return out


def _jax_runs_of(name):
    """One variant's JAX single-device results (in a worker process):
    each generate run's (tokens, routing, p_fa) and the drain's {rid:
    (status, tokens, preemptions)}."""
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_default_matmul_precision", "highest")
    from repro.serve import Request as JaxRequest
    from repro.serve import ServeEngine as JaxEngine
    jcfg, _, jparams, _, prompts = _variant(name)
    side = ({"encoder_frames": jnp.asarray(prompts["frames"])}
            if "frames" in prompts else {})
    eng = JaxEngine(jparams, jcfg, max_len=MAX_LEN, prefill_chunk=CH)
    out = {}
    for routing in ROUTINGS:
        g = eng.generate(prompts["gen"], N,
                         routing_override=_override(jcfg, routing), **side)
        out["gen", name, routing] = (np.asarray(g.tokens), g.routing,
                                     g.p_fa)
    if name in DRAINS:
        done, _ = _drain(JaxEngine(jparams, jcfg, max_len=MAX_LEN,
                                   prefill_chunk=CH), jcfg,
                         prompts["drain"], JaxRequest)
        out["drain", name] = {
            rid: (f.status, np.asarray(f.tokens).tolist(),
                  f.metrics.preemptions) for rid, f in done.items()}
    return out


@contextmanager
def _gate_margins(margins):
    """Append each MoE call's smallest gap between a token's k-th and
    (k+1)-th gate probabilities to ``margins`` while inside."""
    dispatch = TMOE.dispatch

    def recorded(params, cfg, x, *args, **kw):
        d = dispatch(params, cfg, x, *args, **kw)
        p = torch.sort(d.probs, dim=-1, descending=True).values
        margins.append(float((p[..., cfg.top_k - 1]
                              - p[..., cfg.top_k]).min()))
        return d
    TMOE.dispatch = recorded
    try:
        yield
    finally:
        TMOE.dispatch = dispatch


def _single_runs():
    """The port's single-device (tp=None) results of the same runs, each
    generate run with its MoE gate margins."""
    out = {}
    for name, routing in GEN_RUNS:
        _, cfg, _, params, prompts = _variant(name)
        margins = []
        with _gate_margins(margins):
            res = _generate(cfg, params, prompts, routing, None)
        out["gen", name, routing] = dict(res, gate_margins=margins)
    for name in DRAINS:
        _, cfg, _, params, prompts = _variant(name)
        out["drain", name] = _port_drain(cfg, params, prompts, None)
    for name in PREFIXES:
        _, cfg, _, params, prompts = _variant(name)
        out["prefix", name] = _prefix(cfg, params, prompts["prefix"], None)
    return out


# the JAX variants over two worker processes: jamba (the costliest) alone
# on one, the rest on the other
JAX_ORDER = ("jamba", "deepseek", "granite", "mamba2", "whisper")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"tp": [each rank's results], "jax": ..., "single": ...}. The
    ranks are spawned once over gloo (from a thread),
    the JAX runs go to two worker processes, and this process makes the
    single-device runs meanwhile."""
    root = tmp_path_factory.mktemp("tp_archs")
    ranks, errors = [], []

    def run_ranks(inputs):
        try:
            ranks.extend(G.launch(
                _rank_scenarios, WORLD, "gloo", args=(inputs,),
                init_method=f"file://{root / 'store'}", device="cpu",
                timeout=TIMEOUT))
        except Exception as e:  # re-raised below
            errors.append(e)

    with ProcessPoolExecutor(2, mp_context=mp.get_context("spawn")) as pool:
        futures = [pool.submit(_jax_runs_of, n) for n in JAX_ORDER]
        inputs = {n: (_variant(n)[1], _variant(n)[3], _variant(n)[4])
                  for n in ARCHS}
        thread = threading.Thread(target=run_ranks, args=(inputs,))
        thread.start()
        try:
            single = _single_runs()
            jax_out = {}
            for f in futures:
                jax_out.update(f.result())
        finally:
            thread.join()
    if errors:
        raise errors[0]
    return {"tp": ranks, "jax": jax_out, "single": single}


# ---------------------------------------------------------------------------
# generate, the drain and the prefix store against JAX and one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,routing", GEN_RUNS,
                         ids=[f"tp{WORLD}-{n}-{r}" for n, r in GEN_RUNS])
def test_generate_matches_jax_and_single_device(runs, name, routing):
    jtoks, jrouting, jp_fa = runs["jax"]["gen", name, routing]
    one = runs["single"]["gen", name, routing]
    if routing == "router" and jp_fa is not None:
        assert np.all(np.abs(jp_fa - 0.5) > MARGIN), jp_fa
    cfg = _variant(name)[1]
    if cfg.num_experts:
        assert one["gate_margins"], "no MoE call recorded"
        assert min(one["gate_margins"]) > MOE_MARGIN, one["gate_margins"]
    assert len(runs["tp"]) == WORLD
    for res in runs["tp"]:
        got = res["gen", name, routing]
        assert got["routing"] == jrouting == one["routing"]
        assert np.array_equal(got["tokens"], jtoks)
        assert np.array_equal(one["tokens"], jtoks)
        assert _rel(got["logits"], one["logits"]) < REL
        assert _rel(got["final"], one["final"]) < REL
        # global bytes, as JAX's sharded arrays report them
        assert got["kv_bytes"] == one["kv_bytes"]
    first = runs["tp"][0]["gen", name, routing]
    for res in runs["tp"][1:]:  # every rank reads the same logits
        assert np.array_equal(res["gen", name, routing]["logits"],
                              first["logits"])


@pytest.mark.parametrize("name", DRAINS, ids=[f"tp{WORLD}-{n}"
                                              for n in DRAINS])
def test_drain_matches_jax(runs, name):
    want = runs["jax"]["drain", name]
    assert sorted(want) == [0, 1, 2, 3, 9]
    assert sum(p for _, _, p in want.values()) >= 1
    for res in runs["tp"]:
        got = res["drain", name]["done"]
        assert got == want
        assert all(s == STATUS_OK for s, _, _ in got.values())


@pytest.mark.parametrize("name", DRAINS, ids=[f"tp{WORLD}-{n}"
                                              for n in DRAINS])
def test_ledger_counts_kv_per_rank_and_latent_and_state_once(runs, name):
    """Global bytes equal the single-device pool's; a rank holds 1/WORLD
    of the k / v and the whole of every latent cache and Mamba state."""
    one = runs["single"]["drain", name]
    for res in runs["tp"]:
        st, st1 = res["drain", name]["stats"], one["stats"]
        for k in ("payload_bytes", "overhead_bytes"):
            assert st[k] == st1[k], k
        assert res["drain", name]["reconciliation"]["payload_delta"] == 0
        kv = res["drain", name]["head_shard_bytes"]
        assert kv * WORLD == one["head_shard_bytes"]
        assert st["payload_shard_bytes"] + (WORLD - 1) * kv \
            == st["payload_bytes"]
        assert st["overhead_shard_bytes"] == st["overhead_bytes"]
        if name in ("deepseek", "mamba2"):  # no k / v at all: whole
            assert kv == 0
            assert st["payload_shard_bytes"] == st["payload_bytes"]
        elif name == "jamba":  # Mamba states beside one layer's k / v
            assert 0 < kv * WORLD < st["payload_bytes"]
        else:
            assert kv * WORLD == st["payload_bytes"]


@pytest.mark.parametrize("name", PREFIXES)
def test_prefix_warm_equals_cold_and_store_matches(runs, name):
    one = runs["single"]["prefix", name]
    assert one["store"]["drops"] >= 1  # the budget evicts
    for res in runs["tp"]:
        got = res["prefix", name]
        assert got["hits"] == one["hits"] == (0, 32)
        assert np.array_equal(got["tokens"][0], one["tokens"][0])
        assert np.array_equal(one["tokens"][1], one["tokens"][0])
        assert np.array_equal(got["tokens"][1], got["tokens"][0])
        assert np.array_equal(got["logits"][1], got["logits"][0])
        assert np.array_equal(got["final"][1], got["final"][0])
        assert got["store"] == one["store"]


def _reduces_a_step(cfg):
    """A decode step's reduce points: one at each attention or MLA layer
    and at each cross attention, one at each FFN or MoE, none at a Mamba
    block."""
    n = 0
    for i, kind in enumerate(cfg.layer_kinds):
        if kind != "mamba":
            n += 1 + bool(cfg.num_encoder_layers)
        n += TMD.has_ffn(cfg, i)
    return n


@pytest.mark.parametrize("name", list(ARCHS), ids=[f"tp{WORLD}-{n}"
                                                   for n in ARCHS])
def test_decode_collectives_follow_the_layer_rule(runs, name):
    cfg = _variant(name)[1]
    per_step = _reduces_a_step(cfg)
    want = {"granite": 4, "deepseek": 4, "mamba2": 0, "jamba": 9,
            "whisper": 6}[name]
    assert per_step == want
    calls = 3 * per_step
    for res in runs["tp"]:
        # the same at a 16- and a 40-token cache: none is of cache size
        assert res["collectives", name] == [
            (calls, calls * B * cfg.d_model * 4)] * 2


# ---------------------------------------------------------------------------
# The weight layout and the refusals (no process group)
# ---------------------------------------------------------------------------

LAYOUT_CASES = [(n, 2) for n in ARCHS] + [("granite_wide", 4),
                                          ("deepseek", 4)]


@pytest.mark.parametrize("name,world", LAYOUT_CASES,
                         ids=[f"{n}-tp{w}" for n, w in LAYOUT_CASES])
def test_shard_then_concat_gives_params_back_bitwise(name, world):
    cfg = smoke_variant(get_config(ARCHS[VARIANTS[name][0]])).replace(
        **VARIANTS[name][1])
    params = TMD.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shards = [SH.shard_params_tp(params, cfg, r, world)
              for r in range(world)]
    lcfg = SH.tp_config(cfg, world)
    moe = [bp["moe"] for bp in shards[0]["layers"] if "moe" in bp]
    E, D, f = cfg.num_experts, cfg.d_model, lcfg.moe_d_ff
    for m in moe:  # the expert stacks' F axis: last of gate / up, 1 of down
        assert m["experts"]["gate"].shape == (E, D, f)
        assert m["experts"]["up"].shape == (E, D, f)
        assert m["experts"]["down"].shape == (E, f, D)
        if "shared" in m:
            assert m["shared"]["down"].shape == (
                f * cfg.num_shared_experts, D)
    assert bool(moe) == bool(cfg.num_experts)
    if cfg.use_mla:
        attn = shards[0]["layers"][0]["attn"]
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        assert attn["w_uq"].shape[-1] == lcfg.num_heads * qk
        assert attn["w_ukv"].shape[-1] == lcfg.num_heads * (
            cfg.qk_nope_head_dim + cfg.v_head_dim)
        assert attn["w_dkv"] is params["layers"][0]["attn"]["w_dkv"]
    # a model of Mamba blocks alone has no sharded leaf: local either way
    sharded = any(SH.shard_axis(p.split("/")[-2], p.split("/")[-1])
                  is not None for p, _ in _leaves(params))
    assert sharded == (name != "mamba2")
    assert SH.params_are_local(shards[1], cfg, world)
    assert SH.params_are_local(params, cfg, world) == (not sharded)
    back = dict(_leaves(_unshard(shards)))
    for path, t in _leaves(params):
        assert torch.equal(back[path], t), path
    assert SH.global_param_bytes(shards[0], cfg, world) == sum(
        t.nbytes for _, t in _leaves(params))


@pytest.mark.parametrize("name", ["jamba", "whisper"])
def test_init_params_tp_draws_the_shares_of_init_params(name):
    cfg = smoke_variant(get_config(ARCHS[name]))
    full = TMD.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for r in range(2):
        share = SH.init_params_tp(cfg, torch.Generator().manual_seed(0),
                                  r, 2, "cpu")
        want = dict(_leaves(SH.shard_params_tp(full, cfg, r, 2)))
        got = dict(_leaves(share))
        assert sorted(got) == sorted(want)
        for path, t in want.items():
            assert torch.equal(got[path], t), path


def test_tp_config_divides_the_expert_width_and_keeps_mamba_whole():
    ds = SH.tp_config(get_config(ARCHS["deepseek"]), 4)
    assert (ds.num_heads, ds.moe_d_ff, ds.kv_lora_rank) == (32, 384, 512)
    jb = SH.tp_config(get_config(ARCHS["jamba"]), 4)
    full = get_config(ARCHS["jamba"])
    assert (jb.num_heads, jb.num_kv_heads, jb.d_ff, jb.moe_d_ff) == (
        16, 2, 6144, 6144)
    assert (jb.ssm_inner, jb.ssm_num_heads, jb.ssm_state_dim) == (
        full.ssm_inner, full.ssm_num_heads, full.ssm_state_dim)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_full_configs_pass_the_tp_check(name):
    SH.check_tp_supported(get_config(ARCHS[name]), 2)


def test_mla_needs_no_kv_heads_and_whisper_6_heads_at_4_raise():
    # MLA's latent cache has no KV heads: nothing to replicate
    SH.check_tp_supported(smoke_variant(get_config(ARCHS["deepseek"]))
                          .replace(num_kv_heads=1), 2)
    with pytest.raises(ValueError, match="6 heads"):
        SH.check_tp_supported(get_config(ARCHS["whisper"]), 4)
    # jamba's 8 KV heads over 16 ranks: each KV head on 2 ranks
    jamba = get_config(ARCHS["jamba"])
    SH.check_tp_supported(jamba, 16)
    assert SH.kv_replicas(jamba, 16) == 2
    assert SH.tp_config(jamba, 16).num_kv_heads == 1
