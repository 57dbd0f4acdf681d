"""Tensor-parallel serving (``repro_torch.distributed``) on the CPU over
gloo, against the JAX package's single-device ``ServeEngine`` and the
port's own single-device path, on the same weights
(``params_from_jax``), in float32.

The JAX package's mesh path cannot run here (``tests/conftest.py`` pins
one device); its own tests hold it token-identical to its single-device
engine, which is the reference here. Held:

- TP = 2 on the smoke variants of phi3-mini (4 heads over 4), command-r-
  plus (4 over 2, tied embeddings) and gemma3 (5 local layers and 1
  routed), router-driven and under all-FA, all-SA and alternating
  overrides: ``generate`` (chunk 16) gives JAX's tokens and routing and
  first and last logits within 1e-5 (relative to the largest) of the
  port's single-device run; a drain with staggered arrivals, a priority
  arrival and a preemption gives JAX's statuses, tokens and preemption
  counts;
- the same at TP = 4 on a widened phi3-mini (8 heads over 4 KV heads, G
  = 2, ``replace`` on both sides), and the ``xa`` and ``ta`` SA modes at
  TP = 2 (the monolithic repack path);
- KV replication: command-r-plus's smoke variant (4 heads over 2 KV
  heads) at TP = 4, each KV head on 2 ranks, router-driven and mixed,
  and a drain, as JAX's; the ranks that share a KV head hold bitwise
  equal caches, and the ledger counts each KV head once;
- phi3-mini at TP = 2 under a duo override of 3 KV heads (the split
  falls inside rank 1) and of 1, as JAX's ``generate`` under the same
  override;
- a drain with the fidelity probe on every admission at TP = 2 (phi3-
  mini at local 16, so the drain's prompts reach past sink + local):
  each request's ``fidelity`` within 1e-5 of JAX's, the same on every
  rank;
- a warm prefix admission bitwise equal to the cold one and to JAX's
  tokens, and the store's stats (bytes, evictions) equal to the
  single-device store's under the same budget;
- a decode step's collectives: exactly 2 x layers all-reduces of (B, 1,
  d_model), whatever the cache length;
- ``shard_params_tp`` then concatenation gives the params back bitwise,
  and a router with row-sharded ``enc_w`` gives the single-device logits
  under both poolings;
- the memory ledger's reconciliation at TP = 2, its global bytes the
  shard's times 2 for k / v and equal for the rest;
- a rank fed a different submission raises ``TPDivergence``;
- KV replication's layout (shard then concatenate, ``init_params_tp``,
  ``global_param_bytes``), and KV heads that neither divide nor are
  divided by the ranks raise ValueError naming both counts;
- a world-1 group is the identity, and the CLI's ``--mesh-model 2``.

The ranks are spawned once per world size (``tp_runs``): each runs every
scenario and hands its results back; the JAX runs (``jax_runs``) and the
single-device port runs are made in this process while they run.
"""
import functools
import json
import multiprocessing as mp
import threading
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread: as fast at these small shapes, and it leaves the other
# cores to the test processes running beside this one (and to the ranks)
torch.set_num_threads(1)

from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.core import router as TR  # noqa: E402
from repro_torch.distributed import group as G  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.distributed import pool_sharding as PSH  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.serve import kv_cache as TKC  # noqa: E402
from repro_torch.serve import prefix_cache as TPXC  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.slo import STATUS_OK  # noqa: E402

ARCHS = {"phi3": "phi3-mini-3.8b", "command_r": "command-r-plus-104b",
         "gemma3": "gemma3-12b"}
ROUTINGS = ("router", "fa", "sa", "mixed")
# variant → (arch, config replacements, flux replacements)
VARIANTS = {
    "phi3": ("phi3", {}, {}),
    "command_r": ("command_r", {}, {}),
    "gemma3": ("gemma3", {}, {}),
    "wide": ("phi3", dict(num_heads=8, num_kv_heads=4), {}),
    "xa": ("phi3", {}, dict(sa_mode="xa")),
    "ta": ("phi3", {}, dict(sa_mode="ta")),
    # the drain with the fidelity probe: sink + local 24, so most of
    # the drain's prompts reach past the SA window
    "probe": ("phi3", {}, dict(local=16)),
}
# (variant, routing) of each world's generate runs, and its drains
GEN_RUNS = {2: [(v, r) for v in ("phi3", "command_r", "gemma3")
                for r in ROUTINGS] + [("xa", "mixed"), ("ta", "mixed"),
                                      ("phi3", "duo3"), ("phi3", "duo1")],
            4: [("wide", r) for r in ROUTINGS]
            + [("command_r", r) for r in ("router", "mixed")]}
DRAINS = {2: ("phi3", "command_r", "gemma3", "probe"),
          4: ("wide", "command_r")}
# the engines' fidelity probe dial of each drain variant
PROBE_EVERY = {"probe": 1}
B, S, N, CH, MAX_LEN = 2, 40, 12, 16, 64
SA_MODE_S = 100  # past ta's dense chunk (64) and xa's blocks (16)
DRAIN_LENS = (20, 28, 9, 24)
PREFIX_S = 40  # a B = 1 prompt: boundaries at 16 and 32
REL = 1e-5
MARGIN = 1e-3
TIMEOUT = 60.0  # a diverged rank fails a collective instead of hanging


def _override(cfg, routing):
    if routing == "router":
        return None
    if routing.startswith("duo"):  # ("duo", n) at every layer
        return (("duo", int(routing[3:])),) * cfg.num_layers
    if routing == "mixed":
        return tuple("fa" if i % 2 == 0 else "sa"
                     for i in range(cfg.num_layers))
    return (routing,) * cfg.num_layers


@functools.lru_cache(maxsize=None)
def _variant(name):
    """(JAX config, port config, port params, prompts) of a variant: the
    same ``replace`` on both packages' smoke configs, the JAX package's
    weights. Prompts: "gen" (B, S) (SA_MODE_S for xa / ta), "drain" the
    four drain prompts and the priority arrival's, "prefix" (1, S)."""
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.configs import smoke_variant as jax_smoke
    from repro.models import model as JMD
    arch, kw, flux = VARIANTS[name]
    cfgs = []
    for base in (jax_smoke(jax_get_config(ARCHS[arch])),
                 smoke_variant(get_config(ARCHS[arch]))):
        cfgs.append(base.replace(**kw, flux=base.flux.replace(**flux)))
    jcfg, tcfg = cfgs
    if flux:  # an SA mode changes no weight: the base variant's
        _, _, jparams, tparams, _ = _variant(arch)
    else:
        jparams = JMD.init_params(jax.random.key(0), jcfg)
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                  "cpu")
    # seed 1: every router-driven variant's p_fa is > 0.01 from 0.5
    rng = np.random.default_rng(1)
    s = SA_MODE_S if name in ("xa", "ta") else S
    prompts = {"gen": rng.integers(0, tcfg.vocab_size, (B, s)),
               "drain": [rng.integers(0, tcfg.vocab_size, n)
                         for n in DRAIN_LENS + (17,)],
               "prefix": rng.integers(0, tcfg.vocab_size, (1, PREFIX_S))}
    return jcfg, tcfg, jparams, tparams, prompts


# ---------------------------------------------------------------------------
# The scenarios: run on every rank of a group, or with tp=None
# ---------------------------------------------------------------------------

def _generate(cfg, params, prompts, routing, tp):
    eng = ServeEngine(params, cfg, max_len=SA_MODE_S + N,
                      prefill_chunk=CH, device="cpu", tp=tp)
    gen = eng.generate(prompts, N, routing_override=_override(cfg, routing))
    return dict(tokens=gen.tokens, routing=gen.routing, p_fa=gen.p_fa,
                logits=gen.logits.numpy(),
                final=gen.final_logits.numpy(), kv_bytes=gen.kv_bytes)


def _drain(engine, cfg, prompts, req_cls):
    """Four requests into 2-slot pools, decode chunks of 4, under the
    alternating override (one geometry); two arrive after the first
    tick, and once both slots hold a request a priority-9 arrival
    preempts one."""
    ov = _override(cfg, "mixed")
    sched = engine.scheduler(slots_per_bucket=2, chunk=4,
                             prefill_chunks_per_tick=2)
    for rid in (0, 1):
        engine.submit(req_cls(rid=rid, tokens=prompts[rid], n_steps=16,
                              routing_override=ov))
    engine.step()
    for rid in (2, 3):
        engine.submit(req_cls(rid=rid, tokens=prompts[rid], n_steps=16,
                              routing_override=ov))
    for _ in range(8):
        if sched.n_active() == 2:
            break
        engine.step()
    assert sched.n_active() == 2
    engine.submit(req_cls(rid=9, tokens=prompts[4], n_steps=6, priority=9,
                          routing_override=ov))
    return engine.drain(), sched


def _port_drain(cfg, params, prompts, tp, probe_every=0):
    eng = ServeEngine(params, cfg, max_len=MAX_LEN, prefill_chunk=CH,
                      device="cpu", memory_ledger=True, tp=tp,
                      fidelity_probe_every=probe_every)
    out, sched = _drain(eng, cfg, prompts, Request)
    rep = eng.ledger_report()
    (pool,) = sched.pools.values()
    return dict(
        done={rid: (f.status, f.tokens.tolist(), f.metrics.preemptions)
              for rid, f in out.items()},
        fidelity={rid: (f.metrics.fidelity, f.metrics.fidelity_sa_min)
                  for rid, f in out.items()},
        kv=[(c.k.numpy().copy(), c.v.numpy().copy()) for c in pool.caches
            if isinstance(c, (TKC.FullKV, TKC.RingKV))],
        ledger={k: rep[k] for k in ("kv_cache_stats", "mesh",
                                    "reconciliation", "aux_bytes")},
        slot_bytes=(pool.slot_payload_bytes, pool.slot_overhead_bytes),
        head_shard_bytes=PSH.head_sharded_bytes(pool.caches),
        mesh=eng.flight_recorder.last().mesh,
        probes=(eng._probe_admissions,
                None if tp is None else (tp.probe_calls, tp.reduce_calls)))


def _prefix(cfg, params, prompts, tp):
    """A B = 1 prompt served cold (publishing its boundaries at 16 and
    32), then warm from the store, whose budget holds one snapshot
    only, so the second publication evicts the first."""
    need = TPXC.snapshot_spec_bytes(cfg, _override(cfg, "mixed"), MAX_LEN)
    eng = ServeEngine(params, cfg, max_len=MAX_LEN, prefill_chunk=CH,
                      device="cpu", prefix_cache_mb=1.5 * need / 2 ** 20,
                      routing_override=_override(cfg, "mixed"), tp=tp)
    cold = eng.generate(prompts, N)
    warm = eng.generate(prompts, N)
    return dict(hits=(cold.prefix_hit_tokens, warm.prefix_hit_tokens),
                tokens=(cold.tokens, warm.tokens),
                logits=(cold.logits.numpy(), warm.logits.numpy()),
                final=(cold.final_logits.numpy(), warm.final_logits.numpy()),
                store=eng.prefix_store.stats().as_dict())


def _collectives(cfg, params, prompts, tp):
    """The all-reduces of 3 decode steps after a chunked admission, at
    two cache lengths."""
    eng = ServeEngine(params, cfg, max_len=MAX_LEN, prefill_chunk=CH,
                      device="cpu", tp=tp)
    out = []
    for S_ in (16, S):
        job = eng.prefill_chunked(prompts[:, :S_], _override(cfg, "mixed"))
        tp.reset_counts()
        with SH.tensor_parallel(tp):
            TMD.decode_many(eng.params, eng.model_cfg, job.logits,
                            job.caches, S_, n_steps=3)
        out.append((tp.reduce_calls, tp.reduce_bytes))
    return out


def _router_logits(cfg, params, prompts, tp):
    """Layer 0's router logits from its sharded ``enc_w`` over the rank's
    x_Q columns, under both poolings."""
    local = SH.shard_params_tp(params, cfg, tp.rank, tp.world)
    lcfg = SH.tp_config(cfg, tp.world)
    bp = local["layers"][0]
    h = TMD.embed_tokens(local, lcfg, torch.as_tensor(prompts))
    x = TMD.rms_norm(bp["norm1"], h, cfg.norm_eps)
    _, _, _, x_q = TA.gqa_qkv(bp["attn"], lcfg, x,
                              torch.arange(x.shape[1]))
    with SH.tensor_parallel(tp):
        return {pooling: TR.router_logits(bp["router"], x_q,
                                          cfg.flux.pool_size, pooling)
                .numpy() for pooling in ("prefix", "prefix_suffix")}


def _diverge(cfg, params, prompts, tp):
    """Rank 1 is handed a different prompt of the same length; the check
    at the next tick's start must raise on every rank."""
    eng = ServeEngine(params, cfg, max_len=MAX_LEN, prefill_chunk=CH,
                      device="cpu", tp=tp)
    toks = prompts[0].copy()
    if tp.rank == 1:
        toks[3] = (toks[3] + 1) % cfg.vocab_size
    eng.submit(Request(rid=0, tokens=toks, n_steps=4))
    try:
        eng.step()
    except G.TPDivergence as e:
        return str(e)
    return None


def _rank_scenarios(group, inputs):
    """Every scenario of one world size on one rank."""
    torch.set_num_threads(1)
    out = {}
    for name, routing in GEN_RUNS[group.world]:
        cfg, params, prompts = inputs[name]
        out["gen", name, routing] = _generate(cfg, params, prompts["gen"],
                                              routing, group)
    for name in DRAINS[group.world]:
        cfg, params, prompts = inputs[name]
        out["drain", name] = _port_drain(cfg, params, prompts["drain"],
                                         group, PROBE_EVERY.get(name, 0))
    name = "phi3" if group.world == 2 else "wide"
    cfg, params, prompts = inputs[name]
    out["collectives"] = _collectives(cfg, params, prompts["gen"], group)
    if group.world == 2:
        out["prefix"] = _prefix(cfg, params, prompts["prefix"], group)
        out["router"] = _router_logits(cfg, params, prompts["gen"], group)
        out["diverge"] = _diverge(cfg, params, prompts["drain"], group)
    return out


def _jax_runs_of(name, part):
    """One variant's JAX single-device results (in a worker process),
    by ``part``: "gen" each generate run's (tokens, routing, p_fa), one
    engine; "drain" the drain's {rid: (status, tokens, preemptions)} and
    its probes' {rid: (fidelity, fidelity_sa_min)}; "prefix" phi3's B = 1
    prefix prompt's tokens."""
    import jax
    jax.config.update("jax_default_matmul_precision", "highest")
    from repro.serve import Request as JaxRequest
    from repro.serve import ServeEngine as JaxEngine
    jcfg, _, jparams, _, prompts = _variant(name)
    out = {}
    if part == "gen":
        eng = JaxEngine(jparams, jcfg, max_len=SA_MODE_S + N,
                        prefill_chunk=CH)
        for routing in _routings(name):  # once, whatever the worlds
            g = eng.generate(prompts["gen"], N, routing_override=(
                _override(jcfg, routing)))
            out["gen", name, routing] = (np.asarray(g.tokens), g.routing,
                                         g.p_fa)
    elif part == "drain":
        done, _ = _drain(JaxEngine(
            jparams, jcfg, max_len=MAX_LEN, prefill_chunk=CH,
            fidelity_probe_every=PROBE_EVERY.get(name, 0)), jcfg,
            prompts["drain"], JaxRequest)
        out["drain", name] = {
            rid: (f.status, np.asarray(f.tokens).tolist(),
                  f.metrics.preemptions) for rid, f in done.items()}
        out["fidelity", name] = {
            rid: (f.metrics.fidelity, f.metrics.fidelity_sa_min)
            for rid, f in done.items()}
    else:
        eng = JaxEngine(jparams, jcfg, max_len=MAX_LEN, prefill_chunk=CH,
                        routing_override=_override(jcfg, "mixed"))
        out["prefix"] = np.asarray(eng.generate(prompts["prefix"],
                                                N).tokens)
    return out


def _routings(name):
    """A variant's generate routings over both worlds, each once."""
    return sorted({r for runs in GEN_RUNS.values() for n, r in runs
                   if n == name})


def _single_runs():
    """The port's single-device (tp=None) results of the same runs."""
    out = {}
    for name in sorted({n for runs in GEN_RUNS.values() for n, _ in runs}):
        _, cfg, _, params, prompts = _variant(name)
        for routing in _routings(name):
            out["gen", name, routing] = _generate(cfg, params,
                                                  prompts["gen"], routing,
                                                  None)
    for name in ("phi3", "wide", "command_r"):
        _, cfg, _, params, prompts = _variant(name)
        out["drain", name] = _port_drain(cfg, params, prompts["drain"],
                                         None)
    _, cfg, _, params, prompts = _variant("phi3")
    out["prefix"] = _prefix(cfg, params, prompts["prefix"], None)
    return out


# the JAX runs (variant, part), costliest first, over three worker
# processes: each part builds its own engine, so a variant's generate
# runs and its drain can run side by side
JAX_ORDER = (("gemma3", "gen"), ("phi3", "gen"), ("gemma3", "drain"),
             ("command_r", "gen"), ("phi3", "drain"),
             ("command_r", "drain"), ("wide", "gen"), ("wide", "drain"),
             ("probe", "drain"), ("phi3", "prefix"), ("xa", "gen"),
             ("ta", "gen"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"tp": {world: [each rank's results]}, "jax": ..., "single": ...}.
    The ranks are spawned once per world size over gloo (from a thread),
    the JAX runs go to three worker processes, and this process makes the
    single-device runs meanwhile."""
    inputs = {n: (_variant(n)[1], _variant(n)[3], _variant(n)[4])
              for n in {n for runs_ in GEN_RUNS.values() for n, _ in runs_}
              | {n for names in DRAINS.values() for n in names}}
    # the launch pickles the params for the spawned ranks by moving
    # their storage to shared memory, in place: done here, before the
    # thread starts, so no single-device run reads a storage mid-move
    for _, params, _ in inputs.values():
        for _, t in _leaves(params):
            t.share_memory_()
    root = tmp_path_factory.mktemp("tp")
    ranks, errors = {}, []

    def run_ranks():
        try:
            for world in (2, 4):
                ranks[world] = G.launch(
                    _rank_scenarios, world, "gloo", args=(inputs,),
                    init_method=f"file://{root / f'store{world}'}",
                    device="cpu", timeout=TIMEOUT)
        except Exception as e:  # re-raised below
            errors.append(e)

    thread = threading.Thread(target=run_ranks)
    thread.start()
    try:
        with ProcessPoolExecutor(
                3, mp_context=mp.get_context("spawn")) as pool:
            futures = [pool.submit(_jax_runs_of, *t) for t in JAX_ORDER]
            single = _single_runs()
            jax_out = {}
            for f in futures:
                jax_out.update(f.result())
    finally:
        thread.join()
    if errors:
        raise errors[0]
    return {"tp": ranks, "jax": jax_out, "single": single}


@pytest.fixture(scope="module")
def ranks(runs):
    return runs["tp"]


@pytest.fixture(scope="module")
def jax_runs(runs):
    return runs["jax"]


@pytest.fixture(scope="module")
def single_runs(runs):
    return runs["single"]


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# generate and the drain against JAX and the single-device port
# ---------------------------------------------------------------------------

GEN_CASES = [(w, n, r) for w, runs in GEN_RUNS.items() for n, r in runs]


@pytest.mark.parametrize("world,name,routing", GEN_CASES,
                         ids=[f"tp{w}-{n}-{r}" for w, n, r in GEN_CASES])
def test_generate_matches_jax_and_single_device(ranks, jax_runs,
                                                single_runs, world, name,
                                                routing):
    jtoks, jrouting, jp_fa = jax_runs["gen", name, routing]
    one = single_runs["gen", name, routing]
    if routing == "router" and jp_fa is not None:
        assert np.all(np.abs(jp_fa - 0.5) > MARGIN), jp_fa
    assert len(ranks[world]) == world
    for res in ranks[world]:
        got = res["gen", name, routing]
        assert got["routing"] == jrouting == one["routing"]
        assert np.array_equal(got["tokens"], jtoks)
        assert np.array_equal(one["tokens"], jtoks)
        assert _rel(got["logits"], one["logits"]) < REL
        assert _rel(got["final"], one["final"]) < REL
        # global bytes, as JAX's sharded arrays report them
        assert got["kv_bytes"] == one["kv_bytes"]
    first = ranks[world][0]["gen", name, routing]
    for res in ranks[world][1:]:  # every rank reads the same logits
        assert np.array_equal(res["gen", name, routing]["logits"],
                              first["logits"])


DRAIN_CASES = [(w, n) for w, names in DRAINS.items() for n in names]


@pytest.mark.parametrize("world,name", DRAIN_CASES,
                         ids=[f"tp{w}-{n}" for w, n in DRAIN_CASES])
def test_drain_matches_jax(ranks, jax_runs, world, name):
    want = jax_runs["drain", name]
    assert sorted(want) == [0, 1, 2, 3, 9]
    assert sum(p for _, _, p in want.values()) >= 1
    for res in ranks[world]:
        got = res["drain", name]["done"]
        assert got == want
        assert all(s == STATUS_OK for s, _, _ in got.values())


@pytest.mark.parametrize("world,name", [(2, "phi3"), (4, "wide")])
def test_ledger_reconciles_with_global_and_shard_bytes(ranks, single_runs,
                                                       world, name):
    """Global bytes equal the single-device pool's; the shard's k / v
    are 1/world of them and everything else is whole."""
    one = single_runs["drain", name]
    for res in ranks[world]:
        got = res["drain", name]
        assert got["ledger"]["reconciliation"] == \
            one["ledger"]["reconciliation"]
        assert got["ledger"]["reconciliation"]["payload_delta"] == 0
        assert got["slot_bytes"] == one["slot_bytes"]
        st, st1 = got["ledger"]["kv_cache_stats"], \
            one["ledger"]["kv_cache_stats"]
        for k in ("payload_bytes", "overhead_bytes"):
            assert st[k] == st1[k], k
        # a full pool's payload is its k / v: the shard holds 1/world
        assert st["payload_shard_bytes"] * world == st["payload_bytes"]
        assert got["head_shard_bytes"] * world == one["head_shard_bytes"]
        assert st["overhead_shard_bytes"] == st["overhead_bytes"]
        assert st1["payload_shard_bytes"] == st1["payload_bytes"]
        assert got["ledger"]["mesh"] == [1, world]
        assert got["mesh"] == (1, world)
        assert one["ledger"]["mesh"] is None and one["mesh"] is None


def test_fidelity_probe_matches_jax_on_every_rank(ranks, jax_runs):
    """Every admission probed at TP = 2: each request's coverage (mean
    and SA minimum) within 1e-5 of JAX's engine and bitwise the same on
    both ranks; the probe's reduces counted apart, 2 a layer and one a
    routed layer for each probe."""
    want = jax_runs["fidelity", "probe"]
    assert any(f < 1 - 1e-3 for f, _ in want.values()), want
    cfg = _variant("probe")[1]
    first = ranks[2][0]["drain", "probe"]
    for res in ranks[2]:
        got = res["drain", "probe"]
        assert got["fidelity"] == first["fidelity"]
        assert sorted(got["fidelity"]) == sorted(want)
        for rid, (fid, sa_min) in want.items():
            gf, gs = got["fidelity"][rid]
            assert abs(gf - fid) < 1e-5, (rid, gf, fid)
            assert (gs is None) == (sa_min is None), rid
            if sa_min is not None:
                assert abs(gs - sa_min) < 1e-5, (rid, gs, sa_min)
        probes, (probe_calls, _) = got["probes"]
        assert probes >= len(want)  # a preempted request is probed again
        assert probe_calls == probes * (2 * cfg.num_layers
                                        + len(cfg.routable_layers()))


def test_replicated_kv_caches_are_bitwise_equal_on_sharing_ranks(ranks):
    """Command-r's 2 KV heads at TP = 4: ranks 0 and 1 hold KV head 0,
    ranks 2 and 3 KV head 1, and each pair's pool caches are bitwise
    equal after the drain."""
    kv = [res["drain", "command_r"]["kv"] for res in ranks[4]]
    assert kv[0] and all(k.shape[1] == 1 for k, _ in kv[0])
    for a, b in ((0, 1), (2, 3)):
        for (ka, va), (kb, vb) in zip(kv[a], kv[b]):
            assert np.array_equal(ka, kb) and np.array_equal(va, vb)
    assert not all(np.array_equal(k0, k2)
                   for (k0, _), (k2, _) in zip(kv[0], kv[2]))


def test_ledger_counts_each_replicated_kv_head_once(ranks, single_runs):
    """Under KV replication the global bytes are the one-device pool's
    (each KV head once, not once a rank), and a rank holds one KV head
    of the two."""
    one = single_runs["drain", "command_r"]
    Hkv = _variant("command_r")[1].num_kv_heads
    for res in ranks[4]:
        got = res["drain", "command_r"]
        assert got["ledger"]["reconciliation"] == \
            one["ledger"]["reconciliation"]
        assert got["slot_bytes"] == one["slot_bytes"]
        st, st1 = got["ledger"]["kv_cache_stats"], \
            one["ledger"]["kv_cache_stats"]
        assert st["payload_bytes"] == st1["payload_bytes"]
        assert st["payload_shard_bytes"] * Hkv == st["payload_bytes"]
        assert got["head_shard_bytes"] * Hkv == one["head_shard_bytes"]
        assert got["ledger"]["mesh"] == [1, 4]


# ---------------------------------------------------------------------------
# The prefix store, the collectives, the router and the digest
# ---------------------------------------------------------------------------

def test_prefix_warm_equals_cold_and_store_matches(ranks, jax_runs,
                                                   single_runs):
    one = single_runs["prefix"]
    assert one["store"]["drops"] >= 1  # the budget evicts
    for res in ranks[2]:
        got = res["prefix"]
        assert got["hits"] == one["hits"] == (0, 32)
        assert np.array_equal(got["tokens"][0], jax_runs["prefix"])
        assert np.array_equal(got["tokens"][1], got["tokens"][0])
        assert np.array_equal(got["logits"][1], got["logits"][0])
        assert np.array_equal(got["final"][1], got["final"][0])
        assert got["store"] == one["store"]


@pytest.mark.parametrize("world,name", [(2, "phi3"), (4, "wide")])
def test_decode_collectives_are_activation_sized(ranks, world, name):
    cfg = _variant(name)[1]
    want = (2 * cfg.num_layers * 3,
            2 * cfg.num_layers * 3 * B * cfg.d_model * 4)
    for res in ranks[world]:
        # the same at a 16- and a 40-token cache: none is of cache size
        assert res["collectives"] == [want, want]


@pytest.mark.parametrize("pooling", ["prefix", "prefix_suffix"])
def test_row_sharded_router_gives_single_device_logits(ranks, pooling):
    _, cfg, _, params, prompts = _variant("phi3")
    bp = params["layers"][0]
    h = TMD.embed_tokens(params, cfg, torch.as_tensor(prompts["gen"]))
    x = TMD.rms_norm(bp["norm1"], h, cfg.norm_eps)
    _, _, _, x_q = TA.gqa_qkv(bp["attn"], cfg, x, torch.arange(S))
    want = TR.router_logits(bp["router"], x_q, cfg.flux.pool_size,
                            pooling).numpy()
    for res in ranks[2]:
        assert _rel(res["router"][pooling], want) < REL
    assert np.array_equal(ranks[2][0]["router"][pooling],
                          ranks[2][1]["router"][pooling])


def test_digest_check_raises_on_a_different_submission(ranks):
    for res in ranks[2]:
        msg = res["diverge"]
        assert msg is not None and "before tick 1" in msg, msg
        assert "disagree" in msg


# ---------------------------------------------------------------------------
# The weight layout (no process group)
# ---------------------------------------------------------------------------

def _unshard(shards, kv_reps=1):
    """The concatenation ``shard_params_tp`` undoes: each sharded leaf's
    pieces in rank order along its ``shard_axis``, ``enc_w``'s two
    halves each, a replicated KV projection's pieces once a KV head
    (the ``kv_reps`` ranks that share one hold equal pieces); a
    replicated leaf is the one tensor every share holds."""
    def join(parent, name, parts):
        t = parts[0]
        if isinstance(t, dict):
            return {k: join(name, k, [p[k] for p in parts]) for k in t}
        if not isinstance(t, torch.Tensor):
            return [join(parent, name, [p[i] for p in parts])
                    for i in range(len(t))]
        axis = SH.shard_axis(parent, name)
        if axis is None:
            assert all(p is t for p in parts), name  # shared
            return t
        if name in SH.ROUTER_ROW_NAMES:
            half = t.shape[0] // 2
            return torch.cat([p[:half] for p in parts]
                             + [p[half:] for p in parts])
        if kv_reps > 1 and SH.is_kv_leaf(parent, name):
            for i, p in enumerate(parts):
                assert torch.equal(p, parts[i - i % kv_reps]), (name, i)
            parts = parts[::kv_reps]
        return torch.cat(parts, dim=axis)
    return join("", "", shards)


def _leaves(tree, path=""):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")


@pytest.mark.parametrize("name,world", [("phi3", 2), ("command_r", 2),
                                        ("gemma3", 2), ("wide", 4)])
def test_shard_then_concat_gives_params_back_bitwise(name, world):
    _, cfg, _, params, _ = _variant(name)
    shards = [SH.shard_params_tp(params, cfg, r, world)
              for r in range(world)]
    lcfg = SH.tp_config(cfg, world)
    wq = shards[0]["layers"][0]["attn"]["wq"]
    assert wq.shape == (cfg.d_model, lcfg.q_dim) and wq.is_contiguous()
    assert SH.params_are_local(shards[1], cfg, world)
    assert not SH.params_are_local(params, cfg, world)
    back = dict(_leaves(_unshard(shards)))
    for path, t in _leaves(params):
        assert torch.equal(back[path], t), path
    assert SH.global_param_bytes(shards[0], cfg, world) == sum(
        t.nbytes for _, t in _leaves(params))


def test_kv_replication_shard_then_concat_gives_params_back_bitwise():
    """Command-r's 2 KV heads over 4 ranks: rank r keeps KV head r // 2,
    the one its query head reads; each rank's config is 1 head over 1
    KV head; concatenating one share a KV head gives the params back,
    and ``global_param_bytes`` counts each KV head once."""
    _, cfg, _, params, _ = _variant("command_r")
    world, reps = 4, SH.kv_replicas(cfg, 4)
    assert (cfg.num_heads, cfg.num_kv_heads, reps) == (4, 2, 2)
    shards = [SH.shard_params_tp(params, cfg, r, world)
              for r in range(world)]
    lcfg = SH.tp_config(cfg, world)
    assert (lcfg.num_heads, lcfg.num_kv_heads) == (1, 1)
    hd = cfg.head_dim
    for r, share in enumerate(shards):
        a, whole = share["layers"][0]["attn"], params["layers"][0]["attn"]
        assert a["wk"].shape == (cfg.d_model, hd) and a["wk"].is_contiguous()
        kv = r // reps
        assert torch.equal(a["wk"], whole["wk"][:, kv * hd:(kv + 1) * hd])
        assert torch.equal(a["wv"], whole["wv"][:, kv * hd:(kv + 1) * hd])
        assert a["wq"].shape == (cfg.d_model, lcfg.q_dim)
        assert SH.params_are_local(share, cfg, world)
    back = dict(_leaves(_unshard(shards, reps)))
    for path, t in _leaves(params):
        assert torch.equal(back[path], t), path
    assert SH.global_param_bytes(shards[0], cfg, world) == sum(
        t.nbytes for _, t in _leaves(params))


def test_init_params_tp_draws_replicated_kv_shares():
    cfg = smoke_variant(get_config(ARCHS["command_r"]))
    full = TMD.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for r in range(4):
        share = SH.init_params_tp(cfg, torch.Generator().manual_seed(0),
                                  r, 4, "cpu")
        want = dict(_leaves(SH.shard_params_tp(full, cfg, r, 4)))
        got = dict(_leaves(share))
        assert sorted(got) == sorted(want)
        for path, t in want.items():
            assert torch.equal(got[path], t), path


def _group(world):
    """A rank of a ``world``-way group with no process group behind it:
    enough for the checks that run before any collective."""
    return G.TPGroup(rank=0, world=world, backend="gloo",
                     device=torch.device("cpu"))


@pytest.mark.parametrize("world", [3, 6])
def test_uneven_kv_heads_raise_naming_both_counts(world):
    """command-r's 8 KV heads over 3 or 6 ranks: a rank's query heads
    would read parts of two KV heads (JAX replicates the whole KV
    there); the heads and the FFN width divide, the KV heads refuse."""
    cfg = get_config(ARCHS["command_r"])
    assert cfg.num_heads % world == 0 and cfg.d_ff % world == 0
    match = f"{cfg.num_kv_heads} KV heads over {world}"
    with pytest.raises(ValueError, match=match):
        SH.check_tp_supported(cfg, world)
    with pytest.raises(ValueError, match=match):
        SH.tp_config(cfg, world)
    params = {"layers": [{"attn": {"wq": torch.zeros(1, 1)}}]}
    with pytest.raises(ValueError, match=match):
        ServeEngine(params, cfg, max_len=MAX_LEN, device="cpu",
                    tp=_group(world))


def test_init_params_tp_draws_the_shares_of_init_params():
    cfg = smoke_variant(get_config(ARCHS["gemma3"]))
    full = TMD.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for r in range(2):
        share = SH.init_params_tp(cfg, torch.Generator().manual_seed(0),
                                  r, 2, "cpu")
        want = dict(_leaves(SH.shard_params_tp(full, cfg, r, 2)))
        got = dict(_leaves(share))
        assert sorted(got) == sorted(want)
        for path, t in want.items():
            assert torch.equal(got[path], t), path


def test_tp_config_divides_heads_and_ffn():
    cfg = get_config(ARCHS["phi3"])
    lcfg = SH.tp_config(cfg, 2)
    assert (lcfg.num_heads, lcfg.num_kv_heads, lcfg.d_ff) == (16, 16, 4096)
    assert lcfg.q_dim == cfg.q_dim // 2 and lcfg.head_dim == cfg.head_dim
    assert SH.tp_config(cfg, 1) is cfg
    cr = SH.tp_config(get_config(ARCHS["command_r"]), 4)
    assert (cr.num_heads, cr.num_kv_heads) == (24, 2)


# ---------------------------------------------------------------------------
# The identity group and the CLI
# ---------------------------------------------------------------------------

def test_world_one_group_is_the_identity():
    _, cfg, _, params, prompts = _variant("gemma3")
    g1 = G.init_tp(1, 0, None, None, "cpu")
    assert g1.group is None and g1.cpu_group is None
    x = torch.ones(3)
    assert g1.all_reduce_sum(x) is x and g1.reduce_calls == 0
    assert g1.broadcast_host({"a": 1}) == {"a": 1}
    clock = lambda: 7.0  # noqa: E731
    assert g1.host_clock(clock) is clock
    g1.check_agree(5, "nothing")
    with SH.tensor_parallel(g1):
        assert SH.tp_reduce(x) is x
    runs = []
    for tp in (None, g1):
        eng = ServeEngine(params, cfg, max_len=MAX_LEN, prefill_chunk=CH,
                          device="cpu", tp=tp)
        runs.append(eng.generate(prompts["gen"], N))
        assert eng.model_cfg is cfg
    assert np.array_equal(runs[0].tokens, runs[1].tokens)
    assert torch.equal(runs[0].logits, runs[1].logits)
    assert torch.equal(runs[0].final_logits, runs[1].final_logits)


def test_launch_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 raised"):
        G.launch(_fail_on_rank_one, 2, "gloo", device="cpu", timeout=20)


def _fail_on_rank_one(group):
    if group.rank == 1:
        raise ValueError("rank one fails")
    group.barrier()


def test_cli_mesh_model_matches_one_device(capfd):
    from repro_torch.launch import serve as CLI
    argv = ["--smoke", "--device", "cpu", "--requests", "2",
            "--prompt-len", "40", "--gen-len", "6", "--prefill-chunk", "16"]
    CLI.main(argv)
    one = [json.loads(line) for line in capfd.readouterr().out.splitlines()
           if line.startswith('{"rid"')]
    CLI.main(argv + ["--mesh-model", "2", "--dist-backend", "gloo"])
    two = [json.loads(line) for line in capfd.readouterr().out.splitlines()
           if line.startswith('{"rid"')]
    assert len(one) == len(two) == 2  # rank 1 prints nothing
    for a, b in zip(one, two):
        assert (a["tokens"], a["routing"], a["kv_bytes"]) == \
            (b["tokens"], b["routing"], b["kv_bytes"])
    with pytest.raises(SystemExit):
        CLI.main(argv + ["--mesh-model", "2"])  # no backend named
