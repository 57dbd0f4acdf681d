"""The training slice's smaller modules against the JAX package's, on
seeded numpy inputs: ``train/optimizer.py`` (AdamW descent and ascent,
the bf16 cast back, None leaves, ``cosine_warmup``), ``core/router.py``
(``anneal_tau``, ``soft_route``, ``gumbel_noise``), ``core/sparsity.py``
(``sparsity_loss`` with an absent task type, ``project_lagrange``,
``msr``), ``train/train_loop.py`` (``cross_entropy``,
``chunked_cross_entropy`` against JAX's and against the dense form, its
gradient too), ``data/synthetic.py`` (``mixture_iterator`` bitwise equal
to JAX's for two seeds), ``train/checkpoint.py`` (a bitwise round trip
in fp32 and bf16 with ``AdamState`` and None leaves) and
``launch/train.py --smoke --device cpu`` (it runs and writes both
files; an arch with nothing to route skips router training).

Tolerances: 1e-6 relative for the optimizer and schedules (the same
float32 operations in the same order, libm's cos aside), 1e-5 for the
losses (float32 sums in another order).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_variant as jax_smoke  # noqa: E402
from repro.core import router as JR  # noqa: E402
from repro.core import sparsity as JSP  # noqa: E402
from repro.data import mixture_iterator as jax_mixture  # noqa: E402
from repro.train import optimizer as JOPT  # noqa: E402
from repro.train import train_loop as JTL  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.core import router as TR  # noqa: E402
from repro_torch.core import sparsity as TSP  # noqa: E402
from repro_torch.data import mixture_iterator  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402
from repro_torch.train import optimizer as TOPT  # noqa: E402
from repro_torch.train import train_loop as TTL  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OPT_TOL = 1e-6
LOSS_TOL = 1e-5


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _flux():
    return (jax_smoke(jax_get_config("phi3-mini-3.8b")).flux,
            smoke_variant(get_config("phi3-mini-3.8b")).flux)


# ---------------------------------------------------------------------------
# Optimizer and schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ascend", [False, True])
def test_adamw_matches_jax(ascend):
    """Three updates of a tree with a bf16 leaf and a None leaf: params,
    both moments and the count."""
    rng = np.random.default_rng(0)
    p = {"a": rng.normal(size=(4, 3)).astype(np.float32),
         "b": [rng.normal(size=(5,)).astype(np.float32)],
         "c": rng.normal(size=(2, 2)).astype(np.float32)}
    jp = {"a": jnp.asarray(p["a"]), "b": [jnp.asarray(p["b"][0])],
          "c": jnp.asarray(p["c"]).astype(jnp.bfloat16), "z": None}
    tp = {"a": torch.from_numpy(p["a"]), "b": [torch.from_numpy(p["b"][0])],
          "c": torch.from_numpy(p["c"]).to(torch.bfloat16), "z": None}
    js, ts = JOPT.adamw_init(jp), TOPT.adamw_init(tp)
    for i in range(3):
        g = {k: rng.normal(size=np.shape(p[k][0] if k == "b" else p[k]))
             .astype(np.float32) for k in p}
        jg = {"a": jnp.asarray(g["a"]), "b": [jnp.asarray(g["b"])],
              "c": jnp.asarray(g["c"]).astype(jnp.bfloat16), "z": None}
        tg = {"a": torch.from_numpy(g["a"]), "b": [torch.from_numpy(g["b"])],
              "c": torch.from_numpy(g["c"]).to(torch.bfloat16), "z": None}
        lr = 1e-3 * (i + 1)
        jp, js = JOPT.adamw_update(jg, js, jp, lr=jnp.float32(lr),
                                   ascend=ascend)
        tp, ts = TOPT.adamw_update(tg, ts, tp, lr=torch.tensor(lr),
                                   ascend=ascend)
    assert tp["z"] is None and ts.mu["z"] is None
    assert tp["c"].dtype == torch.bfloat16
    for k in ("a", "c"):
        assert _rel(tp[k], np.asarray(jp[k], np.float32)) <= OPT_TOL
        assert _rel(ts.mu[k], js.mu[k]) <= OPT_TOL
        assert _rel(ts.nu[k], js.nu[k]) <= OPT_TOL
    assert _rel(tp["b"][0], jp["b"][0]) <= OPT_TOL
    assert int(ts.count) == int(js.count) == 3


def test_partition_and_combine():
    tree = {"x": torch.ones(2), "router": {"w": torch.zeros(3)},
            "layers": [{"router": {"b": torch.ones(1)}, "f": torch.ones(1)}]}
    from repro_torch.models.model import router_param_filter
    mask = router_param_filter(tree)
    assert mask == {"x": False, "router": {"w": True},
                    "layers": [{"router": {"b": True}, "f": False}]}
    train, frozen = TOPT.partition(tree, mask)
    assert train["x"] is None and frozen["router"]["w"] is None
    back = TOPT.combine(train, frozen)
    assert all(a is b for a, b in zip(TOPT.tree_leaves(back),
                                      TOPT.tree_leaves(tree)))


@pytest.mark.parametrize("args", [(3e-4, 300, 0.05), (5e-4, 300, 0.2),
                                  (1e-4, 3, 0.1), (1e-3, 1, 0.2)])
def test_cosine_warmup_matches_jax(args):
    base, total, warm = args
    jf, tf = JOPT.cosine_warmup(base, total, warm), \
        TOPT.cosine_warmup(base, total, warm)
    for step in range(0, total + 3):
        want = float(jf(jnp.int32(step)))
        got = float(tf(torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= OPT_TOL * max(base, abs(want)), step


def test_anneal_tau_and_soft_route_match_jax():
    jflux, tflux = _flux()
    for total in (1, 3, 300):
        for step in (0, 1, total // 2, total, total + 5):
            want = float(JR.anneal_tau(jflux, jnp.int32(step), total))
            got = TR.anneal_tau(tflux, torch.tensor(step, dtype=torch.int32),
                                total)
            assert got.dtype == torch.float32 and got.dim() == 0
            assert abs(float(got) - want) <= OPT_TOL * want
    rng = np.random.default_rng(1)
    jp = JR.router_init(jax.random.key(0), 64, jflux)
    x = rng.normal(size=(3, 20, 64)).astype(np.float32)
    key = jax.random.key(5)
    want = JR.soft_route(jp, jnp.asarray(x), jflux, 0.3, key)
    g = np.asarray(jax.random.gumbel(key, (3, 2), jnp.float32))
    got = TR.soft_route({k: torch.tensor(np.asarray(v))
                         for k, v in jp.items()}, torch.from_numpy(x), tflux,
                        torch.tensor(0.3), torch.from_numpy(g))
    assert _rel(got, want) <= LOSS_TOL
    noise = TR.gumbel_noise((4000, 2), torch.Generator().manual_seed(0))
    assert noise.dtype == torch.float32 and bool(torch.isfinite(noise).all())
    assert abs(float(noise.mean()) - 0.5772) < 0.05  # Euler's gamma


@pytest.mark.parametrize("tasks", [(0, 1, 1), (1, 1), (0, 0, 1, 0)])
def test_sparsity_loss_matches_jax(tasks):
    jflux, tflux = _flux()
    rng = np.random.default_rng(len(tasks))
    r = rng.random((len(tasks), 5)).astype(np.float32)
    task = np.asarray(tasks, np.int32)
    lam = {"lambda1": np.array([0.1, 0.05], np.float32),
           "lambda2": np.array([0.3, 0.5], np.float32)}
    want, jd = JSP.sparsity_loss(jnp.asarray(r), jnp.asarray(task),
                                 {k: jnp.asarray(v) for k, v in lam.items()},
                                 jflux)
    got, td = TSP.sparsity_loss(torch.from_numpy(r), torch.from_numpy(task),
                                {k: torch.from_numpy(v)
                                 for k, v in lam.items()}, tflux)
    assert _rel(got, want) <= LOSS_TOL
    for k in ("l_diff", "per_task_sparsity", "present"):
        assert np.allclose(td[k].numpy(), np.asarray(jd[k]), atol=1e-6), k
    assert _rel(TSP.msr(torch.from_numpy(r > 0.5)), JSP.msr(
        jnp.asarray(r > 0.5))) == 0
    lam2 = {"lambda1": np.array([-0.2, 0.3], np.float32),
            "lambda2": np.array([0.0, -1e-3], np.float32)}
    want = JSP.project_lagrange({k: jnp.asarray(v) for k, v in lam2.items()})
    got = TSP.project_lagrange({k: torch.from_numpy(v)
                                for k, v in lam2.items()})
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))


def test_lagrangian_init():
    _, tflux = _flux()
    mid = TSP.lagrangian_init(tflux)
    assert mid["lambda1"].tolist() == pytest.approx([0.1, 0.1])
    drawn = TSP.lagrangian_init(tflux, torch.Generator().manual_seed(1))
    assert bool(((drawn["lambda1"] >= 0) & (drawn["lambda1"] < 0.2)).all())
    assert bool(((drawn["lambda2"] >= 0.2) & (drawn["lambda2"] < 0.6)).all())
    again = TSP.lagrangian_init(tflux, torch.Generator().manual_seed(1))
    assert all(torch.equal(drawn[k], again[k]) for k in drawn)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk", [(80, 32), (64, 512), (96, 32)])
def test_chunked_cross_entropy(S, chunk):
    """Against JAX's chunked CE and the port's dense CE, and its gradient
    against the dense form's (the chunks' logits are recomputed in the
    backward pass)."""
    rng = np.random.default_rng(S)
    B, d, V = 2, 16, 50
    h = rng.normal(size=(B, S, d)).astype(np.float32)
    w = rng.normal(size=(d, V)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32)
    want = JTL.chunked_cross_entropy(jnp.asarray(h), jnp.asarray(w),
                                     jnp.asarray(labels), jnp.asarray(mask),
                                     chunk=chunk)
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = TTL.chunked_cross_entropy(th, tw, torch.from_numpy(labels),
                                    torch.from_numpy(mask), chunk=chunk)
    assert _rel(got, want) <= LOSS_TOL
    dense = TTL.cross_entropy(th @ tw, torch.from_numpy(labels),
                              torch.from_numpy(mask))
    jdense = JTL.cross_entropy(jnp.asarray(h) @ jnp.asarray(w),
                               jnp.asarray(labels), jnp.asarray(mask))
    assert _rel(dense, jdense) <= LOSS_TOL
    assert _rel(got, dense.detach().numpy()) <= LOSS_TOL
    g1 = torch.autograd.grad(got, (th, tw))
    g2 = torch.autograd.grad(dense, (th, tw))
    for a, b in zip(g1, g2):
        assert _rel(a, b.numpy()) <= LOSS_TOL


# ---------------------------------------------------------------------------
# Data, checkpoints, the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_mixture_iterator_bitwise(seed):
    jit_, tit = jax_mixture(300, 3, 70, seed=seed), \
        mixture_iterator(300, 3, 70, seed=seed)
    for _ in range(6):
        a, b = next(jit_), next(tit)
        for f in ("tokens", "labels", "loss_mask", "task_type"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_round_trip_bitwise(tmp_path, dtype):
    g = torch.Generator().manual_seed(0)
    params = {"layers": [{"attn": {"wq": torch.randn(4, 4, generator=g)
                                   .to(dtype)},
                          "router": {"enc_w": torch.randn(8, 2,
                                                          generator=g)}}],
              "embed": torch.randn(10, 4, generator=g).to(dtype)}
    state = {"params": params, "opt": TOPT.adamw_init(params),
             "skip": None, "step": torch.tensor(7, dtype=torch.int32)}
    state["opt"].count += 2
    flat = checkpoint.flatten(state)
    assert "layers/0/router/enc_w" in checkpoint.flatten(params)
    assert "opt/.mu/embed" in flat and "opt/.count" in flat
    path = str(tmp_path / "ck" / "state.pt")
    checkpoint.save(path, state)
    like = {"params": {"layers": [{"attn": {"wq": torch.zeros(4, 4,
                                                              dtype=dtype)},
                                   "router": {"enc_w": torch.zeros(8, 2)}}],
                       "embed": torch.zeros(10, 4, dtype=dtype)},
            "opt": TOPT.adamw_init(params), "skip": None,
            "step": torch.tensor(0, dtype=torch.int32)}
    back = checkpoint.load(path, like)
    assert back["skip"] is None and isinstance(back["opt"], TOPT.AdamState)
    got = checkpoint.flatten(back)
    assert got.keys() == flat.keys()
    for k, v in flat.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    del like["params"]["embed"]
    like["params"]["out_w"] = torch.zeros(1)
    with pytest.raises(KeyError, match="out_w"):
        checkpoint.load(path, like)


def _launch(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args,
         "--smoke", "--device", "cpu", "--batch", "2", "--seq", "64",
         "--out", str(tmp_path)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)


def test_launch_train_smoke_cpu(tmp_path):
    out = _launch(tmp_path, "--arch", "phi3-mini-3.8b", "--steps", "2",
                  "--pretrain-steps", "1")
    assert out.returncode == 0, out.stdout + out.stderr
    hist = json.loads((tmp_path / "phi3-mini-3.8b_history.json").read_text())
    assert [r["step"] for r in hist["router"]] == [0, 1]
    assert len(hist["pretrain"]) == 1
    assert all(np.isfinite(r["loss"]) for r in hist["router"])
    params = torch.load(tmp_path / "phi3-mini-3.8b.pt", weights_only=True)
    assert "layers/0/router/enc_w" in params and "embed" in params
    out = _launch(tmp_path, "--arch", "mamba2-780m", "--steps", "1")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "router training skipped" in out.stdout
    assert (tmp_path / "mamba2-780m.pt").exists()
