"""The tensor-core latent decode's launch and the entries' ``out=`` hook.

- ``out=`` on the four entries whose bf16 kernels run on the wgmma engine
  (flash, streaming, block-sparse, the latent decode): on the CPU the
  plain result is written into ``out`` and that tensor is returned,
  bitwise equal to the call without it and, in float32, within 2e-5 of
  the JAX package's Pallas kernel in interpret mode on the same numpy
  inputs; a wrong shape, dtype or a strided ``out`` raises.
- ``mla_plan`` (grid, ranges, scratch, default tiles) at POOL_LENS' pool
  (4 slots, L 4128), long context (4 x 32768) and high batch (64 x 4096),
  at 16, 32 and 128 heads, against a recount from the plan's stated
  rules, and the entry's launch arguments (monkeypatched to "cuda").
- The bf16 kernel's shared memory, recounted from the constants of
  ``csrc/decode_attention_pooled.cu``, within an H100 CTA's 232,448
  bytes; no bf16 path of the C entry reaches the CUDA-core kernel; a
  launch the card refuses raises.
"""
import contextlib
import functools
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread: as fast at these small shapes, and it leaves the other
# cores to the test processes running beside this one
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention_pooled_bh as jax_pooled  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention_mla as DM  # noqa: E402
from repro_torch.kernels.block_sparse_attention import \
    block_sparse_attention_bh  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention_bh  # noqa: E402
from repro_torch.kernels.streaming_attention import \
    streaming_attention_bh  # noqa: E402

TOL = 2e-5
SOURCE = Path(_build.CSRC) / "decode_attention_pooled.cu"
H100_SMEM = 232448  # bytes of shared memory one CTA may use
SMS = 132
SHAPES = {"pool": (4, 4128), "long_context": (4, 32768),
          "high_batch": (64, 4096)}
ENTRIES = ("flash", "streaming", "block_sparse", "latent_decode")


@functools.lru_cache(maxsize=None)
def inputs(entry):
    """Seeded numpy inputs of one entry, small: (args, kwargs, JAX call)."""
    rng = np.random.default_rng(21)
    f32 = np.float32
    if entry == "latent_decode":
        B, H, L, R, rope = 3, 4, 40, 32, 16
        q = rng.normal(size=(B * H, 1, R + rope)).astype(f32)
        ckv = rng.normal(size=(B, L, R)).astype(f32)
        kr = rng.normal(size=(B, L, rope)).astype(f32)
        lengths = np.array([0, 17, 40], np.int32)
        pos = np.full((B, L), -1, np.int32)
        for b, n in enumerate(lengths):
            pos[b, :n] = rng.permutation(2 * L)[:n]
            pos[b, 3:n:5] = -1  # holes
        scale = 0.125

        def want():
            return jax_pooled(jnp.asarray(q),
                              jnp.asarray(np.concatenate([ckv, kr], -1)),
                              jnp.asarray(ckv), jnp.asarray(pos),
                              jnp.asarray(lengths), n_heads=H, scale=scale,
                              block_k=16, interpret=True)
        return ((q, ckv, kr, pos, lengths), dict(n_heads=H, scale=scale),
                want)
    BH, S, D = 4, 70, 32
    q, k, v = (rng.normal(size=(BH, S, D)).astype(f32) for _ in range(3))
    if entry == "flash":
        return ((q, k, v), dict(q_offset=0), lambda: ops.flash_attention(
            *(jnp.asarray(x[None]) for x in (q, k, v)), block_q=32,
            block_k=32, interpret=True))
    if entry == "streaming":
        return ((q, k, v), dict(sink=8, local=24),
                lambda: ops.streaming_attention(
                    *(jnp.asarray(x[None]) for x in (q, k, v)), sink=8,
                    local=24, block_q=32, block_k=32, interpret=True))
    sel = np.array([[[0, -1], [0, 1]]] * BH, np.int32)  # 2 query blocks
    return ((q, k, v, sel), dict(q_offset=0),
            lambda: ops.block_sparse_attention(
                *(jnp.asarray(x[None]) for x in (q, k, v, sel)), block=64,
                interpret=True))


def call(entry, dtype, **kw):
    """The port's entry on ``inputs(entry)`` cast to ``dtype``."""
    args, kwargs, _ = inputs(entry)
    t = [torch.from_numpy(a) for a in args]
    t = [x.to(dtype) if x.is_floating_point() else x for x in t]
    fn = {"flash": flash_attention_bh, "streaming": streaming_attention_bh,
          "block_sparse": block_sparse_attention_bh,
          "latent_decode": DM.decode_attention_mla_bh}[entry]
    return fn(*t, **kwargs, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("entry", ENTRIES)
def test_out_is_written_in_place(entry, dtype):
    plain = call(entry, dtype)
    out = torch.full_like(plain, float("nan"))
    got = call(entry, dtype, out=out)
    assert got is out
    assert torch.equal(got, plain)  # bitwise: NaN-free and the same bits
    if dtype == torch.float32:
        want = np.asarray(inputs(entry)[2]()).reshape(plain.shape)
        assert float(np.abs(got.numpy() - want).max()) < TOL


@pytest.mark.parametrize("bad", ["shape", "dtype", "strided"])
@pytest.mark.parametrize("entry", ENTRIES)
def test_out_of_another_layout_raises(entry, bad):
    plain = call(entry, torch.float32)
    if bad == "shape":
        out = torch.empty((plain.shape[0] + 1, *plain.shape[1:]))
    elif bad == "dtype":
        out = torch.empty(plain.shape, dtype=torch.bfloat16)
    else:  # the right shape, every other element of a wider buffer
        out = torch.empty((*plain.shape[:-1], 2 * plain.shape[-1]))[..., ::2]
    with pytest.raises(ValueError, match="out must be a contiguous"):
        call(entry, torch.float32, out=out)


def recount(B, L, H, bf16):
    """The plan from its stated rules, by search: 64-key tiles T =
    ceil(L / 64); bf16: ceil(H / 64) head blocks a slot, and the fewest
    tiles a range whose ranges put every CTA of a full pool on its own
    multiprocessor (or one range a slot when the pool alone exceeds the
    card); fp32: 4 tiles (at most T)."""
    T = -(-L // 64)
    if bf16:
        blocks = -(-H // 64)
        t = next(t for t in range(1, T + 1)
                 if B * blocks * -(-T // t) <= max(SMS, B * blocks))
    else:
        blocks, t = -(-H // 16), min(4, T)
    ranges = -(-T // t)
    grid = (blocks, ranges, B) if bf16 else (B, ranges, blocks)
    scratch = None if ranges == 1 else ((B * H, ranges, 512),
                                        (2, B * H, ranges))
    return t, ranges, grid, scratch


@pytest.mark.parametrize("H", [16, 32, 128])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plan_matches_recount(shape, H):
    B, L = SHAPES[shape]
    for dtype in (torch.bfloat16, torch.float32):
        plan = DM.mla_plan(B, L, H, dtype, sms=SMS)
        t, ranges, grid, scratch = recount(B, L, H, dtype == torch.bfloat16)
        assert (plan.tiles, plan.n_split, plan.grid, plan.scratch) == (
            t, ranges, grid, scratch)
        assert plan.threads == 256
        # the ranges cover the capacity, the last one not empty
        assert (ranges - 1) * t * 64 < L <= ranges * t * 64
        # every head has a CTA, and no CTA holds only rows past H
        per = DM.WGMMA_HEADS if dtype == torch.bfloat16 else DM.CORE_HEADS
        blocks = plan.grid[0] if dtype == torch.bfloat16 else plan.grid[2]
        assert (blocks - 1) * per < H <= blocks * per
    if shape == "long_context" and H == 128:  # the measured best
        assert DM.mla_plan(B, L, H, torch.bfloat16, sms=SMS).tiles == 32
    if shape == "high_batch" and H == 128:
        assert DM.mla_plan(B, L, H, torch.bfloat16, sms=SMS).n_split == 1


@pytest.mark.parametrize("H", [16, 32, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_entry_launches_the_plan(monkeypatch, dtype, H):
    """With the device test answering "cuda", the entry launches with the
    plan's tiles and passes scratch pointers iff the plan has ranges to
    merge; a forced ``tiles`` is normalized as the plan normalizes it."""
    launched = []
    monkeypatch.setattr(_build, "on_cpu", lambda name, t: False)
    monkeypatch.setattr(DM.KERNEL, "launch",
                        lambda dev, *a: launched.append(a))
    B, L = SHAPES["pool"]
    q = torch.zeros((B * H, 1, 576), dtype=dtype)
    ckv, kr = torch.zeros((B, L, 512), dtype=dtype), torch.zeros(
        (B, L, 64), dtype=dtype)
    lengths = torch.tensor([4112, 2080, 1400, 1], dtype=torch.int32)
    for tiles in (None, 1, 500):
        out = DM.decode_attention_mla_bh(q, ckv, kr, None, lengths,
                                         n_heads=H, scale=192 ** -0.5,
                                         tiles=tiles)
        assert out.shape == (B * H, 1, 512) and out.dtype == dtype
        plan = DM.mla_plan(B, L, H, dtype, tiles=tiles, sms=SMS)
        a = launched[-1]
        assert a[9:16] == (B, H, L, 512, 64, _build.DTYPE_CODES[dtype],
                           plan.tiles)
        assert all(a[6:9]) == (plan.scratch is not None)
    assert launched[-1][15] == 65  # 500 tiles: at most the capacity's 65


def constants(namespace):
    """{name: int} of the ``constexpr int`` lines of one namespace of
    SOURCE, their right-hand sides evaluated in order."""
    text = SOURCE.read_text()
    body = text[text.index(f"namespace {namespace} {{"):]
    body = body[:body.index(f"}}  // namespace {namespace}")]
    out = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", body):
        out[name] = int(eval(expr.replace("/", "//"), {}, dict(out)))
    return out


def test_shared_memory_fits_one_cta():
    c = constants("mla")
    assert (c["kR"], c["kRope"], c["kHeads"], c["kKeys"]) == (512, 64, 64, 64)
    assert c["kThreads"] == 256 and c["kStages"] >= 2
    row = 2 * (c["kR"] + c["kRope"])  # bf16 bytes of one head or key
    total = (1024                          # the base's 1024-byte alignment
             + c["kHeads"] * row           # q
             + c["kStages"] * c["kKeys"] * row  # the key tiles
             + c["kHeads"] * c["kKeys"] * 2     # P
             + 8 * (1 + c["kStages"])      # mbarriers
             + 2 * 2 * c["kHeads"] * 4)    # row maxima and sums, 2 groups
    assert total == 231448
    assert total <= H100_SMEM
    # 128-byte panels of 64 columns: q and a key tile 9 each, P one
    assert c["kPanelBytes"] == c["kKeys"] * 128 and c["kPanels"] == 9
    assert c["kTile"] == c["kKeys"] * row == c["kPanels"] * c["kPanelBytes"]


def test_bf16_never_reaches_the_cuda_cores():
    """The C entry sends bf16 to the wgmma kernel's launcher only; the
    CUDA-core kernel is instantiated for float alone."""
    text = SOURCE.read_text()
    entry = text[text.index('extern "C" int decode_attention_mla_fwd'):]
    bf16 = entry[entry.index("flux::kBF16"):]
    assert bf16.split(";")[0].split("=")[1].strip().startswith(
        "flux::MlaWgmmaLaunch::run(")
    assert "MlaLaunch<float>" in entry
    assert not re.search(r"MlaLaunch<\s*__nv_bfloat16", text)
    assert not re.search(r"mla_decode_kernel<\s*__nv_bfloat16", text)
    # the wgmma kernel's products are tensor-core instructions
    assert "wgmma.mma_async.sync.aligned.m64n32k16" in text
    assert "wgmma.mma_async.sync.aligned.m64n256k16" in text


def test_refused_launch_raises(monkeypatch):
    """A launch whose entry returns a CUDA error (a refused shared-memory
    size, a grid too large) raises, and is not counted."""
    class Lib:
        @staticmethod
        def flux_error_string(code):
            return b"too many resources requested for launch"

    class Stream:
        cuda_stream = 0
    kern = _build.CudaKernel("decode_attention_pooled",
                             "decode_attention_mla_fwd", [])
    kern._lib, kern._fn = Lib(), lambda *a: 701
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    with pytest.raises(RuntimeError, match="CUDA error 701"):
        kern.launch(torch.device("cpu"))
    assert kern.launches == 0
    kern._fn = lambda *a: 0
    kern.launch(torch.device("cpu"))
    assert kern.launches == 1
