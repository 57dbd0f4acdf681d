"""The port stands alone: no module of ``repro_torch`` nor ``chip_smoke.py``
imports JAX or the JAX package, and its entry points run on CUDA unless
the caller asks for the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\."
                       r"|from\s+repro\.|import\s+repro\s*$"
                       r"|from\s+repro\s+import)", re.M)


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(SRC).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' "
        "or n.startswith('jax.') or n.startswith('jaxlib') "
        "or n == 'repro' or n.startswith('repro.'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sources_name_no_jax_import():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        hits = FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f}: {hits}"


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_variant(get_config("phi3-mini-3.8b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, torch.Generator().manual_seed(0))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(params, cfg)
    eng = ServeEngine(params, cfg, max_len=64, device="cpu")
    assert eng.device.type == "cpu"
    args = ["--arch", "phi3-mini-3.8b", "--smoke", "--steps", "1",
            "--batch", "1", "--seq", "16", "--out", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(args)
    assert not any(tmp_path.iterdir())
    launch_train.main(args + ["--device", "cpu"])
    assert (tmp_path / "phi3-mini-3.8b.pt").exists()


def test_wrappers_raise_on_other_devices():
    """The wrappers pick the plain version by the tensor's device alone:
    an operand on a device that is neither cpu nor cuda raises."""
    from repro_torch.kernels import flash_attention
    q = torch.zeros((2, 8, 32), device="meta")
    with pytest.raises(ValueError, match="kernel runs on cuda"):
        flash_attention.flash_attention_bh(q, q, q)


def test_a_cuda_operand_goes_to_the_kernel(monkeypatch):
    """With the device test answering "cuda", every entry launches its
    kernel binding with the operands' pointers and never calls its plain
    version; an unsupported head dim raises before any launch."""
    from repro_torch.kernels import (_build, block_sparse_attention,
                                     decode_attention, flash_attention,
                                     streaming_attention)
    launched = []
    mods = (flash_attention, streaming_attention, block_sparse_attention,
            decode_attention)
    monkeypatch.setattr(_build, "on_cpu", lambda name, t: False)
    # the faked card's multiprocessors, which the decode plan reads
    monkeypatch.setattr(decode_attention, "sm_count", lambda index: 132)
    for m in mods:
        monkeypatch.setattr(m.KERNEL, "launch",
                            lambda dev, *a, _m=m: launched.append(
                                (_m.__name__, a)))
        for plain in [n for n in dir(m) if n.endswith("_plain")]:
            monkeypatch.setattr(m, plain, None)  # calling it would fail
    q = torch.zeros((4, 64, 32))
    flash_attention.flash_attention_bh(q, q, q, q_offset=3)
    streaming_attention.streaming_attention_bh(q, q, q, sink=4, local=8)
    block_sparse_attention.block_sparse_attention_bh(
        q, q, q, torch.zeros((4, 1, 1), dtype=torch.int32))
    decode_attention.decode_attention_bh(
        q[:, :1].contiguous(), q, q, torch.arange(64, dtype=torch.int32), 9)
    assert [n.rsplit(".", 1)[1] for n, _ in launched] == [
        "flash_attention", "streaming_attention", "block_sparse_attention",
        "decode_attention"]
    assert launched[0][1][0] == q.data_ptr()
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention_bh(*(torch.zeros((4, 8, 48)),) * 3)
    sq = torch.zeros((4, 32, 32))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention_bh(sq.transpose(1, 2), sq, sq)
