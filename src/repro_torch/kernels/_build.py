"""Build and bind the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, at first use, into
``kernels/build/`` (git ignores every ``build/`` directory). The library
is loaded with ``ctypes``; no PyTorch header is compiled, so a build takes
seconds. A library's file name carries a hash of its sources and flags, so
an edited source is rebuilt and a stale library is never loaded.

``build()`` starts one ``nvcc`` per missing library, all at once, and
waits for them. ``CudaKernel`` binds one C entry point, launches it on
PyTorch's current stream, raises if the entry point reports a CUDA error,
and counts its launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("flash_attention", "streaming_attention",
           "block_sparse_attention", "decode_attention",
           "decode_attention_pooled")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# dtype codes and head dims the kernels are instantiated for
# (csrc/attention_common.cuh: kF32, kBF16, dispatch_head_dim)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 96, 128)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled at first use by the "
        "CUDA toolkit's nvcc; put it on PATH or set CUDA_HOME")


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of that source,
    every ``csrc/*.cuh`` header (sorted by name) and the flags."""
    h = hashlib.sha256()
    for f in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile the missing libraries among ``names`` in parallel.

    Returns {name: seconds from the start until its nvcc finished} for
    the libraries built by this call (an empty dict when all exist). The
    compiler's report (registers, shared memory, spills per kernel) is
    kept beside each library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    seconds, failures = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name}.cu: nvcc exited {proc.returncode}\n"
                            f"{log}")
            continue
        out.with_name(out.name + ".log").write_text(log)
        os.replace(tmp, out)  # atomic: a reader never sees a partial file
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


class CudaKernel:
    """One C entry point of one kernel library, and its launch count.

    ``launches`` goes up by one for each launch the entry point accepted;
    nothing else changes it but ``reset``."""

    def __init__(self, source: str, symbol: str,
                 argtypes: Sequence[type]):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]  # + stream
        self._lib = None
        self._fn = None
        self.launches = 0

    def reset(self) -> None:
        self.launches = 0

    def _bind(self) -> None:
        path = library_path(self.source)
        if not path.exists():
            build((self.source,))
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        lib.flux_error_string.argtypes = [ctypes.c_int]
        lib.flux_error_string.restype = ctypes.c_char_p
        self._lib, self._fn = lib, fn

    def launch(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream; raise on a CUDA error."""
        if self._fn is None:
            self._bind()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream().cuda_stream
            code = self._fn(*args, stream)
        if code != 0:
            msg = self._lib.flux_error_string(code).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {code}: {msg}")
        self.launches += 1


def _check_common(name: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, *others: torch.Tensor) -> None:
    """Rank, emptiness, one device (also for ``others``) and one dtype of
    q, k, v."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"{name}: q, k, v must be 3-D (rows, seq, dim); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if 0 in q.shape or 0 in k.shape or 0 in v.shape:
        raise ValueError(f"{name}: empty operand: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    devices = [t.device for t in (q, k, v, *others)]
    if any(d != q.device for d in devices):
        raise ValueError(f"{name}: operands on different devices "
                         f"({', '.join(map(str, devices))})")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"{name}: q, k, v of different dtypes "
                         f"({q.dtype}, {k.dtype}, {v.dtype})")


def check_operands(name: str, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> None:
    """The checks every attention entry makes, on any device:
    q (BH, Sq, D), k / v (BHkv, Skv, D), BH a multiple of BHkv, one
    device and one dtype."""
    _check_common(name, q, k, v)
    if k.shape != v.shape or q.shape[2] != k.shape[2]:
        raise ValueError(f"{name}: k and v must both be (BHkv, Skv, D) "
                         f"with q's D; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.shape[0] % k.shape[0]:
        raise ValueError(f"{name}: q rows {q.shape[0]} are not a multiple "
                         f"of kv rows {k.shape[0]}")


def check_pooled_operands(name: str, q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, positions, lengths: torch.Tensor,
                          n_heads: int) -> None:
    """The checks the pooled decode entry makes, on any device: q
    (B·n_heads, 1, Dk), k (BHkv, L, Dk), v (BHkv, L, Dv) with Dv free,
    BHkv a multiple of B dividing B·n_heads, positions None or (B, L)
    int32, lengths (B,) int32; one device, and one dtype for q, k, v."""
    _check_common(name, q, k, v, lengths,
                  *(() if positions is None else (positions,)))
    BH, Sq, Dk = q.shape
    BHkv, L = k.shape[0], k.shape[1]
    if Sq != 1 or k.shape[2] != Dk or v.shape[:2] != k.shape[:2]:
        raise ValueError(f"{name}: want q (BH, 1, Dk), k (BHkv, L, Dk), v "
                         f"(BHkv, L, Dv); got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if n_heads < 1 or BH % n_heads:
        raise ValueError(f"{name}: q rows {BH} are not a multiple of "
                         f"n_heads={n_heads}")
    B = BH // n_heads
    if BH % BHkv or BHkv % B:
        raise ValueError(f"{name}: kv rows {BHkv} must divide q rows {BH} "
                         f"and be a multiple of the {B} slots")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError(f"{name}: lengths must be ({B},) int32; got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    if positions is not None and (positions.shape != (B, L)
                                  or positions.dtype != torch.int32):
        raise ValueError(f"{name}: positions must be None or ({B}, {L}) "
                         f"int32; got {tuple(positions.shape)} "
                         f"{positions.dtype}")


def on_cpu(name: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version runs), False for a CUDA
    tensor (the kernel runs); raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{name}: tensors on {t.device}; the kernel runs on "
                     f"cuda and its plain version on cpu")


def check_cuda(name: str, *tensors: torch.Tensor) -> int:
    """The checks a CUDA launch adds: contiguous operands, a dtype and
    head dim the kernels are built for. Returns the dtype code."""
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} "
                             f"is not contiguous")
    dtype, d = tensors[0].dtype, tensors[0].shape[-1]
    if dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: dtype {dtype} not supported by the "
                         f"kernel (float32, bfloat16)")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not supported by the "
                         f"kernel {HEAD_DIMS}")
    return DTYPE_CODES[dtype]


def check_aligned16(name: str, why: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor's base is 16-byte aligned (``why``: the
    loads that need it)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} "
                             f"starts at {t.data_ptr():#x}, not 16-byte "
                             f"aligned; the kernel needs it for {why}")


def check_tma_aligned(name: str, *tensors: torch.Tensor) -> None:
    """The bf16 prefill kernels load their operands with TMA, which needs a
    16-byte aligned base (csrc/prefill_wgmma.cuh: make_map)."""
    check_aligned16(name, "its TMA loads", *tensors)


def default_scale(d: int, scale) -> float:
    return d ** -0.5 if scale is None else float(scale)
