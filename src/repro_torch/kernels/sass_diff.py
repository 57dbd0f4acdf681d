"""Compare the compiled code of this tree's kernel libraries with another
tree's, function by function.

    python -m repro_torch.kernels.sass_diff PARENT_SRC

PARENT_SRC is the ``src`` directory of another checkout (for example a
``git archive`` of the parent commit). Both trees' libraries are built
(the other tree's in a subprocess, with its own ``_build``), each
is disassembled with the CUDA toolkit's ``cuobjdump -sass``, and every
kernel symbol the two share is compared instruction by instruction,
whitespace aside: ``cuobjdump`` pads its columns to the longest
instruction of the whole library, so a new kernel instance with a longer
mnemonic re-pads every other listing. A kernel template that gained a
second head dim (the flash, streaming and block-sparse kernels' and
the fp32 backward kernels' Dv beside D) is paired by its old name:
``<.., D, D, ..>`` in this tree with ``<.., D, ..>`` in the other
(``old_name``), and so is one that gained a last ``bool`` argument
whose ``false`` keeps the old code (the batch decode's
``decode_split_kernel<.., kPartial>``): ``<.., false>`` in this tree
with ``<..>`` in the other. Prints one line per library (the shared, identical
and differing symbols, and the new ones) and exits 1 if any shared
symbol differs. Runs on a machine with ``nvcc``.
"""
from __future__ import annotations

import ast
import os
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict

from repro_torch.kernels import _build


def cuobjdump() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    return str(home / "bin" / "cuobjdump")


def sass(lib: Path) -> Dict[str, str]:
    """{kernel symbol: its SASS with the whitespace collapsed}."""
    text = subprocess.run([cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out = {}
    for body in re.split(r"\n\s*Function : ", text)[1:]:
        name = body.split(None, 1)[0]
        out[name] = " ".join(body[len(name):].split())
    return out


def instance(name: str) -> str:
    """A kernel symbol up to its template arguments (the void return type
    and the parameters dropped: they follow from the arguments, and a
    template that gained an argument renumbers its ``T<n>_``
    references)."""
    m = re.match(r"(.*?E)v", name)
    return m.group(1) if m else name


def old_name(name: str, old: Dict[str, str]) -> str:
    """``name``'s instance (``instance``) in the other tree, whose symbols
    ``old`` holds by instance: itself, or, where that tree has no such
    instance, with a last ``false`` template argument dropped
    (``IfLi96ELi1ELb0EE`` → ``IfLi96ELi1EE``) or else its first repeated
    int template argument dropped (``ILi96ELi96EE`` → ``ILi96EE``,
    ``IfLi96ELi96ENS0_11FlashPolicyE`` → ``IfLi96ENS0_11FlashPolicyE``)."""
    key = instance(name)
    if key in old:
        return key
    no_flag = re.sub(r"Lb0E(?=E)", "", key, count=1)
    if no_flag in old:
        return no_flag
    return re.sub(r"Li(\d+)ELi\1E", r"Li\1E", key, count=1)


def other_libraries(src: Path) -> Dict[str, Path]:
    """Build the other tree's libraries in a subprocess; their paths."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import _build; _build.build(); "
            "print({n: str(_build.library_path(n)) "
            "for n in _build.SOURCES})")
    out = subprocess.run([sys.executable, "-c", code, str(src)],
                         capture_output=True, text=True, check=True).stdout
    return {n: Path(p) for n, p in
            ast.literal_eval(out.strip().splitlines()[-1]).items()}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit(__doc__)
    other = other_libraries(Path(argv[0]).resolve())
    _build.build()
    moved = 0
    for name in _build.SOURCES:
        if name not in other:
            print(f"{name}: not in the other tree")
            continue
        a = {instance(f): text for f, text in sass(other[name]).items()}
        b = {old_name(f, a): text
             for f, text in sass(_build.library_path(name)).items()}
        shared = sorted(set(a) & set(b))
        differ = [f for f in shared if a[f] != b[f]]
        moved += len(differ)
        print(f"{name}: {len(shared)} shared kernels, "
              f"{len(shared) - len(differ)} identical, {len(differ)} "
              f"differ {differ}; new {sorted(set(b) - set(a))}; "
              f"gone {sorted(set(a) - set(b))}", flush=True)
    return 1 if moved else 0


if __name__ == "__main__":
    sys.exit(main())
