#!/usr/bin/env python3
"""The SASS instruction mix of the port's compiled kernels: for every
kernel of the built library whose (mangled) name holds ``--kernel``, the
count of each opcode in its machine code, largest first, so that a
kernel's per-row work can be counted and set against the card's pipes:

    python3 tools/sass_mix.py --kernel stream_grouped_kernelILi8ELi4E \\
        [--src src] [--top 25]

Builds the library of the ``repro_torch`` package under ``--src`` (or
finds it built) and runs the CUDA toolkit's ``cuobjdump -sass`` on it.
Counts are static (instructions in the code, not executed). Needs nvcc and
cuobjdump; needs no card.
"""
from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--kernel", required=True)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import _build
    lib = _build.load_library()._name
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    # a function's code runs from its "Function : name" line to the next
    for name, body in re.findall(r"Function : (\S+)\n(.*?)(?=Function : |\Z)",
                                 sass, re.S):
        if args.kernel not in name:
            continue
        ops = collections.Counter(
            m.group(1).split(".")[0]
            for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                                 r"([A-Z][A-Z0-9_.]*)", body))
        print(f"{name}: {sum(ops.values())} instructions")
        for op, n in ops.most_common(args.top):
            print(f"  {op:12s} {n}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
