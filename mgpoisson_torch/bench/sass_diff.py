"""Compares the machine code (SASS) of the kernels two builds share.

    python3 -m mgpoisson_torch.bench.sass_diff OLD.so NEW.so [--rename OLD_FN NEW_FN ...]

Disassembles both libraries (``cuobjdump -sass``, from the CUDA toolkit),
cuts each listing into its functions and prints one JSON line per function
that both hold: its name, its instruction count in each, whether the
instructions are the same once addresses and encodings are dropped, and
where they are not, whether they are the same once every register's
number and the operand-reuse hints (`.reuse`, which follow the registers)
are dropped (`registers_only`: the same instructions and operands in the
same order, in other registers).  This
shows whether a change to shared tile code left a kernel's code as it was,
e.g. the single-device kernels of a commit against its parent's build.
`--rename OLD_FN NEW_FN` (repeatable; mangled names, as cuobjdump prints
them) compares the old build's OLD_FN under the new name: a kernel whose
name changed, e.g. with a template argument dropped.  Exits non-zero if
cuobjdump fails.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

_FUNCTION = re.compile(r"^\s*Function : (\S+)")
# "        /*0a30*/   FFMA R1, R2, R3, R4 ;   /* 0x... */"
_INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;")


def functions(listing: str) -> dict:
    """Function name -> its instructions, addresses and encodings dropped."""
    out, current = {}, None
    for line in listing.splitlines():
        m = _FUNCTION.match(line)
        if m:
            current = out.setdefault(m.group(1), [])
            continue
        m = _INSTRUCTION.search(line)
        if m and current is not None:
            current.append(" ".join(m.group(1).split()))
    return out


_REGISTER = re.compile(r"\b(U?R|U?P|B)(\d+)\b")


def unnumbered(code):
    """The instructions with each register's number and reuse hint dropped,
    its file kept (R, UR, P, UP, B; RZ, PT and the like are kept whole)."""
    return [_REGISTER.sub(lambda m: m.group(1), ins).replace(".reuse", "") for ins in code]


def compare(old: dict, new: dict):
    """One row per function in both listings, in the new one's order; where
    the code differs, the number of positions that differ and the first
    three of them as [position, old instruction, new instruction]."""
    rows = []
    for name, code in new.items():
        if name not in old:
            continue
        row = {"function": name, "instructions_old": len(old[name]),
               "instructions_new": len(code), "identical": old[name] == code}
        if not row["identical"]:
            diff = [[k, a, b] for k, (a, b) in enumerate(zip(old[name], code)) if a != b]
            row["differing"] = len(diff) + abs(len(code) - len(old[name]))
            row["first_differences"] = diff[:3]
            row["registers_only"] = unnumbered(old[name]) == unnumbered(code)
        rows.append(row)
    return rows


def rename(fns: dict, pairs) -> dict:
    """The listing with each (old name, new name) pair's function under its
    new name, where the listing holds it."""
    fns = dict(fns)
    for a, b in pairs:
        if a in fns:
            fns[b] = fns.pop(a)
    return fns


def cuobjdump() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for c in (shutil.which("cuobjdump"), os.path.join(home, "bin", "cuobjdump")):
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("cuobjdump not found (set CUDA_HOME)")


def sass(lib: str) -> str:
    return subprocess.run([cuobjdump(), "-sass", lib], check=True, capture_output=True,
                          text=True).stdout


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("old")
    p.add_argument("new")
    p.add_argument("--rename", nargs=2, action="append", default=[],
                   metavar=("OLD_FN", "NEW_FN"))
    args = p.parse_args(argv)
    old = rename(functions(sass(args.old)), args.rename)
    for row in compare(old, functions(sass(args.new))):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
