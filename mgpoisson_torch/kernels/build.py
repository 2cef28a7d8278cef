"""Builds the CUDA sources of ``mgpoisson_torch/csrc`` at first use.

nvcc compiles them for Hopper (``sm_90a``), one process per source, all
started together, and links the objects into one shared library with a
plain C interface, which ctypes loads.  The library goes to
``build/mgpoisson_torch/`` at the root of the checkout, under a name that
carries a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is not.  A failed build raises with nvcc's output:
there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mgpoisson_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of each entry point: (argtypes, restype).  The 3D entries
# take the tile side after n.
SIGNATURES = {
    "mg_smooth": ((_P, _P, _P, _I, _I, _I, _I, _F, _F, _P), _I),
    "mg_smooth_rr": ((_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _I, _P), _I),
    "mg_prolong_correct_smooth": (
        (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _I, _P), _I),
    "mg_smooth3d": ((_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P), _I),
    "mg_smooth_rr3d": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _I, _P), _I),
    "mg_prolong_correct_smooth3d": (
        (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _P), _I),
    "mg_packed_rr": ((_P, _P, _P, _P, _I, _I, _F, _F, _P), _I),
    "mg_packed_pc": ((_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _P), _I),
    # the strip kernels: the arrays, then the u and f strips (top, bot,
    # left, right) and for the up-leg V's, then the block's geometry (grid
    # side, block extents, origin, strip depths; in 3D the tile side)
    "mg_sharded_rr": ((_P,) * 12 + (_I,) * 9 + (_F, _F, _F, _I, _P), _I),
    "mg_sharded_pc": ((_P,) * 17 + (_I,) * 11 + (_F, _F, _F, _I, _P), _I),
    "mg_sharded_rr3d": ((_P,) * 12 + (_I,) * 10 + (_F, _F, _F, _I, _P), _I),
    "mg_sharded_pc3d": ((_P,) * 17 + (_I,) * 12 + (_F, _F, _F, _I, _P), _I),
    # the packed strip kernels: the arrays, the u and f (and V) row strips
    # (top, bot), then grid side, block rows, first row, strip depths, nu
    # (and the prolongation kind)
    "mg_sharded_packed_rr": ((_P,) * 8 + (_I,) * 5 + (_F, _F, _P), _I),
    "mg_sharded_packed_pc": ((_P,) * 11 + (_I,) * 7 + (_F, _F, _I, _P), _I),
    "mg_error_string": ((_I,), ctypes.c_char_p),
}
# the bf16 forms of K1-K6 take what their f32 forms take
SIGNATURES.update({name + "_bf16": SIGNATURES[name] for name in
                   ("mg_smooth", "mg_smooth_rr", "mg_prolong_correct_smooth", "mg_smooth3d",
                    "mg_smooth_rr3d", "mg_prolong_correct_smooth3d")})


def sources(csrc: Path = CSRC):
    return sorted(csrc.glob("*.cu")), sorted(csrc.glob("*.cuh"))


def nvcc() -> str:
    """The nvcc to build with: $CUDA_HOME/bin/nvcc, else nvcc on PATH,
    else /usr/local/cuda/bin/nvcc."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the mgpoisson_torch "
                       "CUDA kernels are built from source at first use")


def library_path(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    cu, cuh = sources(csrc)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return build_dir / f"libmgpoisson_torch_{h.hexdigest()[:16]}.so"


def _run(cmds):
    """Runs the commands in parallel; returns their (returncode, output)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def build(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    """Compiles the library unless this exact build is already there;
    returns its path.  nvcc's report (ptxas registers, shared memory,
    spills) is kept beside it as ``<name>.log``.  Another source tree
    (`csrc`, e.g. a parent commit's, for bench/ab.py) builds the same
    way into `build_dir`."""
    lib = library_path(csrc, build_dir)
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    cu, _ = sources(csrc)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        objs = [os.path.join(tmp, p.stem + ".o") for p in cu]
        cmds = [[nvcc(), *NVCC_FLAGS, "-c", str(p), "-o", o] for p, o in zip(cu, objs)]
        link = [nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", os.path.join(tmp, lib.name),
                *objs]
        log = []
        for cmd, (rc, out) in zip(cmds, _run(cmds)):
            log.append(f"== {' '.join(cmd)}\n{out}")
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}): {log[-1]}")
        rc, out = _run([link])[0]
        if rc != 0:
            raise RuntimeError(f"nvcc link failed ({rc}): {' '.join(link)}\n{out}")
        lib.with_suffix(".log").write_text("".join(log))
        os.replace(os.path.join(tmp, lib.name), lib)   # atomic: a concurrent loader sees all or nothing
    return lib


def load_library(path) -> ctypes.CDLL:
    """Loads a built library with the argument and result types of every
    entry point it holds declared (a build of an older tree, e.g. for
    bench/ab.py, lacks the newer entries: calling one raises)."""
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is None:
            continue
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """Builds (if needed) and loads the library once per process."""
    return load_library(build())
