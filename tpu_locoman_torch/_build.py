"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a``, then the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build goes to
``tpu_locoman_torch/_build/<hash>/``, keyed by a hash of the sources (the
``.cu`` files and the ``.cuh`` headers beside them) and the flags, at first
use; nothing is downloaded. Besides their own headers the sources include
only the CUDA runtime headers.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

from . import trace

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(PKG_DIR, "_build")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libtpu_locoman_kernels.so"

_lib = None
#: seconds the last build took (0.0 when the cached library was loaded)
build_seconds = 0.0
#: ptxas resource report of the last build (registers, shared memory, spills)
build_log = ""

_C_VOID = ctypes.c_void_p
_C_INT = ctypes.c_int
_C_FLOAT = ctypes.c_float
_SIGNATURES = {
    "chol_inv_node_launch": [_C_VOID, _C_VOID, _C_INT, _C_INT, _C_VOID],
    "rnea_derivs_launch": [_C_VOID] * 17 + [_C_INT] * 8 + [_C_VOID],
    "fac_whole_launch": [_C_VOID] * 5 + [_C_INT] * 3 + [_C_VOID],
    "admm_sweeps_launch": ([_C_VOID] * 15 + [_C_INT] * 9 + [_C_FLOAT] * 3
                           + [_C_VOID]),
}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return path


def _sources(csrc=CSRC):
    """The kernel sources: each ``.cu`` file (compiled on its own) and the
    ``.cuh`` headers they include, which the build key must cover too."""
    return sorted(glob.glob(os.path.join(csrc, "*.cu"))
                  + glob.glob(os.path.join(csrc, "*.cuh")))


def _digest(sources):
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return h.hexdigest()[:16]


def build():
    """Compile the kernels if no library for the current sources exists;
    return its path."""
    global build_seconds, build_log
    sources = _sources()
    out_dir = os.path.join(BUILD_ROOT, _digest(sources))
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        build_seconds = 0.0
        return lib_path
    os.makedirs(BUILD_ROOT, exist_ok=True)
    t0 = time.time()
    nvcc = _nvcc()
    work = tempfile.mkdtemp(dir=BUILD_ROOT)
    procs = []
    for src in (s for s in sources if s.endswith(".cu")):
        obj = os.path.join(work, os.path.basename(src) + ".o")
        cmd = [nvcc] + ARCH + FLAGS + ["-c", src, "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, objs = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {os.path.basename(src)}\n{out}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        objs.append(obj)
    tmp_lib = os.path.join(work, LIB_NAME)
    link = subprocess.run([nvcc] + ARCH + ["-shared", "-o", tmp_lib] + objs,
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.makedirs(out_dir, exist_ok=True)
    os.replace(tmp_lib, lib_path)
    shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.time() - t0
    build_log = "\n".join(logs)
    return lib_path


def load():
    """The kernel library (built at first use), with argument types set."""
    global _lib
    if _lib is None:
        with trace.span("kernels.load") as sp:
            lib = ctypes.CDLL(build())
            sp.set(built=int(build_seconds > 0))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
