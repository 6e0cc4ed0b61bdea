"""ctypes bindings for the native deployment runtime: the port's counterpart
of ``tpu_locoman/native.py``, over the same source,
``native/locoman_runtime.cc``.

The shared library is compiled with ``g++`` at first use into the port's
own build directory, ``tpu_locoman_torch/_build/native-<hash>/``, keyed by
a hash of the source (a checkout resets modification times), and never
into ``native/``, whose library is the JAX package's build product. The
build goes to a temporary name first and is renamed into place, so
processes that build at once do not read a half-written library.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_LIB = None
_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "locoman_runtime.cc")
_BUILD_ROOT = os.path.join(_PKG, "_build")
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def library_path():
    """Where the library for the current source lives (built or not)."""
    with open(_SRC, "rb") as f:
        key = hashlib.sha256(" ".join(_FLAGS).encode() + f.read()).hexdigest()
    return os.path.join(_BUILD_ROOT, f"native-{key[:16]}",
                        "liblocoman_runtime.so")


def _build(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
    os.close(fd)
    try:
        subprocess.run(["g++"] + _FLAGS + [_SRC, "-o", tmp, "-lpthread"],
                       check=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


_D, _I, _P, _V = (ctypes.c_double, ctypes.c_int,
                  ctypes.POINTER(ctypes.c_double), ctypes.c_void_p)
#: name -> (restype, argtypes) of native/locoman_runtime.cc's C interface
_SIGNATURES = {
    "locoman_geometric_dts": (None, [_D, _D, _I, _P]),
    "locoman_gait_schedule": (None, [_I, _D, _D, _P, _I, _P, _P]),
    "locoman_spline_vel_z": (_D, [_D, _D, _D, _D, _D]),
    "locoman_pack_params": (_I, [_P, _I, _P, _P, _I, _P, _P, _P, _P, _I,
                                 _P]),
    "locoman_ring_create": (_V, [_I, _I]),
    "locoman_ring_push": (None, [_V, _P]),
    "locoman_ring_read_latest": (ctypes.c_uint64, [_V, _P]),
    "locoman_ring_destroy": (None, [_V]),
}


def lib():
    global _LIB
    if _LIB is None:
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        lib_ = ctypes.CDLL(path)
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib_, name)
            fn.restype, fn.argtypes = restype, argtypes
        _LIB = lib_
    return _LIB


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


GAIT_IDS = {"trot": 0, "walk": 1, "stand": 2}


def geometric_dts(dt_min, dt_max, nodes):
    out = np.zeros(nodes)
    lib().locoman_geometric_dts(
        ctypes.c_double(dt_min), ctypes.c_double(dt_max), nodes, _dptr(out)
    )
    return out


def gait_schedule(gait_type, gait_period, t_current, dts):
    nodes = len(dts)
    dts = np.ascontiguousarray(dts, dtype=np.float64)
    contact = np.zeros((4, nodes))
    swing = np.zeros((4, nodes))
    lib().locoman_gait_schedule(
        GAIT_IDS[gait_type], ctypes.c_double(gait_period),
        ctypes.c_double(t_current), _dptr(dts), nodes,
        _dptr(contact), _dptr(swing),
    )
    return contact, swing


def spline_vel_z(swing_phase, swing_period, h_max=0.1, v_liftoff=0.1,
                 v_touchdown=-0.2):
    return lib().locoman_spline_vel_z(
        ctypes.c_double(swing_phase), ctypes.c_double(swing_period),
        ctypes.c_double(h_max), ctypes.c_double(v_liftoff),
        ctypes.c_double(v_touchdown),
    )


def _f64(x):
    """A contiguous float64 numpy array of x (a tensor on any device)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, dtype=np.float64)


def pack_params(x_init, contact, swing, base_vel_des, ext_force_des,
                arm_vel_des, tau_prev):
    """One scenario's flat parameter vector (the reference's compiled-solver
    parameter layout); contact and swing (4, nodes)."""
    x_init, contact, swing = _f64(x_init), _f64(contact), _f64(swing)
    tau_prev = _f64(tau_prev)
    nodes = contact.shape[1]
    nj = len(tau_prev)
    out = np.zeros(len(x_init) + 8 * nodes + 12 + nj)
    n = lib().locoman_pack_params(
        _dptr(x_init), len(x_init), _dptr(contact), _dptr(swing), nodes,
        _dptr(_f64(base_vel_des)), _dptr(_f64(ext_force_des)),
        _dptr(_f64(arm_vel_des)), _dptr(tau_prev), nj,
        _dptr(out),
    )
    return out[:n]


class StateRing:
    """Lock-free latest-value buffer for robot-state ingestion."""

    def __init__(self, width, slots=8):
        self.width = width
        self._ring = ctypes.c_void_p(lib().locoman_ring_create(slots, width))

    def push(self, value):
        v = np.ascontiguousarray(value, dtype=np.float64)
        assert v.size == self.width
        lib().locoman_ring_push(self._ring, _dptr(v))

    def read_latest(self):
        out = np.zeros(self.width)
        seq = lib().locoman_ring_read_latest(self._ring, _dptr(out))
        return (out, int(seq)) if seq else (None, 0)

    def __del__(self):
        try:
            lib().locoman_ring_destroy(self._ring)
        except Exception:
            pass
