"""The recorded JAX outputs that the port's tests read (tests/data/
torch_*_jax.*) against a fresh run of the JAX package on the CPU.

Each recording is written by its test file's generator (``JAX_PLATFORMS=cpu
python tests/test_torch_X.py``). Here the generator runs again without
writing, and its output must equal the committed file: keys and strings
exactly, numbers within 1e-6 (absolute and relative), the bound of
test_torch_mpc.py's own fixture check. A recording that no longer matches
the JAX package fails here. Each case compiles the JAX side cold (one to
six minutes), so they are all ``slow``."""

import importlib
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
TOL = 1e-6

#: recording -> (test module, function returning its content)
RECORDINGS = {
    "torch_accurate_rollout_jax.npz": ("test_torch_accurate",
                                       "_jax_accurate_rollout"),
    "torch_aot_centroidal_jax.json": ("test_torch_aot_jax", "_fixture"),
    "torch_euler_jacobians_jax.npz": ("test_torch_euler",
                                      "_jacobians_recording"),
    "torch_jax_rollouts.npz": ("test_torch_mpc", "_rollouts_recording"),
    "torch_mpc_run_jax.npz": ("test_torch_mpc_run", "_jax_side"),
    "torch_structure_jax.json": ("test_torch_ops", "_structure_recording"),
    "torch_transcribe_jax.npz": ("test_torch_transcribe", "_recording"),
    "torch_variants_linearize_jax.npz": ("test_torch_variants",
                                         "_linearize_recording"),
}


def _same(fresh, rec, where):
    """fresh == rec: containers and strings exactly, numbers within TOL."""
    if isinstance(rec, dict):
        assert sorted(fresh) == sorted(rec), where
        for k in rec:
            _same(fresh[k], rec[k], f"{where}/{k}")
        return
    a, b = np.asarray(fresh), np.asarray(rec)
    if a.dtype.kind in "biuf" and b.dtype.kind in "biuf":
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=where)
    elif isinstance(rec, list) and a.dtype == object:
        assert len(fresh) == len(rec), where
        for i, (x, y) in enumerate(zip(fresh, rec)):
            _same(x, y, f"{where}[{i}]")
    else:
        np.testing.assert_array_equal(a, b, err_msg=where)


def test_every_recording_is_listed():
    # the parity dump is tools/make_torch_golden.py's, checked by
    # tests/test_torch_parity.py
    names = {f for f in os.listdir(DATA) if f.startswith("torch_")
             and "jax" in f} - {"torch_parity_b2g_n14_jax_seq.json"}
    assert names == set(RECORDINGS)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(RECORDINGS))
def test_recording_reproduces_from_jax(name):
    mod, fn = RECORDINGS[name]
    fresh = getattr(importlib.import_module(mod), fn)()
    path = os.path.join(DATA, name)
    if name.endswith(".npz"):
        with np.load(path) as d:
            rec = {k: d[k] for k in d.files}
        fresh = {k: np.asarray(v) for k, v in fresh.items()}
    else:
        with open(path) as f:
            rec = json.load(f)
        fresh = json.loads(json.dumps(fresh))
    _same(fresh, rec, name)
