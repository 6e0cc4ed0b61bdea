"""The port imports without JAX: its package never imports jax or
tpu_locoman, and a batched MPC tick runs on the CPU in a process where
importing jax fails. Also: the port's entry points default to the card,
its copies of the robot specs equal the JAX package's files, and its
solver layers import downward only (each kernel module holds its plain
version; the QP layer above them is imported by sqp alone)."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tpu_locoman_torch")

_SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any import of jax now raises
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(2)
import tpu_locoman_torch as T
from tpu_locoman_torch import convert  # noqa: F401
robot = T.Go2()
robot.set_gait_sequence("trot", 0.8)
mpc = T.MPC(robot, dynamics="whole_body_rnea", nodes=3, device="cpu",
            config=T.SQPConfig(n_trials=2, corrector_iters=2,
                               admm=T.ADMMConfig(iters=3)))
carries = T.batched_init(mpc, 2)
targets = torch.tensor([[0.2, 0, 0, 0, 0, 0], [0.0, 0, 0, 0, 0, 0.1]])
carries, stats = T.batched_step(mpc)(carries, 0.0, targets)
assert torch.isfinite(carries.x_init).all()
assert stats["status"].shape == (2,)
bad = [m for m, mod in sys.modules.items() if mod is not None and (
    m == "jax" or m.startswith("jax.") or m == "tpu_locoman"
    or m.startswith("tpu_locoman."))]
assert not bad, bad
print("OK", float(stats["max_violation"].max()))
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _SCRIPT, ROOT],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("OK")


def test_no_jax_or_reference_imports_in_port_sources():
    pat = re.compile(r"^\s*(import|from)\s+(jax|tpu_locoman)(\.|\s|$)", re.M)
    hits = []
    for dirpath, dirs, files in os.walk(PKG):
        if "_build" in dirs:
            dirs.remove("_build")  # kernel build outputs, not sources
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                with open(path) as f:
                    if pat.search(f.read()):
                        hits.append(path)
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        if pat.search(f.read()):
            hits.append("chip_smoke.py")
    assert not hits, hits


@pytest.mark.parametrize("name", ["go2", "b2g", "b2", "b2g_arm_locked"])
def test_spec_copies_equal_jax_package_files(name):
    """The port reads its own copy of each spec; it must not drift from the
    JAX package's file."""
    import tpu_locoman_torch as T
    from tpu_locoman_torch import robots

    assert robots.SPEC_DIR == os.path.join(PKG, "specs")
    with open(os.path.join(PKG, "specs", name + ".json")) as f:
        copy = json.load(f)
    with open(os.path.join(ROOT, "tpu_locoman", "robots", "specs",
                           name + ".json")) as f:
        ref = json.load(f)
    assert copy == ref
    with open(os.path.join(PKG, "specs", name + ".json"), "rb") as f:
        raw = f.read()
    with open(os.path.join(ROOT, "tpu_locoman", "robots", "specs",
                           name + ".json"), "rb") as f:
        assert raw == f.read()  # byte for byte
    assert T.Go2().model.nq == 19 and T.B2G().model.nq == 25


def test_mpc_defaults_to_cuda(monkeypatch):
    """Without device=..., MPC runs on the card and, where there is none,
    raises instead of falling back to the CPU."""
    import tpu_locoman_torch as T

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    robot = T.Go2()
    robot.set_gait_sequence("trot", 0.8)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        T.MPC(robot, nodes=3)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        T.geometric_dts(0.01, 0.08, 3)
    assert T.MPC(robot, nodes=3, device="cpu").device.type == "cpu"


_NEW_MODULES = r"""
import sys
sys.modules["jax"] = None  # any import of jax now raises
sys.path.insert(0, sys.argv[1])
import tpu_locoman_torch  # noqa: F401
from tpu_locoman_torch import (aot, distributed, dryrun, native, parallel,
                               viz)  # noqa: F401
from tpu_locoman_torch.examples import run_mpc, run_ocp  # noqa: F401
bad = [m for m, mod in sys.modules.items() if mod is not None and (
    m == "jax" or m.startswith("jax.") or m == "tpu_locoman"
    or m.startswith("tpu_locoman."))]
assert not bad, bad
print("OK")
"""


def test_new_modules_import_without_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _NEW_MODULES, ROOT],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("OK")


def test_native_builds_outside_native_dir(tmp_path):
    """Importing and using the port's native bindings writes nothing under
    native/ (the JAX package's build product lives there): run in a tree
    whose native/ holds only the source and whose package links to the
    port's."""
    import shutil

    shutil.copytree(os.path.join(ROOT, "native"), tmp_path / "native",
                    ignore=shutil.ignore_patterns("*.so"))
    before = sorted(os.listdir(tmp_path / "native"))
    os.symlink(PKG, tmp_path / "tpu_locoman_torch")
    script = ("import sys; sys.modules['jax'] = None\n"
              "sys.path.insert(0, sys.argv[1])\n"
              "from tpu_locoman_torch import native\n"
              "assert len(native.geometric_dts(0.01, 0.08, 14)) == 14\n"
              "print(native.library_path())\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert sorted(os.listdir(tmp_path / "native")) == before
    lib = out.stdout.strip().splitlines()[-1]
    assert lib.startswith(str(tmp_path / "tpu_locoman_torch" / "_build"))
    assert os.path.exists(lib)


SOLVER = "tpu_locoman_torch.solver"
#: the solver's layers below qp.py: K1, K3 and K4 with their plain
#: versions, and the library factorizations
BELOW_QP = ("chol_base.py", "fac_whole.py", "admm_sweeps.py", "blocked.py")


def _imports(rel):
    """(module, inside a function) of every import in the port's file
    ``rel``; a ``from M import n`` names both M and M.n (n may be a
    module), relative imports resolved against the file's package."""
    package = "tpu_locoman_torch." + os.path.dirname(rel).replace("/", ".")
    package = package.rstrip(".")
    tree = ast.parse(open(os.path.join(PKG, rel)).read())
    inner = {id(n) for f in ast.walk(tree)
             if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
             for n in ast.walk(f) if n is not f}
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = package.split(".")[:len(package.split("."))
                                             - node.level + 1]
                base = ".".join(parts + ([base] if base else []))
            mods = [base] + [f"{base}.{a.name}" for a in node.names]
        else:
            continue
        out += [(m, id(node) in inner) for m in mods]
    return out


@pytest.mark.parametrize("name", BELOW_QP)
def test_kernel_layers_import_neither_qp_nor_sqp(name):
    up = {m for m, _ in _imports("solver/" + name)} & {
        f"{SOLVER}.qp", f"{SOLVER}.sqp"}
    assert not up, f"solver/{name} reaches up to {sorted(up)}"


@pytest.mark.parametrize("name", BELOW_QP + ("qp.py",))
def test_no_import_inside_a_function_among_the_qp_layers(name):
    """The wrappers' lazy load of the kernel library (``_build``) is the
    one import left inside a function."""
    inner = {m for m, inside in _imports("solver/" + name)
             if inside and not m.startswith("tpu_locoman_torch._build")}
    assert not inner, f"solver/{name} imports {sorted(inner)} in a function"


def test_only_sqp_imports_qp():
    rels = ["rbda.py"] + ["solver/" + f
                          for f in os.listdir(os.path.join(PKG, "solver"))
                          if f.endswith(".py")]
    importers = {rel for rel in rels
                 if f"{SOLVER}.qp" in {m for m, _ in _imports(rel)}}
    assert importers == {"solver/sqp.py", "solver/__init__.py"}
