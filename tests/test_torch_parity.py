"""The port's parity ABI v1 dump and diff (tpu_locoman_torch.parity)
against the JAX package's (tools/parity_check.py): the port's Go2 N=6 hot
dump over 5 ticks against the committed JAX dump
tests/data/torch_parity_go2_n6_hot.json (tools/make_torch_golden.py
--parity-go2), and the port's diff against the tool's on the same files.

The bound of each quantity is three times JAX against itself: the largest
max abs error of the JAX dumps made with "cholinv" and "babe" diffed
against the committed one ("auto", i.e. "sequential" on the CPU),
recorded under the dump's "meta". The port on the CPU runs "auto" too,
which is "sequential" there."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tpu_locoman_torch import parity  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DUMP = os.path.join(ROOT, "tests", "data", "torch_parity_go2_n6_hot.json")
SPREAD_FACTOR = 3.0


def _tool():
    spec = importlib.util.spec_from_file_location(
        "parity_check", os.path.join(ROOT, "tools", "parity_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port_dump(tmp_path_factory):
    path = tmp_path_factory.mktemp("parity") / "go2_port.json"
    parity.make_dump(str(path), ticks=5, hot=True, robot_name="go2", nodes=6,
                     device="cpu")
    return str(path)


def test_go2_dump_matches_jax_dump(port_dump):
    """Same schema and config as the JAX dump, and every quantity within
    three times JAX's spread, per quantity's max abs error over the 5
    ticks. Measured: the port lands within 0.51-2.3x JAX "cholinv"'s error
    in every quantity but max_violation (9.3e-5 against "cholinv"'s 2.2e-5
    and "babe"'s 4.5e-5, bound 1.34e-4): max_violation at 10 ADMM sweeps
    is the worst row at the iteration floor, which moves with summation
    order."""
    with open(port_dump) as f:
        ours = json.load(f)
    with open(JAX_DUMP) as f:
        ref = json.load(f)
    assert ours["abi_version"] == ref["abi_version"] == 1
    assert ours["config"] == ref["config"]
    assert ours["solver"] == ref["solver"]
    for node in ("node0", "node1"):
        for k in parity.QUANTITIES:
            assert np.shape(ours[node][k]) == np.shape(ref[node][k]), (node, k)
    spread = ref["meta"]["spread"]
    out = parity.diff(ours, ref)
    assert set(out) == set(spread)
    for key, e in out.items():
        assert e["ticks_compared"] == 5, key
        bound = SPREAD_FACTOR * spread[key]
        assert e["max_abs_err"] <= bound, (key, e["max_abs_err"], bound)


def test_port_diff_equals_the_tool_diff(port_dump, capsys):
    """The port's numpy diff gives the tool's numbers on the same two files
    (and the tool reads the port's dump)."""
    tool = _tool()
    ref = tool.diff(port_dump, JAX_DUMP)
    capsys.readouterr()
    assert parity.diff(port_dump, JAX_DUMP) == ref


def test_cli_diff(port_dump):
    """python -m tpu_locoman_torch.parity --diff prints the diff as JSON."""
    out = subprocess.run(
        [sys.executable, "-m", "tpu_locoman_torch.parity", "--diff",
         port_dump, JAX_DUMP], capture_output=True, text=True, cwd=ROOT,
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == parity.diff(port_dump, JAX_DUMP)


def test_b2g_parity_bounds_file():
    """The references and bounds of chip_smoke.py's parity phase: JAX
    "sequential" and "cholinv", held open loop to
    tools/golden_b2g_rnea_n14.json, against it over the same T ticks (the
    spread, their larger error per quantity) and against each other, and
    the "sequential" dump; each bound is three times its spread, on the
    quantities where that is positive and at most PARITY_SCALE_SHARE of
    the reference's scale."""
    chip_smoke = _chip_smoke()
    with open(chip_smoke.PARITY_SPREAD) as f:
        spread = json.load(f)
    with open(chip_smoke.PARITY_GOLDEN) as f:
        golden = json.load(f)
    with open(chip_smoke.PARITY_JAX) as f:
        jax_dump = json.load(f)
    n = spread["ticks"]
    assert 0 < n <= golden["config"]["ticks"] and spread["open_loop"]
    assert jax_dump["config"] == dict(golden["config"], ticks=n)
    assert len(jax_dump["x"]) == n
    variants = spread["variants"]
    assert sorted(variants) == ["cholinv", "sequential"]
    assert variants["sequential"]["diff"] == parity.diff(jax_dump, golden,
                                                         warn=False)
    for key, e in spread["spread"].items():
        errs = [v["diff"][key]["max_abs_err"] for v in variants.values()]
        assert all(v["diff"][key]["ticks_compared"] == n
                   for v in variants.values())
        assert e["max_abs_err"] == max(errs), key
    for sp in (spread["spread"], spread["jax_spread"]):
        bounds = chip_smoke.held_bounds(sp)
        for key, b in bounds.items():
            assert b == SPREAD_FACTOR * sp[key]["max_abs_err"] > 0, key
            assert b <= chip_smoke.PARITY_SCALE_SHARE * sp[key]["ref_scale"]
        # the held state itself (node 0's q and v) has nothing to hold
        assert {"node0.q", "node0.v"}.isdisjoint(bounds)
        assert {"x", "max_violation", "node1.q"} <= set(bounds)


def test_b2g_open_loop_plain_path():
    """The first two ticks of the parity phase on the port's plain path
    (the CPU: "auto" is "sequential"), held open loop to the golden dump,
    within the phase's bounds against the golden and against JAX
    "sequential"'s dump held the same way."""
    chip_smoke = _chip_smoke()
    with open(chip_smoke.PARITY_SPREAD) as f:
        spread = json.load(f)
    with open(chip_smoke.PARITY_GOLDEN) as f:
        golden = json.load(f)
    dump = parity.make_dump(None, ticks=2, device="cpu", hold=golden)
    with open(chip_smoke.PARITY_JAX) as f:
        jax_dump = json.load(f)
    for ref, sp in ((golden, spread["spread"]),
                    (jax_dump, spread["jax_spread"])):
        d = parity.diff(dump, ref, warn=False)
        for key, b in chip_smoke.held_bounds(sp).items():
            assert d[key]["ticks_compared"] == 2
            assert d[key]["max_abs_err"] <= b, (key, d[key], b)


def _chip_smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke
