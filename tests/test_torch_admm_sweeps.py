"""K4 (``solver/admm_sweeps.py``): the op's plain version, its dispatch in
``run_iters``, its checks and its fake implementation, on the CPU. The
kernel itself runs only on the card: ``chip_smoke.py`` phase 35 holds it
against the plain loop and a float64 loop there."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from tpu_locoman_torch import trace  # noqa: E402
from tpu_locoman_torch.solver import admm_sweeps as k4  # noqa: E402
from tpu_locoman_torch.solver import qp  # noqa: E402
from tpu_locoman_torch.solver.fac_whole import (  # noqa: E402
    factorize_whole_plain)

CFG = qp.ADMMConfig(iters=3)


def _parent_loop(work, q, l, u, cfg, x, z, y, iters, box_idx=None):
    """``run_iters``' loop as it stood before K4, word for word."""
    rho = work.rho_vec
    solve = qp._solver_for(work.fac)
    for _ in range(iters):
        rhs = cfg.sigma * x - q + qp._At_matvec(work.A, work.D, rho * z - y,
                                                box_idx)
        x_t = solve(work.fac, rhs)
        z_t = qp._A_matvec(work.A, work.D, x_t, box_idx)
        x_new = cfg.alpha * x_t + (1.0 - cfg.alpha) * x
        z_relax = cfg.alpha * z_t + (1.0 - cfg.alpha) * z
        z_new = torch.clamp(z_relax + y / rho, min=l, max=u)
        y = y + rho * (z_relax - z_new)
        x, z = x_new, z_new
    return x, z, y


def _problem(Bs, K, s, md, k, nbox, factor="cholinv", seed=0):
    """A seeded QP on the stage blocks: (work, q, l, u, x, z, y, box_idx).
    factor: "cholinv" (the propagation pattern, V (.., s, k)), "pallas"
    (K3's full-width factor, V (.., s, s), still with the pattern),
    "dense" (a general C: a dense D), "babe" or "cyclic"."""
    g = torch.Generator().manual_seed(seed)
    N, ndx = K - 1, k
    A = 0.3 * torch.randn(Bs, N, md, s, generator=g)
    box = (torch.randperm(s, generator=g)[:nbox].sort().values
           if nbox else None)
    m = md + nbox
    l = -torch.rand(Bs, N, m, generator=g) - 0.1
    u = torch.rand(Bs, N, m, generator=g) + 0.1
    u = torch.where(torch.rand(Bs, N, m, generator=g) < 0.3, l, u)
    rho = qp._rho_vec(l, u, CFG)
    P = torch.rand(Bs, K, s, generator=g) + 0.5
    C = torch.zeros(Bs, N, md, ndx)
    C[..., :k, :k] = torch.eye(k)
    if factor == "dense":
        C = C + 0.1 * torch.randn(Bs, N, md, ndx, generator=g)
    pattern = None if factor == "dense" else k
    H, U, A2, D = qp.assemble_blocks(A[..., :ndx], A[..., ndx:], C, P, rho,
                                     CFG.sigma, box_idx=box,
                                     c_eye_rows=pattern)
    Uf = torch.cat([U, U.new_zeros(U.shape[:-1] + (s - U.shape[-1],))], -1)
    fac = {"cholinv": lambda: qp.factorize(H, U, chol_impl="cholinv"),
           "dense": lambda: qp.factorize(H, U, chol_impl="cholinv"),
           "pallas": lambda: factorize_whole_plain(H, Uf),
           "babe": lambda: qp.factorize_babe(H, U),
           "cyclic": lambda: qp.factorize_cyclic(H, Uf)}[factor]()
    work = qp.QPWork(fac=fac, A=A2, D=D, rho_vec=rho)
    q = torch.randn(Bs, K, s, generator=g)
    x, z, y = (0.1 * torch.randn(shape, generator=g)
               for shape in ((Bs, K, s), (Bs, N, m), (Bs, N, m)))
    return work, q, l, u, x, z, y, box


@pytest.mark.parametrize("factor, nbox", [("cholinv", 54), ("pallas", 54),
                                          ("pallas", 0)])
def test_plain_version_is_the_parent_loop(factor, nbox):
    """The hot shapes (batch 2, s 105, k 48, 54 box rows), and K3's
    full-width factor (kv = s) with and without box rows: the op on CPU
    tensors and run_iters are the parent's loop bit for bit."""
    work, q, l, u, x, z, y, box = _problem(2, 15, 105, 110, 48, nbox, factor)
    assert isinstance(work.D, int)
    assert work.fac.V.shape[-1] == (48 if factor == "cholinv" else 105)
    want = _parent_loop(work, q, l, u, CFG, x, z, y, CFG.iters, box)
    got_op = k4.admm_sweeps(work, q, l, u, CFG.sigma, CFG.alpha, x, z, y,
                            CFG.iters, box)
    got = qp.run_iters(work, q, l, u, CFG, x, z, y, CFG.iters, box)
    for w, a, b in zip(want, got_op, got):
        assert torch.equal(w, a) and torch.equal(w, b)


def test_counter_stays_on_cpu_tensors():
    work, q, l, u, x, z, y, box = _problem(2, 4, 12, 10, 4, 3)
    before = trace.counter(k4.LAUNCHES)
    qp.run_iters(work, q, l, u, CFG, x, z, y, CFG.iters, box)
    assert trace.counter(k4.LAUNCHES) == before


@pytest.mark.parametrize("factor, path", [
    ("cholinv", "kernel"), ("pallas", "kernel"), ("babe", "plain"),
    ("cyclic", "plain"), ("dense", "plain")])
def test_run_iters_path(factor, path):
    """A BlockTridiagFactor with the int pattern goes to the op; BABE,
    cyclic and a dense D keep the plain loop: the span says which, and
    both give the parent's loop."""
    work, q, l, u, x, z, y, box = _problem(2, 4, 12, 10, 4, 3, factor)
    trace.reset()
    trace.enable()
    try:
        got = qp.run_iters(work, q, l, u, CFG, x, z, y, CFG.iters, box)
    finally:
        trace.disable()
    spans = [s for s in trace.spans() if s.name == "qp.sweeps"]
    trace.reset()
    assert [s.attrs for s in spans] == [{"iters": CFG.iters, "path": path}]
    want = _parent_loop(work, q, l, u, CFG, x, z, y, CFG.iters, box)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _op_args(Bs=2, K=4, s=12, md=10, k=4, nbox=3):
    work, q, l, u, x, z, y, box = _problem(Bs, K, s, md, k, nbox)
    f = work.fac
    return dict(Linv=f.Linv, W=f.W, V=f.V, A=work.A, D=work.D, box_idx=box,
                rho=work.rho_vec, q=q, l=l, u=u, x=x, z=z, y=y, iters=3)


def test_check_takes_the_hot_shapes():
    k4._check(**_op_args())
    assert k4.smem_bytes(15, 105, 48, 110, 164, 54) <= k4.MAX_SMEM
    assert k4.smem_bytes(31, 105, 105, 110, 164, 54) <= k4.MAX_SMEM


@pytest.mark.parametrize("change, match", [
    (dict(q=lambda t: t.double()), "float32"),
    (dict(Linv=lambda t: t[0]), "Linv"),
    (dict(V=lambda t: t[..., :1, :]), "V"),
    (dict(z=lambda t: t[..., :-1]), "z"),
    (dict(box_idx=lambda t: t.int()), "int64"),
    (dict(iters=lambda t: 0), "iters"),
    (dict(D=lambda t: 11), "D="),
])
def test_check_refuses(change, match):
    args = _op_args()
    for name, fn in change.items():
        args[name] = fn(args[name])
    with pytest.raises(ValueError, match=match):
        k4._check(**args)


@pytest.mark.parametrize("K, s, md, nbox, match", [
    (200, 105, 110, 54, "shared memory"),  # K beyond the plan
    (4, 129, 10, 3, "s <= 128"),         # s beyond a warp's four columns
    (4, 12, 10, 40000, "shared memory"),  # m beyond the plan
])
def test_check_refuses_oversize(K, s, md, nbox, match):
    Bs, N = 1, K - 1
    m = md + nbox
    e = torch.empty
    args = dict(Linv=e(Bs, K, s, s), W=e(Bs, K, s, s), V=e(Bs, K, s, 4),
                A=e(Bs, N, md, s), D=4,
                box_idx=torch.zeros(nbox, dtype=torch.int64), rho=e(Bs, N, m),
                q=e(Bs, K, s), l=e(Bs, N, m), u=e(Bs, N, m), x=e(Bs, K, s),
                z=e(Bs, N, m), y=e(Bs, N, m), iters=1)
    with pytest.raises(ValueError, match=match):
        k4._check(**args)


def test_fake_shapes():
    args = _op_args()
    iters = args.pop("iters")
    with FakeTensorMode() as mode:
        fake = {k: mode.from_tensor(v) if isinstance(v, torch.Tensor) else v
                for k, v in args.items()}
        x, z, y = torch.ops.tpu_locoman_torch.admm_sweeps(
            fake["Linv"], fake["W"], fake["V"], fake["A"], fake["D"],
            fake["box_idx"], fake["rho"], fake["q"], fake["l"], fake["u"],
            fake["x"], fake["z"], fake["y"], CFG.sigma, CFG.alpha, iters)
    assert (x.shape, z.shape, y.shape) == (args["x"].shape, args["z"].shape,
                                           args["y"].shape)
    assert x.dtype == z.dtype == y.dtype == torch.float32


def test_sweep_bytes_at_the_flagship():
    """The bytes each sweep reads per scenario at (15, 105, 48, 110, 164):
    the plain loop's products read 3.58 MB of blocks, the kernel 2.27 MB."""
    blocks = 4 * (3 * 15 * 105 + 7 * 14 * 164)
    assert k4.sweep_bytes(15, 105, 48, 110, 164, once=False) - blocks == (
        4 * (15 * (3 * 105 ** 2 + 105 * 48) + 2 * 14 * 110 * 105))
    assert k4.sweep_bytes(15, 105, 48, 110, 164) - blocks == (
        4 * (15 * (2 * 105 ** 2 + 105 * 48) + 14 * 110 * 105))
