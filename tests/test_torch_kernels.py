"""The plain PyTorch versions of the port's three kernels against the Pallas
TPU kernels they replace, run in interpret mode as the JAX package's own
tests run them off-TPU (tests/test_pallas_rbda.py, tests/test_qp.py).

The CUDA kernels themselves run only on the GPU; chip_smoke.py holds each
one against these plain versions there. Here: the wrappers' CPU dispatch
and checks, and the build key.

K1 (``chol_inv_node``) takes a whole node block on the card; its plain
version is the recursive ``chol_inv`` with plain leaves, held here against
JAX's ``chol_inv(base_impl="pallas")`` (the TPU kernel at the leaves).

Tolerances: K2 atol 2e-4 * (max|ref| + 1) as test_pallas_rbda.py; K1 and
the factorize+solve path 1e-4 * (max|ref| + 1) as test_qp.py (the plain
version and the Pallas kernel share the algorithm, not the f32 summation
order); K3 atol 1e-5 as test_qp.py's test_pallas_factorize_matches_xla."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tpu_locoman as J  # noqa: E402
from tpu_locoman.pallas_rbda import rnea_derivatives_pallas  # noqa: E402
from tpu_locoman.solver import qp as jqp  # noqa: E402
from tpu_locoman.solver.pallas_base import chol_inv_base_batched  # noqa: E402
from tpu_locoman.solver.pallas_fac import factorize_pallas  # noqa: E402
import tpu_locoman_torch as T  # noqa: E402
from tpu_locoman_torch import rnea_derivs, trace  # noqa: E402
from tpu_locoman_torch.solver import chol_base, fac_whole  # noqa: E402
from tpu_locoman_torch.solver import qp as tqp  # noqa: E402


def _spd(rng, B, b):
    A = rng.standard_normal((B, b, b)).astype(np.float32)
    return A @ A.transpose(0, 2, 1) + b * np.eye(b, dtype=np.float32)


@pytest.mark.parametrize("with_forces", [True, False])
def test_k2_plain_matches_pallas_interpret(with_forces):
    jrob, trob = J.B2G(), T.B2G()
    m = jrob.model
    B = 5  # the Pallas pad-to-128 path
    rng = np.random.default_rng(11)
    q = np.tile(np.asarray(jrob.q0, np.float32), (B, 1))
    quat = rng.standard_normal((B, 4)).astype(np.float32)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] += rng.standard_normal((B, m.nq - 7)).astype(np.float32) * 0.3
    v = rng.standard_normal((B, m.nv)).astype(np.float32)
    a = rng.standard_normal((B, m.nv)).astype(np.float32)
    ee = tuple(jrob.FOOT_FRAMES) + (jrob.ext_force_frame,)
    f = rng.standard_normal((B, 3 * len(ee))).astype(np.float32) * 30.0
    if with_forces:
        ref = rnea_derivatives_pallas(m, q, v, a, ee, f, interpret=True)
        args = (torch.tensor(q), torch.tensor(v), torch.tensor(a), ee,
                torch.tensor(f))
    else:
        ref = rnea_derivatives_pallas(m, q, v, a, interpret=True)
        args = (torch.tensor(q), torch.tensor(v), torch.tensor(a))
    before = trace.counter(rnea_derivs.LAUNCHES)
    out = rnea_derivs.rnea_derivatives(trob.model, *args)
    # CPU tensors: plain version
    assert trace.counter(rnea_derivs.LAUNCHES) == before
    assert len(out) == len(ref) == (4 if with_forces else 3)
    for o, r in zip(out, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r,
                                   atol=2e-4 * (np.abs(r).max() + 1))


@pytest.mark.parametrize("name", ["B2G", "Go2"])
def test_k2_tree_table_rebuilds_the_ancestry(name):
    """The table the K2 kernel walks holds exactly the ancestry: its live
    pairs are the ones of ancestry_mask(), each dof's column is its link's
    subtree range, the live (dof, column) pairs are those of
    anc[dof_link], and the live outputs those that share a moved link,
    each summed over the deeper link's subtree."""
    m = getattr(T, name)().model
    anc = m.ancestry_mask()
    tab = rnea_derivs.tree_table(m.parent)
    live = np.zeros_like(anc)
    live[tab.pairs[:, 0], tab.pairs[:, 1]] = 1.0
    np.testing.assert_array_equal(live, anc)
    for j, L in enumerate(m.dof_link()):
        col = np.zeros(m.n_links)
        col[tab.lo[L]:tab.hi[L]] = 1.0
        np.testing.assert_array_equal(col, anc[:, j])
        # column j's pairs start at col_off[j], links ascending
        seg = tab.pairs[tab.col_off[j]:tab.col_off[j] + tab.hi[L] - tab.lo[L]]
        np.testing.assert_array_equal(seg, [(i, j) for i in
                                            range(tab.lo[L], tab.hi[L])])
    wlive = np.zeros((m.nv, m.nv))
    wlive[tab.wpairs[:, 0], tab.wpairs[:, 1]] = 1.0
    np.testing.assert_array_equal(wlive, anc[m.dof_link()])
    for q, (mm, j) in enumerate(tab.wpairs):
        assert tab.wcol_off[j] + mm == q
    shared = anc.T @ anc  # [k, j]: links moved by both dofs
    olive = np.zeros((m.nv, m.nv))
    olive[tab.outs[:, 0], tab.outs[:, 1]] = 1.0
    np.testing.assert_array_equal(olive, shared > 0)
    for k, j, L in tab.outs:
        assert tab.hi[L] - tab.lo[L] == shared[k, j]


@pytest.mark.parametrize("name", ["B2G", "Go2"])
def test_k2_packed_table_walks_and_children(name):
    """The records the kernel reads: each live pair's walk is the ancestor
    dofs of its link that its column's dof moves, ascending; each pair
    with children lists exactly its link's children, by depth; each live
    output points at the pair of its subtree's link."""
    m = getattr(T, name)().model
    anc, dl = m.ancestry_mask(), m.dof_link()
    tab = rnea_derivs.tree_table(m.parent)
    words = rnea_derivs.pack_table(tab, [3]).view(np.uint32).astype(np.int64)
    n, nv, npairs = m.n_links, m.nv, len(tab.pairs)
    lvl = words[2 * n + nv + 1:2 * n + nv + 2 + rnea_derivs.MAX_DEPTH]
    at = -(-(2 * n + nv + 2 + rnea_derivs.MAX_DEPTH) // 4) * 4
    pairs = words[at:at + 4 * npairs].reshape(-1, 4)
    for (i, j), r in zip(tab.pairs, pairs):
        assert (r[0] & 255, r[0] >> 8 & 255) == (i, j)
        code = int(r[1]) | int(r[2]) << 32
        walk = [5 + (code >> 8 * c & 255) for c in range(r[0] >> 16 & 255)]
        dofs = list(range(6)) * int(r[0] >> 24) + walk
        assert dofs == [mm for mm in range(nv) if anc[i, mm] and anc[dl[mm], j]]
    sub = words[at + 4 * npairs:at + 4 * (npairs + lvl[-1])].reshape(-1, 4)
    with_children = [p for p, (i, _) in enumerate(tab.pairs)
                     if (tab.parent == i).any()]
    assert sorted(sub[:, 0] & 0xFFFF) == with_children
    for d in range(rnea_derivs.MAX_DEPTH):
        for r in sub[lvl[d]:lvl[d + 1]]:
            i = tab.pairs[r[0] & 0xFFFF, 0]
            offs = [int(r[1 + c // 4]) >> 8 * (c % 4) & 255
                    for c in range(r[0] >> 16)]
            assert tab.depth[i] == d
            assert [i + o for o in offs] == list(np.flatnonzero(tab.parent == i))
    outs = words[at + 4 * (npairs + lvl[-1]) + 2 * len(tab.wpairs):][
        :2 * len(tab.outs)].reshape(-1, 2)
    for (k, j, L), r in zip(tab.outs, outs):
        assert tuple(tab.pairs[r[1] & 0xFFFF]) == (L, j)
        assert r[1] >> 16 == tab.hi[L] - tab.lo[L]
        assert (r[0] >> 24) == (L == dl[k])


@pytest.mark.parametrize("parent", [(-1, 0, 1, 0, 2), (-1, 0, 2, 1),
                                    (-1, 0, 1, 2, 3, 4, 5, 6, 7)])
def test_k2_tree_table_rejects_what_the_kernel_cannot_walk(parent):
    """A subtree that is not a range of links (link 4 under link 1 after
    link 3), a parent after its child, or a tree deeper than the kernel's
    path table raises."""
    with pytest.raises(ValueError):
        rnea_derivs.tree_table(parent)


@pytest.mark.parametrize("B", [5, 130])
@pytest.mark.parametrize("b", [13, 14, 16])
def test_k1_plain_matches_pallas_interpret(b, B):
    S = _spd(np.random.default_rng(b * 1000 + B), B, b)
    ref = np.asarray(chol_inv_base_batched(jnp.asarray(S), interpret=True))
    before = trace.counter(chol_base.LAUNCHES)
    out = chol_base.chol_inv_node(torch.tensor(S)).numpy()
    assert trace.counter(chol_base.LAUNCHES) == before
    # b <= 16: the plain version is the recursion's plain leaf itself
    np.testing.assert_array_equal(
        out, chol_base.chol_inv_base_plain(torch.tensor(S)).numpy())
    np.testing.assert_allclose(out, ref, atol=1e-4 * (np.abs(ref).max() + 1))
    # and it is the inverse Cholesky factor: Linv S Linv^T = I
    eye = np.einsum("bij,bjk,blk->bil", out.astype(np.float64), S, out)
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(b), eye.shape),
                               atol=1e-3)


def test_k1_plain_keeps_nan_for_non_spd():
    S = np.tile(np.eye(14, dtype=np.float32), (3, 1, 1))
    S[1] *= -1.0
    out = chol_base.chol_inv_node(torch.tensor(S))
    assert torch.isnan(out[1]).any() and torch.isfinite(out[0]).all()


@pytest.mark.parametrize("s", [78, 110])
def test_k1_node_plain_matches_jax_pallas_interpret(s):
    """K1's plain version (the recursion with plain leaves) against JAX's
    chol_inv with Pallas leaves, vmapped so the leaf kernel fires in
    interpret mode through its custom_vmap rule, at the node widths of the
    Go2 and accurate B2G paths."""
    S = _spd(np.random.default_rng(s), 3, s)
    ref = np.asarray(jax.vmap(functools.partial(
        jqp.chol_inv, base=16, base_impl="pallas"))(jnp.asarray(S))[1])
    before = trace.counter(chol_base.LAUNCHES)
    out = chol_base.chol_inv_node(torch.tensor(S)).numpy()
    # CPU tensors: the plain version
    assert trace.counter(chol_base.LAUNCHES) == before
    np.testing.assert_allclose(out, ref, atol=1e-4 * (np.abs(ref).max() + 1))


@pytest.mark.parametrize("s", [13, 105])
def test_chol_inv_kernel_impl_on_cpu_is_the_plain_recursion(s):
    """chol_inv(base_impl="kernel") on CPU tensors recurses to the plain
    leaves: the same Linv as the plain recursion, and no launch."""
    S = torch.tensor(_spd(np.random.default_rng(s + 1), 2, s))
    before = trace.counter(chol_base.LAUNCHES)
    L, Linv = tqp.chol_inv(S, 16, "kernel")
    assert L is None and trace.counter(chol_base.LAUNCHES) == before
    ref = tqp.chol_inv(S, 16, "torch")[1]
    torch.testing.assert_close(Linv, ref, rtol=0, atol=0)


@pytest.mark.parametrize("s, blocks", [
    (1, [1]), (105, [105]), (112, [112]), (113, [57, 56]),
    (224, [112, 112]), (225, [57, 56, 112]), (300, [75, 75, 75, 75])])
def test_k1_kernel_blocks_tile_s(s, blocks):
    """The blocks chol_inv hands to one K1 launch each on the card: widths
    <= MAX_S that tile s, following the recursion's split."""
    assert tqp.kernel_blocks(s) == blocks
    assert sum(blocks) == s and max(blocks) <= chol_base.MAX_S


def test_k1_wrapper_rejects_what_the_kernel_cannot_take():
    """The checks chol_inv_node makes before a launch: float32, square
    blocks, 1 <= s <= MAX_S."""
    z = torch.zeros
    for S in (z(4, 8, 8, dtype=torch.float64), z(4, 8, 6), z(8),
              z(2, 113, 113)):
        with pytest.raises(ValueError):
            chol_base._check(S)
    chol_base._check(z(2, 112, 112))
    chol_base._check(z(3, 2, 105, 105))


def test_factorize_cholinv_pb_matches_jax_interpret():
    """factorize(chol_impl="cholinv_pb") + solve_factorized against the JAX
    cholinv_pb path vmapped over scenarios (its Pallas base kernel fires in
    interpret mode through the custom_vmap rule, as test_qp.py runs it),
    with skinny couplings U (s, k) as assemble_blocks produces them."""
    rng = np.random.default_rng(12)
    Bs, K, s, k = 3, 5, 40, 24
    A = rng.standard_normal((Bs, K, s, s)).astype(np.float32)
    H = A @ A.transpose(0, 1, 3, 2) + 10 * np.eye(s, dtype=np.float32)
    U = (0.1 * rng.standard_normal((Bs, K - 1, s, k))).astype(np.float32)
    b = rng.standard_normal((Bs, K, s)).astype(np.float32)
    fpb = jax.vmap(functools.partial(jqp.factorize, chol_impl="cholinv_pb"))
    fac = fpb(jnp.asarray(H), jnp.asarray(U))
    ref = np.asarray(jax.vmap(jqp.solve_factorized)(fac, jnp.asarray(b)))
    tfac = tqp.factorize(torch.tensor(H), torch.tensor(U),
                         chol_impl="cholinv_pb")
    for name in ("Linv", "W", "V"):
        r = np.asarray(getattr(fac, name))
        np.testing.assert_allclose(getattr(tfac, name).numpy(), r,
                                   atol=1e-4 * (np.abs(r).max() + 1),
                                   err_msg=name)
    out = tqp.solve_factorized(tfac, torch.tensor(b)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4 * (np.abs(ref).max() + 1))


def test_k3_plain_matches_pallas_interpret():
    """K3's plain version (``factorize_whole`` on CPU tensors) against
    ``factorize_pallas`` in interpret mode at test_qp.py's shape: K=6,
    s=37 (odd: uneven recursion splits), a batch of 2 looped on the JAX
    side. Linv, W, V and solve_factorized. Measured gap: at most 2.4e-7
    absolute; held at 1e-5 as test_qp.py."""
    rng = np.random.default_rng(7)
    Bs, K, s = 2, 6, 37
    A = rng.normal(size=(Bs, K, s, s)).astype(np.float32)
    H = np.einsum("bnij,bnkj->bnik", A, A) / s + 3.0 * np.eye(s, dtype=np.float32)
    U = (0.1 * rng.normal(size=(Bs, K - 1, s, s))).astype(np.float32)
    b = rng.normal(size=(Bs, K, s)).astype(np.float32)
    before = trace.counter(fac_whole.LAUNCHES)
    fac = fac_whole.factorize_whole(torch.tensor(H), torch.tensor(U))
    # CPU tensors: the plain version
    assert trace.counter(fac_whole.LAUNCHES) == before
    x = tqp.solve_factorized(fac, torch.tensor(b)).numpy()
    for i in range(Bs):
        ref = factorize_pallas(jnp.asarray(H[i]), jnp.asarray(U[i]),
                               interpret=True)
        for name in ("Linv", "W", "V"):
            np.testing.assert_allclose(getattr(fac, name)[i].numpy(),
                                       np.asarray(getattr(ref, name)),
                                       atol=1e-5, err_msg=f"{name} {i}")
        np.testing.assert_allclose(
            x[i], np.asarray(jqp.solve_factorized(ref, jnp.asarray(b[i]))),
            atol=1e-5)
    assert np.all(fac.W[:, 0].numpy() == 0) and np.all(fac.V[:, -1].numpy() == 0)


def test_k3_plain_keeps_nan_for_non_spd():
    """A non-SPD node block must reach the solver as NaN (the eq-projection
    guard and the status codes depend on it), in its own scenario only."""
    H = np.tile(np.eye(10, dtype=np.float32), (2, 4, 1, 1))
    H[1, 2] *= -1.0
    U = np.zeros((2, 3, 10, 10), np.float32)
    fac = fac_whole.factorize_whole(torch.tensor(H), torch.tensor(U))
    assert torch.isnan(fac.Linv[1, 2]).any()
    assert torch.isfinite(fac.Linv[0]).all()


def test_k3_wrapper_rejects_what_the_kernel_cannot_take():
    """The checks the wrapper makes before a launch: float32, full-width U,
    s <= MAX_S."""
    z = torch.zeros
    for H, U in ((z(1, 3, 8, 8), z(1, 2, 8, 4)),
                 (z(1, 3, 8, 8, dtype=torch.float64), z(1, 2, 8, 8)),
                 (z(1, 3, 120, 120), z(1, 2, 120, 120))):
        with pytest.raises(ValueError):
            fac_whole._check(H, U)
    fac_whole._check(z(1, 3, 112, 112), z(1, 2, 112, 112))


def test_build_key_is_stable(tmp_path):
    """The kernel build directory is keyed by the sources, headers included,
    and the flags alone (the build itself needs nvcc and runs on the GPU
    machine): editing a header changes the key."""
    import shutil

    from tpu_locoman_torch import _build

    srcs = _build._sources()
    assert [s.rsplit("/", 1)[-1] for s in srcs] == ["admm_sweeps.cu",
                                                    "chol_inv_node.cu",
                                                    "chol_tile.cuh",
                                                    "fac_whole.cu",
                                                    "rnea_derivs.cu"]
    assert set(_build._SIGNATURES) == {"admm_sweeps_launch",
                                       "chol_inv_node_launch",
                                       "fac_whole_launch",
                                       "rnea_derivs_launch"}
    assert _build._digest(srcs) == _build._digest(list(srcs))
    assert "arch=compute_90a,code=sm_90a" in _build.ARCH
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    before = _build._digest(_build._sources(str(copy)))
    assert before == _build._digest(srcs)
    with open(copy / "chol_tile.cuh", "a") as fh:
        fh.write("// edited\n")
    assert _build._digest(_build._sources(str(copy))) != before
