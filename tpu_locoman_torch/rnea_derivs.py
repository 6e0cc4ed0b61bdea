"""K2: analytic RNEA derivatives over a flat batch, as a CUDA kernel.

Replaces the TPU kernel ``rnea_derivatives_pallas`` / ``_rnea_derivs_kernel``
in ``tpu_locoman/pallas_rbda.py``. Contract: for a flat batch of
(q, v, a[, forces_world]) it returns dtau/dq (local tangent), dtau/dv,
dtau/da, each (B, nv, nv), and dtau/df (B, nv, 3 * n_frames) — the same as
mapping ``rbda.rnea_derivatives`` of the JAX package over axis 0.

Split of the work, as on the TPU: the cheap O(n*6) forward quantities
(world motion axes S_w, world inertias, link velocities and accelerations,
body forces, force arms) are computed here in plain batched torch; the
O(n*nv*6) derivative pass runs in ``csrc/rnea_derivs.cu``.

What bounds it on an H100: at the flagship shape (B = 512 scenarios x 14
nodes = 7168 elements, nv = 24, n = 19 links) the bytes, ~106 MB of inputs
and outputs; at accurate batch 1's B = 14, latency. The kernel works on the
live (link, column) pairs of the tree only, as tree recursions, from a
table built here once per robot (``tree_table``, ``pack_table``); every
intermediate stays in shared memory; one CTA per element, of two warps at
large B and of eight at small B (``lanes_per_element``). See the source
note in ``csrc/rnea_derivs.cu``.

``derivative_pass`` is the kernel's wrapper. It calls the custom op
``tpu_locoman_torch::rnea_derivs`` on both devices, with the packed tree
table as a tensor argument and its sizes as ints, so that an exported
program (``aot.py``) holds the pass as one node: the op's CPU
implementation is the plain version (the tree's index constants rebuilt
from the table), its CUDA implementation launches the kernel or raises.
``rnea_derivatives`` is the forward pass followed by ``derivative_pass``.
"""

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import rbda
from .rbda import cross, motion_cross, motion_cross_star

#: kernel launches made by ``derivative_pass`` (the CUDA path only)
launches = 0


def forward_quantities(model, q, v, a, ee_frames=(), forces_world=None):
    """World-frame forward pass shared by the kernel and the plain version.

    Returns a dict of (B, ...) float32 tensors: Sw (nv, 6), Iw (n, 6, 6),
    Vl, A, Iv, IA, f (n, 6) with f WITHOUT the external forces, sdot
    (nv, 6), and pf (n_frames, 3) frame positions."""
    T = model.tensors(q.device)
    anc, dof_link = T["anc"], T["dof_link"]
    R_w, p_w = rbda.fk(model, q)
    Sw = rbda.world_motion_axes(model, R_w, p_w)
    Iw = rbda.world_inertias(model, R_w, p_w)
    sv = Sw * v[..., None]
    Vl = torch.einsum("nm,bmd->bnd", anc, sv)
    sdot = motion_cross(Vl[:, dof_link], Sw)
    sa = Sw * a[..., None] + sdot * v[..., None]
    A = torch.einsum("nm,bmd->bnd", anc, sa) + T["g_spatial"]
    Iv = rbda.mv(Iw, Vl)
    IA = rbda.mv(Iw, A)
    f = IA + motion_cross_star(Vl, Iv)
    if forces_world is not None and len(ee_frames) > 0:
        pf = torch.stack([rbda.frame_placement(model, fn, R_w, p_w)[1]
                          for fn in ee_frames], dim=1)
    else:
        pf = q.new_zeros(q.shape[0], 0, 3)
    return {"Sw": Sw, "Iw": Iw, "Vl": Vl, "A": A, "Iv": Iv, "IA": IA,
            "f": f, "sdot": sdot, "pf": pf}


def rnea_derivatives_plain(model, q, v, a, ee_frames=(), forces_world=None):
    """Plain PyTorch version of ``rnea_derivatives`` on any device."""
    fq = forward_quantities(model, q, v, a, ee_frames, forces_world)
    return derivative_pass_plain(model, fq, v, a, ee_frames, forces_world)


def derivative_pass_plain(model, fq, v, a, ee_frames=(), forces_world=None):
    """Plain PyTorch version of the kernel (port of
    ``_rnea_derivatives_flat``, with the batch leading): the analytic
    world-frame derivation of ``rbda.rnea_derivatives`` as masked einsums,
    from the forward quantities ``fq``."""
    T = model.tensors(v.device)
    with_f = forces_world is not None and len(ee_frames) > 0
    ee_joint = ([model.frames[fn].parent_joint for fn in ee_frames]
                if with_f else [])
    return _pass_plain(T["anc"], T["dof_link"], T["DM"], ee_joint, fq, v, a,
                       forces_world if with_f else None)


def _pass_plain(anc, dof_link, DM, ee_joint, fq, v, a, forces_world):
    """The plain pass on the tree's index constants: ``anc`` (n, nv),
    ``dof_link`` (nv,), ``DM`` = anc[dof_link] and the force frames'
    joints ``ee_joint``."""
    AL = anc[None, :, :, None]  # (1, n, nv, 1)
    Sw, Iw, Vl, A = fq["Sw"], fq["Iw"], fq["Vl"], fq["A"]
    Iv, IA, f, sdot = fq["Iv"], fq["IA"], fq["f"], fq["sdot"]
    sv = Sw * v[..., None]

    def I_dot(X):  # (B, n, j, 6) -> I_n X
        return torch.einsum("bnde,bnje->bnjd", Iw, X)

    S_j = Sw[:, None]  # (B, 1, nv, 6)
    # d/da: the CRBA quadratic form
    ISm = torch.einsum("bnde,bme->bnmd", Iw, Sw)
    Z = torch.einsum("nk,bnmd->bkmd", anc, AL * ISm)
    dtau_da = torch.einsum("bkd,bkmd->bkm", Sw, Z)

    # shared: dV_q[i, j] = s_j x sum_m anc[i, m] DM[m, j] sv_m
    Vt = torch.einsum("nm,mj,bmd->bnjd", anc, DM, sv)
    dV_q = motion_cross(S_j, Vt)

    # d/dv
    dV_v = AL * S_j
    dA_v = dV_q + AL * sdot[:, None]
    df_v = (I_dot(dA_v) + motion_cross_star(dV_v, Iv[:, :, None])
            + motion_cross_star(Vl[:, :, None], I_dot(dV_v)))
    dtau_dv = torch.einsum("nk,bkd,bnmd->bkm", anc, Sw, df_v)

    # d/dq (local tangent)
    crossSS = motion_cross(Sw[:, None, :, :], Sw[:, :, None, :])  # s_j x s_m
    dS = DM[None, :, :, None] * crossSS
    dsdot = (motion_cross(dV_q[:, dof_link], Sw[:, :, None])
             + DM[None, :, :, None]
             * motion_cross(Vl[:, dof_link][:, :, None], crossSS))
    dA_q = torch.einsum("nm,bmjd->bnjd", anc,
                        dS * a[:, :, None, None] + dsdot * v[:, :, None, None])
    dIA = AL * (motion_cross_star(S_j, IA[:, :, None])
                - I_dot(motion_cross(S_j, A[:, :, None]))) + I_dot(dA_q)
    dIv = AL * (motion_cross_star(S_j, Iv[:, :, None])
                - I_dot(motion_cross(S_j, Vl[:, :, None]))) + I_dot(dV_q)
    df_q = (dIA + motion_cross_star(dV_q, Iv[:, :, None])
            + motion_cross_star(Vl[:, :, None], dIv))

    dtau_df = None
    if forces_world is not None and len(ee_joint) > 0:
        f = f.clone()
        cols = []
        for idx, jid in enumerate(ee_joint):
            fw = forces_world[:, 3 * idx:3 * idx + 3]
            p_f = fq["pf"][:, idx]
            f[:, jid] = f[:, jid] - torch.cat([fw, cross(p_f, fw)], -1)
            arm = Sw[..., :3] + cross(Sw[..., 3:], p_f[:, None])  # (B, nv, 3)
            dp_f = anc[jid][None, :, None] * arm
            dFx = torch.cat([torch.zeros_like(dp_f),
                             cross(dp_f, fw[:, None])], -1)
            df_q[:, jid] = df_q[:, jid] - dFx
            cols.append(-anc[jid][None, :, None] * arm)
        dtau_df = torch.cat(cols, dim=-1)

    F_dof = torch.einsum("nk,bnd->bkd", anc, f)
    dtau_dq = (torch.einsum("bkjd,bkd->bkj", dS, F_dof)
               + torch.einsum("nk,bkd,bnjd->bkj", anc, Sw, df_q))
    outs = (dtau_dq, dtau_dv, dtau_da)
    return outs + (dtau_df,) if dtau_df is not None else outs


#: longest root-to-link path the kernel takes, root included (csrc MAXD)
MAX_DEPTH = 8


class TreeTable(NamedTuple):
    """The kinematic tree as the kernel walks it. Links are in depth-first
    order (``parent[i] < i`` and every subtree a range), so the subtree of
    link L is the links ``[lo[L], hi[L])``; dof j is carried by link
    ``dof_link[j]`` and moves exactly the links of its subtree."""

    parent: np.ndarray  # (n,)
    depth: np.ndarray  # (n,)
    lo: np.ndarray  # (n,)
    hi: np.ndarray  # (n,)
    path: np.ndarray  # (n, MAX_DEPTH) links from the root to i, -1 after
    dof_link: np.ndarray  # (nv,)
    # live (link i, column j) pairs, column by column, links ascending:
    # the kernel's storage order; column j's start in it
    pairs: np.ndarray  # (np, 2)
    col_off: np.ndarray  # (nv,)
    # live (dof m, column j) pairs, the same way; (m, j) at wcol_off[j] + m
    wpairs: np.ndarray  # (nw, 2)
    wcol_off: np.ndarray  # (nv,)
    # live outputs (k, j, link whose subtree the contraction sums)
    outs: np.ndarray  # (no, 3)


def tree_table(parent):
    """The TreeTable of a tree given by its parent array (``parent[0]`` is
    the free-flyer base). Raises unless ``parent[i] < i`` and every subtree
    is a contiguous range of links."""
    n = len(parent)
    if n > 255 or any(not 0 <= parent[i] < i for i in range(1, n)):
        raise ValueError("the RNEA derivative kernel needs parent[i] < i "
                         "and at most 255 links")
    depth = np.zeros(n, np.int32)
    path = np.full((n, MAX_DEPTH), -1, np.int32)
    anc = np.eye(n, dtype=bool)  # anc[i, L]: L is i or an ancestor of i
    for i in range(1, n):
        depth[i] = depth[parent[i]] + 1
        anc[i] |= anc[parent[i]]
    if depth.max() >= MAX_DEPTH:
        raise ValueError(f"the RNEA derivative kernel takes trees of depth "
                         f"< {MAX_DEPTH}")
    lo = np.arange(n, dtype=np.int32)
    hi = lo + anc.sum(0).astype(np.int32)
    for L in range(n):
        if not anc[L:hi[L], L].all():
            raise ValueError(f"the subtree of link {L} is not a contiguous "
                             f"range of links: order the links depth first")
        path[L, :depth[L] + 1] = np.flatnonzero(anc[L])
    dof_link = np.array([0] * 6 + list(range(1, n)), np.int32)
    nv = len(dof_link)
    pairs, col_off, wpairs, wcol_off = [], [], [], []
    for j in range(nv):
        L = dof_link[j]
        col_off.append(len(pairs))
        pairs += [(i, j) for i in range(lo[L], hi[L])]
        dofs = [m for m in range(nv) if lo[L] <= dof_link[m] < hi[L]]
        wcol_off.append(len(wpairs) - dofs[0])
        wpairs += [(m, j) for m in dofs]
    outs = []
    for k in range(nv):
        for j in range(nv):
            lk, lj = dof_link[k], dof_link[j]
            if anc[lk, lj]:
                outs.append((k, j, lk))
            elif anc[lj, lk]:
                outs.append((k, j, lj))
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    return TreeTable(i32(parent), depth, lo, hi, path, dof_link, i32(pairs),
                     i32(col_off), i32(wpairs), i32(wcol_off), i32(outs))


def pack_table(tab, ee_joint):
    """The int32 table the kernel reads. Sections, in order: lo (n), hi
    (n), dof_link (nv), each force frame's joint (nfr), lvl_off (MAX_DEPTH
    + 1: where the pairs with children of each link depth start), zeros to
    a multiple of 4; then one record per live pair (4 ints: i | j << 8 |
    count << 16 | base << 24, the links of its walk one byte each in two
    ints, and w's offset for column j), per live pair with children (4
    ints: its index | count << 16, then its children's pair offsets, one
    byte each), per live (dof, column) pair (2 ints: m | j << 8 | link(m)
    << 16, the pair index of (link(m), j)), per live output (2 ints: k |
    j << 8 | link(k) << 16 | [dof j moves link(k)] << 24, the pair index
    of (its subtree's link, j) | the subtree's size << 16), and last a
    bitmask of the live outputs (bit k * nv + j)."""
    nv = len(tab.dof_link)
    pairs = np.zeros((len(tab.pairs), 4), np.int64)
    for p, (i, j) in enumerate(tab.pairs):
        L = tab.dof_link[j]
        base = int(L == 0)
        walk = tab.path[i, tab.depth[L] + base:tab.depth[i] + 1]
        code = sum(int(link) << 8 * c for c, link in enumerate(walk))
        pairs[p] = (i | j << 8 | len(walk) << 16 | base << 24,
                    code & 0xFFFFFFFF, code >> 32, tab.wcol_off[j])
    pair_of = {(i, j): p for p, (i, j) in enumerate(tab.pairs)}
    children = [np.flatnonzero(tab.parent == i) for i in range(len(tab.lo))]
    if max(len(c) for c in children) > 12:
        raise ValueError("the RNEA derivative kernel takes links with at "
                         "most 12 children")
    sub, lvl_off = [], []
    for d in range(MAX_DEPTH):
        lvl_off.append(len(sub))
        for p, (i, j) in enumerate(tab.pairs):
            if tab.depth[i] != d or not len(children[i]):
                continue
            words = np.zeros(12, np.int64)
            words[:len(children[i])] = children[i] - i
            sub.append([p | len(children[i]) << 16]
                       + list((words.reshape(3, 4) << 8 * np.arange(4)).sum(1)))
    lvl_off.append(len(sub))
    head = np.concatenate([tab.lo, tab.hi, tab.dof_link,
                           np.asarray(ee_joint, np.int32), lvl_off])
    head = np.concatenate([head, np.zeros(-len(head) % 4, np.int32)])
    w = [(m | j << 8 | tab.dof_link[m] << 16, pair_of[tab.dof_link[m], j])
         for m, j in tab.wpairs]
    outs = [(k | j << 8 | tab.dof_link[k] << 16
             | int(L == tab.dof_link[k]) << 24,
             pair_of[L, j] | (tab.hi[L] - tab.lo[L]) << 16)
            for k, j, L in tab.outs]
    live = np.zeros(-(-nv * nv // 32) * 32, np.int64)
    live[tab.outs[:, 0] * nv + tab.outs[:, 1]] = 1
    mask = (live.reshape(-1, 32) << np.arange(32)).sum(1)
    words = np.concatenate([head, pairs.ravel(), np.ravel(sub), np.ravel(w),
                            np.ravel(outs), mask])
    return words.astype(np.uint32).view(np.int32)


def _topology(model, ee_frames, device):
    """(TreeTable, the packed table on ``device``), cached per robot and
    force frames beside the model's tensors."""
    cache = model.tensors(device)
    key = ("_k2_topo", tuple(ee_frames))
    if key not in cache:
        if "_k2_tree" not in cache:
            cache["_k2_tree"] = tree_table(model.parent)
        tab = cache["_k2_tree"]
        ee_joint = [model.frames[fn].parent_joint for fn in ee_frames]
        cache[key] = (tab, torch.as_tensor(pack_table(tab, ee_joint),
                                           device=device))
    return cache[key]


_sm_count = {}  # SMs per CUDA device index


def lanes_per_element(B, device):
    """Threads per element of the launch: two warps (up to 10 elements per
    SM, as shared memory allows) once B gives every SM four elements or
    more, else eight warps, so that a small batch (accurate mode's 14)
    spreads each element's pairs over a whole SM."""
    index = torch.device(device).index or 0
    if index not in _sm_count:
        _sm_count[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return 64 if B >= 4 * _sm_count[index] else 256


def _check(x, shape, name):
    if x.dtype != torch.float32 or not x.is_cuda or not x.is_contiguous():
        raise ValueError(f"{name}: need a contiguous float32 CUDA tensor")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)} != {tuple(shape)}")


_FQ = ("Sw", "Iw", "sdot", "Vl", "A", "Iv", "IA", "f", "pf")


def _table_constants(topo, n, nv, nfr, dtype):
    """(anc, dof_link, DM, ee_joint) read back from the packed table's
    head (lo, hi, dof_link, the force frames' joints): dof j moves link i
    when i lies in the subtree [lo, hi) of the link that carries j."""
    head = topo[:2 * n + nv + nfr].long()
    lo, hi, dof_link = head[:n], head[n:2 * n], head[2 * n:2 * n + nv]
    links = torch.arange(n, device=topo.device)[:, None]
    anc = ((links >= lo[dof_link]) & (links < hi[dof_link])).to(dtype)
    return anc, dof_link, anc[dof_link], head[2 * n + nv:].tolist()


@torch.library.custom_op("tpu_locoman_torch::rnea_derivs", mutates_args=(),
                         device_types="cpu")
def _op(topo: torch.Tensor, Sw: torch.Tensor, Iw: torch.Tensor,
        sdot: torch.Tensor, Vl: torch.Tensor, A: torch.Tensor,
        Iv: torch.Tensor, IA: torch.Tensor, f: torch.Tensor, pf: torch.Tensor,
        v: torch.Tensor, a: torch.Tensor, fw: torch.Tensor, n: int, nv: int,
        nfr: int, n_pairs: int, n_wpairs: int, n_outs: int
        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    anc, dof_link, DM, ee_joint = _table_constants(topo, n, nv, nfr, v.dtype)
    fq = dict(zip(_FQ, (Sw, Iw, sdot, Vl, A, Iv, IA, f, pf)))
    outs = _pass_plain(anc, dof_link, DM, ee_joint, fq, v, a,
                       fw if nfr else None)
    df = outs[3] if nfr else v.new_zeros(v.shape[0], nv, 1)
    return outs[0], outs[1], outs[2], df


@_op.register_kernel("cuda")
def _launch(topo, Sw, Iw, sdot, Vl, A, Iv, IA, f, pf, v, a, fw, n, nv, nfr,
            n_pairs, n_wpairs, n_outs):
    from ._build import load

    global launches
    B = v.shape[0]
    shapes = {"Sw": (B, nv, 6), "Iw": (B, n, 6, 6), "sdot": (B, nv, 6),
              "Vl": (B, n, 6), "A": (B, n, 6), "Iv": (B, n, 6),
              "IA": (B, n, 6), "f": (B, n, 6), "pf": (B, nfr, 3),
              "v": (B, nv), "a": (B, nv), "forces_world": (B, 3 * nfr)}
    ins = (Sw, Iw, sdot, Vl, A, Iv, IA, f, pf, v, a, fw)
    for x, (name, shp) in zip(ins, shapes.items()):
        _check(x, shp, name)
    dq = torch.empty(B, nv, nv, dtype=torch.float32, device=v.device)
    dv = torch.empty_like(dq)
    da = torch.empty_like(dq)
    df = torch.empty(B, nv, max(3 * nfr, 1), dtype=torch.float32,
                     device=v.device)
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = torch.cuda.current_stream(v.device).cuda_stream
    rc = load().rnea_derivs_launch(
        p(topo), p(Sw), p(Iw), p(v), p(a), p(sdot), p(Vl), p(A), p(Iv),
        p(IA), p(f), p(pf), p(fw), p(dq), p(dv), p(da), p(df),
        *(ctypes.c_int(x) for x in (
            B, n, nv, nfr, n_pairs, n_wpairs, n_outs,
            lanes_per_element(B, v.device))),
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"rnea_derivs kernel launch failed: CUDA error {rc}")
    launches += 1
    return dq, dv, da, df


@_op.register_fake
def _(topo, Sw, Iw, sdot, Vl, A, Iv, IA, f, pf, v, a, fw, n, nv, nfr,
      n_pairs, n_wpairs, n_outs):
    B = v.shape[0]
    dq = v.new_empty(B, nv, nv)
    return dq, torch.empty_like(dq), torch.empty_like(dq), v.new_empty(
        B, nv, max(3 * nfr, 1))


def derivative_pass(model, fq, v, a, ee_frames=(), forces_world=None):
    """The kernel's wrapper: the derivative pass from the forward
    quantities ``fq``, through the op (CPU tensors take the plain version;
    CUDA tensors launch the kernel). A CPU tensor inside a ``torch.func``
    transform takes the plain version directly."""
    if not v.is_cuda and torch._C._functorch.is_functorch_wrapped_tensor(v):
        return derivative_pass_plain(model, fq, v, a, ee_frames, forces_world)
    B, nfr = v.shape[0], len(ee_frames)
    tab, topo = _topology(model, ee_frames, v.device)
    fw = forces_world.contiguous() if nfr else v.new_zeros(B, 0)
    out = torch.ops.tpu_locoman_torch.rnea_derivs(
        topo, *(fq[k].contiguous() for k in _FQ), v.contiguous(),
        a.contiguous(), fw, model.n_links, model.nv, nfr, len(tab.pairs),
        len(tab.wpairs), len(tab.outs))
    return out if nfr else out[:3]


def rnea_derivatives(model, q, v, a, ee_frames=(), forces_world=None):
    """(dtau/dq, dtau/dv, dtau/da[, dtau/df]) over a flat batch (B, ...):
    the forward quantities in plain torch, then ``derivative_pass``."""
    with_f = forces_world is not None and len(ee_frames) > 0
    ee = tuple(ee_frames) if with_f else ()
    fw = forces_world if with_f else None
    fq = forward_quantities(model, q, v, a, ee, fw)
    return derivative_pass(model, fq, v, a, ee, fw)
