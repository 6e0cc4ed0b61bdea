"""Each scenario's whole block-tridiagonal factorization, in plain PyTorch.
For H (Bs, K, s, s) diagonal blocks and full-width couplings U
(Bs, K-1, s, s) it runs, node by node,

    S_i = H_i - F_{i-1}^T F_{i-1} + 1e-6 I,   Linv_i = chol(S_i)^-1,
    F_i = Linv_i U_i,   W_i = Linv_i F_{i-1}^T,   V_i = Linv_i^T F_i,

and returns the ``BlockTridiagFactor`` (Linv, W, V) that
``solve_factorized`` takes, with the recursive ``chol_inv``."""

import torch

#: widest block the program's K3 takes
MAX_S = 112


def factorize_whole_plain(H, U):
    """Plain PyTorch version: the same recurrence with the recursive
    ``chol_inv`` of ``factorize(chol_impl="cholinv")``."""
    from .qp import factorize

    return factorize(H, U, chol_impl="cholinv")


def factorize_whole(H, U):
    """BlockTridiagFactor of H (Bs, K, s, s) and U (Bs, K-1, s, s): the plain
    recurrence."""
    return factorize_whole_plain(H, U)
