"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit) and the work of the kernel layer's calls, counted from
their shapes, never from what implements them."""

H100_BYTES_PER_S = 3.35e12
H100_F32_PER_S = 67e12


def bound_s(nbytes, ops):
    """The least time the card could take to move ``nbytes`` and do ``ops``
    float32 operations."""
    return max(nbytes / H100_BYTES_PER_S, ops / H100_F32_PER_S)


def factor_work(Bs, K, s):
    """(bytes, f32 operations) of factorizing Bs block-tridiagonal systems
    of K diagonal blocks of size s with full-width couplings. Operations
    per system: Cholesky and inverse 2s^3/3 on every block; the Schur
    update F^T F and W = Linv F_prev^T, s^2(s+1) each, on the K-1 blocks
    with a predecessor; F = Linv U and V = Linv^T F, s^2(s+1) each, on the
    K-1 blocks with a successor. Bytes: the K diagonal and K-1 coupling
    blocks read once, Linv, W and V written once."""
    tri = s * s * (s + 1)
    ops = K * 2 * s ** 3 / 3 + 4 * (K - 1) * tri
    return 4 * Bs * s * s * (K + (K - 1) + 3 * K), Bs * ops


def derivs_bytes(B, nq, nv, nf):
    """Bytes of the RNEA derivatives of B samples: q, v, a and the contact
    forces read once, dtau/dq, dtau/dv, dtau/da (nv x nv each) and dtau/df
    (nv x nf) written once."""
    return 4 * B * (nq + 2 * nv + nf + 3 * nv * nv + nv * nf)
