# SPDX-License-Identifier: CECILL-2.1
"""Top-k symmetric eigenvalues via blocked subspace iteration.

The STA2 sharpness estimator only consumes the top few eigenvalues of the
image covariance (reference metrics/sharpness.py:839 takes k=5 of a full
SVD). A dense ``eigvalsh`` of the (M, M) Gram matrix computes the entire
spectrum with serial QR sweeps. Subspace iteration spends its FLOPs in
(M, M) @ (M, r) matmuls instead: power-iterate an r = k + p block,
re-orthonormalise, then Rayleigh-Ritz an (r, r) problem. Every matmul
runs at ``precision="highest"`` (full fp32; TF32 would cost ~3 digits).

Convergence: eigenvalue i's error decays like (lambda_{r+1}/lambda_i)^(2q).
With the defaults (p=27, q=16) speckle-like covariance spectra agree with
dense eigvalsh to float32 resolution (measured 2e-6 rel on a clustered
2048^2 speckle Gram). The honest limit: a perfectly FLAT spectrum (pure
white noise, lambda ratios ~1) defeats any power method — measured ~1e-3
rel there. Flat-spectrum frames carry no sharpness structure, but callers
ranking near-identical noise-dominated frames should request the exact
dense path (``eig_method="dense"`` on the public estimators).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["topk_eigvalsh_subspace"]


def topk_eigvalsh_subspace(G, k: int, *, oversample: int = 27, iters: int = 16):
    """Top-``k`` eigenvalues (descending) of a symmetric PSD matrix ``G``.

    Matmul-bound compute: ``iters`` rounds of (M, M) @ (M, r) products
    with tall-skinny QR re-orthonormalisation, then an exact (r, r)
    Rayleigh-Ritz solve. Deterministic (fixed PRNG key) so results are
    reproducible run to run.
    """
    M = int(G.shape[-1])
    r = min(M, int(k) + int(oversample))

    start = jax.random.normal(jax.random.PRNGKey(7), (M, r), dtype=G.dtype)
    Q, _ = jnp.linalg.qr(start)

    def body(_, Q):
        Z = jnp.matmul(G, Q, precision="highest")
        Q, _ = jnp.linalg.qr(Z)
        return Q

    Q = jax.lax.fori_loop(0, int(iters), body, Q)

    GQ = jnp.matmul(G, Q, precision="highest")
    T = jnp.matmul(Q.T, GQ, precision="highest")
    T = 0.5 * (T + T.T)  # symmetrise Rayleigh-Ritz rounding
    ev = jnp.linalg.eigvalsh(T)  # ascending, length r
    return jnp.flip(ev, axis=-1)[: int(k)]
