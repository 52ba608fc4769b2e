"""Two-microphone front ends in PyTorch: WPE dereverberation and AuxIVA
separation, complex64.

Counterpart of ``audiojax.nn.spatial`` (H-GTCRN's in-graph front end).  WPE
solves its multi-frame linear-prediction system per (batch, bin) with a
batched complex conjugate-gradient solver on the eps·I-regularised
Hermitian normal equations; AuxIVA runs auxiliary-function updates with an
analytic 2 × 2 complex solve and projects back to microphone 0.  The CG runs
as a Python loop of ``n_iter`` steps (the JAX package's ``lax.fori_loop``
carries nothing across calls), each column frozen once its residual falls
to 1e-10 of its start: past convergence ``beta`` is rounding noise and the
iteration diverges.  The products are complex64 matrix products (cuBLAS on
the card, TF32 off).
"""
from __future__ import annotations

import torch

__all__ = ["wpe", "auxiva"]


def _sq(z: torch.Tensor) -> torch.Tensor:
    """(conj(z)·z).real = |z|²."""
    return (torch.conj(z) * z).real


def _cg_solve(r_mat: torch.Tensor, p_mat: torch.Tensor, n_iter: int) -> torch.Tensor:
    """Batched complex CG for Hermitian-PSD ``R x = P``.
    r_mat: (..., N, N); p_mat: (..., N, M)."""
    x = torch.zeros_like(p_mat)
    rr = torch.sum(_sq(p_mat), dim=-2) + 1e-12  # (..., M)
    tol = 1e-10 * rr
    r, p = p_mat, p_mat
    for _ in range(n_iter):
        ap = r_mat @ p
        pap = torch.sum((torch.conj(p) * ap).real, dim=-2) + 1e-12
        active = rr > tol
        alpha = torch.where(active, rr / pap, torch.zeros_like(rr))[..., None, :]
        x = x + alpha * p
        r = r - alpha * ap
        rr_new = torch.sum(_sq(r), dim=-2) + 1e-12
        beta = torch.where(active, rr_new / rr, torch.zeros_like(rr))[..., None, :]
        p = r + beta * p
        rr = rr_new
    return x


def wpe(x: torch.Tensor, *, taps: int, delay: int = 2, num_iter: int = 1,
        cg_iter: int = 36) -> torch.Tensor:
    """Weighted prediction error dereverberation.

    x: (B, M, F, T) complex64 → dereverberated, same shape.  ``taps`` =
    rt60·fs/hop prediction frames, after ``delay`` frames."""
    b, m, f, t = x.shape
    xp = x.transpose(1, 2)  # (B, F, M, T)

    # delay bank (B, F, taps·M, T): row (l, m) is x[m] delayed by delay + l
    # frames; rows shifted wholly out of the clip stay zero
    bank = xp.new_zeros((b, f, taps, m, t))
    for lag in range(taps):
        s = min(delay + lag, t)
        bank[:, :, lag, :, s:] = xp[..., : t - s]
    x_delay = bank.reshape(b, f, taps * m, t)

    eps_val = 1e-3 * torch.mean(torch.amax(_sq(xp), dim=(-2, -1)), dim=-1).reshape(-1, 1, 1, 1)

    y = xp
    xp_h = torch.conj(xp.transpose(-2, -1))
    xd_h = torch.conj(x_delay.transpose(-2, -1))
    eye = torch.eye(m * taps, dtype=x.dtype, device=x.device)

    for _ in range(num_iter):
        lam = torch.maximum(torch.mean(_sq(y), dim=2, keepdim=True), eps_val)  # (B, F, 1, T)
        temp = x_delay / lam
        r_mat = temp @ xd_h + eps_val * eye
        p_mat = temp @ xp_h
        g = _cg_solve(r_mat, p_mat, cg_iter)
        y = xp - torch.conj(g).transpose(-2, -1) @ x_delay

    return y.transpose(1, 2)


def _solve_2x2(a_mat: torch.Tensor, rhs: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Analytic 2 × 2 complex solve (Cramer), batched over leading dims.
    a_mat: (..., 2, 2); rhs: (..., 2, 1) → (..., 2, 1)."""
    a, b = a_mat[..., 0, 0], a_mat[..., 0, 1]
    c, d = a_mat[..., 1, 0], a_mat[..., 1, 1]
    det = a * d - b * c
    inv = torch.conj(det) / (torch.abs(det) ** 2 + eps)
    b0, b1 = rhs[..., 0, 0], rhs[..., 1, 0]
    x0 = (d * b0 - b * b1) * inv
    x1 = (a * b1 - c * b0) * inv
    return torch.stack([x0, x1], dim=-1)[..., None]


def auxiva(x: torch.Tensor, *, n_iter: int = 10, eps: float = 1e-10) -> torch.Tensor:
    """AuxIVA blind source separation for two channels.

    x: (B, 2, F, T) complex64 → separated sources (B, 2, F, T), projected
    back to channel 0."""
    b, m, f, t = x.shape
    if m != 2:
        raise ValueError(f"the analytic solve takes exactly 2 channels, got {m}")
    xf = x.transpose(1, 2)  # (B, F, M, T)
    x_h = torch.conj(xf.transpose(-2, -1))
    eye = torch.eye(m, dtype=x.dtype, device=x.device)
    w_rows = [eye[s: s + 1].expand(b, f, 1, m) for s in range(m)]
    eye_eps = eps * eye
    y = xf

    for it in range(n_iter):
        r = 2.0 * torch.sqrt(torch.sum(_sq(y), dim=1) + eps)  # (B, M, T)
        for s in range(m):
            wx = xf * (1.0 / r[:, s])[:, None, None, :]
            v_mat = (wx @ x_h) * (1.0 / t)  # (B, F, M, M)
            wv = v_mat if it == 0 and s == 0 else torch.cat(w_rows, dim=2) @ v_mat
            e_s = eye[:, s: s + 1].expand(b, f, m, 1)
            w_new = _solve_2x2(wv + eye_eps, e_s)
            w_conj = torch.conj(w_new)
            denom = torch.sum((w_conj * (v_mat @ w_new)).real, dim=-2, keepdim=True)
            scale = torch.rsqrt(torch.clamp(denom, min=0.0) + eps)
            w_rows[s] = (w_conj * scale).reshape(b, f, 1, m)
        y = torch.cat(w_rows, dim=2) @ xf

    # projection back to channel 0: num = Σ conj(y)·ref = conj(c)·denom, so
    # num / denom is already the conjugated coefficient
    ref = xf[:, :, 0:1, :]
    num = torch.sum(torch.conj(y) * ref, dim=-1)  # (B, F, M)
    denom = torch.sum(_sq(y), dim=-1)
    valid = denom > 0.0
    coef = torch.where(valid, num / torch.where(valid, denom, torch.ones_like(denom)),
                       torch.ones_like(num))
    return (coef[..., None] * y).transpose(1, 2)
