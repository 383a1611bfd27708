"""Line searches (paper §III-D, Alg. 6).

Port of src/repro/core/linesearch.py:
  - the speculative batched Armijo of the batched sweep: the full α ladder
    α₀·shrinkᵏ, k = 0..K-1, for all B lanes as ONE (K·B, D) value call, and
    the first accepted rung per lane; with `ladder_len = L` (0 < L < K) the
    adaptive ladder: the first L rungs as one call, then one (B, D) call
    per further rung while any lane still searches;
  - the sequential Armijo backtracking and the weak-Wolfe bisection of the
    per-lane sweep. The reference writes each as a scalar `while_loop` that
    `jax.vmap` runs over the lanes; here each is one loop over the whole
    lane stack in which every lane keeps its own loop state, and a lane
    that has finished keeps it while the others go on. The loop ends when
    no lane continues or after `max_iters` rounds.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch


def ladder_alphas(K: int, dtype, alpha0: float = 1.0,
                  shrink: float = 0.5) -> np.ndarray:
    """The host-side α ladder α₀·shrinkᵏ, k = 0..K-1, as a numpy (K,) array,
    by repeated multiplies (cumprod) in the array dtype, so it reproduces a
    sequential alpha *= shrink bit for bit (unlike shrink**k)."""
    npdt = np.dtype(dtype)
    steps = np.full((K,), shrink, npdt)
    steps[0] = npdt.type(1.0)
    return (npdt.type(alpha0) * np.cumprod(steps)).astype(npdt)


@functools.lru_cache(maxsize=None)
def _device_ladder(K: int, alpha0: float, shrink: float,
                   device: torch.device) -> torch.Tensor:
    """ladder_alphas as a float32 tensor on `device`, copied there once per
    (K, α₀, shrink, device) rather than on every sweep."""
    return torch.as_tensor(ladder_alphas(K, np.float32, alpha0, shrink),
                           device=device)


def exhaustion_alpha(K: int, alpha0: float = 1.0, shrink: float = 0.5) -> float:
    """The α a lane takes when it accepts none of the K rungs: α_{K−1}·shrink
    rounded in float32, as the sequential search's last halving and the
    staged ladder's `alphas[-1] * shrink` round it."""
    return float(ladder_alphas(K, np.float32, alpha0, shrink)[-1] * np.float32(shrink))


def armijo_thresholds(F0: torch.Tensor, ddir: torch.Tensor,
                      alphas: torch.Tensor, c1: float) -> torch.Tensor:
    """Armijo accept thresholds f₀ + c1·αₖ·(g₀ᵀp) for all K rungs, (K, B),
    in the reference's operation order: (c1·αₖ)·ddir, then + f₀. Eager
    torch materialises each op, so nothing re-fuses the chain."""
    return F0[None] + c1 * alphas[:, None] * ddir[None]


def ladder_thresholds(F0: torch.Tensor, G0: torch.Tensor, P: torch.Tensor,
                      c1: float, K: int, alpha0: float = 1.0, shrink: float = 0.5):
    """(alphas (K,), rhs (K, B)): the device ladder and the Armijo thresholds
    of a batched search. Every batched program (the full ladder, the
    adaptive ladder, the sweep megakernel) compares against this one
    computation, so all make the same accept decisions."""
    ddir = torch.sum(G0 * P, dim=-1)  # (B,) directional derivatives
    alphas = _device_ladder(K, alpha0, shrink, P.device)
    return alphas, armijo_thresholds(F0, ddir, alphas, c1)


class LineSearchResult(NamedTuple):
    """Per-lane result of the sequential searches, each field (B,)."""

    alpha: torch.Tensor  # accepted step sizes
    # f at the accepted trial; when a lane's search exhausts unaccepted, the
    # last *evaluated* trial (α/shrink for Armijo)
    f_new: torch.Tensor
    n_evals: torch.Tensor  # int32 objective evaluations consumed


def armijo_backtracking(
    value_batch: Callable,
    X: torch.Tensor,  # (B, D)
    P: torch.Tensor,  # (B, D)
    F0: torch.Tensor,  # (B,)
    G0: torch.Tensor,  # (B, D)
    c1: float = 0.3,
    alpha0: float = 1.0,
    shrink: float = 0.5,
    max_iters: int = 20,
) -> LineSearchResult:
    """Alg. 6 per lane: find α with f(x + αp) <= f0 + c1·α·g0ᵀp, halving α
    after each rejected trial. Every round evaluates the whole stack in one
    `value_batch` call (row-independent); only the searching lanes take the
    result. n_evals is a lane's round count, as the reference reports."""
    B = X.shape[0]
    ddir = torch.sum(G0 * P, dim=-1)
    i = torch.zeros((B,), dtype=torch.int32, device=X.device)
    alpha = torch.full((B,), alpha0, dtype=X.dtype, device=X.device)
    f1 = F0
    done = torch.zeros((B,), dtype=torch.bool, device=X.device)
    for _ in range(max_iters):
        searching = ~done
        if not bool(torch.any(searching)):
            break
        ft = value_batch(X + alpha[:, None] * P)
        ok = ft <= F0 + c1 * alpha * ddir
        next_alpha = torch.where(ok, alpha, alpha * shrink)
        alpha = torch.where(searching, next_alpha, alpha)
        f1 = torch.where(searching, ft, f1)
        i = i + searching.to(torch.int32)
        done = done | ok
    return LineSearchResult(alpha=alpha, f_new=f1, n_evals=i)


def wolfe_linesearch(
    value_and_grad_batch: Callable,
    X: torch.Tensor,  # (B, D)
    P: torch.Tensor,  # (B, D)
    F0: torch.Tensor,  # (B,)
    G0: torch.Tensor,  # (B, D)
    c1: float = 1e-4,
    c2: float = 0.9,
    alpha0: float = 1.0,
    max_iters: int = 20,
) -> LineSearchResult:
    """Weak-Wolfe bisection per lane (Lewis & Overton style): keep a
    bracket [lo, hi], expand while Armijo holds but curvature fails,
    bisect when Armijo fails. Each round takes value and gradient of the
    whole stack. n_evals is a lane's round count plus one, as the reference
    reports."""
    B = X.shape[0]
    ddir = torch.sum(G0 * P, dim=-1)
    i = torch.zeros((B,), dtype=torch.int32, device=X.device)
    lo = torch.zeros((B,), dtype=X.dtype, device=X.device)
    hi = torch.full((B,), float("inf"), dtype=X.dtype, device=X.device)
    alpha = torch.full((B,), alpha0, dtype=X.dtype, device=X.device)
    f1 = F0
    done = torch.zeros((B,), dtype=torch.bool, device=X.device)
    for _ in range(max_iters):
        searching = ~done
        if not bool(torch.any(searching)):
            break
        ft, gt = value_and_grad_batch(X + alpha[:, None] * P)
        armijo = ft <= F0 + c1 * alpha * ddir
        curv = torch.sum(gt * P, dim=-1) >= c2 * ddir
        ok = armijo & curv
        new_hi = torch.where(armijo, hi, alpha)
        new_lo = torch.where(armijo & ~curv, alpha, lo)
        new_alpha = torch.where(
            ok, alpha, torch.where(torch.isfinite(new_hi), 0.5 * (new_lo + new_hi),
                                   2.0 * alpha))
        lo = torch.where(searching, new_lo, lo)
        hi = torch.where(searching, new_hi, hi)
        alpha = torch.where(searching, new_alpha, alpha)
        f1 = torch.where(searching, ft, f1)
        i = i + searching.to(torch.int32)
        done = done | ok
    return LineSearchResult(alpha=alpha, f_new=f1, n_evals=i + 1)


class BatchLineSearchResult(NamedTuple):
    alpha: torch.Tensor  # (B,) accepted step sizes
    f_new: torch.Tensor  # (B,) f at the accepted (or last evaluated) trial
    # objective evals per lane: K for the full ladder, L + the fallback
    # rungs run for the adaptive one
    n_evals: int
    rung: torch.Tensor  # (B,) int32 accepted rung, K when exhausted


def rung_tail_fallback_launches(hist, ladder_len: int) -> int:
    """Fallback launches an L-rung ladder implies for an accepted-rung
    histogram `hist` (K + 1 bins; bin K = exhausted): fallback rung
    j ∈ [L, K) launches iff some lane needs it, i.e. iff Σ_{r≥j} hist[r] > 0.
    L <= 0 or L >= K (the full ladder) pays none."""
    h = np.asarray(hist)
    K = h.shape[0] - 1
    L = int(ladder_len)
    if L <= 0 or L >= K:
        return 0
    tails = np.cumsum(h[::-1])[::-1]  # tails[j] = Σ_{r≥j} h[r]
    return int(np.count_nonzero(tails[L:K] > 0))


def armijo_backtracking_batch(
    value_batch: Callable,
    X: torch.Tensor,  # (B, D) current iterates
    P: torch.Tensor,  # (B, D) search directions
    F0: torch.Tensor,  # (B,)
    G0: torch.Tensor,  # (B, D)
    c1: float = 0.3,
    alpha0: float = 1.0,
    shrink: float = 0.5,
    max_iters: int = 20,
    ladder_len: int = 0,
) -> BatchLineSearchResult:
    """Speculative batched Armijo: the whole α ladder in one value call.

    Because the ladder is exactly the sequence the sequential search
    probes, the accepted α is the one it would accept. A lane that accepts
    no rung takes α_last·shrink and reports the last trial's f, as the
    sequential search does on exhaustion. `value_batch` must be
    row-independent (row i's value depends on row i only).

    `ladder_len = L` (0 < L < K) makes the ladder adaptive: the first L
    rungs go out as one (L·B, D) call, then each further rung as one
    (B, D) call over the whole stack while any lane still searches. Every
    call builds its trials with the one expression
    X[None] + al[:, None, None] * P[None] from the one ladder, so each
    trial row, each Armijo comparison and the exhaustion α are bitwise the
    full ladder's, and so are α and rung. Before each fallback rung the
    host reads back whether every lane is done: one readback per fallback
    rung checked. A lane whose threshold is NaN (NaN f₀ or g₀ᵀp) can never
    accept and starts done, so it cannot make every fallback rung launch;
    it keeps α_{L−1}·shrink, as in the reference. ladder_len <= 0 or >= K
    runs the full ladder."""
    B, D = X.shape
    K = max_iters
    if K <= 0:
        return BatchLineSearchResult(
            alpha=torch.full((B,), alpha0, dtype=X.dtype, device=X.device),
            f_new=F0, n_evals=0,
            rung=torch.zeros((B,), dtype=torch.int32, device=X.device))
    L = K if ladder_len <= 0 else min(ladder_len, K)
    alphas, rhs = ladder_thresholds(F0, G0, P, c1, K, alpha0, shrink)

    def ladder_launch(al):
        """One value call over the rungs `al` (a slice of the ladder)."""
        k = al.shape[0]
        trials = X[None] + al[:, None, None] * P[None]  # (k, B, D)
        return value_batch(trials.reshape(k * B, D)).reshape(k, B)

    F = ladder_launch(alphas[:L])
    ok = F <= rhs[:L]
    any_ok = torch.any(ok, dim=0)
    # argmax returns the first maximum: the first accepted rung (0 if none)
    k_acc = torch.argmax(ok.to(torch.int32), dim=0)
    alpha_acc = alphas[k_acc]
    f_acc = torch.gather(F, 0, k_acc[None])[0]
    rung = torch.where(any_ok, k_acc, K).to(torch.int32)
    if L == K:
        return BatchLineSearchResult(
            alpha=torch.where(any_ok, alpha_acc, alphas[-1] * shrink),
            f_new=torch.where(any_ok, f_acc, F[-1]),
            n_evals=K,
            rung=rung,
        )

    # masked sequential fallback over the remaining rungs; a lane rejecting
    # rung i carries α_i·shrink, so exhaustion at i = K-1 is the full
    # ladder's alphas[-1]·shrink
    alpha = torch.where(any_ok, alpha_acc, alphas[L - 1] * shrink)
    f1 = torch.where(any_ok, f_acc, F[-1])
    done = any_ok | torch.isnan(rhs[0])
    n = L
    for i in range(L, K):
        if bool(torch.all(done)):
            break
        Ft = ladder_launch(alphas[i:i + 1])[0]
        ok_i = Ft <= rhs[i]
        searching = ~done
        alpha = torch.where(searching,
                            torch.where(ok_i, alphas[i], alphas[i] * shrink), alpha)
        f1 = torch.where(searching, Ft, f1)
        accepted = searching & ok_i
        done = done | accepted
        rung = torch.where(accepted, i, rung).to(torch.int32)
        n += 1
    return BatchLineSearchResult(alpha=alpha, f_new=f1, n_evals=n, rung=rung)
