"""Public kernel entry points of the port, dispatched by the tensor's device.

Port of src/repro/kernels/ops.py. Each op takes its plain PyTorch version
for a tensor on the CPU, and its hand-written CUDA kernel for a tensor on
the card: there is no switch that sends a CUDA tensor to the plain
version, and a kernel that cannot launch raises. Nothing is padded: the
JAX ops pad D to the TPU's 128-lane tile, which these kernels do not need.

Each op carries a plain integer counter, `<op>.launches`, that it raises by
one where it launches its kernel and nowhere else, so a run can show that
its main path went through the kernels. The ops with a float64 kernel
(FLOAT64_OPS: every ZEUS kernel, B1a to B7b) count their float64 launches
apart, in `<op>.launches_f64`, which `launch_counts()` reports as
`<op>_f64`.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import bfgs_update as _bfgs_update
from repro_torch.kernels import direction as _direction
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import fused_obj, meanfield_step, pso_step
from repro_torch.kernels import sweep_megakernel as _sweep
from repro_torch.kernels.fused_obj import FUSED_OBJECTIVES  # noqa: F401


def _on_cpu(t: torch.Tensor) -> bool:
    return t.is_cpu


def _launched(op, t: torch.Tensor) -> None:
    """Count one launch of `op`'s kernel on `t`: its float64 instantiation's
    counter for a float64 tensor, else the float32 one."""
    if t.dtype is torch.float64:
        op.launches_f64 += 1
    else:
        op.launches += 1


def fused_value_grad(name: str, x: torch.Tensor):
    """x (N, D) -> (f (N,), g (N, D)) for a name in FUSED_OBJECTIVES."""
    if _on_cpu(x):
        return fused_obj.value_grad_plain(name, x)
    out = fused_obj.value_grad_cuda(name, x)
    _launched(fused_value_grad, x)
    return out


def fused_value(name: str, x: torch.Tensor) -> torch.Tensor:
    """x (N, D) -> f (N,): the value-only twin of fused_value_grad, whose f
    it matches bit for bit (the Armijo test compares the two)."""
    if _on_cpu(x):
        return fused_obj.value_grad_plain(name, x, with_grad=False)[0]
    f, _ = fused_obj.value_grad_cuda(name, x, with_grad=False)
    _launched(fused_value, x)
    return f


def _itemsize(dtype) -> int:
    """Bytes an element of a kernel's dtype (float32 or float64)."""
    if dtype is torch.float32:
        return 4
    if dtype is torch.float64:
        return 8
    raise TypeError(f"the kernels take float32 or float64 (got {dtype})")


def fused_obj_row_threads(D: int) -> int:
    """The threads that csrc/fused_obj.cu (B1a, B1b) gives a row of D: the
    smallest power of two >= D, at most a warp's 32, so that a warp
    evaluates 32 // P rows at a time; from D = 17 on a row takes a whole
    warp, its lanes striding over D. The kernel's launch applies the same
    rule (row_threads there)."""
    P = 1
    while P < D and P < 32:
        P *= 2
    return P


# -- variants of the fused-objective kernel (B1a, B1b) -------------------------
# csrc/fused_obj.cu picks one of three variants by D and the element size,
# with the rules stated here (row_threads, ring and launch_layout there):
#   rows    — row groups of P < 32 lanes through a shared-memory tile, D <= 16;
#   staged  — a warp a row, persistent blocks, tiles of R rows (a multiple
#             of 16, about 16 KB, 16 to 64 rows: two rows at a time for each
#             of eight consumer warps) staged by bulk copies through a ring
#             of S <= 4 stages of R·D elements and a 16-byte pad behind 64
#             bytes of mbarriers, while two stages of 16 rows fit in a
#             block's 232,448 bytes: 17 <= D <= 1815 in float32, to 907 in
#             float64;
#   direct  — a warp a row reading device memory, above.
_FUSED_TILE_BYTES = 16384  # a stage's target, 16 KB
_FUSED_TILE_ROWS = (16, 64)
_FUSED_MAX_STAGES = 4
_FUSED_BARRIER_BYTES = 64
_FUSED_PAD_BYTES = 16  # a stage's room for a base that is not 16-byte aligned


def fused_obj_tile_rows(D: int, dtype=torch.float32) -> int:
    """Rows a tile of the staged variant at D: 16 KB of elements (4096
    floats, 2048 doubles) over D, rounded down to a multiple of 16, from 16
    to 64."""
    lo, hi = _FUSED_TILE_ROWS
    return min(hi, max(lo, _FUSED_TILE_BYTES // _itemsize(dtype) // D // lo * lo))


def fused_obj_ring_bytes(D: int, rows: int, stages: int, dtype=torch.float32) -> int:
    """Shared memory of a block of the staged variant: `stages` stages of
    rows·D elements and a 16-byte pad (4 floats or 2 doubles, which take a
    base that is not 16-byte aligned) behind the full and empty mbarriers."""
    size = _itemsize(dtype)
    return stages * (rows * D + _FUSED_PAD_BYTES // size) * size + _FUSED_BARRIER_BYTES


def fused_obj_stages(D: int, dtype=torch.float32) -> int:
    """Stages of the staged variant's ring at D: as many as fit in a block's
    shared memory, at most 4; under 2 where the variant does not run."""
    stage = (fused_obj_ring_bytes(D, fused_obj_tile_rows(D, dtype), 1, dtype)
             - _FUSED_BARRIER_BYTES)
    return min(_FUSED_MAX_STAGES, (SMEM_PER_BLOCK - _FUSED_BARRIER_BYTES) // stage)


def fused_obj_staged_max_dim(dtype=torch.float32) -> int:
    """The largest D whose smallest ring, two stages of 16 rows, fits:
    2·(16·D + 16 / s)·s + 64 <= 232,448 bytes for elements of s bytes, 1815
    in float32 and 907 in float64."""
    lo, size = _FUSED_TILE_ROWS[0], _itemsize(dtype)
    return (((SMEM_PER_BLOCK - _FUSED_BARRIER_BYTES) // (2 * size)
             - _FUSED_PAD_BYTES // size) // lo)


def fused_obj_variant(D: int, dtype=torch.float32) -> str:
    """The variant of the fused-objective kernel that rows of D run in
    `dtype`: "rows", "staged" or "direct"."""
    if fused_obj_row_threads(D) < 32:
        return "rows"
    return "staged" if fused_obj_stages(D, dtype) >= 2 else "direct"


def guarded_update_direction(H, dx, dg, g_new, rho):
    """Guarded fused H' + p' = −H' g_new; rho (B,) is 0 where the update is
    disabled, with dx, dg zeroed there, so H' = H exactly for those lanes."""
    if _on_cpu(H):
        return _bfgs_update.guarded_update_direction_plain(H, dx, dg, g_new, rho)
    out = _bfgs_update.guarded_update_direction_cuda(H, dx, dg, g_new, rho)
    _launched(guarded_update_direction, H)
    return out


def bfgs_update(H, dx, dg):
    """Unguarded H' with ρ = 1/(δxᵀδg) per lane, H (B, D, D), dx/dg (B, D):
    the per-lane path's hessian_impl="pallas". Never pass a zero pair."""
    if _on_cpu(H):
        return _bfgs_update.bfgs_update_plain(H, dx, dg)
    out = _bfgs_update.bfgs_update_cuda(H, dx, dg)
    _launched(bfgs_update, H)
    return out


def bfgs_update_direction(H, dx, dg, g_new):
    """bfgs_update fused with p' = −H' g_new. Returns (H', p')."""
    if _on_cpu(H):
        return _bfgs_update.update_direction_plain(H, dx, dg, g_new)
    out = _bfgs_update.update_direction_cuda(H, dx, dg, g_new)
    _launched(bfgs_update_direction, H)
    return out


def direction(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """p = −H g for H (B, D, D), g (B, D)."""
    if _on_cpu(H):
        return _direction.direction_plain(H, g)
    p = _direction.direction_cuda(H, g)
    _launched(direction, H)
    return p


def pso_step_update(x, v, px, gx, r1, r2, w, c1, c2):
    """Fused PSO step: (x', v') from x/v/px/r1/r2 (N, D) and gx (D,)."""
    if _on_cpu(x):
        return pso_step.pso_step_plain(x, v, px, gx, r1, r2, w, c1, c2)
    out = pso_step.pso_step_cuda(x, v, px, gx, r1, r2, w, c1, c2)
    _launched(pso_step_update, x)
    return out


def meanfield_step_update(x, v, xbar, xi, w, drift, sigma, noise="anisotropic"):
    """Fused mean-field update: (x', v') from x/v/ξ (N, D) and x̄ (D,);
    noise "isotropic" (row-norm envelope) or "anisotropic" (signed d)."""
    if _on_cpu(x):
        return meanfield_step.meanfield_step_plain(x, v, xbar, xi, w, drift, sigma,
                                                   noise)
    out = meanfield_step.meanfield_step_cuda(x, v, xbar, xi, w, drift, sigma, noise)
    _launched(meanfield_step_update, x)
    return out


# -- sweep megakernel ---------------------------------------------------------
# Shared-memory cap of the sweep megakernel on the H100. A block may use
# 232,448 bytes (227 KB) of shared memory. The kernel keeps eight D-vectors
# (x, p, g, x', g', δx, δg, u) and, for the full sweep, eight trial rows of D
# and the K trial values in it, (16·D + K) elements, beside a few scalars
# (under 64 bytes). So the largest D for a K-rung ladder with elements of s
# bytes is ((232448 − 64) / s − K) / 16: 3629 in float32 and 1814 in
# float64 at the paper's K = 20. A constant of the card, not a device query,
# so the CPU and the card route alike.
SMEM_PER_BLOCK = 232_448
_SMEM_SCALARS = 64


def megakernel_max_dim(K: int, dtype=torch.float32) -> int:
    """The largest D the sweep megakernel takes with a K-rung ladder, for
    elements of `dtype` (float32 unless given)."""
    return ((SMEM_PER_BLOCK - _SMEM_SCALARS) // _itemsize(dtype) - K) // 16


MEGAKERNEL_MAX_DIM = megakernel_max_dim(20)


def megakernel_smem_dim(K: int, full: bool = True, dtype=torch.float32) -> int:
    """The largest D at which the sweep megakernel reads each lane's H from
    device memory once: its D² elements of s bytes fit in shared memory
    beside the vectors, (D² + 16·D + K)·s + 64 <= 232,448 bytes for the full
    sweep (B5: 233 in float32, 162 in float64 at K = 20) and (D² + 8·D)·s +
    64 for the commit (B5b, full=False: 237 and 166; K unused). Above it the
    kernel streams H twice. The kernel's launch applies the same rule
    (csrc/sweep_megakernel.cu, h_fits_smem)."""
    size = _itemsize(dtype)
    vectors = (lambda D: 16 * D + K) if full else (lambda D: 8 * D)
    D = math.isqrt((SMEM_PER_BLOCK - _SMEM_SCALARS) // size)
    while D > 0 and (D * D + vectors(D)) * size + _SMEM_SCALARS > SMEM_PER_BLOCK:
        D -= 1
    return D


# -- variants of the BFGS-update kernel (B2, B7a, B7b) --------------------------
# csrc/bfgs_update.cu picks one of three variants by the lane's D and the
# element size, with the rules stated here (kSmallMaxDim and h_fits_smem
# there):
#   small      — a warp per lane while a row fits in the warp's 32 threads,
#                D <= 32;
#   smem       — one block per lane reading H once through shared memory
#                while D² + 4·D elements (H, δx, δg, g', u) and 128 bytes of
#                static scalars fit in a block's 232,448 bytes,
#                (D² + 4·D)·s + 128 <= 232,448 for elements of s bytes:
#                D <= 239 in float32, 168 in float64;
#   streaming  — one block per lane streaming H from device memory twice.
_UPDATE_SMEM_SCALARS = 128


def update_small_dim() -> int:
    """The largest D at which the BFGS-update kernel takes a warp per lane:
    one row's D columns fit in the warp's 32 threads."""
    return 32


def update_smem_dim(dtype=torch.float32) -> int:
    """The largest D at which the BFGS-update kernel reads each lane's H
    from device memory once: (D² + 4·D)·s + 128 <= 232,448 bytes for
    elements of s bytes, 239 in float32 and 168 in float64. Above it the
    kernel streams H twice."""
    size = _itemsize(dtype)
    D = math.isqrt((SMEM_PER_BLOCK - _UPDATE_SMEM_SCALARS) // size)
    while D > 0 and (D * D + 4 * D) * size + _UPDATE_SMEM_SCALARS > SMEM_PER_BLOCK:
        D -= 1
    return D


def update_variant(D: int, dtype=torch.float32) -> str:
    """The variant of the BFGS-update kernel that a lane of D runs in
    `dtype`: "small", "smem" or "streaming"."""
    if D <= update_small_dim():
        return "small"
    return "smem" if D <= update_smem_dim(dtype) else "streaming"


def sweep_megakernel_full(name, X, P, G, H, active, rhs, alphas, exhaust_alpha):
    """ONE launch: ladder + accept + value+grad + guarded H' + p'.

    X/P/G (B, D), H (B, D, D), active (B,) bool, rhs (K, B) the Armijo
    thresholds (core/linesearch.armijo_thresholds), alphas (K,) the ladder
    on X's device and exhaust_alpha α_{K−1}·shrink rounded in X's dtype (the
    reference takes the numpy ladder instead). Returns
    (x', f', g', H', p', α, rung)."""
    if _on_cpu(X):
        return _sweep.sweep_megakernel_full_plain(name, X, P, G, H, active, rhs, alphas,
                                                  exhaust_alpha)
    out = _sweep.sweep_megakernel_full_cuda(name, X, P, G, H, active, rhs, alphas,
                                            exhaust_alpha)
    _launched(sweep_megakernel_full, X)
    return out


def sweep_megakernel_commit(name, X, P, G, H, active, alpha):
    """ONE launch: x + α·p, value+grad, guarded H' + p', with α (B,) from the
    adaptive ladder. Returns (x', f', g', H', p')."""
    if _on_cpu(X):
        return _sweep.sweep_megakernel_commit_plain(name, X, P, G, H, active, alpha)
    out = _sweep.sweep_megakernel_commit_cuda(name, X, P, G, H, active, alpha)
    _launched(sweep_megakernel_commit, X)
    return out


# -- flash attention -----------------------------------------------------------
def flash_attention(q, k, v, *, causal=True, scale=None):
    """Flash attention: q (B, Sq, H, hd), k/v (B, Sk, KV, hd) -> (B, Sq, H,
    hd), GQA via H % KV == 0; bf16 or float32, fp32 softmax state, output
    in q's dtype. Any Sq, Sk: the kernel masks ragged tiles itself."""
    if _on_cpu(q):
        return _flash.flash_attention_plain(q, k, v, causal=causal, scale=scale)
    out = _flash.flash_attention_cuda(q, k, v, causal=causal, scale=scale)
    flash_attention.launches += 1
    return out


KERNEL_OPS = (fused_value, fused_value_grad, guarded_update_direction,
              bfgs_update, bfgs_update_direction, direction, pso_step_update,
              meanfield_step_update, sweep_megakernel_full, sweep_megakernel_commit,
              flash_attention)
# the ops whose kernels have a float64 instantiation: every ZEUS kernel (B8
# serves the LM path in bf16 and float32)
FLOAT64_OPS = (fused_value, fused_value_grad, guarded_update_direction, bfgs_update,
               bfgs_update_direction, direction, pso_step_update, meanfield_step_update,
               sweep_megakernel_full, sweep_megakernel_commit)


def reset_launch_counts() -> None:
    for op in KERNEL_OPS:
        op.launches = 0
    for op in FLOAT64_OPS:
        op.launches_f64 = 0


reset_launch_counts()


def launch_counts() -> dict:
    """Every counter by name: `<op>` for float32 launches (every kernel
    launch of the ops without a float64 kernel), `<op>_f64` for float64."""
    counts = {op.__name__: op.launches for op in KERNEL_OPS}
    counts.update({f"{op.__name__}_f64": op.launches_f64 for op in FLOAT64_OPS})
    return counts
