"""Solution clustering + confidence report (paper §VII-B).

Port of src/repro/core/clustering.py. After a multistart run, converged
iterates are grouped into candidate basins by coordinate distance
(single-linkage over a radius) or by function value. Confidence that the
lowest cluster is the global minimum grows with the number of independent
lanes that landed in it. Host-side numpy, like the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List

import numpy as np
import torch

from repro_torch.core.engine import CONVERGED, BFGSResult


@dataclasses.dataclass
class Cluster:
    center: np.ndarray
    fval: float
    count: int
    members: np.ndarray  # indices into the lane axis


@dataclasses.dataclass
class ConfidenceReport:
    clusters: List[Cluster]
    best_cluster: Cluster
    confidence: float  # fraction of converged lanes in the best cluster
    n_converged: int
    n_lanes: int

    def summary(self) -> str:
        return (
            f"{len(self.clusters)} candidate basins from "
            f"{self.n_converged}/{self.n_lanes} converged lanes; best "
            f"f={self.best_cluster.fval:.6g} holds {self.best_cluster.count} "
            f"lanes (confidence {self.confidence:.1%})"
        )


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def cluster_solutions(
    res: BFGSResult,
    radius: float = 1e-2,
    by: str = "coords",
    value_tol: float = 1e-6,
) -> ConfidenceReport:
    """Group a multistart result's converged lanes into candidate basins.

    res:    BFGSResult (tensors or numpy arrays); reads `.x`, `.fval`,
            `.status`.
    radius: single-linkage distance (by="coords"): a lane joins the first
            existing cluster whose center is within `radius` in ‖·‖₂. Lanes
            are visited in ascending fval, so centers seed at basin minima.
    by:     "coords" (default) or "value" (fvals that agree to `value_tol`,
            relative, floored at 1.0).

    Returns a ConfidenceReport with clusters sorted by fval (centers are
    member means, fval the member min). With zero converged lanes the best
    lane becomes a single count-0 cluster at confidence 0.0."""
    x = _np(res.x)
    f = _np(res.fval)
    status = _np(res.status)
    conv = np.nonzero(status == CONVERGED)[0]
    n_lanes = x.shape[0]

    if conv.size == 0:
        i = int(np.argmin(f))
        c = Cluster(center=x[i], fval=float(f[i]), count=0, members=np.array([i]))
        return ConfidenceReport([c], c, 0.0, 0, n_lanes)

    order = conv[np.argsort(f[conv])]
    clusters: List[Cluster] = []
    assigned = np.full(n_lanes, -1)
    for i in order:
        placed = False
        for ci, c in enumerate(clusters):
            if by == "coords":
                close = np.linalg.norm(x[i] - c.center) <= radius
            else:  # by function value
                close = abs(f[i] - c.fval) <= value_tol * max(1.0, abs(c.fval))
            if close:
                assigned[i] = ci
                placed = True
                break
        if not placed:
            assigned[i] = len(clusters)
            clusters.append(Cluster(center=x[i].copy(), fval=float(f[i]),
                                    count=0, members=np.empty(0, int)))

    for ci, c in enumerate(clusters):
        members = np.nonzero(assigned == ci)[0]
        c.members = members
        c.count = int(members.size)
        c.center = x[members].mean(axis=0)
        c.fval = float(f[members].min())

    clusters.sort(key=lambda c: c.fval)
    best = clusters[0]
    return ConfidenceReport(
        clusters=clusters,
        best_cluster=best,
        confidence=best.count / conv.size,
        n_converged=int(conv.size),
        n_lanes=n_lanes,
    )


def run_until_confident(
    run_fn: Callable[[object], BFGSResult],
    draws_per_round: Iterable,
    min_lanes_in_best: int = 10,
    radius: float = 1e-2,
) -> ConfidenceReport:
    """§VII-B iterative procedure: keep launching rounds until the lowest
    cluster has accumulated `min_lanes_in_best` convergences.

    run_fn:          `draws -> BFGSResult`, e.g.
                     `lambda d: zeus(..., draws=d).raw`.
    draws_per_round: one draws hook (or torch.Generator, whatever run_fn
                     takes) per round; its length bounds the rounds, and
                     independent streams make the lanes independent
                     evidence.
    Returns the last round's report over the union of all lanes so far
    (grad_norm is zero-filled in the merged result). If the rounds run out
    first, check `report.best_cluster.count` against the threshold."""
    agg_x, agg_f, agg_s = [], [], []
    report = None
    for draws in draws_per_round:
        res = run_fn(draws)
        agg_x.append(_np(res.x))
        agg_f.append(_np(res.fval))
        agg_s.append(_np(res.status))
        status = np.concatenate(agg_s)
        merged = BFGSResult(
            x=np.concatenate(agg_x),
            fval=np.concatenate(agg_f),
            grad_norm=np.zeros(status.shape[0]),
            status=status,
            iterations=res.iterations,
            n_converged=int(np.sum(status == CONVERGED)),
        )
        report = cluster_solutions(merged, radius=radius)
        if report.best_cluster.count >= min_lanes_in_best:
            break
    return report
