"""Per-window host telemetry for the schedule controller's cost model.

Port of src/repro/launch/telemetry.py. The schedule="auto" controller
(core/engine.py) picks each window's ladder from the p90 accepted rung;
with `auto_cost_model=True` it scores every candidate in measured seconds
instead, from this module:

- `TelemetryCarry`      — per-window wall, rows, launches and energy, and
                          the fitted costs, riding inside the engine's
                          EngineCarry: checkpoint/resume round-trips it and
                          the solve returns it as BFGSResult.telemetry.
- `fit_costs`           — online EMA decomposition of a window's wall into
                          per-objective-row (c_row) and per-launch
                          (c_launch) costs.
- `cost_model_decision` — the p90 controller with its ladder target
                          replaced by the two-term score
                          (L + E[fb])·active·c_row + E[fb]·c_launch.
- `WindowTelemetry`     — a begin()/end() recorder for host loops that
                          carry no TelemetryCarry.
- `probe_energy`        — NVML (pynvml) then RAPL (powercap sysfs)
                          capability probe. Never a dependency: with
                          neither present the probe is absent and the
                          energy fields stay NaN, with no error raised.

The engine's window wall is taken on the host clock from the window's
first sweep to the stop-count readback after its last, which synchronises
with the device. Decisions happen only at schedule_every boundaries and
always pick a plan-lattice member, so schedule="replay" of a recorded trace
is array-equal to the run; fixed telemetry_costs make every decision a pure
function of the carry. The carry's leaves are numpy arrays: they are host
measurements.
"""
from __future__ import annotations

import glob
import time
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.linesearch import rung_tail_fallback_launches

__all__ = [
    "EnergyProbe",
    "TelemetryCarry",
    "WindowTelemetry",
    "cost_model_decision",
    "fit_costs",
    "probe_energy",
    "record_window",
    "telemetry_init",
    "telemetry_summary",
]


# ---------------------------------------------------------------------------
# Energy capability probe (NVML → RAPL → absent)
# ---------------------------------------------------------------------------
class EnergyProbe:
    """Cumulative-energy reader behind a capability probe.

    `source` is "nvml", "rapl" or None; `read_j()` returns cumulative
    joules or None when absent. A reader that starts failing mid-run
    degrades to absent instead of raising: telemetry never kills a solve.
    """

    def __init__(self, source: Optional[str],
                 read: Optional[Callable[[], float]]):
        self.source = source
        self._read = read

    @property
    def available(self) -> bool:
        return self._read is not None

    def read_j(self) -> Optional[float]:
        if self._read is None:
            return None
        try:
            return float(self._read())
        except Exception:
            self._read = None
            self.source = None
            return None


def _probe_nvml():
    try:
        import pynvml  # optional: energy is read where it is installed
    except Exception:
        return None
    try:
        pynvml.nvmlInit()
        handle = pynvml.nvmlDeviceGetHandleByIndex(0)
        pynvml.nvmlDeviceGetTotalEnergyConsumption(handle)  # millijoules
        return ("nvml",
                lambda: pynvml.nvmlDeviceGetTotalEnergyConsumption(handle)
                / 1e3)
    except Exception:
        return None


# top-level RAPL package domains only (intel-rapl:N); the :N:M subzones are
# subsets of their package and would double-count
_RAPL_GLOB = "/sys/class/powercap/intel-rapl:*/energy_uj"


def _rapl_paths() -> Tuple[str, ...]:
    paths = []
    for p in sorted(glob.glob(_RAPL_GLOB)):
        if p.count(":") != 1:
            continue
        try:
            with open(p) as fh:
                int(fh.read().strip())
        except (OSError, ValueError):
            continue
        paths.append(p)
    return tuple(paths)


def _probe_rapl():
    paths = _rapl_paths()
    if not paths:
        return None

    def read() -> float:
        total_uj = 0
        for p in paths:
            with open(p) as fh:
                total_uj += int(fh.read().strip())
        return total_uj / 1e6

    return ("rapl", read)


def probe_energy() -> EnergyProbe:
    """NVML first (device energy), then RAPL (package energy), else an
    absent probe. Probing never raises."""
    for probe in (_probe_nvml, _probe_rapl):
        try:
            got = probe()
        except Exception:
            got = None
        if got is not None:
            return EnergyProbe(*got)
    return EnergyProbe(None, None)


# ---------------------------------------------------------------------------
# The telemetry carried through the solve
# ---------------------------------------------------------------------------
class TelemetryCarry(NamedTuple):
    """Per-window telemetry riding inside EngineCarry.telem. wall_s and
    energy_j are host measurements of this run, not replayable quantities
    (fixed-cost mode exists so that decisions need not depend on them)."""

    wall_s: Any  # (n_windows,) f32 — host wall seconds per window
    rows: Any  # (n_windows,) i32 — objective-row delta per window
    launches: Any  # (n_windows,) i32 — chunk-step (map trip) delta
    energy_j: Any  # (n_windows,) f32 — energy delta; NaN = probe absent
    c_row: Any  # () f32 — fitted per-row cost (EMA, or the fixed constant)
    c_launch: Any  # () f32 — fitted per-launch cost
    windows: Any  # () i32 — completed windows recorded so far


def telemetry_init(n_windows: int,
                   costs: Optional[Tuple[float, float]] = None
                   ) -> TelemetryCarry:
    """Fresh telemetry; `costs=(c_row, c_launch)` seeds the fixed,
    deterministic mode (the EMA fit is then never applied)."""
    c_row, c_launch = (0.0, 0.0) if costs is None else costs
    return TelemetryCarry(
        wall_s=np.zeros((n_windows,), np.float32),
        rows=np.zeros((n_windows,), np.int32),
        launches=np.zeros((n_windows,), np.int32),
        energy_j=np.full((n_windows,), np.nan, np.float32),
        c_row=np.asarray(float(c_row), np.float32),
        c_launch=np.asarray(float(c_launch), np.float32),
        windows=np.zeros((), np.int32),
    )


def fit_costs(c_row: float, c_launch: float, wall_s: float, rows: int,
              launches: int, *, n: int, ema: float
              ) -> Tuple[float, float]:
    """One completed window's observation → updated (c_row, c_launch).

    Decomposes wall ≈ c_row·rows + c_launch·launches by alternating
    residuals: rows absorb what launches don't explain and vice versa. One
    window cannot identify both terms; windows with different launch
    counts do. The first window (n == 0) assigns directly; later windows
    blend with weight `ema`.
    """
    rows = max(int(rows), 1)
    launches = max(int(launches), 1)
    obs_row = max(wall_s - c_launch * launches, 0.0) / rows
    c_row = obs_row if n == 0 else (1.0 - ema) * c_row + ema * obs_row
    obs_launch = max(wall_s - c_row * rows, 0.0) / launches
    c_launch = (obs_launch if n == 0
                else (1.0 - ema) * c_launch + ema * obs_launch)
    return c_row, c_launch


def record_window(telem: TelemetryCarry, w: int, wall_s: float, rows: int,
                  launches: int, energy_j: Optional[float] = None, *,
                  ema: float = 0.5, fixed: bool = False,
                  refit: bool = True) -> TelemetryCarry:
    """Accumulate one segment's measurements into window `w` and, when the
    window just completed and the costs are not fixed, refit the EMA cost
    model from the window's totals. Returns a new carry."""
    wall = np.asarray(telem.wall_s).copy()
    rws = np.asarray(telem.rows).copy()
    lns = np.asarray(telem.launches).copy()
    ens = np.asarray(telem.energy_j).copy()
    w = int(w)
    wall[w] += np.float32(wall_s)
    rws[w] += np.int32(rows)
    lns[w] += np.int32(launches)
    if energy_j is not None and energy_j >= 0.0:
        base = 0.0 if np.isnan(ens[w]) else float(ens[w])
        ens[w] = np.float32(base + energy_j)
    c_row = float(np.asarray(telem.c_row))
    c_launch = float(np.asarray(telem.c_launch))
    n = int(np.asarray(telem.windows))
    if refit:
        if not fixed:
            c_row, c_launch = fit_costs(
                c_row, c_launch, float(wall[w]), int(rws[w]), int(lns[w]),
                n=n, ema=ema)
        n += 1
    return TelemetryCarry(
        wall_s=wall, rows=rws, launches=lns, energy_j=ens,
        c_row=np.asarray(c_row, np.float32),
        c_launch=np.asarray(c_launch, np.float32),
        windows=np.asarray(n, np.int32))


def telemetry_summary(telem) -> dict:
    """JSON-friendly view of a TelemetryCarry (or BFGSResult.telemetry).
    Energy keys are present only when a probe recorded anything."""
    wall = np.asarray(telem.wall_s, np.float64)
    ran = wall > 0.0
    out = {
        "n_windows": int(np.count_nonzero(ran)),
        "wall_s_total": float(wall.sum()),
        "wall_s_p50": float(np.median(wall[ran])) if ran.any() else 0.0,
        "rows_total": int(np.asarray(telem.rows).sum()),
        "launches_total": int(np.asarray(telem.launches).sum()),
        "c_row": float(np.asarray(telem.c_row)),
        "c_launch": float(np.asarray(telem.c_launch)),
    }
    energy = np.asarray(telem.energy_j, np.float64)
    if np.isfinite(energy).any():
        out["energy_j_total"] = float(np.nansum(energy))
    return out


# ---------------------------------------------------------------------------
# The host-side plan decision (two-term cost model)
# ---------------------------------------------------------------------------
def cost_model_decision(hist, n_act: int, eff_lens: Sequence[int],
                        plan: int, prev_lidx: int, dyn_on: bool, *,
                        act_thresh: float, c_row: float, c_launch: float
                        ) -> Tuple[int, int, bool]:
    """Score every candidate ladder in measured seconds and decide the next
    window's plan. The dynamic latch and the asymmetric adoption
    hysteresis are the p90 controller's (engine._auto_controller); only the
    ladder target changes, to the argmin of

        score(L) = (L + fb(L)) · active · c_row + fb(L) · c_launch

    where fb(L) = rung_tail_fallback_launches(hist, L) is the number of
    fallback launches the window's rung histogram implies under an L-rung
    ladder (each is one more launch and one more row batch). Ties break
    toward the shortest candidate.

    Returns (plan, prev_lidx, dyn_on) as host ints."""
    hist = np.asarray(hist)
    n_ladders = len(eff_lens)
    total = int(hist.sum())
    act = int(n_act)
    dyn_new = bool(dyn_on) or (act < act_thresh)
    lidx, best = 0, None
    for i, L in enumerate(eff_lens):
        fb = rung_tail_fallback_launches(hist, L)
        score = (L + fb) * act * c_row + fb * c_launch
        if best is None or score < best:
            lidx, best = i, score
    cur = int(plan) % n_ladders
    stable_up = (lidx > cur) and (lidx == int(prev_lidx))
    adopt = (total > 0) and ((lidx < cur) or stable_up)
    new_lidx = lidx if adopt else cur
    new_plan = (n_ladders if dyn_new else 0) + new_lidx
    new_prev = lidx if total > 0 else int(prev_lidx)
    return int(new_plan), int(new_prev), bool(dyn_new)


# ---------------------------------------------------------------------------
# Standalone host recorder
# ---------------------------------------------------------------------------
class WindowTelemetry:
    """begin()/end() wall and energy recorder for host loops that carry no
    TelemetryCarry. Keeps per-window wall seconds and the same EMA-fitted
    c_row/c_launch; `summary()` is JSON-safe. Never raises for a missing
    energy backend."""

    def __init__(self, ema: float = 0.5,
                 costs: Optional[Tuple[float, float]] = None,
                 probe: Optional[EnergyProbe] = None):
        self.ema = float(ema)
        self.fixed = costs is not None
        self.c_row, self.c_launch = (
            (0.0, 0.0) if costs is None else (float(costs[0]),
                                              float(costs[1])))
        self.probe = probe if probe is not None else probe_energy()
        self.wall_s: list = []
        self.rows: list = []
        self.launches: list = []
        self.energy_j: list = []
        self._t0: Optional[float] = None
        self._e0: Optional[float] = None

    def begin(self) -> None:
        self._e0 = self.probe.read_j()
        self._t0 = time.perf_counter()

    def end(self, rows: int = 0, launches: int = 0) -> float:
        """Close the current window; returns its wall seconds."""
        if self._t0 is None:
            return 0.0
        wall = time.perf_counter() - self._t0
        e1 = self.probe.read_j()
        de = (e1 - self._e0
              if e1 is not None and self._e0 is not None else None)
        self._t0 = self._e0 = None
        self.wall_s.append(float(wall))
        self.rows.append(int(rows))
        self.launches.append(int(launches))
        self.energy_j.append(float(de) if de is not None and de >= 0.0
                             else float("nan"))
        if not self.fixed:
            self.c_row, self.c_launch = fit_costs(
                self.c_row, self.c_launch, wall, rows, launches,
                n=len(self.wall_s) - 1, ema=self.ema)
        return float(wall)

    def summary(self) -> dict:
        if not self.wall_s:
            return {"n_windows": 0}
        wall = np.asarray(self.wall_s, np.float64)
        out = {
            "n_windows": len(self.wall_s),
            "wall_s_total": float(wall.sum()),
            "wall_s_p50": float(np.median(wall)),
            "wall_s_p95": float(np.percentile(wall, 95)),
            "c_row": float(self.c_row),
            "c_launch": float(self.c_launch),
        }
        energy = np.asarray(self.energy_j, np.float64)
        if np.isfinite(energy).any():
            out["energy_j_total"] = float(np.nansum(energy))
            out["energy_source"] = self.probe.source
        return out
