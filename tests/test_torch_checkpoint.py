"""The port's checkpoint manager and its checkpoint/resume contract.

- checkpoint/manager.py: the reference's own manager cases
  (tests/test_checkpoint_manager.py: two-phase commit, keep-N GC, torn
  writes, structure mismatch, restore into a structure with no data), its
  stricter checks (a leaf's shape or dtype, the shard's byte length), and
  the on-disk layout shared with the reference: a snapshot of numpy leaves
  written by either package restores through the other's manager,
  array-equal.
- The engine (core/engine.py), port against port: a solve preempted at a
  sweep boundary and resumed from its newest snapshot is array-equal to
  the uninterrupted solve in every BFGSResult field, on every sweep mode
  and schedule, with retries and injected faults, and with the fixed-cost
  cost model; a checkpointed solve is array-equal to an uncheckpointed
  one; a snapshot does not restore into another configuration; keep-N GC
  holds during a solve; zeus(resume=) equals the uninterrupted call.

No reference solve runs here (its checkpointed solves are not oracles for
the port): sizes stay at 10 lanes of D = 3 and 25 sweeps.
"""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import manager as jmanager  # noqa: E402
from repro_torch.checkpoint import manager  # noqa: E402
from repro_torch.core import (  # noqa: E402
    BFGSOptions,
    LBFGSOptions,
    PSOOptions,
    TorchDraws,
    ZeusOptions,
    batched_bfgs,
    batched_lbfgs,
    get_objective,
    zeus,
)
from repro_torch.launch.faults import FaultPlan, Preempted  # noqa: E402

rosenbrock = get_objective("rosenbrock").fn


@pytest.fixture(autouse=True, scope="module")
def _strict_fp32():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


# ---------------------------------------------------------------------------
# the manager: the reference's cases
# ---------------------------------------------------------------------------
def _tree(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {
        "x": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)),
        "k": np.asarray(seed, np.int32),
        "nested": (torch.from_numpy(rng.integers(0, 9, size=(2,)).astype(np.int32)),),
    }


def _leaves(t):
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
            for x in manager.tree_flatten(t)[0]]


def _assert_tree_equal(a, b):
    assert manager.tree_flatten(a)[1] == manager.tree_flatten(b)[1]
    for x, y in zip(_leaves(a), _leaves(b)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_save_restore_array_equal(tmp_path):
    t = _tree(1)
    manager.save(str(tmp_path), 7, t)
    _assert_tree_equal(manager.restore(str(tmp_path), t), t)


def test_restore_into_meta_tensors(tmp_path):
    """The resume path restores into tensors on the meta device: shapes
    and dtypes alone, no data."""
    t = _tree(2)
    manager.save(str(tmp_path), 3, t)
    like = manager.tree_map(
        lambda a: a.to("meta") if isinstance(a, torch.Tensor) else a, t)
    _assert_tree_equal(manager.restore(str(tmp_path), like), t)


def test_restore_picks_latest_committed(tmp_path):
    a, b = _tree(1), _tree(2)
    manager.save(str(tmp_path), 5, a)
    manager.save(str(tmp_path), 10, b)
    _assert_tree_equal(manager.restore(str(tmp_path), a), b)
    _assert_tree_equal(manager.restore(str(tmp_path), a, step=5), a)


def test_gc_keeps_newest_n(tmp_path):
    for s in (1, 2, 3, 4, 5):
        manager.save(str(tmp_path), s, _tree(s), keep=3)
    assert manager.committed_steps(str(tmp_path)) == [3, 4, 5]
    assert not os.path.exists(os.path.join(str(tmp_path), "step_000000001"))


def test_keep_zero_disables_gc(tmp_path):
    for s in (1, 2, 3):
        manager.save(str(tmp_path), s, _tree(s), keep=0)
    assert manager.committed_steps(str(tmp_path)) == [1, 2, 3]


def test_missing_commit_ignored(tmp_path):
    t = _tree(1)
    manager.save(str(tmp_path), 5, t)
    newer = manager.save(str(tmp_path), 9, _tree(2))
    os.remove(os.path.join(newer, "COMMIT"))
    assert manager.committed_steps(str(tmp_path)) == [5]
    _assert_tree_equal(manager.restore(str(tmp_path), t), t)


def test_torn_tmp_dir_ignored(tmp_path):
    manager.save(str(tmp_path), 5, _tree(1))
    torn = os.path.join(str(tmp_path), "step_000000009.tmp")
    shutil.copytree(os.path.join(str(tmp_path), "step_000000005"), torn)
    assert manager.committed_steps(str(tmp_path)) == [5]
    assert manager.latest_step(str(tmp_path)) == 5


def test_explicit_step_without_commit_raises(tmp_path):
    manager.save(str(tmp_path), 5, _tree(1))
    os.remove(os.path.join(str(tmp_path), "step_000000005", "COMMIT"))
    with pytest.raises(FileNotFoundError):
        manager.restore(str(tmp_path), _tree(1), step=5)


def test_empty_root_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        manager.restore(str(tmp_path / "nope"), _tree(1))


def test_save_overwrites_same_step(tmp_path):
    manager.save(str(tmp_path), 5, _tree(1))
    manager.save(str(tmp_path), 5, _tree(2))
    _assert_tree_equal(manager.restore(str(tmp_path), _tree(2)), _tree(2))


def test_meta_records_leaf_count(tmp_path):
    d = manager.save(str(tmp_path), 5, _tree(1))
    with open(os.path.join(d, "meta.json")) as fh:
        meta = json.load(fh)
    assert meta["n_leaves"] == len(manager.tree_flatten(_tree(1))[0])
    assert meta["step"] == 5
    assert meta["shapes"] == [[], [2], [4, 3]]  # dicts flatten by sorted key
    assert meta["dtypes"] == ["int32", "int32", "float32"]


@pytest.mark.parametrize("wrong", ["leaf_count", "shape", "dtype", "bytes"])
def test_structure_mismatch_raises(tmp_path, wrong):
    """Restoring into another structure fails loudly, never mis-assigning
    leaves: the reference checks the leaf count and the bytes, the port also
    each leaf's shape and dtype."""
    t = _tree(1)
    d = manager.save(str(tmp_path), 5, t)
    like = dict(t)
    if wrong == "leaf_count":
        like["extra"] = torch.zeros(2)
    elif wrong == "shape":
        like["x"] = torch.zeros(3, 4)
    elif wrong == "dtype":
        like["x"] = torch.zeros(4, 3, dtype=torch.float64)
    else:
        with open(os.path.join(d, "shard_00000.bin"), "ab") as fh:
            fh.write(b"\0" * 4)
    with pytest.raises(ValueError, match="carry structure|bytes"):
        manager.restore(str(tmp_path), like)


# ---------------------------------------------------------------------------
# the on-disk layout, shared with the reference
# ---------------------------------------------------------------------------
def _np_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(3, 5)).astype(np.float32),
            "b": (rng.integers(0, 7, size=(4,)).astype(np.int32),
                  np.asarray(rng.random() < 0.5)),
            "c": rng.integers(0, 255, size=(6,)).astype(np.uint8)}


def test_port_snapshot_restores_through_reference(tmp_path):
    t = _np_tree(3)
    manager.save(str(tmp_path), 12, t)
    got = jmanager.restore(str(tmp_path), jax.tree.map(jnp.asarray, t))
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(t)):
        assert np.asarray(x).dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x), y)
    assert jmanager.latest_step(str(tmp_path)) == 12


def test_reference_snapshot_restores_through_port(tmp_path):
    t = _np_tree(4)
    jmanager.save(str(tmp_path), 8, jax.tree.map(jnp.asarray, t))
    like = manager.tree_map(torch.from_numpy, t)
    got = manager.restore(str(tmp_path), like)
    for x, y in zip(manager.tree_flatten(got)[0], manager.tree_flatten(t)[0]):
        np.testing.assert_array_equal(x.numpy(), y)
    assert manager.snapshot_meta(str(tmp_path))["step"] == 8


# ---------------------------------------------------------------------------
# the engine: resume == uninterrupted, port against port
# ---------------------------------------------------------------------------
def _x0(n=10, d=3, seed=1, lo=-2.0, hi=2.0):
    return np.random.default_rng(seed).uniform(lo, hi, (n, d)).astype(np.float32)


def _assert_result_equal(a, b, skip=()):
    """Array-equality over every BFGSResult field (None-ness included)."""
    for fld in a._fields:
        if fld in skip:
            continue
        va, vb = getattr(a, fld), getattr(b, fld)
        assert (va is None) == (vb is None), fld
        if fld == "telemetry" and va is not None:
            # wall and energy are this run's host measurements
            for part in ("rows", "launches", "windows", "c_row", "c_launch"):
                np.testing.assert_array_equal(getattr(va, part), getattr(vb, part),
                                              err_msg=part)
        elif isinstance(va, torch.Tensor):
            assert torch.equal(va, vb), fld
        else:
            assert va == vb, fld


PLAN_INJECT = FaultPlan(nan_grads=((2, 1), (6, 4)), kill_lanes=((5, 7),))
CELLS = {
    "batched": dict(sweep_mode="batched"),
    "per_lane": dict(sweep_mode="per_lane"),
    "megakernel": dict(sweep_mode="megakernel"),
    "chunk-repack-compact": dict(sweep_mode="batched", lane_chunk=4, repack_every=3,
                                 compact_every=2),
    "auto-chunk": dict(sweep_mode="batched", lane_chunk=4, schedule="auto",
                       schedule_every=3),
    "retry-injection": dict(sweep_mode="batched", lane_chunk=5, repack_every=2,
                            fault_plan=PLAN_INJECT, retry_budget=2),
    "cost-model-fixed": dict(sweep_mode="batched", lane_chunk=4, schedule="auto",
                             schedule_every=2, auto_ladders=(2, 0), ls_iters=10,
                             auto_cost_model=True, telemetry_costs=(1.0, 1.0)),
}


def _solve(opts, ck=None, every=4, preempt=None, resume=False, seed=1):
    if ck is not None:
        plan = opts.fault_plan if preempt is None else dataclasses.replace(
            opts.fault_plan or FaultPlan(), preempt_at_sweep=preempt)
        opts = dataclasses.replace(opts, checkpoint_every=every, checkpoint_dir=ck,
                                   fault_plan=plan)
    return batched_bfgs(rosenbrock, _x0(seed=seed), opts, device="cpu",
                        retry_draws=TorchDraws("cpu", seed=12),
                        resume_from=ck if resume else None)


@pytest.mark.parametrize("name", list(CELLS))
def test_resume_equals_uninterrupted(tmp_path, name):
    """Preempted at sweep 11 (sweeps 9-11 lost: the newest snapshot is at
    8), resumed: array-equal to the uninterrupted checkpointed solve, and
    that to the same solve without checkpoints."""
    opts = BFGSOptions(iter_bfgs=25, theta=1e-5, **CELLS[name])
    plain = _solve(opts)
    ref = _solve(opts, ck=str(tmp_path / "ref"))
    _assert_result_equal(plain, ref, skip=("telemetry",))
    ck = str(tmp_path / "ck")
    with pytest.raises(Preempted) as ei:
        _solve(opts, ck=ck, preempt=11)
    assert ei.value.sweep == 11 and ei.value.checkpoint_dir == ck
    assert manager.latest_step(ck) == 8
    res = _solve(opts, ck=ck, resume=True)
    _assert_result_equal(ref, res)
    assert res.iterations == 25
    if name == "retry-injection":
        assert int(res.n_restarts.sum()) == 3


def test_resume_lbfgs_chunked(tmp_path):
    """The same contract through L-BFGS, whose circular buffers and
    per-lane head and count ride in the carry."""
    base = LBFGSOptions(iter_max=25, theta=1e-5, memory=4, sweep_mode="batched",
                        lane_chunk=4)
    x0 = _x0(8, 4, seed=2)

    def run(**kw):
        resume = kw.pop("resume", None)
        return batched_lbfgs(rosenbrock, x0, dataclasses.replace(base, **kw),
                             device="cpu", resume_from=resume)

    ref = run(checkpoint_every=3, checkpoint_dir=str(tmp_path / "ref"))
    _assert_result_equal(run(), ref)
    ck = str(tmp_path / "ck")
    with pytest.raises(Preempted):
        run(checkpoint_every=3, checkpoint_dir=ck, fault_plan=FaultPlan(preempt_at_sweep=8))
    assert manager.latest_step(ck) == 6
    _assert_result_equal(ref, run(checkpoint_every=3, checkpoint_dir=ck, resume=ck))


def test_restore_into_another_configuration_raises(tmp_path):
    ck = str(tmp_path / "ck")
    opts = BFGSOptions(iter_bfgs=6, theta=1e-5, sweep_mode="batched", lane_chunk=4,
                       checkpoint_every=3, checkpoint_dir=ck)
    batched_bfgs(rosenbrock, _x0(), opts, device="cpu")
    for other, x0 in (
            (dataclasses.replace(opts, lane_chunk=None), _x0()),  # one group, not three
            (opts, _x0(d=4)),  # another D
            (dataclasses.replace(opts, compact_every=1), _x0()),  # compaction plans
            (dataclasses.replace(opts, sweep_mode="per_lane"), _x0())):  # no p
        with pytest.raises(ValueError, match="carry structure"):
            batched_bfgs(rosenbrock, x0, other, device="cpu", resume_from=ck)


def test_keep_n_gc_during_solve(tmp_path):
    ck = str(tmp_path / "gc")
    res = batched_bfgs(rosenbrock, _x0(8, 3), BFGSOptions(
        iter_bfgs=30, theta=1e-30, sweep_mode="batched", checkpoint_every=2,
        checkpoint_dir=ck, checkpoint_keep=2), device="cpu")
    assert res.iterations == 30
    assert manager.committed_steps(ck) == [28, 30]


def test_snapshot_is_written_at_the_stop(tmp_path):
    """A solve that stops between two cadence boundaries still leaves its
    final carry: resuming it returns the finished result at once."""
    ck = str(tmp_path / "stop")
    opts = BFGSOptions(iter_bfgs=23, theta=1e-5, sweep_mode="batched",
                       checkpoint_every=5, checkpoint_dir=ck)
    ref = batched_bfgs(rosenbrock, _x0(), opts, device="cpu")
    assert manager.committed_steps(ck)[-1] == 23
    _assert_result_equal(ref, batched_bfgs(rosenbrock, _x0(), opts, device="cpu",
                                           resume_from=ck))


def test_retry_stream_needs_state_hooks_under_checkpointing(tmp_path):
    class NoState:
        def __call__(self, shape, low, high):
            return torch.full(tuple(shape), 0.5 * (low + high))

        def normal(self, shape):
            return torch.zeros(tuple(shape))

    with pytest.raises(ValueError, match="get_state"):
        batched_bfgs(rosenbrock, _x0(), BFGSOptions(
            iter_bfgs=5, sweep_mode="batched", retry_budget=1, checkpoint_every=2,
            checkpoint_dir=str(tmp_path / "x")), device="cpu", retry_draws=NoState())


def test_zeus_resume_matches_uninterrupted(tmp_path):
    """zeus(resume=) replays phase 1 from the same seed and restores phase
    2: raw, best_x and pso_best_f array-equal to the uninterrupted call."""
    obj = get_objective("rosenbrock")
    base = dict(pso=PSOOptions(n_particles=12, iter_pso=2),
                bfgs=BFGSOptions(iter_bfgs=30, theta=1e-4), sweep_mode="batched",
                retry_budget=1)

    def run(resume=None, **kw):
        gen = torch.Generator().manual_seed(2)
        return zeus(obj.fn, 3, -5.0, 10.0, ZeusOptions(**base, **kw), device="cpu",
                    generator=gen, resume=resume)

    ref = run(checkpoint_every=4, checkpoint_dir=str(tmp_path / "zref"))
    _assert_result_equal(run().raw, ref.raw)
    ck = str(tmp_path / "zck")
    with pytest.raises(Preempted):
        run(checkpoint_every=4, checkpoint_dir=ck, fault_plan=FaultPlan(preempt_at_sweep=10))
    res = run(checkpoint_every=4, checkpoint_dir=ck, resume=ck)
    _assert_result_equal(ref.raw, res.raw)
    assert torch.equal(ref.best_x, res.best_x)
    assert torch.equal(ref.pso_best_f, res.pso_best_f)
