"""Solve-service launcher: the continuous-batching optimization service
(serve/service.py) driven by a deterministic request stream from the
command line. Port of src/repro/launch/serve.py, with --device.

On the card (the default device):
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --problems rastrigin:4,ackley:2 --requests 6 --slots 8 \\
        --iter-max 40 --theta 1e-4

On the CPU, add --device cpu. From Python, `main([...])` takes the same
arguments and returns {rid: SolveResult}; for example the service over
two problems, four requests of two starts each, through four slots:
    from repro_torch.launch import serve
    results = serve.main(["--problems", "rastrigin:3,ackley:2",
                          "--requests", "4", "--n-starts", "2",
                          "--iter-max", "30", "--slots", "4",
                          "--device", "cpu"])

Each request round-robins over the registered problems with its index as
the start seed, so the stream (and every solve in it) is reproducible.
Prints a per-request table plus the service's latency/throughput summary;
`--ledger PATH` dumps the admit/retire event ledger as JSON.
"""
from __future__ import annotations

import argparse

from repro_torch.core import BFGSOptions, ZeusOptions
from repro_torch.serve.service import ProblemRegistry, SolveRequest, SolveService


def _parse_problems(spec: str):
    """"rastrigin:4,ackley:2" -> [(objective, dim), ...]."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, dim = part.partition(":")
        out.append((name, int(dim) if dim else 2))
    if not out:
        raise ValueError(f"no problems in spec {spec!r}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="continuous-batching multistart solve service")
    ap.add_argument("--problems", default="rastrigin:4,ackley:2",
                    help="objective:dim[,objective:dim...] to register")
    ap.add_argument("--requests", type=int, default=6,
                    help="requests in the deterministic stream")
    ap.add_argument("--n-starts", type=int, default=2,
                    help="start points (lanes) per request")
    ap.add_argument("--iter-max", type=int, default=40,
                    help="per-lane sweep budget per request")
    ap.add_argument("--slots", type=int, default=8,
                    help="lane slots per problem pool")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="wait-queue bound before submit raises QueueFull")
    ap.add_argument("--admit-every", type=int, default=1,
                    help="segment boundary cadence in sweeps")
    ap.add_argument("--sweep-mode", default="batched",
                    choices=["per_lane", "batched", "megakernel"])
    ap.add_argument("--theta", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0,
                    help="request seeds are seed + request index")
    ap.add_argument("--ledger", default=None,
                    help="write the JSON event ledger here")
    ap.add_argument("--device", default="cuda",
                    help="where the pools run: cuda (default) or cpu")
    args = ap.parse_args(argv)

    opts = ZeusOptions(bfgs=BFGSOptions(
        iter_bfgs=args.iter_max, theta=args.theta, ad_mode="reverse",
        sweep_mode=args.sweep_mode))
    registry = ProblemRegistry()
    names = []
    for obj_name, dim in _parse_problems(args.problems):
        pname = f"{obj_name}:{dim}"
        registry.register(pname, obj_name, dim, opts=opts)
        names.append(pname)

    service = SolveService(registry, slots=args.slots,
                           max_queue=args.max_queue,
                           admit_every=args.admit_every, device=args.device)
    rids = [
        service.submit(SolveRequest(
            problem=names[i % len(names)], seed=args.seed + i,
            n_starts=args.n_starts, iter_max=args.iter_max))
        for i in range(args.requests)
    ]
    results = service.drain()

    print(f"[serve] {len(results)} requests drained")
    for rid in rids:
        r = results[rid]
        print(f"  rid={rid:<3d} {r.problem:<16s} status={r.status} "
              f"conv={r.n_converged}/{len(r.lanes)} best_f={r.best_f:.3e} "
              f"admit={r.admit_latency_s * 1e3:.1f}ms "
              f"total={r.total_latency_s * 1e3:.1f}ms")
    stats = service.stats()
    print(f"[serve] sweeps/pool={stats['pool_sweeps']} "
          f"admit_p50={stats['admit_latency_sweeps_p50']:.0f}sw "
          f"p95={stats['admit_latency_sweeps_p95']:.0f}sw "
          f"{stats['solves_per_sec']:.2f} solves/s (incl. compile)")
    if args.ledger:
        service.dump_ledger(args.ledger)
        print(f"[serve] ledger -> {args.ledger}")
    return results


if __name__ == "__main__":
    main()
