"""The chaos corpus runner: seeded fleet-scale fault schedules over the
port's fleet (``testing/chaos.py``).

The counterpart of the JAX repository's ``tools/chaos_run.py`` (a tool
beside the JAX package, not a module of it), with its flags, its exit
status and its last line; it imports nothing of the JAX package or of the
repository's ``tools/``. Explore a corpus::

    python -m k8s_operator_libs_tpu_torch.tools.chaos_run --seeds 200

Reproduce one failing seed, writing its schedule to a file::

    python -m k8s_operator_libs_tpu_torch.tools.chaos_run --seed 17 --schedule-json out.json

Replay a schedule file (the config rides inside it; a file the JAX
command wrote replays here to the same final digest)::

    python -m k8s_operator_libs_tpu_torch.tools.chaos_run --replay out.json

Check one seed's determinism (run it twice, compare the traces)::

    python -m k8s_operator_libs_tpu_torch.tools.chaos_run --seed 17 --verify-determinism

The exit status is nonzero on any invariant violation or non-convergence.
The last line of standard output is one JSON summary object. In corpus
mode each seed's line on standard error also carries its fires and its
final digest.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_config(args):
    from ..testing.chaos import ChaosConfig

    return ChaosConfig(
        pools=args.pools,
        hosts=args.hosts,
        workers=args.workers,
        shards=args.shards,
        budget=args.budget,
        hub=args.hub,
        checkpoint=args.checkpoint,
        wire=args.wire,
        relay=args.relay,
        replicas=args.replicas,
        max_steps=args.max_steps,
        policy=tuple(args.policy or ()),
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=0,
                        help="corpus mode: run seeds [start, start+N)")
    parser.add_argument("--start-seed", type=int, default=0)
    parser.add_argument("--seed", type=int, default=None,
                        help="run exactly one seed")
    parser.add_argument("--schedule-json", default="",
                        help="write the seed's schedule JSON here "
                             "(the repro artifact)")
    parser.add_argument("--replay", default="",
                        help="run a schedule JSON file instead of a seed")
    parser.add_argument("--verify-determinism", action="store_true",
                        help="run each schedule twice and require "
                             "identical traces + final state")
    parser.add_argument("--trace-json", default="",
                        help="run with the rollout tracer installed and "
                             "write the causal span trace (normalized "
                             "JSONL, docs/tracing.md) here — the repro "
                             "artifact's flight recorder; with "
                             "--verify-determinism the run-twice check "
                             "extends to byte-identical trace exports")
    parser.add_argument("--pools", type=int, default=64)
    parser.add_argument("--hosts", type=int, default=1)
    parser.add_argument("--workers", type=int, default=2)
    parser.add_argument("--shards", type=int, default=4)
    parser.add_argument("--budget", default="25%")
    parser.add_argument("--max-steps", type=int, default=0)
    parser.add_argument("--hub", action="store_true",
                        help="co-hosted workers behind one WatchHub "
                             "(arms the hub_replay fault point)")
    parser.add_argument("--checkpoint", action="store_true",
                        help="checkpoint-coordinated drains + victim "
                             "workloads (arms the worker-restart-mid-"
                             "checkpoint scenario)")
    parser.add_argument("--wire", action="store_true",
                        help="run over a LocalApiServer (arms wire_kill)")
    parser.add_argument("--relay", action="store_true",
                        help="co-hosted workers stream watches through "
                             "one WatchRelay (arms relay_kill)")
    parser.add_argument("--replicas", type=int, default=0,
                        help="with --wire: N read replicas over the "
                             "primary's journal (arms replica_failover)")
    parser.add_argument("--policy", action="append", default=None,
                        metavar="NAME",
                        help="compose this registered upgrade policy "
                             "into the pools' spec (repeatable; "
                             "docs/policy-plugins.md)")
    parser.add_argument("--policy-matrix", action="store_true",
                        help="corpus mode: sweep the shipped policy "
                             "compositions (standard_compositions) over "
                             "the seed corpus; fails on any budget "
                             "violation")
    parser.add_argument("--quiet", action="store_true")
    args = parser.parse_args(argv)

    import logging

    logging.basicConfig(
        level=logging.ERROR if args.quiet else logging.WARNING
    )
    from ..testing.chaos import (
        FaultSchedule,
        generate_schedule,
        run_corpus,
        run_schedule,
    )

    def run_traced(schedule):
        """run_schedule under a fresh tracer; returns (result, trace
        bytes). The export is NORMALIZED (content-ordered ids) and
        excludes spans stamped after the harness retired its virtual
        clock (teardown runs on real time — by then the deterministic
        record is complete), so the same seed exports the same bytes."""
        from ..utils import tracing

        tracer = tracing.Tracer()
        tracing.install_tracer(tracer)
        try:
            result = run_schedule(schedule)
        finally:
            tracing.clear_tracer()
        return result, tracer.export_bytes(
            end_before=tracing.CHAOS_EXPORT_CUTOFF
        )

    def run_once(schedule) -> dict:
        if args.trace_json:
            result, trace_blob = run_traced(schedule)
        else:
            result, trace_blob = run_schedule(schedule), None
        if args.verify_determinism:
            if args.trace_json:
                second, second_blob = run_traced(schedule)
            else:
                second, second_blob = run_schedule(schedule), None
            deterministic = (
                result.final_digest == second.final_digest
                and result.trace == second.trace
                and trace_blob == second_blob
            )
        else:
            deterministic = None
        summary = result.summary()
        if trace_blob is not None:
            with open(args.trace_json, "wb") as f:
                f.write(trace_blob)
            summary["trace_spans"] = trace_blob.count(b"\n")
            summary["trace_json"] = args.trace_json
            print(f"trace written to {args.trace_json}", file=sys.stderr)
        if deterministic is not None:
            summary["deterministic_replay"] = deterministic
        return summary

    if args.replay:
        with open(args.replay, encoding="utf-8") as f:
            schedule = FaultSchedule.from_json(f.read())
        summary = run_once(schedule)
        print(json.dumps(summary, sort_keys=True))
        ok = summary["converged"] and not summary["total_violations"]
        ok = ok and summary.get("deterministic_replay", True)
        return 0 if ok else 1

    config = build_config(args)

    if args.seed is not None:
        schedule = generate_schedule(args.seed, config)
        if args.schedule_json:
            with open(args.schedule_json, "w", encoding="utf-8") as f:
                f.write(schedule.to_json())
            print(f"schedule written to {args.schedule_json}",
                  file=sys.stderr)
        summary = run_once(schedule)
        print(json.dumps(summary, sort_keys=True))
        ok = summary["converged"] and not summary["total_violations"]
        ok = ok and summary.get("deterministic_replay", True)
        return 0 if ok else 1

    if args.seeds <= 0:
        parser.error("one of --seeds, --seed, --replay is required")
    if args.verify_determinism:
        # Corpus mode never re-runs schedules; silently ignoring the
        # flag would let a nondeterminism regression pass a run the
        # operator believes replay-verified.
        parser.error(
            "--verify-determinism applies to --seed/--replay only "
            "(the run-twice check doubles corpus cost; verify a "
            "specific seed instead)"
        )

    def progress(result) -> None:
        # The JAX command's progress line, with each seed's fires and final
        # digest besides (the corpus summary has neither).
        line = {
            "seed": result.seed,
            "converged": result.converged,
            "violations": result.total_violations,
            "steps": result.steps,
            "wall_s": round(result.wall_s, 3),
            "fired": result.fired,
            "final_digest": result.final_digest,
        }
        print(json.dumps(line, sort_keys=True), file=sys.stderr)

    if args.policy_matrix:
        if args.policy:
            parser.error(
                "--policy-matrix sweeps the shipped compositions; it "
                "does not compose with --policy"
            )
        from ..testing.chaos import run_policy_matrix

        summary = run_policy_matrix(
            range(args.start_seed, args.start_seed + args.seeds),
            config,
            on_result=progress,
        )
        print(json.dumps(summary, sort_keys=True))
        failed = (
            summary["invariant_violations"] or summary["not_converged"]
        )
        return 1 if failed else 0

    summary = run_corpus(
        range(args.start_seed, args.start_seed + args.seeds),
        config,
        on_result=progress,
    )
    print(json.dumps(summary, sort_keys=True))
    failed = summary["invariant_violations"] or summary["not_converged"]
    if failed and summary["failing_seeds"]:
        seed = summary["failing_seeds"][0]
        # Echo the corpus's config flags: regenerating the seed under a
        # DIFFERENT config is a different schedule, not a repro.
        flags = [
            f"--pools {args.pools}", f"--hosts {args.hosts}",
            f"--workers {args.workers}", f"--shards {args.shards}",
            f"--budget {args.budget}",
        ]
        if args.max_steps:
            flags.append(f"--max-steps {args.max_steps}")
        for switch in ("hub", "checkpoint", "wire", "relay"):
            if getattr(args, switch):
                flags.append(f"--{switch}")
        if args.replicas:
            flags.append(f"--replicas {args.replicas}")
        for name in args.policy or ():
            flags.append(f"--policy {name}")
        print(
            "reproduce with: python -m k8s_operator_libs_tpu_torch.tools.chaos_run "
            f"--seed {seed} {' '.join(flags)} "
            f"--schedule-json chaos-seed-{seed}.json",
            file=sys.stderr,
        )
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
