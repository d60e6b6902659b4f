"""Sweep one configuration key of a cell on the card: the runs that fixed
``batch`` and ``kmax`` of ``did60_scen``.

    python3 -m portbench.tools.sweep --workload did60_scen.montecarlo \
        --key batch --values 1024 4096 16384 --seeds 11 12 --seconds 10 \
        --trace 1 [--set key=JSON ...] [--out chiprun_out/sweep.jsonl]

Each (value, seed) is one :func:`portbench.run.run` in this process (the
first pays the build and the card's start), with the key overridden; one
line of JSON a run goes to standard output and to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--key", required=True)
    ap.add_argument("--values", type=int, nargs="+", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--set", nargs="*", default=[],
                    help="further overrides, key=JSON value")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from portbench import run as bench_run

    extra = {k: json.loads(v) for k, v in
             (kv.split("=", 1) for kv in args.set)}
    for val in args.values:
        for seed in args.seeds:
            res = bench_run.run(args.workload, seed, args.seconds,
                                bool(args.trace),
                                overrides=dict(extra, **{args.key: val}),
                                control=bool(args.control))
            line = json.dumps(dict(
                key=args.key, value=val, seed=seed,
                correct=res["correct"], attempted=res["attempted"],
                failed=res["failed"], window=res["window"],
                metrics={k: m["value"] for k, m in res["metrics"].items()},
                device=res["device"], check=res["check"],
                breakdown=res.get("breakdown")))
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as fh:
                    fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
