#!/usr/bin/env python
"""Inspect a telemetry run directory: per-phase/per-rank tables, step-time
percentiles, the event log, and the merged Chrome-trace export.

    python scripts/torch_telemetry_summary.py RUN_DIR
    python scripts/torch_telemetry_summary.py RUN_DIR --chrome-trace t.json
    python scripts/torch_telemetry_summary.py RUN_DIR --json
    python scripts/torch_telemetry_summary.py RUN_DIR --slo [--rules r.json]
    python scripts/torch_telemetry_summary.py --postmortem BUNDLE_OR_RUN_DIR

The port's copy of scripts/telemetry_summary.py, reading through the
port's utils/telemetry.py and utils/monitor.py (the two packages write the
same records, so either script reads either package's runs).  The run
directory is whatever ``--telemetry-dir`` (cli.py / lm_cli.py / launch.py
of distributed_pytorch_tpu_torch) pointed at: one rank-tagged JSONL file
per process.  ``--chrome-trace`` writes one merged Chrome-trace/Perfetto
JSON spanning every rank and generation (open it at
https://ui.perfetto.dev): pid = rank, tid = phase, the generation on every
event.  ``--json`` dumps the machine-readable ``run_summary`` instead of
the tables.

It imports neither torch nor JAX, so it runs anywhere the run directory
was copied to.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from distributed_pytorch_tpu_torch.utils import monitor, telemetry  # noqa: E402,E501


def _fmt_s(v: float) -> str:
    return f"{v * 1e3:.2f}ms" if v < 1.0 else f"{v:.3f}s"


def _fleet_rows(summary: dict) -> dict[str, dict[str, str]]:
    """Fleet-phase activity per replica lane (a serving fleet's registry
    per replica, rank = replica id, the router rank -2): the
    ``rank{R}/fleet/{name}`` keys are the per-replica grouping."""
    rows: dict[str, dict[str, str]] = {}
    for section, fmt in (
            ("spans",
             lambda st: f"{st['count']}x {_fmt_s(st['total_s'])}"),
            ("events", lambda e: f"{e['count']}x"),
            ("counters", lambda v: f"{v:g}")):
        for key, st in summary[section].items():
            rank, phase, name = key.split("/", 2)
            if phase == "fleet":
                rows.setdefault(rank, {})[name] = fmt(st)
    return rows


def print_tables(run_dir: str, summary: dict, *, max_events: int) -> None:
    print(f"telemetry run: {os.path.abspath(run_dir)}")
    print(f"ranks: {summary['ranks']}  "
          f"generations: {summary['generations']}")

    if summary["spans"]:
        print("\nspans (per rank/phase/name):")
        hdr = (f"  {'where':<40} {'count':>6} {'total':>10} {'p50':>10} "
               f"{'p95':>10} {'max':>10}")
        print(hdr)
        for key, st in summary["spans"].items():
            print(f"  {key:<40} {st['count']:>6} "
                  f"{_fmt_s(st['total_s']):>10} {_fmt_s(st['p50_s']):>10} "
                  f"{_fmt_s(st['p95_s']):>10} {_fmt_s(st['max_s']):>10}")

    fleet = _fleet_rows(summary)
    if fleet:
        print("\nserving fleet (per replica lane; rank -2 = router):")
        for rank in sorted(fleet, key=lambda r: int(r[4:])):
            parts = "  ".join(f"{n}={v}"
                              for n, v in sorted(fleet[rank].items()))
            print(f"  {rank:<8} {parts}")

    if summary["counters"]:
        print("\ncounters (final totals):")
        for key, v in summary["counters"].items():
            print(f"  {key:<40} {v:>10g}")

    if summary["gauges"]:
        print("\ngauges (last value):")
        for key, g in summary["gauges"].items():
            last = g["last"]
            shown = f"{last:.6g}" if isinstance(last, float) else str(last)
            print(f"  {key:<40} {shown:>12}  (x{g['count']})")

    if summary["events"]:
        print("\nevents (count, by generation):")
        for key, e in summary["events"].items():
            by_gen = ", ".join(f"gen{g}: {n}"
                               for g, n in sorted(e["by_gen"].items()))
            print(f"  {key:<40} {e['count']:>6}  ({by_gen})")

    # chronological event log (discrete events only; spans/gauges are
    # summarized above)
    rows = []
    for epoch, records in telemetry.read_run(run_dir):
        for rec in records:
            if rec.get("type") == "event":
                rows.append((telemetry._align_us(epoch, rec["ts"]), rec))
    rows.sort(key=lambda r: r[0])
    if rows:
        print(f"\nevent log ({min(len(rows), max_events)} of {len(rows)}):")
        for ts_us, rec in rows[:max_events]:
            args = dict(rec.get("args") or {})
            # a caller-supplied generation wins over the registry's, as in
            # the trace and by_gen tables (the agent is pinned gen 0 but
            # its events span every generation)
            gen = args.pop("gen", rec.get("gen"))
            arg_s = " ".join(f"{k}={v}" for k, v in args.items())
            print(f"  t+{(ts_us - rows[0][0]) / 1e6:9.3f}s "
                  f"rank{rec.get('rank')} gen{gen} "
                  f"[{rec.get('phase')}] {rec.get('name')} {arg_s}")


def print_slo_table(run_dir: str, rules) -> int:
    """Offline doctor pass (monitor.evaluate_run) rendered as a breach
    table; returns the number of rules currently in breach."""
    states = monitor.evaluate_run(run_dir, rules)
    print(f"\nSLO monitors ({len(states)} rules):")
    print(f"  {'rule':<24} {'state':<9} {'metric':<22} {'agg':>5} "
          f"{'current':>12} {'bound':>14} {'breaches':>8} "
          f"{'samples':>8}")
    breached = 0
    for name in sorted(states):
        st = states[name]
        rule = st["rule"]
        mark = "BREACHED" if st["breached"] else "ok"
        breached += int(bool(st["breached"]))
        cur = st["current"]
        cur_s = f"{cur:.4g}" if isinstance(cur, (int, float)) else "-"
        bound = f"{rule['op']} {rule['threshold']:g}"
        print(f"  {name:<24} {mark:<9} {rule['metric']:<22} "
              f"{rule['agg']:>5} {cur_s:>12} {bound:>14} "
              f"{st['breaches']:>8} {st['samples']:>8}")
    return breached


def print_postmortems(target: str) -> int:
    """Render one bundle, or every bundle under a run dir, through
    monitor.load_postmortem / format_postmortem.  Returns bundles
    rendered."""
    paths = (monitor.find_postmortems(target) if os.path.isdir(target)
             else [target])
    if not paths:
        print(f"no postmortem bundles "
              f"({monitor.BUNDLE_PREFIX}*.json) under {target!r}")
        return 0
    for i, path in enumerate(paths):
        if i:
            print()
        print(f"== {path}")
        print(monitor.format_postmortem(monitor.load_postmortem(path)))
    return len(paths)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description="merge/inspect a unified-telemetry run directory")
    p.add_argument("run_dir", nargs="?", default=None,
                   help="directory of events_*.jsonl files "
                        "(a --telemetry-dir)")
    p.add_argument("--chrome-trace", default=None, metavar="OUT_JSON",
                   help="write the merged Chrome-trace/Perfetto JSON "
                        "(pid=rank, tid=phase, generation-tagged)")
    p.add_argument("--json", action="store_true",
                   help="dump the machine-readable run summary instead "
                        "of tables")
    p.add_argument("--max-events", type=int, default=40,
                   help="event-log rows to print (tables mode)")
    p.add_argument("--slo", action="store_true",
                   help="evaluate SLO rules over the run (offline "
                        "doctor pass) and print the breach table; "
                        "exits 2 when any rule is in breach")
    p.add_argument("--rules", default=None, metavar="RULES_JSON",
                   help="SLO rule list (monitor.SloRule dicts); "
                        "default: monitor.default_rules()")
    p.add_argument("--postmortem", default=None, metavar="BUNDLE",
                   help="render a postmortem bundle (or every bundle "
                        "under a run dir) and exit")
    args = p.parse_args(argv)

    if args.postmortem is not None:
        return 0 if print_postmortems(args.postmortem) else 1

    if args.run_dir is None:
        p.error("run_dir is required (unless --postmortem)")
    if not os.path.isdir(args.run_dir):
        p.error(f"{args.run_dir!r} is not a directory")
    summary = telemetry.run_summary(args.run_dir)
    if not summary["ranks"]:
        p.error(f"no telemetry files ({telemetry.FILE_PREFIX}*.jsonl) "
                f"under {args.run_dir!r}")

    if args.json:
        json.dump(summary, sys.stdout, indent=1, sort_keys=True)
        print()
    else:
        print_tables(args.run_dir, summary, max_events=args.max_events)

    breached = 0
    if args.slo:
        rules = (monitor.rules_from_json(args.rules)
                 if args.rules else monitor.default_rules())
        breached = print_slo_table(args.run_dir, rules)

    if args.chrome_trace:
        trace = telemetry.merge_chrome_trace(args.run_dir)
        tmp = args.chrome_trace + ".tmp"
        with open(tmp, "w") as f:
            json.dump(trace, f)
        os.replace(tmp, args.chrome_trace)
        print(f"\nchrome trace: {args.chrome_trace} "
              f"({len(trace['traceEvents'])} events) — open in "
              f"https://ui.perfetto.dev", file=sys.stderr)
    return 2 if breached else 0


if __name__ == "__main__":
    sys.exit(main())
