#!/usr/bin/env python
"""Render run-doctor postmortem bundles (the port's utils/monitor.py).

    python scripts/torch_postmortem.py RUN_DIR             # every bundle
    python scripts/torch_postmortem.py BUNDLE.json         # one bundle
    python scripts/torch_postmortem.py BUNDLE.json --json  # raw (validated)

The port's copy of scripts/postmortem.py.  A bundle is written at a run's
failure (the launcher's ``worker_fault``: a worker that exits non-zero)
and carries the last-N telemetry records, the SLO states, the gang, serve
stats, memory watermarks and the recent log tail.  Validation (strict
JSON, schema keys, a known trigger) and rendering are
``monitor.load_postmortem`` / ``monitor.format_postmortem``, the pair the
tests and ``torch_telemetry_summary --postmortem`` use.

It imports neither torch nor JAX, so it runs anywhere the run directory
was copied to.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from distributed_pytorch_tpu_torch.utils import monitor  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description="render run-doctor postmortem bundles")
    p.add_argument("target",
                   help="a postmortem bundle, or a run dir holding "
                        f"{monitor.BUNDLE_PREFIX}*.json bundles")
    p.add_argument("--json", action="store_true",
                   help="dump the validated bundle(s) as JSON instead "
                        "of the rendered report")
    args = p.parse_args(argv)

    paths = (monitor.find_postmortems(args.target)
             if os.path.isdir(args.target) else [args.target])
    if not paths:
        print(f"no postmortem bundles under {args.target!r}",
              file=sys.stderr)
        return 1
    bundles = []
    for path in paths:
        try:
            bundles.append((path, monitor.load_postmortem(path)))
        except (OSError, ValueError) as e:
            print(f"invalid bundle {path}: {e}", file=sys.stderr)
            return 1
    if args.json:
        json.dump([b for _, b in bundles] if len(bundles) > 1
                  else bundles[0][1], sys.stdout, indent=1,
                  sort_keys=True)
        print()
        return 0
    for i, (path, bundle) in enumerate(bundles):
        if i:
            print()
        print(f"== {path}")
        print(monitor.format_postmortem(bundle))
    return 0


if __name__ == "__main__":
    sys.exit(main())
