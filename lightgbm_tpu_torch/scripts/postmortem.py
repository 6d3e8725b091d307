"""Gang post-mortem CLI: point it at the breadcrumb directory of a dead
run (the supervisor's diagnosis directory, a telemetry_dir, or a
checkpoint directory) and get a classified verdict.

    python -m lightgbm_tpu_torch.scripts.postmortem CKPT_OR_DIAG_DIR
        [MORE_DIRS...] [--checkpoint-dir D] [--json OUT.json]
        [--expect VERDICT]

Merges per-rank flight-recorder JSONLs (``flight_rank*.jsonl``,
incarnation suffixes included), watchdog/divergence diagnosis JSONs and
checkpoint-manifest health sections into one timeline, classifies the
failure (kill / hang / divergence / nan / oom), and names the
first-bad rank. Prints the human report to stdout; ``--json`` also
writes the machine document (the same file
``supervisor.run_supervised`` writes on gang failure). It reads files
only: no card is needed.

Exit codes: 0 = report produced; 1 = ``--expect`` mismatch (smoke
gates use it); 2 = no artifacts found under the given directories.
"""

import argparse
import glob
import json
import os
import sys

from .. import postmortem


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="classify a dead gang's breadcrumbs into a verdict")
    ap.add_argument("dirs", nargs="+",
                    help="directories holding flight_rank*.jsonl / "
                         "watchdog_rank*.json / divergence_rank*.json "
                         "(a checkpoint dir works: its supervisor_diag "
                         "and telemetry subdirs are scanned too)")
    ap.add_argument("--checkpoint-dir", default=None, dest="checkpoint_dir",
                    help="checkpoint directory whose manifests anchor "
                         "the 'last known good' marks (default: the "
                         "first positional dir when it contains ckpt_*)")
    ap.add_argument("--json", default=None, dest="json_out",
                    help="also write the machine JSON report here")
    ap.add_argument("--expect", default=None,
                    choices=postmortem.VERDICTS,
                    help="fail (exit 1) unless the verdict matches "
                         "(for smoke gates)")
    ap.add_argument("--timeline", type=int, default=40,
                    help="max timeline events rendered (default 40)")
    args = ap.parse_args(argv)

    ck = args.checkpoint_dir
    if ck is None:
        for d in args.dirs:
            if glob.glob(os.path.join(d, "ckpt_*")):
                ck = d
                break
    pm = postmortem.analyze(args.dirs, checkpoint_dir=ck)
    if not pm.sources["flights"] and not pm.sources["diags"] \
            and not pm.sources["manifests"]:
        print(f"no post-mortem artifacts found under {args.dirs} "
              f"(looked for flight_rank*.jsonl, watchdog_rank*.json, "
              f"divergence_rank*.json, ckpt_*/MANIFEST.json)",
              file=sys.stderr)
        return 2
    sys.stdout.write(pm.render(max_timeline=args.timeline))
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(pm.to_json(), fh, indent=1, sort_keys=True,
                      default=str)
            fh.write("\n")
        print(f"# machine report: {args.json_out}")
    if args.expect and pm.verdict != args.expect:
        print(f"EXPECT FAILED: verdict {pm.verdict!r} != "
              f"{args.expect!r}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
