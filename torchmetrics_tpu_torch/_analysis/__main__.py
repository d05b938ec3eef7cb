"""Trace-safety and concurrency lint CLI for torchmetrics_tpu_torch.

Usage:
    python -m torchmetrics_tpu_torch._analysis torchmetrics_tpu_torch/            # human report
    python -m torchmetrics_tpu_torch._analysis torchmetrics_tpu_torch/ --json     # CI / machines
    python -m torchmetrics_tpu_torch._analysis torchmetrics_tpu_torch/ --write-baseline
    python -m torchmetrics_tpu_torch._analysis torchmetrics_tpu_torch/ --write-manifest
    python -m torchmetrics_tpu_torch._analysis torchmetrics_tpu_torch/ --write-thread-safety

Exit status: 0 when no un-baselined violations (and no parse errors),
1 otherwise. ``--write-baseline`` rewrites the suppression file to the
current violation set (keeping existing justifications) and exits 0;
``--write-manifest`` regenerates the certified-clean class manifest the
runtime uses to skip the `_host_attr_snapshot` fingerprint guard;
``--write-thread-safety`` regenerates the guard map the lock sanitizer
verifies. Every write mode refuses a partial scan (exit 2), which would drop
the entries of the files it did not scan.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import List, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
DEFAULT_BASELINE = Path(__file__).resolve().parent / "lint_baseline.json"


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m torchmetrics_tpu_torch._analysis",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("paths", nargs="*", help="files or directories to scan (default: the whole package)")
    parser.add_argument("--json", action="store_true", help="emit a machine-readable JSON report")
    parser.add_argument("--baseline", type=Path, default=DEFAULT_BASELINE, help="baseline suppression file")
    parser.add_argument("--no-baseline", action="store_true", help="report every violation, ignoring the baseline")
    parser.add_argument("--write-baseline", action="store_true", help="rewrite the baseline to the current violations")
    parser.add_argument("--write-manifest", action="store_true", help="regenerate the certified-clean manifest")
    parser.add_argument("--manifest", type=Path, default=None, help="manifest output path (default: package location)")
    parser.add_argument(
        "--write-thread-safety", action="store_true",
        help="regenerate the concurrency guard-map manifest (per-module verdicts, R7-R9)",
    )
    args = parser.parse_args(argv)

    from torchmetrics_tpu_torch._analysis import (
        MANIFEST_PATH,
        RULES,
        THREAD_SAFETY_PATH,
        analyze_paths,
        load_baseline,
        split_baselined,
        thread_safety_to_json,
        write_baseline,
        write_manifest,
        write_thread_safety,
    )
    from torchmetrics_tpu_torch._analysis.manifest import load_manifest, load_thread_safety

    t0 = time.perf_counter()
    paths = args.paths or [str(PACKAGE_DIR)]
    result = analyze_paths(paths)
    elapsed = time.perf_counter() - t0

    baseline = {} if args.no_baseline else load_baseline(args.baseline)
    new, suppressed, stale = split_baselined(result.violations, baseline, scanned_paths=result.scanned_paths)

    # the write modes rewrite their file to exactly the current scan's view,
    # so a partial (single-file / subpackage) scan would silently drop every
    # entry belonging to an unscanned file — refuse instead of corrupting
    scanned = set(result.scanned_paths)

    def _module_files(qualname: str) -> tuple:
        mod = qualname.rsplit(".", 1)[0].replace(".", "/")
        return (f"{mod}.py", f"{mod}/__init__.py")

    if args.write_baseline:
        undecided = sorted({e.path for e in baseline.values() if e.path not in scanned})
        if undecided:
            print(
                f"refusing --write-baseline on a partial scan: {len(undecided)} baselined"
                " file(s) were not scanned and their entries would be dropped"
                f" (e.g. {undecided[0]}); rerun on the package root"
            )
            return 2
        n = write_baseline(result.violations, args.baseline, baseline)
        print(f"wrote {n} baseline entries to {args.baseline}")
        return 0

    if args.write_manifest:
        out = args.manifest or MANIFEST_PATH
        prior = load_manifest(out) if out.exists() else frozenset()
        dropped = sorted(
            c
            for c in prior
            if c not in result.certified and not any(f in scanned for f in _module_files(c))
        )
        if dropped:
            print(
                f"refusing --write-manifest on a partial scan: {len(dropped)} previously"
                " certified class(es) live in unscanned files and would lose their"
                f" fingerprint-skip certification (e.g. {dropped[0]}); rerun on the package root"
            )
            return 2
        n = write_manifest(result.certified, out)
        print(f"wrote {n} certified R1-clean classes to {out}")
        return 0

    if args.write_thread_safety:
        prior = load_thread_safety(THREAD_SAFETY_PATH) if THREAD_SAFETY_PATH.exists() else {}
        dropped = sorted(p for p in prior if p not in scanned)
        if dropped:
            print(
                f"refusing --write-thread-safety on a partial scan: {len(dropped)} previously"
                f" recorded module(s) were not scanned (e.g. {dropped[0]}); rerun on the"
                " package root"
            )
            return 2
        n = write_thread_safety(thread_safety_to_json(result.thread_safety.values()), THREAD_SAFETY_PATH)
        print(f"wrote {n} module thread-safety verdicts to {THREAD_SAFETY_PATH}")
        return 0

    if args.json:
        # per-rule finding counts over the whole catalog (zeros included), so
        # a diff of two reports shows exactly which rule moved
        rule_counts = {
            rule_id: {
                "new": sum(1 for v in new if v.rule == rule_id),
                "baselined": sum(1 for v in suppressed if v.rule == rule_id),
            }
            for rule_id in sorted(RULES, key=lambda r: int(r[1:]))
        }
        print(
            json.dumps(
                {
                    "files_scanned": result.files_scanned,
                    "classes_seen": result.classes_seen,
                    "certified_count": len(result.certified),
                    "rule_counts": rule_counts,
                    "elapsed_seconds": round(elapsed, 3),
                    "violations": [v.to_json() for v in new],
                    "suppressed_count": len(suppressed),
                    "stale_baseline_entries": [
                        {"path": e.path, "rule": e.rule, "scope": e.scope, "snippet": e.snippet} for e in stale
                    ],
                    "parse_errors": result.parse_errors,
                },
                indent=2,
            )
        )
    else:
        for v in new:
            print(v.render())
        for err in result.parse_errors:
            print(f"PARSE ERROR: {err}")
        print(
            f"\nscanned {result.files_scanned} files / {result.classes_seen} classes in {elapsed:.2f}s:"
            f" {len(new)} violations ({len(suppressed)} baselined, {len(stale)} stale baseline entries),"
            f" {len(result.certified)} classes certified R1-clean"
        )
        if stale:
            print("stale baseline entries (fixed code — prune with --write-baseline):")
            for e in stale[:20]:
                print(f"  {e.path} {e.rule} [{e.scope}] {e.snippet}")

    return 1 if (new or result.parse_errors) else 0


if __name__ == "__main__":
    raise SystemExit(main())
