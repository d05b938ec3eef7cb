"""The port's AOT cache CLI (JAX ``tools/aot_cache.py`` and ``tools/compile_golden.py``).

Usage::

    python -m torchmetrics_tpu_torch._aot list   [--dir DIR] [--json]
    python -m torchmetrics_tpu_torch._aot verify [--dir DIR] [--json]
    python -m torchmetrics_tpu_torch._aot evict  [--dir DIR] [--stale] [--kind KIND] [--yes]
    python -m torchmetrics_tpu_torch._aot pack   [--dir DIR] --out BUNDLE.tar.gz
    python -m torchmetrics_tpu_torch._aot unpack [--dir DIR] --bundle BUNDLE.tar.gz [--force]
    python -m torchmetrics_tpu_torch._aot golden [--write]

``--dir`` is the cache directory as set (default ``$TM_TPU_AOT_CACHE``); the
commands act on the port's artifacts under ``<dir>/torch/`` and leave the
JAX package's top level alone. ``list`` prints every artifact with its kind,
owner, format, size and whether it fits this machine (``stale``: another
fingerprint, or a library built by an ``nvcc`` newer than this driver).
``verify`` re-checks each artifact's framing and checksum and exits 1 when one
is corrupt or stale. ``evict`` deletes artifacts: all, one ``--kind``, or
``--stale`` only; ``--yes`` skips the prompt.

``pack`` bundles the artifacts into one gzip tarball with a ``MANIFEST.json``
of sha256 checksums, the JAX package's bundle format. ``unpack`` installs a
bundle, verifying every member against the manifest before anything is
written: a corrupt, tampered or path-escaping bundle is refused whole (exit
1, target untouched). ``--force`` overwrites same-named artifacts.

``golden`` drives the certified default path on the CPU and checks it
against ``torchmetrics_tpu_torch/_compile_golden.json`` (exit 1 on a key
beyond it, or a stale manifest); ``--write`` regenerates the manifest.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import sys
import tarfile
from datetime import datetime, timezone
from pathlib import Path
from typing import Optional

from torchmetrics_tpu_torch._aot.cache import SUBDIR, AotCache

BUNDLE_MANIFEST = "MANIFEST.json"
BUNDLE_VERSION = 1


def _fmt_created(ts) -> str:
    try:
        return datetime.fromtimestamp(float(ts), tz=timezone.utc).strftime("%Y-%m-%d %H:%M:%S")
    except (TypeError, ValueError):
        return "?"


def cmd_list(directory: str, as_json: bool) -> int:
    entries = AotCache(directory).entries()
    if as_json:
        print(json.dumps({"directory": directory, "artifacts": entries}, indent=1, default=str))
        return 0
    if not entries:
        print(f"{directory}: no artifacts")
        return 0
    print(f"{directory}: {len(entries)} artifact(s)")
    header = f"{'kind':<16} {'format':<15} {'bytes':>9} {'created (UTC)':<20} {'status':<10} owner"
    print(header)
    print("-" * len(header))
    for e in entries:
        status = e["status"] if e["status"] != "ok" else ("stale" if e.get("stale") else "ok")
        print(
            f"{e.get('kind', '?'):<16} {str(e.get('format', '?')):<15} {e['file_bytes']:>9}"
            f" {_fmt_created(e.get('created')):<20} {status:<10} {e.get('owner', '?')}"
        )
    return 0


def cmd_verify(directory: str, as_json: bool) -> int:
    entries = AotCache(directory).entries()
    bad = [e for e in entries if e["status"] != "ok" or e.get("stale")]
    if as_json:
        print(json.dumps({"directory": directory, "artifacts": len(entries), "ok": len(entries) - len(bad),
                          "problems": bad}, indent=1, default=str))
    else:
        for e in bad:
            why = e["status"] if e["status"] != "ok" else "does not fit this machine (stale)"
            print(f"BAD {e['path']}: {why}")
        print(f"{len(entries) - len(bad)}/{len(entries)} artifacts verified ok")
    return 1 if bad else 0


def cmd_evict(directory: str, stale: bool, kind: Optional[str], assume_yes: bool) -> int:
    cache = AotCache(directory)
    targets = [
        e for e in cache.entries()
        if (kind is None or e.get("kind") == kind) and (not stale or e["status"] != "ok" or e.get("stale"))
    ]
    if not targets:
        print("nothing to evict")
        return 0
    if not assume_yes:
        print(f"will delete {len(targets)} artifact(s) from {directory}:")
        for e in targets:
            print(f"  {e['path']}")
        if input("proceed? [y/N] ").strip().lower() not in ("y", "yes"):
            print("aborted")
            return 1
    removed = cache.evict(stale_only=stale, kind=kind, entries=targets)
    print(f"evicted {len(removed)} artifact(s)")
    return 0


def _sha256_file(path: Path) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def cmd_pack(directory: str, out: str) -> int:
    src = Path(directory) / SUBDIR
    artifacts = sorted(src.glob("*.aot"))
    if not artifacts:
        print(f"{directory}: no artifacts to pack", file=sys.stderr)
        return 1
    manifest = {
        "version": BUNDLE_VERSION,
        "artifacts": {p.name: {"sha256": _sha256_file(p), "bytes": p.stat().st_size} for p in artifacts},
    }
    out_path = Path(out)
    tmp = out_path.with_suffix(out_path.suffix + ".tmp")
    try:
        with tarfile.open(tmp, "w:gz") as tar:
            manifest_bytes = json.dumps(manifest, indent=1, sort_keys=True).encode()
            info = tarfile.TarInfo(BUNDLE_MANIFEST)
            info.size = len(manifest_bytes)
            tar.addfile(info, io.BytesIO(manifest_bytes))
            for p in artifacts:
                tar.add(p, arcname=p.name)
        os.replace(tmp, out_path)
    finally:
        if tmp.exists():
            tmp.unlink()
    total = sum(e["bytes"] for e in manifest["artifacts"].values())
    print(f"packed {len(artifacts)} artifact(s) ({total} bytes) -> {out_path}")
    return 0


def cmd_unpack(directory: str, bundle: str, force: bool) -> int:
    """Verify, then install: nothing lands under ``<directory>/torch/`` unless the whole bundle checks out
    (manifest present, every member listed, every checksum matching, no member reaching outside the target)."""
    dest = Path(directory) / SUBDIR
    try:
        with tarfile.open(bundle, "r:gz") as tar:
            members = {m.name: m for m in tar.getmembers()}
            meta = members.get(BUNDLE_MANIFEST)
            if meta is None:
                print(f"refusing {bundle}: no {BUNDLE_MANIFEST} in bundle", file=sys.stderr)
                return 1
            fh = tar.extractfile(meta)
            manifest = json.loads(fh.read()) if fh is not None else None
            if not isinstance(manifest, dict) or manifest.get("version") != BUNDLE_VERSION:
                print(f"refusing {bundle}: unknown bundle version", file=sys.stderr)
                return 1
            listed = manifest.get("artifacts", {})
            payloads = {}
            for name, m in members.items():
                if name == BUNDLE_MANIFEST:
                    continue
                # path-traversal guard: members are flat basenames, nothing else
                if not m.isfile() or "/" in name or "\\" in name or name.startswith(".."):
                    print(f"refusing {bundle}: suspicious member {name!r}", file=sys.stderr)
                    return 1
                if name not in listed:
                    print(f"refusing {bundle}: member {name!r} not in manifest", file=sys.stderr)
                    return 1
                data = tar.extractfile(m).read()
                if hashlib.sha256(data).hexdigest() != listed[name]["sha256"]:
                    print(f"refusing {bundle}: checksum mismatch for {name!r}", file=sys.stderr)
                    return 1
                payloads[name] = data
            missing = sorted(set(listed) - set(payloads))
            if missing:
                print(f"refusing {bundle}: manifest lists absent member(s) {missing}", file=sys.stderr)
                return 1
    except (tarfile.TarError, OSError, ValueError, EOFError, json.JSONDecodeError) as err:
        print(f"refusing {bundle}: unreadable bundle ({err})", file=sys.stderr)
        return 1
    if not payloads:
        print(f"refusing {bundle}: empty bundle", file=sys.stderr)
        return 1
    clobbered = [n for n in payloads if (dest / n).exists()]
    if clobbered and not force:
        print(f"refusing to overwrite {len(clobbered)} existing artifact(s) (pass --force): "
              + ", ".join(clobbered[:5]), file=sys.stderr)
        return 1
    dest.mkdir(parents=True, exist_ok=True)
    for name, data in sorted(payloads.items()):
        tmp = dest / (name + ".tmp")
        tmp.write_bytes(data)
        os.replace(tmp, dest / name)
    print(f"installed {len(payloads)} artifact(s) into {dest}")
    return 0


def cmd_golden(write: bool) -> int:
    from torchmetrics_tpu_torch._aot.golden import GOLDEN_PATH, check_observed, load_golden, write_golden

    if write:
        blob = write_golden()
        n_keys = sum(len(v) for v in blob["classes"].values())
        print(f"wrote {GOLDEN_PATH}: {len(blob['classes'])} classes, {n_keys} compile keys")
        return 0
    from torchmetrics_tpu_torch._aot.default_path import drive_default_path

    golden = load_golden()
    problems = check_observed(drive_default_path(device="cpu"), golden)
    if problems:
        print(f"RECOMPILE GATE FAILED ({len(problems)} problem(s)):")
        for p in problems:
            print(f"  - {p}")
        return 1
    n_keys = sum(len(v) for v in golden.values())
    print(f"certified default path clean: {len(golden)} classes, {n_keys} compile keys, zero beyond golden")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m torchmetrics_tpu_torch._aot", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)
    for name in ("list", "verify", "evict", "pack", "unpack", "golden"):
        p = sub.add_parser(name)
        if name == "golden":
            p.add_argument("--write", action="store_true", help="regenerate the golden manifest")
            continue
        p.add_argument("--dir", default=os.environ.get("TM_TPU_AOT_CACHE", ""), help="cache directory")
        if name in ("list", "verify"):
            p.add_argument("--json", action="store_true")
        elif name == "evict":
            p.add_argument("--stale", action="store_true", help="only stale and corrupt artifacts")
            p.add_argument("--kind", default=None, help="only artifacts of this kind")
            p.add_argument("--yes", action="store_true", help="skip the confirmation prompt")
        elif name == "pack":
            p.add_argument("--out", required=True, help="bundle tarball to write")
        else:
            p.add_argument("--bundle", required=True, help="bundle tarball to install")
            p.add_argument("--force", action="store_true", help="overwrite same-named artifacts")
    args = parser.parse_args(argv)
    if args.command == "golden":
        return cmd_golden(args.write)
    if not args.dir:
        print("no cache directory: pass --dir or set TM_TPU_AOT_CACHE", file=sys.stderr)
        return 2
    if args.command == "list":
        return cmd_list(args.dir, args.json)
    if args.command == "verify":
        return cmd_verify(args.dir, args.json)
    if args.command == "pack":
        return cmd_pack(args.dir, args.out)
    if args.command == "unpack":
        return cmd_unpack(args.dir, args.bundle, args.force)
    return cmd_evict(args.dir, args.stale, args.kind, args.yes)


if __name__ == "__main__":
    raise SystemExit(main())
