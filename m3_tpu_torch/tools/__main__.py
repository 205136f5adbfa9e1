"""Tools CLI dispatcher (port of m3_tpu/tools/__main__.py; reference:
src/cmd/tools/*/main):
python -m m3_tpu_torch.tools read_data_files --root R --namespace ns --shard 0

The decoding tools (read_data_files, read_ids, verify_index_files) run on
the CUDA card unless `--device` names another device, and exit non-zero
without one; their last line on stderr is the kernels' launches, as JSON
("m3_tpu_torch <tool> kernel launches {...}"). The others are host only
and take no `--device`."""

from __future__ import annotations

import argparse
import json
import sys

from . import fileset_tools as ft


def main(argv=None):
    p = argparse.ArgumentParser(prog="m3_tpu_torch.tools")
    sub = p.add_subparsers(dest="tool", required=True)

    def common(sp, commitlog=False, device=False):
        if commitlog:
            sp.add_argument("--dir", required=True)
            return
        sp.add_argument("--root", required=True)
        sp.add_argument("--namespace", required=True)
        sp.add_argument("--shard", type=int, required=True)
        sp.add_argument("--block-start", type=int, default=None)
        if device:
            sp.add_argument("--device", default=None,
                            help="torch device to decode on (default: the "
                                 "CUDA card)")

    common(sub.add_parser("read_data_files"), device=True)
    common(sub.add_parser("read_index_files"))
    common(sub.add_parser("read_ids"), device=True)
    common(sub.add_parser("verify_index_files"), device=True)
    common(sub.add_parser("verify_commitlogs"), commitlog=True)
    cp = sub.add_parser("clone_fileset")
    common(cp)
    cp.add_argument("--dst", required=True)

    args = p.parse_args(argv)
    ns = args.namespace.encode() if hasattr(args, "namespace") else None
    if hasattr(args, "device"):
        from ..device import resolve

        try:
            device = resolve(args.device)
        except RuntimeError as err:
            print(err, file=sys.stderr)
            return 1
        rc = _run(args, ns, device)
        from ..ops import kernel_launches

        print(f"m3_tpu_torch {args.tool} kernel launches "
              f"{json.dumps(kernel_launches())}", file=sys.stderr)
        return rc
    return _run(args, ns, None)


def _run(args, ns, device) -> int:
    """One tool's work and its exit code."""
    if args.tool == "read_data_files":
        for sid, t, v in ft.read_data_files(args.root, ns, args.shard,
                                            args.block_start, device=device):
            for ts, val in zip(t, v):
                print(f"{sid.decode(errors='replace')} {ts} {val}")
    elif args.tool == "read_ids":
        for sid in ft.read_ids(args.root, ns, args.shard, device=device):
            print(sid.decode(errors="replace"))
    elif args.tool == "read_index_files":
        out = ft.read_index_files(args.root, ns, args.shard)
        for fs in out:
            print(json.dumps({**fs, "entries": [
                {**e, "id": e["id"].decode(errors="replace")}
                for e in fs["entries"]]}))
    elif args.tool == "verify_index_files":
        out = ft.verify_index_files(args.root, ns, args.shard,
                                     device=device)
        print(json.dumps(out))
        return 1 if out["corrupt"] else 0
    elif args.tool == "verify_commitlogs":
        out = ft.verify_commitlogs(args.dir)
        # Namespaces are bytes; the reference's json.dumps of them raises.
        print(json.dumps({**out, "namespaces": [
            n.decode(errors="replace") for n in out["namespaces"]]}))
        return 1 if out["errors"] else 0
    elif args.tool == "clone_fileset":
        cloned = ft.clone_fileset(args.root, args.dst, ns, args.shard,
                                  args.block_start)
        for path in cloned:
            print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
