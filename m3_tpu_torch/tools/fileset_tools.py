"""Fileset/commitlog inspection + verification tools (port of
m3_tpu/tools/fileset_tools.py; reference: src/cmd/tools/{read_data_files,
read_index_files,read_ids,verify_commitlogs,verify_index_files,
clone_fileset}/main/main.go).

Each function returns structured results (and the CLI prints them), so the
same code serves tests, scripts, and operators.

The readers take `device=None` (the CUDA card; they raise without one
unless given "cpu") and decode each fileset through `FilesetReader(...)
.to_block(device)` in one batched decode (K2 on the card); verification
also rebuilds each bloom on the device (K3). One stated divergence:
the reference's `verify_index_files` reports every exception as
corruption, the port's lets a device fault (`ComputeError`, or the
`RuntimeError` of a missing card or a CUDA error) propagate, since a
device fault says nothing about the fileset. What a corrupt or
incomplete file raises is reported under `corrupt`, as in the
reference."""

from __future__ import annotations

import os
import shutil
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..device import resolve
from ..parallel.guard import ComputeError
from ..persist import commitlog as cl
from ..persist.fs import FilesetReader, PersistManager, fileset_complete


def _decoded_rows(path: str, device, verify: bool = False):
    """(ids, [(timestamps, values)] by row) of one fileset, decoded in one
    launch. `verify` also checks row checksums and the bloom."""
    reader = FilesetReader(path, device=device)
    if verify:
        reader.verify_rows()
    blk, ids = reader.to_block()
    if not ids:
        return ids, []
    ts, vals, npts = blk.read_all()
    rows = [(np.ascontiguousarray(ts[i, :n]), np.ascontiguousarray(vals[i, :n]))
            for i, n in enumerate(np.asarray(npts).tolist())]
    return ids, rows


def read_data_files(root: str, namespace: bytes, shard: int,
                    block_start: Optional[int] = None, *, device=None
                    ) -> Iterator[Tuple[bytes, np.ndarray, np.ndarray]]:
    """Yield (series_id, timestamps, values) for every series in the shard's
    filesets (read_data_files: decode every entry)."""
    dev = resolve(device)

    def rows():
        pm = PersistManager(root)
        for bs, path in pm.list_filesets(namespace, shard):
            if block_start is not None and bs != block_start:
                continue
            ids, decoded = _decoded_rows(path, dev)
            for sid, (t, v) in zip(ids, decoded):
                yield sid, t, v

    return rows()


def read_ids(root: str, namespace: bytes, shard: int, *,
             device=None) -> List[bytes]:
    """Just the series IDs (read_ids)."""
    dev = resolve(device)
    pm = PersistManager(root)
    out: List[bytes] = []
    for _bs, path in pm.list_filesets(namespace, shard):
        _blk, ids = FilesetReader(path, device=dev).to_block()
        out.extend(ids)
    return sorted(set(out))


def read_index_files(root: str, namespace: bytes, shard: int) -> List[dict]:
    """Per-fileset index summaries: each entry's id, data row, bits,
    points and row checksum (read_index_files). Host only: nothing is
    decoded. (The reference reads fields an index entry does not have and
    raises AttributeError; the entries here are the ones the file holds.)"""
    pm = PersistManager(root)
    out = []
    for bs, path in pm.list_filesets(namespace, shard):
        reader = FilesetReader(path)
        entries = [
            {"id": e.id, "row": e.row, "nbits": e.nbits,
             "npoints": e.npoints, "checksum": e.checksum}
            for e in reader.entries
        ]
        out.append({"block_start": bs, "path": path, "entries": entries})
    return out


def verify_index_files(root: str, namespace: bytes, shard: int, *,
                       device=None) -> dict:
    """Digest + structural verification of every fileset
    (verify_index_files: catch corruption before a node serves it)."""
    dev = resolve(device)
    pm = PersistManager(root)
    ok, bad = [], []
    for bs, path in pm.list_filesets(namespace, shard):
        try:
            if not fileset_complete(path):
                raise IOError("incomplete fileset (no checkpoint)")
            _decoded_rows(path, dev, verify=True)  # raises on corrupt rows
            ok.append(path)
        except (ComputeError, RuntimeError):
            raise  # a device fault, not a corrupt fileset
        except Exception as e:  # noqa: BLE001 - what a corrupt file raises
            bad.append((path, str(e)))
    return {"ok": ok, "corrupt": bad}


def verify_commitlogs(directory: str) -> dict:
    """Replay every commitlog chunk, counting entries + corruption
    (verify_commitlogs). Host only."""
    entries = 0
    namespaces = set()
    series = set()
    errors: List[str] = []
    try:
        for ns, sid, t_ns, value in cl.replay(directory):
            entries += 1
            namespaces.add(ns)
            series.add((ns, sid))
    except Exception as e:  # noqa: BLE001
        errors.append(str(e))
    return {"entries": entries, "namespaces": sorted(namespaces),
            "num_series": len(series), "errors": errors}


def clone_fileset(src_root: str, dst_root: str, namespace: bytes, shard: int,
                  block_start: Optional[int] = None) -> List[str]:
    """Copy filesets between roots, re-verifying digests on the way
    (clone_fileset: used to seed test environments from prod data).
    Host only."""
    pm = PersistManager(src_root)
    cloned = []
    for bs, path in pm.list_filesets(namespace, shard):
        if block_start is not None and bs != block_start:
            continue
        FilesetReader(path, verify=True)  # verify before copying
        rel = os.path.relpath(path, src_root)
        dst = os.path.join(dst_root, rel)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copytree(path, dst, dirs_exist_ok=True)
        FilesetReader(dst, verify=True)  # and after
        cloned.append(dst)
    return cloned


def carbon_load(endpoint: str, paths: List[bytes], qps: float,
                duration_s: float, value_fn=None, clock=None) -> int:
    """Tiny carbon load generator (cmd/tools/carbon_load): writes lines at
    a target rate; returns lines sent."""
    import socket
    import time as _time

    clock = clock or _time.time
    host, _, port = endpoint.rpartition(":")
    sent = 0
    interval = 1.0 / qps if qps > 0 else 0
    deadline = _time.monotonic() + duration_s
    with socket.create_connection((host, int(port)), timeout=5.0) as sock:
        i = 0
        while _time.monotonic() < deadline:
            path = paths[i % len(paths)]
            value = value_fn(i) if value_fn else float(i % 100)
            line = b"%s %f %d\n" % (path, value, int(clock()))
            sock.sendall(line)
            sent += 1
            i += 1
            if interval:
                _time.sleep(interval)
    return sent
