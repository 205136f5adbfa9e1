"""Index segment persistence (host copy of m3_tpu/index/persist.py, the
same file format; reference: src/m3ninx/persist — the FST
segment file format written during fileset flush, dbnode
persist/fs/persist_manager.go:193-332 index segment persist — and read
back by the filesystem bootstrapper's index phase,
bootstrapper/base_index_step.go).

Layout per (namespace, block_start):
    <root>/index/<ns>/<block_start>/segment.bin   framed payload
    <root>/index/<ns>/<block_start>/digest        adler32 of segment.bin
    <root>/index/<ns>/<block_start>/checkpoint    written last = durable

The payload carries the immutable segment's docs (ids + tag fields via the
x/serialize codec) and per-field sorted terms with offset-indexed postings
— the same arrays the in-memory ImmutableSegment serves queries from, so
load is zero-parse into numpy."""

from __future__ import annotations

import os
import zlib
from typing import Dict, List, Tuple

import numpy as np

from ..rpc import wire
from ..utils import serialize as tag_serialize
from .segment import Document, ImmutableSegment


def _dir(root: str, namespace: bytes, block_start: int) -> str:
    return os.path.join(root, "index", namespace.decode(errors="replace"),
                        str(block_start))


def write_segment(root: str, namespace: bytes, block_start: int,
                  seg: ImmutableSegment) -> str:
    d = _dir(root, namespace, block_start)
    os.makedirs(d, exist_ok=True)
    docs = [
        {"id": doc.id, "tags": tag_serialize.encode_tags(dict(doc.fields))}
        for doc in seg._docs
    ]
    fields = {}
    for name in seg.fields():
        terms, offs, cat = seg.field_raw(name)
        fields[name] = {
            "terms": list(terms),
            "offsets": np.asarray(offs, np.int64),
            "postings": np.asarray(cat, np.int32),
        }
    payload = wire.encode({"block_start": block_start, "docs": docs,
                           "fields": fields})
    seg_path = os.path.join(d, "segment.bin")
    with open(seg_path, "wb") as f:
        f.write(payload)
    digest = zlib.adler32(payload) & 0xFFFFFFFF
    with open(os.path.join(d, "digest"), "w") as f:
        f.write(str(digest))
    # Checkpoint written last marks the segment durable (persist/fs
    # checkpoint file convention, write.go:68).
    with open(os.path.join(d, "checkpoint"), "w") as f:
        f.write("ok")
    return d


def segment_complete(d: str) -> bool:
    return os.path.exists(os.path.join(d, "checkpoint"))


def read_segment(root: str, namespace: bytes, block_start: int,
                 verify: bool = True) -> ImmutableSegment:
    d = _dir(root, namespace, block_start)
    if not segment_complete(d):
        raise IOError(f"index segment {d} incomplete (no checkpoint)")
    with open(os.path.join(d, "segment.bin"), "rb") as f:
        payload = f.read()
    if verify:
        with open(os.path.join(d, "digest")) as f:
            want = int(f.read().strip())
        got = zlib.adler32(payload) & 0xFFFFFFFF
        if got != want:
            raise IOError(f"index segment digest mismatch in {d}: "
                          f"{got} != {want}")
    obj = wire.decode(payload)
    docs = [
        Document(doc["id"],
                 tuple(sorted(tag_serialize.decode_tags(doc["tags"]).items())))
        for doc in obj["docs"]
    ]
    fields: Dict[bytes, Tuple[List[bytes], np.ndarray, np.ndarray]] = {}
    for name, fobj in obj["fields"].items():
        key = name if isinstance(name, bytes) else name.encode()
        fields[key] = (
            list(fobj["terms"]),
            np.asarray(fobj["offsets"], np.int64),
            np.asarray(fobj["postings"], np.int32),
        )
    # Zero-parse into the array-native segment: the on-disk triples ARE
    # the serving structure (TermDict wraps the terms, postings load as
    # the offset-indexed spans).
    return ImmutableSegment.from_raw(docs, fields)


def list_segments(root: str, namespace: bytes) -> List[int]:
    d = os.path.join(root, "index", namespace.decode(errors="replace"))
    if not os.path.isdir(d):
        return []
    out = []
    for name in os.listdir(d):
        if name.isdigit() and segment_complete(os.path.join(d, name)):
            out.append(int(name))
    return sorted(out)


def flush_index(root: str, namespace: bytes, index, now_ns: int,
                retention_ns: int) -> List[int]:
    """Seal + persist every full, not-yet-persisted index block
    (persist_manager.go index segment flush during fileset persist)."""
    flushed = []
    for bs, block in sorted(index.blocks.items()):
        if bs + index.block_size_ns > now_ns:
            continue  # still accepting writes
        if bs in getattr(index, "_persisted", set()):
            continue
        block.seal()
        segs = block.segments()
        if not segs:
            continue
        merged = (segs[0] if len(segs) == 1 and isinstance(segs[0], ImmutableSegment)
                  else ImmutableSegment.merge(
                      [s if isinstance(s, ImmutableSegment)
                       else ImmutableSegment.from_mutable(s) for s in segs]))
        write_segment(root, namespace, bs, merged)
        if not hasattr(index, "_persisted"):
            index._persisted = set()
        index._persisted.add(bs)
        flushed.append(bs)
    return flushed


def bootstrap_index(root: str, namespace: bytes, index) -> List[int]:
    """Load persisted segments into the namespace index (the filesystem
    bootstrapper's index phase, base_index_step.go)."""
    loaded = []
    for bs in list_segments(root, namespace):
        seg = read_segment(root, namespace, bs)
        block = index._block_for(bs)
        block.immutable.append(seg)
        block.sealed = True
        if not hasattr(index, "_persisted"):
            index._persisted = set()
        index._persisted.add(bs)
        loaded.append(bs)
    return loaded
