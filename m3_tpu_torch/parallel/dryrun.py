"""The multi-device dry run: every mesh route of the port driven once over
a device list and held to its single-device definition (the port's
counterpart of the reference's `__graft_entry__.dryrun_multichip`).

  python -c "import torch; from m3_tpu_torch.parallel.dryrun import \\
      dryrun_multichip; print(dryrun_multichip([torch.device('cpu')] * 8))"

runs it on eight CPU entries; `[torch.device('cuda', 0)] * 4` splits one
card four ways. Any disagreement raises AssertionError."""

from __future__ import annotations

import json
import urllib.parse
import urllib.request
from typing import Sequence

import numpy as np
import torch

from . import ingest
from . import query as pq
from ..device import attach, attached
from ..ops import tsz


def dryrun_multichip(devices: Sequence) -> dict:
    """Under attach(devices): (1) the sharded ingest step on the shard x
    time mesh against host reductions of its input, (2) every time
    chunk's words decoded back to its input, (3) sum_rate over a series
    count that does not divide the shard axis against
    sum_rate_host_reference, (4) a coordinator over HTTP whose default
    engine must serve a dashboard query through `query.sharded_agg`
    exactly once, equal (rtol 1e-5) to a mesh=None engine's answer.
    Returns what it checked."""
    with attach(devices):
        devs = attached()
        mesh = ingest.make_mesh(devices=devs)
        first = mesh.first
        out = {"mesh": mesh.shape}
        out.update(_ingest(mesh))
        out.update(_sum_rate(mesh, first))
        out.update(_served(first))
    return out


def _ingest(mesh) -> dict:
    t = mesh.shape["time"]
    n_shard = mesh.shape["shard"]
    n, w = 8 * n_shard, 12
    batch = ingest.make_example_batch(n, w, np.random.default_rng(1),
                                      chunks=t, device="cpu")
    max_words = tsz.max_words_for(w)
    step = ingest.make_sharded_ingest(mesh, rollup_factor=6,
                                      max_words=max_words)
    words, nbits, roll, qtl, whole, total_bits = step(
        ingest.shard_batch(batch, mesh))
    assert tuple(words.shape) == (t, n, max_words), tuple(words.shape)
    assert tuple(whole["sum"].shape) == (n,), tuple(whole["sum"].shape)
    assert int(total_bits) == int(nbits.to(torch.int64).sum()) > 0

    # The merges across the time axis against a host reduction of the
    # raw [T, N, W] values.
    raw = batch.values.double().numpy()
    flat = np.concatenate(list(raw), axis=1)               # [N, T * W]
    got = {k: v.cpu().double().numpy() for k, v in whole.items()}
    np.testing.assert_array_equal(got["count"], np.full(n, float(t * w)))
    np.testing.assert_allclose(got["sum"], flat.sum(axis=1), rtol=1e-5)
    np.testing.assert_array_equal(got["min"], flat.min(axis=1))
    np.testing.assert_array_equal(got["max"], flat.max(axis=1))
    np.testing.assert_array_equal(got["first"], flat[:, 0])
    np.testing.assert_array_equal(got["last"], flat[:, -1])

    # Every chunk's streams decode back to its input.
    for i in range(t):
        dec = tsz.decode_batch(words[i], batch.npoints[i], window=w,
                               device=words.device)
        assert torch.equal(dec["dt"].cpu(), batch.dt[i]), i
        assert torch.equal(dec["v"].cpu(), batch.v[i]), i
    return {"ingest_rows": n, "chunks": t, "total_bits": int(total_bits)}


def _sum_rate(mesh, first) -> dict:
    W = 6
    s_q, t_q = 4 * mesh.shape["shard"] + 3, 24   # not axis-divisible
    rng = np.random.default_rng(2)
    grid = np.cumsum(rng.poisson(4.0, (s_q, t_q)), axis=1).astype(np.float64)
    grid[rng.random((s_q, t_q)) < 0.1] = np.nan
    step_ns, range_ns = 10 * 10**9, W * 10 * 10**9
    got = pq.sum_rate(grid, mesh, W=W, step_ns=step_ns, range_ns=range_ns)
    want = pq.sum_rate_host_reference(grid, W=W, step_ns=step_ns,
                                      range_ns=range_ns, device=first)
    np.testing.assert_allclose(got, want, rtol=1e-5, equal_nan=True)
    return {"sum_rate_series": s_q}


def _served(first) -> dict:
    """The serving path over the mesh: a coordinator's HTTP query_range
    whose default engine takes the sharded aggregation."""
    from ..coordinator.http_api import HTTPApi
    from ..query.executor import Engine
    from ..utils.instrument import ROOT

    s_ns = 10**9
    npts = 48
    rng = np.random.default_rng(3)
    tq = 1_700_000_000 * s_ns + np.arange(npts, dtype=np.int64) * 10 * s_ns
    vals = np.cumsum(rng.poisson(3.0, (41, npts)), axis=1).astype(float)
    series = {
        b"qm{i=%d}" % i: {"tags": {b"__name__": b"qm", b"i": str(i).encode()},
                          "t": tq, "v": vals[i]}
        for i in range(41)}

    class _Storage:
        def fetch_raw(self, matchers, start_ns, end_ns):
            return {k: dict(v) for k, v in series.items()}

    eng = Engine(_Storage(), device=first)
    assert eng.mesh is not None, "expected the attached devices' mesh"
    api = HTTPApi(eng).serve()
    try:
        q = "sum(rate(qm[1m]))"
        start_s, end_s = int(tq[12] // s_ns), int(tq[-1] // s_ns)
        url = (f"{api.endpoint}/api/v1/query_range?"
               + urllib.parse.urlencode(
                   {"query": q, "start": start_s, "end": end_s, "step": 30}))
        before = ROOT.counter("query.sharded_agg").value()
        with urllib.request.urlopen(url, timeout=60) as r:
            resp = json.load(r)
        fired = ROOT.counter("query.sharded_agg").value() - before
        assert fired == 1, f"the sharded path served {fired} times"
        assert resp["status"] == "success" and resp["data"]["result"], resp
        served = np.array(
            [float(v) for _, v in resp["data"]["result"][0]["values"]])
        ref = Engine(_Storage(), device=first, mesh=None).execute_range(
            q, start_s * s_ns, end_s * s_ns, 30 * s_ns).values[0]
        ref = np.asarray(ref)[np.isfinite(ref)][:served.size]
        np.testing.assert_allclose(served, ref, rtol=1e-5)
    finally:
        api.close()
    return {"sharded_agg": int(fired), "served_points": int(served.size)}
