"""Runtime numerics witness (port of m3_tpu/utils/numwatch.py, host
only): opt-in with M3_TPU_NUMERICS=1, auto-installed by the package init
so it is armed before any query runs. Costs nothing when unset — the
serving hooks read one module bool.

What it witnesses, at the compiled programs' host-materialization
boundaries (the post-program observation point of the `plan` route,
parallel/compile.py::execute; the reference also observes its
aggregator's quantile gather, `agg_flush`, which this port has not yet):

  nan-live      a NaN in a NON-padding output lane. Legal only where the
                reference's static pass proves the module treats NaN
                as its missing-value domain (m3_tpu's
                analysis/numeric_rules.accepted_witness).
  inf-live      an inf in a live lane. Legal only where the lowered op
                table emits an unguarded divide (PromQL `x/0` is +Inf).
  pad-finite    a FINITE value in a padding ROW of a compiled plan's
                output plane — a padding lane's value survived to the
                materialized result (an unmasked -1 gather wraps a live
                row into padding; a missing `where` lets pad lanes fold
                forward). NEVER accepted.
  pad-nonzero   a non-zero value in a count-0 row of the aggregator's
                exact quantile output (stream.go:145-146 empty
                convention). NEVER accepted.

Findings aggregate per (site, kind) with first-occurrence detail and a
count, JSON-dumped at exit to M3_TPU_NUMERICS_OUT (one file per
process). `unaccepted` filters findings against an accepted set of
(site, kind) pairs; the reference's scripts/numerics_check.py applies it
to the dumps of its smoke runs.

The witness is a SMOKE-TIER tool: observation materializes the padded
output plane (one extra D2H per query), which is exactly the transfer
the serving path exists to avoid — never enable it in production
serving.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "enabled", "installed", "install", "uninstall", "reset", "findings",
    "observed_count", "observe_result", "observe_rows", "dump_now",
    "unaccepted", "KINDS",
]

KINDS = ("nan-live", "inf-live", "pad-finite", "pad-nonzero")

_LOCK = threading.Lock()
_INSTALLED = False
_OBSERVED = 0
_FINDINGS: Dict[Tuple[str, str], Dict] = {}
_MAX_SITES = 256  # bound the table; the kinds x sites product is tiny


def enabled() -> bool:
    return os.environ.get("M3_TPU_NUMERICS", "") not in ("", "0")


def installed() -> bool:
    return _INSTALLED


def install():
    """Arm the witness hooks (idempotent) and register the exit dump."""
    global _INSTALLED
    with _LOCK:
        if _INSTALLED:
            return
        _INSTALLED = True
    atexit.register(_atexit_dump)


def uninstall():
    global _INSTALLED
    with _LOCK:
        _INSTALLED = False


def reset():
    global _OBSERVED
    with _LOCK:
        _OBSERVED = 0
        _FINDINGS.clear()


def _record(site: str, kind: str, detail: str):
    with _LOCK:
        key = (site, kind)
        entry = _FINDINGS.get(key)
        if entry is None:
            if len(_FINDINGS) >= _MAX_SITES:
                return
            _FINDINGS[key] = {"site": site, "kind": kind, "count": 1,
                              "detail": detail}
        else:
            entry["count"] += 1


def findings() -> List[Dict]:
    with _LOCK:
        return [dict(v) for v in _FINDINGS.values()]


def observed_count() -> int:
    return _OBSERVED


def observe_result(site: str, arr, live_rows: Optional[int] = None,
                   live_cols: Optional[int] = None):
    """Witness one materialized result plane. `live_rows`/`live_cols`
    bound the non-padding region (None = the whole extent is live; the
    padding check applies to ROWS — the NaN row-padding contract; column
    padding is time-axis slack the host slices and presence-style
    outputs legitimately fill)."""
    global _OBSERVED
    if not _INSTALLED:
        return
    # A device tensor crosses to the host only here, with the witness
    # installed: the one extra D2H the module docstring warns of.
    a = (arr.detach().cpu().numpy() if hasattr(arr, "detach")
         else np.asarray(arr))
    with _LOCK:
        _OBSERVED += 1
    if a.ndim == 0:
        a = a.reshape(1, 1)
    elif a.ndim == 1:
        a = a.reshape(1, -1)
    rows = a.shape[0] if live_rows is None else min(live_rows, a.shape[0])
    cols = a.shape[1] if live_cols is None else min(live_cols, a.shape[1])
    live = a[:rows, :cols]
    if live.size:
        if np.isinf(live).any():
            _record(site, "inf-live",
                    f"inf in live lanes of a [{a.shape[0]}x{a.shape[1]}] "
                    f"plane (live {rows}x{cols})")
        if np.isnan(live).any():
            _record(site, "nan-live",
                    f"NaN in live lanes of a [{a.shape[0]}x{a.shape[1]}] "
                    f"plane (live {rows}x{cols})")
    if live_rows is not None and rows < a.shape[0]:
        # FULL-width pad-row scan: a leak can land in a padding row at a
        # padding COLUMN too (an unclamped gather wraps anywhere), and
        # in-tree padding rows are NaN across the whole time extent.
        pad = a[rows:, :]
        if pad.size and np.isfinite(pad).any():
            _record(site, "pad-finite",
                    f"finite value in padding rows [{rows}:{a.shape[0]}] "
                    f"— a padding lane's value reached the materialized "
                    "result")


def observe_rows(site: str, vals, live_mask):
    """Witness a row-keyed output where liveness is per row (the
    aggregator's quantile gather: live rows have count > 0; count-0 rows
    must be exactly zero)."""
    global _OBSERVED
    if not _INSTALLED:
        return
    v = np.asarray(vals)
    m = np.asarray(live_mask, dtype=bool)
    with _LOCK:
        _OBSERVED += 1
    live = v[m]
    if live.size:
        if np.isinf(live).any():
            _record(site, "inf-live", f"inf in {int(m.sum())} live row(s)")
        if np.isnan(live).any():
            _record(site, "nan-live", f"NaN in {int(m.sum())} live row(s)")
    pad = v[~m]
    if pad.size and np.any(pad != 0):
        _record(site, "pad-nonzero",
                f"non-zero value in {int((~m).sum())} empty row(s) — the "
                "count-0 zero convention (stream.go:145-146) was violated")


# ----------------------------------------------------------------- dumps


def default_out_dir() -> str:
    return os.environ.get("M3_TPU_NUMERICS_OUT", "")


def dump_now(path: str = "") -> str:
    """Write this process's witness state as JSON; returns the path
    ('' when no output dir is configured and none was given)."""
    if not path:
        out_dir = default_out_dir()
        if not out_dir:
            return ""
        path = os.path.join(out_dir, f"numerics-{os.getpid()}.json")
    payload = {
        "pid": os.getpid(),
        "observed": observed_count(),
        "findings": findings(),
    }
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(payload, fh)
        os.replace(tmp, path)
    except OSError:
        return ""
    return path


def _atexit_dump():
    if _INSTALLED:
        dump_now()


# ------------------------------------------------------------ gate logic


def unaccepted(witnessed: List[Dict], accepted) -> List[Dict]:
    """Witness findings not covered by the static pass's accepted set
    of (site, kind) pairs — the numerics_check contract: this list must
    be empty."""
    acc = set(accepted)
    return [f for f in witnessed if (f["site"], f["kind"]) not in acc]
