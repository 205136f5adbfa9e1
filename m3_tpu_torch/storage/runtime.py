"""Hot-reloadable runtime options driven from KV watches (host copy of
m3_tpu/storage/runtime.py; reference:
src/dbnode/runtime/runtime_options_manager.go + the kvconfig keys in
src/dbnode/kvconfig/keys.go:24-40 and their watchers in
dbnode/server/server.go:673-935)."""

from __future__ import annotations

import dataclasses
import json
import threading
from typing import Callable, List, Optional

from ..cluster import kv as cluster_kv

# kvconfig key names mirroring dbnode/kvconfig/keys.go
WRITE_NEW_SERIES_ASYNC = "write-new-series-async"
WRITE_NEW_SERIES_LIMIT_PER_SECOND = "write-new-series-limit-per-second"
BOOTSTRAP_CONSISTENCY_LEVEL = "bootstrap-consistency-level"
CLIENT_WRITE_CONSISTENCY = "client-write-consistency-level"
CLIENT_READ_CONSISTENCY = "client-read-consistency-level"


@dataclasses.dataclass(frozen=True)
class RuntimeOptions:
    """runtime.Options: the hot-tunable subset of node behavior."""

    write_new_series_async: bool = True
    write_new_series_limit_per_second: int = 0  # 0 = unlimited
    tick_min_interval_ns: int = 10 * 1_000_000_000
    bootstrap_consistency: str = "majority"
    write_consistency: str = "majority"
    read_consistency: str = "unstrict_majority"


class RuntimeOptionsManager:
    """Holds current options; listeners fire on every set
    (runtime_options_manager.go SetRuntimeOptions/RegisterListener)."""

    def __init__(self, initial: RuntimeOptions = RuntimeOptions()):
        self._lock = threading.Lock()
        self._opts = initial
        self._listeners: List[Callable[[RuntimeOptions], None]] = []

    def get(self) -> RuntimeOptions:
        with self._lock:
            return self._opts

    def set(self, opts: RuntimeOptions):
        with self._lock:
            self._opts = opts
            listeners = list(self._listeners)
        for fn in listeners:
            fn(opts)

    def update(self, **changes) -> RuntimeOptions:
        with self._lock:
            self._opts = dataclasses.replace(self._opts, **changes)
            opts = self._opts
            listeners = list(self._listeners)
        for fn in listeners:
            fn(opts)
        return opts

    def register_listener(self, fn: Callable[[RuntimeOptions], None]):
        with self._lock:
            self._listeners.append(fn)
        fn(self.get())


def watch_kv_runtime_options(store: cluster_kv.MemStore,
                             mgr: RuntimeOptionsManager,
                             prefix: str = "_kvconfig"):
    """Wire the kvconfig keys to the manager (server.go:673-935: each key
    gets a watch that folds its value into runtime options)."""

    def key(name: str) -> str:
        return f"{prefix}/{name}"

    def _on(name: str, fold: Callable[[RuntimeOptionsManager, object], None]):
        def cb(_k, value: cluster_kv.Value):
            try:
                parsed = json.loads(value.data.decode())
            except ValueError:
                return
            fold(mgr, parsed)

        store.on_change(key(name), cb)
        existing = store.get(key(name))
        if existing is not None:
            cb(key(name), existing)

    _on(WRITE_NEW_SERIES_ASYNC,
        lambda m, v: m.update(write_new_series_async=bool(v)))
    _on(WRITE_NEW_SERIES_LIMIT_PER_SECOND,
        lambda m, v: m.update(write_new_series_limit_per_second=int(v)))
    _on(BOOTSTRAP_CONSISTENCY_LEVEL,
        lambda m, v: m.update(bootstrap_consistency=str(v)))
    _on(CLIENT_WRITE_CONSISTENCY,
        lambda m, v: m.update(write_consistency=str(v)))
    _on(CLIENT_READ_CONSISTENCY,
        lambda m, v: m.update(read_consistency=str(v)))
    return mgr
