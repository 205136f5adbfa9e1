"""m3lint on the port (m3_tpu_torch/analysis): every rule family on
synthetic positive and negative snippets, mirrored from
tests/test_static_analysis.py with the paths moved under m3_tpu_torch/,
and the tier-1 tree gate — `python -m m3_tpu_torch.analysis m3_tpu_torch/`
must report ZERO non-suppressed findings.

Parity with the reference's analyzer (m3_tpu/analysis):
- `lint` runs every carried rule (one whose id and semantics the port
  keeps) through the reference's rule too, on the same snippet at the
  reference's path, and holds the two to the same (rule, line, message);
- over a copy of m3_tpu/ placed under a directory named m3_tpu_torch/, the
  port's analyzer gives the reference's findings (none) and the same
  suppressed count per carried rule, and its static lock graph equals the
  reference's ProgramIndex graph over m3_tpu/, edge for edge.

The JAX rules have torch counterparts (analysis/device_rules.py, the
torch `unbudgeted-device-put` and `host-sync-in-plan`), each with positive
and negative cases mirroring the reference's JAX cases.

The whole-tree runs are module-scoped and shared: one run of the CLI's
own code path (`__main__.main`) over the port's tree, one over the copy
and one of the reference's CLI over m3_tpu/, each recording every finding
as it passes the suppression filter."""

import collections
import contextlib
import importlib
import io
import pathlib
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

import m3_tpu.analysis.callgraph as ref_callgraph
import m3_tpu.analysis.core as ref_core
from m3_tpu.analysis import __main__ as ref_main
from m3_tpu_torch.analysis import Module, run_module, run_paths
from m3_tpu_torch.analysis import __main__ as port_main
from m3_tpu_torch.analysis import callgraph as port_callgraph
from m3_tpu_torch.analysis import core as port_core
from m3_tpu_torch.analysis.batch_rules import BatchPartialIngestRule
from m3_tpu_torch.analysis.cache_rules import (CacheKeyBufferRule,
                                               CacheMethodBufferKeyRule)
from m3_tpu_torch.analysis.device_rules import (CapturePurityRule,
                                                ItemInLoopRule, MeshSpecRule,
                                                NonStaticCaptureCacheRule,
                                                UnclassifiedDeviceDispatchRule,
                                                UnguardedKernelDispatchRule)
from m3_tpu_torch.analysis.numeric_rules import (DtypeDataflowRule,
                                                 SentinelTaintRule)
from m3_tpu_torch.analysis.lock_rules import (FlushCallbackLoopRule,
                                              HotLoopUnderLockRule,
                                              LockDisciplineRule)
from m3_tpu_torch.analysis.hbm_rules import UnbudgetedDevicePutRule
from m3_tpu_torch.analysis.obs_rules import (HostSyncInPlanRule,
                                             UnboundedTelemetryTagRule,
                                             WallClockLatencyRule)
from m3_tpu_torch.analysis.overload_rules import UnboundedQueueRule
from m3_tpu_torch.analysis.replay_rules import PerEntryReplayRule
from m3_tpu_torch.analysis.diskio_rules import UncheckedDiskIORule
from m3_tpu_torch.analysis.retry_rules import (BroadExceptWireIORule,
                                               RawSleepRetryRule)

REPO = pathlib.Path(__file__).resolve().parent.parent

# The counterparts of the reference's JAX rules: same place in the
# catalog, torch semantics, so never held to the reference's verdicts.
COUNTERPARTS = {"capture-purity", "capture-traced-branch",
                "capture-host-sync", "nonstatic-capture-cache",
                "item-in-loop", "mesh-spec", "mesh-axis-unbound",
                "shard-spec-arity", "unannotated-out-sharding",
                "unguarded-kernel-dispatch", "unclassified-device-dispatch",
                "unbudgeted-device-put", "host-sync-in-plan"}
# The reference's rules with no carried counterpart (its JAX family).
REF_ONLY = {"jax-purity", "jax-traced-branch", "jax-numpy-in-jit",
            "jax-host-sync", "jax-nonstatic-jit-cache", "jax-item-in-loop",
            "unguarded-pallas-dispatch", "mesh-spec", "mesh-axis-unbound",
            "shard-spec-arity", "unannotated-out-sharding",
            "unclassified-device-dispatch", "unbudgeted-device-put",
            "host-sync-in-plan"}


# host-sync-in-plan keeps every shape the reference flags, so the
# reference's snippets hold both rules to the same verdicts; its torch
# shapes are checked with parity=False.
_SNIPPET_PARITY = {"host-sync-in-plan"}


def _ref_rule(rule):
    """The reference's instance of a rule that gives its verdicts on the
    reference's snippets, or None."""
    if rule.id in COUNTERPARTS - _SNIPPET_PARITY:
        return None
    name = type(rule).__module__.rsplit(".", 1)[-1]
    try:
        mod = importlib.import_module(f"m3_tpu.analysis.{name}")
    except ImportError:
        return None
    cls = getattr(mod, type(rule).__name__, None)
    return cls() if cls is not None and cls.id == rule.id else None


def _ref_path(relpath: str) -> str:
    return relpath.replace("m3_tpu_torch/", "m3_tpu/")


# Two of the reference's messages tag a shape with the reference's own
# change-history numbers; the port's say the same without them.
_REF_PHRASES = ((re.compile(r"the PR \d+ (straggler-replica shape)"), r"the \1"),
                (re.compile(r"PR \d+/\d+ contract"), "the padding contract"))


def _key(f):
    return (f.rule, f.line, f.message)


def _ref_key(f):
    msg = f.message
    for pattern, repl in _REF_PHRASES:
        msg = pattern.sub(repl, msg)
    return (f.rule, f.line, msg)


def lint(source, rule, relpath="m3_tpu_torch/ops/mod.py", parity=True):
    """Non-suppressed findings of one rule over a source snippet. Unless
    `parity=False`, a carried rule also runs the reference's rule of the
    same class on the same source at the reference's path, and the two
    must give the same (rule, line, message)."""
    src = textwrap.dedent(source)
    mod = Module.from_source(src, relpath)
    findings, _ = run_module(mod, [rule])
    ref = _ref_rule(rule) if parity else None
    if ref is not None:
        rmod = ref_core.Module.from_source(src, _ref_path(relpath))
        want, _ = ref_core.run_module(rmod, [ref])
        assert [_key(f) for f in findings] == [_ref_key(f) for f in want], \
            f"{rule.id}: the port's findings differ from the reference's"
    return findings


def rule_ids(findings):
    return [f.rule for f in findings]


# ------------------------------------------------------- whole-tree runs


class _TreeRun:
    """One CLI run over a tree, with every finding that reached the
    suppression filter recorded."""

    def __init__(self, rc, out, seen, index):
        self.rc = rc
        self.out = out
        self.findings = [f for f, sup in seen if not sup]
        self.suppressed = collections.Counter(f.rule for f, sup in seen
                                              if sup)
        self.index = index

    def of(self, rule_ids_):
        return [f for f in self.findings if f.rule in rule_ids_]


def _cli_run(core, callgraph, main, argv, cwd, patches=()):
    seen = []
    indexes = []
    orig = core.Module.suppressed

    def recording(self, f):
        hit = orig(self, f)
        seen.append((f, hit))
        return hit

    class Recorded(callgraph.ProgramIndex):
        def __init__(self, modules):
            super().__init__(modules)
            indexes.append(self)

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(core.Module, "suppressed", recording)
        mp.setattr(callgraph, "ProgramIndex", Recorded)
        mp.chdir(cwd)
        for target, name, value in patches:
            mp.setattr(target, name, value)
        with contextlib.redirect_stdout(out):
            rc = main.main(argv)
    return _TreeRun(rc, out.getvalue(), seen, indexes[-1])


@pytest.fixture(scope="module")
def port_tree():
    """THE gate's run: `python -m m3_tpu_torch.analysis m3_tpu_torch/
    --no-cache`, through the CLI's own main()."""
    return _cli_run(port_core, port_callgraph, port_main,
                    ["m3_tpu_torch/", "--no-cache"], REPO)


@pytest.fixture(scope="module")
def ref_copy(tmp_path_factory):
    """The port's analyzer over a copy of m3_tpu/ placed under a directory
    named m3_tpu_torch/ (the race family given the reference's ledger),
    and the reference's analyzer over m3_tpu/ itself."""
    from m3_tpu.analysis import race_rules as ref_race
    from m3_tpu_torch.analysis import race_rules as port_race

    root = tmp_path_factory.mktemp("refcopy")
    shutil.copytree(REPO / "m3_tpu", root / "m3_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    mine = _cli_run(port_core, port_callgraph, port_main,
                    ["m3_tpu_torch/", "--no-cache"], root,
                    patches=[(port_race, "ledger_path",
                              ref_race.ledger_path)])
    theirs = _cli_run(ref_core, ref_callgraph, ref_main,
                      ["m3_tpu/", "--no-cache"], REPO)
    return mine, theirs


class TestTreeGate:
    """THE gate: the real tree stays at zero non-suppressed findings.
    New rules (or new code) that introduce findings must fix them or add
    a justified `# m3lint: disable=<rule>` in the same change."""

    def test_tree_is_clean(self, port_tree):
        # `python -m m3_tpu_torch.analysis m3_tpu_torch/ --no-cache`
        assert port_tree.rc == 0, port_tree.out
        rendered = "\n".join(f.render() for f in port_tree.findings)
        assert port_tree.findings == [], \
            f"m3lint findings on the tree:\n{rendered}"
        last = port_tree.out.strip().splitlines()[-1]
        assert last.startswith("m3lint: 0 finding(s)"), last
        nmods = int(last.split("suppressed, ")[1].split(" file")[0])
        assert nmods > 100  # sanity: the walk saw the whole package
        # the suppression mechanism is in real use (documented sites)
        assert sum(port_tree.suppressed.values()) >= 1


class TestParityOnTheReferenceTree:
    """The port's carried rules over a copy of m3_tpu/ under an
    m3_tpu_torch/ directory against the reference's analyzer over
    m3_tpu/."""

    def test_same_findings_as_the_reference(self, ref_copy):
        mine, theirs = ref_copy
        assert theirs.rc == 0 and theirs.findings == []
        carried = [f for f in mine.findings if f.rule not in COUNTERPARTS]
        assert carried == [], "\n".join(f.render() for f in carried)

    def test_same_suppressed_count_per_rule(self, ref_copy):
        mine, theirs = ref_copy
        got = {k: v for k, v in mine.suppressed.items()
               if k not in COUNTERPARTS}
        want = {k: v for k, v in theirs.suppressed.items()
                if k not in REF_ONLY}
        assert got == want
        assert sum(want.values()) >= 10

    def test_lock_graph_equals_the_reference_graph(self, ref_copy):
        mine, theirs = ref_copy
        got = set(mine.index.lock_edges())
        want = set(theirs.index.lock_edges())
        assert len(want) > 10
        assert got == want
        # and each edge is first seen at the same place in the package
        sites = {e: (s[0].split("m3_tpu_torch/", 1)[-1], s[1])
                 for e, s in mine.index.lock_edges().items()}
        ref_sites = {e: (s[0].split("m3_tpu/", 1)[-1], s[1])
                     for e, s in theirs.index.lock_edges().items()}
        assert sites == ref_sites

    def test_the_port_scopes_by_its_own_package_name(self):
        """Module.scope_parts anchors on the last m3_tpu_torch segment, so
        an ancestor directory's name never scopes a rule; the reference's
        core anchors on m3_tpu and scopes the port's paths by every
        segment, which is why its tree is held through a copy here."""
        src = "import collections\nq = collections.deque()\n"
        path = "/tmp/storage/proj/m3_tpu_torch/tools/q.py"
        assert Module.from_source(src, path).scope_parts == ("tools", "q.py")
        assert lint(src, UnboundedQueueRule(), path, parity=False) == []
        assert rule_ids(lint(src, UnboundedQueueRule(),
                             "/tmp/x/m3_tpu_torch/storage/q.py")) == \
            ["unbounded-queue"]
        assert ref_core.Module.from_source(src, path).scope_parts == (
            "/", "tmp", "storage", "proj", "m3_tpu_torch", "tools", "q.py")


class TestCacheKeyBuffer:
    def test_flags_prefix_hashing_pattern(self):
        # the EXACT pre-fix m3_tpu_torch/utils/hashing.py shape: lru_cache
        # wrapped around a bytes-annotated scalar hash
        src = """
            import functools

            def murmur3_32(data: bytes, seed: int = 0) -> int:
                return len(data)

            _murmur3_32_lru = functools.lru_cache(maxsize=65536)(murmur3_32)
        """
        found = lint(src, CacheKeyBufferRule(), "m3_tpu_torch/utils/hashing.py")
        assert rule_ids(found) == ["cache-key-buffer"]
        assert "'data'" in found[0].message

    def test_flags_decorator_form_and_bytearray(self):
        src = """
            import functools

            @functools.lru_cache(maxsize=8)
            def route(key: bytearray) -> int:
                return len(key)
        """
        found = lint(src, CacheKeyBufferRule())
        assert rule_ids(found) == ["cache-key-buffer"]
        assert "bytearray" in found[0].message

    def test_flags_union_and_string_annotations(self):
        src = """
            from functools import lru_cache
            from typing import Union

            @lru_cache(maxsize=8)
            def f(x: "Union[bytes, memoryview]") -> int:
                return len(x)
        """
        assert rule_ids(lint(src, CacheKeyBufferRule())) == ["cache-key-buffer"]

    def test_infers_from_call_sites_when_unannotated(self):
        src = """
            import functools

            @functools.lru_cache(maxsize=8)
            def f(x):
                return len(x)

            def caller():
                return f(b"hot-id") + f(bytearray(3))
        """
        found = lint(src, CacheKeyBufferRule())
        assert rule_ids(found) == ["cache-key-buffer"]
        assert "call site" in found[0].message

    def test_clean_scalar_keys_pass(self):
        src = """
            import functools

            @functools.lru_cache(maxsize=8)
            def f(width: int, qs: tuple) -> int:
                return width

            @functools.lru_cache(maxsize=8)
            def g(name: str) -> str:
                return name

            def cache(x):
                return x

            cache(b"not-functools-cache")
        """
        assert lint(src, CacheKeyBufferRule()) == []

    def test_suppression_silences(self):
        src = """
            import functools

            def f(data: bytes) -> int:
                return len(data)

            g = functools.lru_cache(maxsize=8)(f)  # m3lint: disable=cache-key-buffer
        """
        assert lint(src, CacheKeyBufferRule()) == []


class TestCacheMethodBufferKey:
    """Custom-cache boundary: buffer params must be bytes-normalized
    before they reach a key (the PostingsListCache contract)."""

    def test_flags_raw_buffer_in_key_tuple(self):
        src = """
            class PostingsCache:
                def get(self, gen: int, field: bytes, key: bytes):
                    return self._lru.get((gen, field, key))
        """
        found = lint(src, CacheMethodBufferKeyRule())
        assert rule_ids(found) == ["cache-buffer-key-method"]
        assert "'field'" in found[0].message

    def test_flags_raw_subscript_and_memoryview(self):
        src = """
            class SegCache:
                def put(self, key: memoryview, value):
                    self._map[key] = value
        """
        assert rule_ids(lint(src, CacheMethodBufferKeyRule())) == [
            "cache-buffer-key-method"]

    def test_flags_map_get_arg(self):
        src = """
            class RouteCache:
                def lookup(self, key: bytearray):
                    return self._entries.get(key)
        """
        assert rule_ids(lint(src, CacheMethodBufferKeyRule())) == [
            "cache-buffer-key-method"]

    def test_rebind_normalization_passes(self):
        src = """
            class PostingsCache:
                def get(self, gen: int, field: bytes, key: bytes):
                    field = bytes(field)
                    key = bytes(key)
                    return self._lru.get((gen, field, key))
        """
        assert lint(src, CacheMethodBufferKeyRule()) == []

    def test_inline_bytes_wrap_passes(self):
        src = """
            class PostingsCache:
                @staticmethod
                def _key(gen: int, field: bytes, key: bytes):
                    return (gen, bytes(field), "term", bytes(key))
        """
        assert lint(src, CacheMethodBufferKeyRule()) == []

    def test_use_before_normalization_still_flagged(self):
        src = """
            class LateCache:
                def put(self, key: bytes, v):
                    self._map[key] = v
                    key = bytes(key)
        """
        assert rule_ids(lint(src, CacheMethodBufferKeyRule())) == [
            "cache-buffer-key-method"]

    def test_non_cache_class_and_scalar_params_ignored(self):
        src = """
            class Registry:
                def get(self, key: bytes):
                    return self._map.get(key)

            class WidthCache:
                def get(self, width: int, name: str):
                    return self._map.get((width, name))

                def helper(self, data: bytes):
                    return len(data)
        """
        assert lint(src, CacheMethodBufferKeyRule()) == []

    def test_delegating_to_normalizing_key_builder_passes(self):
        src = """
            class PostingsCache:
                @staticmethod
                def _key(field: bytes, key: bytes):
                    return (bytes(field), bytes(key))

                def get(self, field: bytes, key: bytes):
                    return self._lru.get(self._key(field, key))
        """
        assert lint(src, CacheMethodBufferKeyRule()) == []

    def test_suppression_silences(self):
        src = """
            class PinCache:
                def get(self, key: bytes):
                    return self._map.get(key)  # m3lint: disable=cache-buffer-key-method
        """
        assert lint(src, CacheMethodBufferKeyRule()) == []


# ===================================================================
# The torch counterparts of the reference's JAX rules
# (analysis/device_rules.py): capture purity, the capture cache, syncs
# in loops, mesh specs, the kernel dispatch seams
# ===================================================================


def capture(srcs):
    """capture-purity findings over synthetic modules {relpath: src}."""
    idx = ProgramIndex.from_sources(
        {rel: textwrap.dedent(s) for rel, s in srcs.items()})
    return list(CapturePurityRule().check_program(idx))


class TestCapturePurity:
    """The counterpart of TestJaxPurity: functions reached from a
    `torch.cuda.graph` capture record kernels; host syncs and Python
    branches on device tensors inside them run once, at capture time."""

    def test_flags_branch_numpy_and_sync_in_capture(self):
        found = capture({"m3_tpu_torch/parallel/c.py": """
            import numpy as np
            import torch

            def body(x, y):
                if x > 0:
                    return np.sum(y)
                return float(y) + x.item()

            def capture_it(x, y):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    out = body(x, y)
                return g, out
        """})
        ids = rule_ids(found)
        assert ids.count("capture-traced-branch") == 1
        assert ids.count("capture-host-sync") == 3  # np, float(), .item()
        assert all("captured at m3_tpu_torch/parallel/c.py" in f.message
                   for f in found)

    def test_metadata_none_and_membership_tests_are_fine(self):
        found = capture({"m3_tpu_torch/parallel/c.py": """
            import torch

            def body(x, extra=None, cache=None):
                if extra is None:             # a host identity test
                    extra = torch.zeros(x.shape[0])
                while x.shape[0] > 1:         # shapes are host metadata
                    x = x[:1]
                if x.dim() == 2 and x.numel():
                    x = x.sum(-1)
                if id(x) in cache:            # dict membership
                    return cache[id(x)]
                parts = [x, extra]
                if not parts:                 # a list's length
                    return x
                return x + extra

            def capture_it(x):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    out = body(x)
                return g, out
        """})
        assert found == []

    def test_item_inside_a_captured_plan_body(self):
        # The port's shape: a builder returns the nested `body`, an
        # Executable stores it, and _capture calls self.body under the
        # graph: the nested def is reached through the constructor call.
        found = capture({"m3_tpu_torch/parallel/compile.py": """
            import torch

            def _build_body(plan):
                def body(fetch_flat, slots):
                    scale = slots[0].item()     # a host sync mid-capture
                    return fetch_flat[0] * scale
                return body

            class Executable:
                def __init__(self, body, device):
                    self.body = body
                    self.device = device

                def _capture(self, fetch_flat, slots):
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph):
                        out = self.body(fetch_flat, slots)
                    return graph, out

            def plan_executable(plan, dev):
                return Executable(_build_body(plan), dev)
        """})
        assert rule_ids(found) == ["capture-host-sync"]
        assert ".item()" in found[0].message and "'body'" in found[0].message

    def test_taint_propagates_into_helpers(self):
        found = capture({"m3_tpu_torch/parallel/c.py": """
            import torch

            def _helper(v, n):
                if v.any():         # v arrives as a device tensor
                    return v
                return v * n

            def body(x):
                return _helper(x, 3)

            def capture_it(x):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    out = body(x)
                return g, out
        """})
        assert rule_ids(found) == ["capture-traced-branch"]
        assert "_helper" in found[0].message

    def test_host_constants_passed_to_helpers_stay_static(self):
        found = capture({"m3_tpu_torch/parallel/c.py": """
            import torch

            def rate_math(adj, *, W, is_counter):
                if is_counter:      # a host bool: plan structure
                    adj = adj + 1
                for j in range(W):
                    adj = adj * 2
                return torch.where(torch.isfinite(adj), adj, 0.0)

            def body(x):
                return rate_math(x, W=3, is_counter=True)

            def capture_it(x):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    out = body(x)
                return g, out
        """})
        assert found == []

    def test_branch_on_a_torch_op_result(self):
        # a tensor made inside the body is a device tensor whatever fed
        # it: the Python `if` on it reached from the capture is a finding
        found = capture({"m3_tpu_torch/parallel/c.py": """
            import torch

            def body(ctx):
                m = torch.isfinite(ctx.plane)
                if m.all():
                    return ctx.plane
                return torch.where(m, ctx.plane, 0.0)

            def capture_it(ctx):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    out = body(ctx)
                return g, out
        """})
        assert rule_ids(found) == ["capture-traced-branch"]

    def test_sync_calls_are_flagged_unconditionally(self):
        found = capture({"m3_tpu_torch/parallel/c.py": """
            import torch

            def body(x):
                idx = torch.nonzero(x > 0)
                torch.cuda.synchronize()
                return x[idx]

            def capture_it(x):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    out = body(x)
                return g, out
        """})
        assert rule_ids(found) == ["capture-host-sync"] * 2

    def test_code_outside_the_capture_is_not_checked(self):
        found = capture({"m3_tpu_torch/parallel/c.py": """
            import torch

            def warm(x):
                if x.sum() > 0:        # eager warm-up: a host sync is fine
                    return x.item()
                return 0.0

            def capture_it(x):
                warm(x)
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    out = x * 2
                return g, out
        """})
        assert found == []

    def test_suppression_silences(self):
        src = {"m3_tpu_torch/parallel/c.py": """
            import torch

            def body(x):
                # DELIBERATE: capture-time constant by contract
                n = int(x.shape[0] * x.sum())  # m3lint: disable=capture-host-sync
                return x * n

            def capture_it(x):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    out = body(x)
                return g, out
        """}
        assert rule_ids(capture(src)) == ["capture-host-sync"]
        idx = ProgramIndex.from_sources(
            {rel: textwrap.dedent(s) for rel, s in src.items()})
        findings, sup = port_core.run_program(
            list(idx.modules.values()), program_rules=[CapturePurityRule()])
        assert findings == [] and sup == 1


class TestCapturePurityAcrossModules:
    """The counterpart of TestCrossModuleTaint: a captured body calling an
    imported helper with a device tensor; the helper's Python branch is
    the same capture hazard the module alone cannot show."""

    SRCS = {
        "m3_tpu_torch/parallel/kernel.py": """
            import torch
            from ..ops.helpers import clamp

            def step(x):
                return clamp(x) + 1

            def capture_it(x):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    out = step(x)
                return g, out
        """,
        "m3_tpu_torch/ops/helpers.py": """
            def clamp(v):
                if v > 0:
                    return v
                return 0
        """,
    }

    def test_tainted_branch_in_imported_helper_flags(self):
        found = capture(self.SRCS)
        assert [f.rule for f in found] == ["capture-traced-branch"]
        assert found[0].path == "m3_tpu_torch/ops/helpers.py"
        assert "captured at m3_tpu_torch/parallel/kernel.py" in \
            found[0].message

    def test_untainted_cross_module_call_is_clean(self):
        srcs = dict(self.SRCS)
        srcs["m3_tpu_torch/parallel/kernel.py"] = """
            import torch
            from ..ops.helpers import clamp

            def step(x, n: int):
                _ = clamp(7)
                return x + 1

            def capture_it(x):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    out = step(x, 3)
                return g, out
        """
        assert capture(srcs) == []

    def test_taint_transitive_helper_reaches_imported_module(self):
        srcs = dict(self.SRCS)
        srcs["m3_tpu_torch/parallel/kernel.py"] = """
            import torch
            from ..ops.helpers import clamp

            def _local(y):
                return clamp(y)

            def step(x):
                return _local(x) + 1

            def capture_it(x):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    out = step(x)
                return g, out
        """
        found = capture(srcs)
        assert [f.rule for f in found] == ["capture-traced-branch"]
        assert found[0].path == "m3_tpu_torch/ops/helpers.py"

    def test_taint_continues_into_callee_local_helpers(self):
        srcs = dict(self.SRCS)
        srcs["m3_tpu_torch/parallel/kernel.py"] = \
            self.SRCS["m3_tpu_torch/parallel/kernel.py"].replace(
                "import clamp", "import outer").replace(
                "clamp(x)", "outer(x)")
        srcs["m3_tpu_torch/ops/helpers.py"] = """
            def _inner(w):
                if w > 0:
                    return w
                return 0

            def outer(v):
                return _inner(v)
        """
        found = capture(srcs)
        assert [f.rule for f in found] == ["capture-traced-branch"]
        assert "_inner" in found[0].message

    def test_the_port_capture_body_is_pure(self, port_tree):
        """The real compiled-plan capture (parallel/compile.py) is found
        through Executable._capture's `self.body` and reaches the
        lowering rules, temporal's *_math, series_agg and the window
        kernel's wrapper, holding no host sync."""
        roots = CapturePurityRule()._roots(port_tree.index)
        assert {(d, fn.name) for d, fn, _p in roots} == {
            ("m3_tpu_torch.parallel.compile", "body")}
        assert port_tree.of({"capture-traced-branch",
                             "capture-host-sync"}) == []


class TestNonStaticCaptureCache:
    def test_flags_unhashable_key_of_a_graph_builder(self):
        src = """
            import functools
            import torch

            @functools.lru_cache(maxsize=8)
            def builder(width: int, qs: list):
                g = torch.cuda.CUDAGraph()
                return g
        """
        found = lint(src, NonStaticCaptureCacheRule())
        assert rule_ids(found) == ["nonstatic-capture-cache"]
        assert "'qs'" in found[0].message

    def test_flags_tensor_key_and_mutable_default_of_an_ext_builder(self):
        src = """
            import functools
            import torch
            from .codec_kernels import build

            @functools.lru_cache(maxsize=8)
            def op_for(x: torch.Tensor, opts={}):
                return build().window
        """
        found = lint(src, NonStaticCaptureCacheRule())
        assert rule_ids(found) == ["nonstatic-capture-cache"] * 2

    def test_hashable_keys_and_non_builders_pass(self):
        src = """
            import functools
            import torch

            @functools.lru_cache(maxsize=8)
            def builder(width: int, qs: tuple, flag: bool = False):
                with torch.cuda.graph(torch.cuda.CUDAGraph()):
                    pass

            @functools.lru_cache(maxsize=8)
            def not_a_builder(xs: list):
                return sum(xs)      # no graph inside: other rules' problem
        """
        assert lint(src, NonStaticCaptureCacheRule()) == []


class TestItemInLoop:
    def test_item_and_synchronize_in_loops(self):
        src = """
            import torch

            def drain(ts):
                out = []
                for t in ts:
                    out.append(t.item())
                while out:
                    torch.cuda.synchronize()
                    out.pop()
                return out

            def batched(t):
                return t.cpu().tolist()  # one transfer: fine
        """
        found = lint(src, ItemInLoopRule())
        assert rule_ids(found) == ["item-in-loop"] * 2
        assert found[0].severity == "warning"

    def test_module_without_torch_is_skipped(self):
        src = """
            def drain(arrs):
                return [a.item() for a in arrs for _ in range(2)]

            def loop(arrs):
                for a in arrs:
                    a.item()
        """
        assert lint(src, ItemInLoopRule()) == []


class TestLockDiscipline:
    REL = "m3_tpu_torch/storage/mod.py"

    def test_abba_inversion_direct_and_call_mediated(self):
        src = """
            import threading

            class T:
                def __init__(self):
                    self._a_lock = threading.Lock()
                    self._b_lock = threading.Lock()

                def ab(self):
                    with self._a_lock:
                        with self._b_lock:
                            pass

                def ba(self):
                    with self._b_lock:
                        self.take_a()

                def take_a(self):
                    with self._a_lock:
                        pass
        """
        found = lint(src, LockDisciplineRule(), self.REL)
        assert rule_ids(found) == ["lock-order-inversion"]
        assert "_a_lock" in found[0].message and "_b_lock" in found[0].message

    def test_single_order_is_fine(self):
        src = """
            import threading

            class T:
                def __init__(self):
                    self._a_lock = threading.Lock()
                    self._b_lock = threading.Lock()

                def ab(self):
                    with self._a_lock:
                        with self._b_lock:
                            pass

                def ab2(self):
                    with self._a_lock:
                        self.take_b()

                def take_b(self):
                    with self._b_lock:
                        pass
        """
        assert lint(src, LockDisciplineRule(), self.REL) == []

    def test_nonreentrant_reacquire(self):
        src = """
            import threading

            class T:
                def __init__(self):
                    self._lock = threading.Lock()

                def outer(self):
                    with self._lock:
                        self.inner()

                def inner(self):
                    with self._lock:
                        pass
        """
        found = lint(src, LockDisciplineRule(), self.REL)
        assert rule_ids(found) == ["lock-order-inversion"]
        assert "self-deadlock" in found[0].message

    def test_rlock_reentry_is_fine(self):
        src = """
            import threading

            class T:
                def __init__(self):
                    self._lock = threading.RLock()

                def outer(self):
                    with self._lock:
                        self.inner()

                def inner(self):
                    with self._lock:
                        pass
        """
        assert lint(src, LockDisciplineRule(), self.REL) == []

    def test_blocking_under_lock_direct_and_via_callee(self):
        src = """
            import threading
            import time

            class T:
                def __init__(self):
                    self._lock = threading.Lock()

                def naps(self):
                    with self._lock:
                        time.sleep(1)

                def indirect(self):
                    with self._lock:
                        self.do_io()

                def do_io(self):
                    self._sock.sendall(b"x")
        """
        found = lint(src, LockDisciplineRule(), self.REL)
        ids = rule_ids(found)
        assert ids == ["lock-held-blocking-call"] * 2
        assert any("time.sleep" in f.message for f in found)
        assert any("do_io" in f.message for f in found)

    def test_condition_wait_exempt_and_snapshot_pattern(self):
        src = """
            import threading
            import time

            class T:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._cond = threading.Condition()
                    self._items = []

                def waiter(self):
                    with self._cond:
                        self._cond.wait()   # THE blocking-under-lock shape

                def snapshot_then_block(self):
                    with self._lock:
                        items = list(self._items)
                    time.sleep(0.1)         # lock already released
                    return items
        """
        assert lint(src, LockDisciplineRule(), self.REL) == []

    def test_queue_get_under_lock(self):
        src = """
            import queue
            import threading

            class T:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._q = queue.Queue()

                def drain(self):
                    with self._lock:
                        return self._q.get()
        """
        found = lint(src, LockDisciplineRule(), self.REL)
        assert rule_ids(found) == ["lock-held-blocking-call"]
        # dict .get() is NOT blocking: no finding for plain mappings
        src_ok = """
            import threading

            class T:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._map = {}

                def lookup(self, k):
                    with self._lock:
                        return self._map.get(k)
        """
        assert lint(src_ok, LockDisciplineRule(), self.REL) == []

    def test_out_of_scope_dirs_skipped(self):
        src = """
            import threading
            import time

            _lock = threading.Lock()

            def naps():
                with _lock:
                    time.sleep(1)
        """
        # query/ and parallel/ are in the scope (the plan
        # compiler's caches and the remote-storage exchange lock are the
        # locks the multi-host mesh work will contend); metrics/ stays out
        mod = Module.from_source(textwrap.dedent(src), "m3_tpu_torch/metrics/mod.py")
        rule = LockDisciplineRule()
        assert not rule.applies(mod)
        for now_in in ("m3_tpu_torch/query/mod.py", "m3_tpu_torch/parallel/mod.py"):
            assert rule.applies(
                Module.from_source(textwrap.dedent(src), now_in))


class TestBatchPartialIngest:
    REL = "m3_tpu_torch/aggregator/mod.py"

    PRE_FIX = """
        import numpy as np

        def dispatch_timed_batch(agg, e):
            ids, times, values = e["ids"], e["times"], e["values"]
            if not (len(ids) == len(times) == len(values)):
                raise ValueError("mismatch")
            if not all(isinstance(m, (bytes, bytearray)) for m in ids):
                raise ValueError("ids must be bytes")
            times = times.tolist() if hasattr(times, "tolist") else times
            values = values.tolist() if hasattr(values, "tolist") else values
            for mid, t, v in zip(ids, times, values):
                agg.add_timed(mid, t, v)
    """

    POST_FIX = """
        import numpy as np

        def dispatch_timed_batch(agg, e):
            ids, times, values = e["ids"], e["times"], e["values"]
            if not (len(ids) == len(times) == len(values)):
                raise ValueError("mismatch")
            if not all(isinstance(m, (bytes, bytearray)) for m in ids):
                raise ValueError("ids must be bytes")
            ids = [m if type(m) is bytes else bytes(m) for m in ids]
            times = np.asarray(times)
            values = np.asarray(values)
            if times.dtype.kind not in "iuf" or values.dtype.kind not in "iuf":
                raise ValueError("non-numeric")
            times = times.tolist()
            values = values.tolist()
            for mid, t, v in zip(ids, times, values):
                agg.add_timed(mid, t, v)
    """

    def test_flags_pre_fix_dispatch_pattern(self):
        found = lint(self.PRE_FIX, BatchPartialIngestRule(), self.REL)
        msgs = " | ".join(f.message for f in found)
        assert rule_ids(found) == ["batch-partial-ingest"] * 3
        assert "bytearray" in msgs            # ids admit unhashable buffers
        assert "'times'" in msgs and "'values'" in msgs  # unvalidated cols

    def test_post_fix_dispatch_is_clean(self):
        assert lint(self.POST_FIX, BatchPartialIngestRule(), self.REL) == []

    def test_bare_asarray_without_dtype_check_still_flags(self):
        # np.asarray(col) with NO dtype and NO dtype check silently
        # coerces a mixed column to strings — the hazard survives, so
        # deleting the dtype check must re-flag the columns
        src = self.POST_FIX.replace(
            '            if times.dtype.kind not in "iuf" or '
            'values.dtype.kind not in "iuf":\n'
            '                raise ValueError("non-numeric")\n', "")
        assert 'dtype.kind' not in src  # the replace really removed it
        found = lint(src, BatchPartialIngestRule(), self.REL)
        msgs = " | ".join(f.message for f in found)
        assert rule_ids(found) == ["batch-partial-ingest"] * 2
        assert "'times'" in msgs and "'values'" in msgs

    def test_annassign_rlock_reentry_is_fine(self):
        # RLock declared via ANNOTATED assignment must still register as
        # reentrant (was a false self-deadlock through the name heuristic)
        src = """
            import threading

            class T:
                def __init__(self):
                    self._lock: threading.RLock = threading.RLock()

                def outer(self):
                    with self._lock:
                        self.inner()

                def inner(self):
                    with self._lock:
                        pass
        """
        assert lint(src, LockDisciplineRule(),
                    "m3_tpu_torch/storage/mod.py") == []

    def test_dirs_scoping_anchors_at_package_root(self):
        # ancestor directories named like scoped packages (a checkout at
        # /tmp/msg/...) must not trip directory-scoped rules on modules
        # the scope excludes
        src = "import threading\n"
        rule = LockDisciplineRule()
        assert not rule.applies(
            Module.from_source(src, "/tmp/msg/proj/m3_tpu_torch/metrics/x.py"))
        assert rule.applies(
            Module.from_source(src, "/tmp/metrics/proj/m3_tpu_torch/msg/x.py"))

    def test_no_contract_no_finding(self):
        # zip loops without a validate-then-iterate contract (no
        # isinstance validation) are not all-or-nothing promises
        src = """
            def plot(xs, ys):
                out = []
                for x, y in zip(xs, ys):
                    out.append(draw(x, y))
                return out
        """
        assert lint(src, BatchPartialIngestRule(), self.REL) == []


class TestSuppressionAndRunner:
    def test_line_and_next_line_and_file_suppression(self):
        base = """
            import functools

            @functools.lru_cache(maxsize=8){deco_comment}
            def f(data: bytes) -> int:
                return len(data)
        """
        flagged = lint(base.format(deco_comment=""), CacheKeyBufferRule())
        assert len(flagged) == 1
        line = flagged[0].line
        # trailing comment on the flagged line
        src = textwrap.dedent(base.format(deco_comment=""))
        lines = src.splitlines()
        lines[line - 1] += "  # m3lint: disable=cache-key-buffer"
        assert lint("\n".join(lines), CacheKeyBufferRule()) == []
        # standalone comment on the line above
        lines = src.splitlines()
        lines.insert(line - 1, "# m3lint: disable=cache-key-buffer")
        assert lint("\n".join(lines), CacheKeyBufferRule()) == []
        # file-level
        assert lint("# m3lint: disable-file=all\n" + src,
                    CacheKeyBufferRule()) == []

    def test_trailing_suppression_does_not_bleed_to_next_line(self):
        # a trailing disable on line N must NOT suppress a finding on
        # line N+1 — only STANDALONE comment lines cover the line below
        src = textwrap.dedent("""
            import functools

            def f(data: bytes) -> int:
                return len(data)

            g = functools.lru_cache(8)(f)  # m3lint: disable=cache-key-buffer
            h = functools.lru_cache(8)(f)
        """)
        found = lint(src, CacheKeyBufferRule())
        assert len(found) == 1  # only the unsuppressed wrap reports
        assert found[0].line == src.splitlines().index(
            "h = functools.lru_cache(8)(f)") + 1

    def test_overlapping_paths_analyze_each_file_once(self, tmp_path):
        f = tmp_path / "ops" / "one.py"
        f.parent.mkdir()
        f.write_text(textwrap.dedent("""
            import functools

            @functools.lru_cache(maxsize=8)
            def f(data: bytes) -> int:
                return len(data)
        """))
        findings, _, nmods = run_paths([str(tmp_path), str(f)])
        assert nmods == 1
        assert len(findings) == 1

    def test_disable_marker_in_string_is_not_honored(self):
        src = """
            import functools

            S = "# m3lint: disable-file=all"

            @functools.lru_cache(maxsize=8)
            def f(data: bytes) -> int:
                return len(data)
        """
        assert len(lint(src, CacheKeyBufferRule())) == 1

    def test_cli_exit_codes(self, tmp_path):
        bad = tmp_path / "ops" / "bad.py"
        bad.parent.mkdir()
        bad.write_text(textwrap.dedent("""
            import functools

            @functools.lru_cache(maxsize=8)
            def f(data: bytes) -> int:
                return len(data)
        """))
        env_dir = str(REPO)
        r = subprocess.run(
            [sys.executable, "-m", "m3_tpu_torch.analysis", str(bad)],
            cwd=env_dir, capture_output=True, text=True)
        assert r.returncode == 1
        assert "cache-key-buffer" in r.stdout
        ok = tmp_path / "ops" / "ok.py"
        ok.write_text("x = 1\n")
        r = subprocess.run(
            [sys.executable, "-m", "m3_tpu_torch.analysis", str(ok)],
            cwd=env_dir, capture_output=True, text=True)
        assert r.returncode == 0

    def test_unparseable_file_is_a_finding(self, tmp_path):
        f = tmp_path / "broken.py"
        f.write_text("def f(:\n")
        findings, _, _ = run_paths([str(f)])
        assert rule_ids(findings) == ["parse-error"]


class TestRetryRules:
    def test_flags_fixed_delay_retry_loop(self):
        src = """
            import time

            def pump(connect):
                while True:
                    try:
                        connect()
                        return
                    except OSError:
                        pass
                    time.sleep(0.2)
        """
        found = lint(src, RawSleepRetryRule(), "m3_tpu_torch/msg/mod.py")
        assert rule_ids(found) == ["raw-sleep-retry"]

    def test_sleep_in_handler_also_flags(self):
        src = """
            import time

            def fetch(call):
                for _ in range(5):
                    try:
                        return call()
                    except ConnectionError:
                        time.sleep(1.0)
        """
        assert rule_ids(lint(src, RawSleepRetryRule())) == ["raw-sleep-retry"]

    def test_poll_loop_without_try_is_fine(self):
        src = """
            import time

            def watch(poll):
                while True:
                    poll()
                    time.sleep(5)
        """
        assert lint(src, RawSleepRetryRule()) == []

    def test_retrier_module_is_exempt(self):
        src = """
            import time

            def attempt(fn):
                while True:
                    try:
                        return fn()
                    except OSError:
                        time.sleep(0.1)
        """
        assert lint(src, RawSleepRetryRule(), "m3_tpu_torch/utils/retry.py") == []
        # ...but the same shape anywhere else is not
        assert lint(src, RawSleepRetryRule(), "m3_tpu_torch/cluster/mod.py")

    def test_nested_function_sleep_not_attributed_to_loop(self):
        src = """
            import time

            def outer(items):
                while items:
                    try:
                        items.pop()
                    except IndexError:
                        pass

                    def helper():
                        time.sleep(1)
        """
        assert lint(src, RawSleepRetryRule()) == []

    def test_flags_broad_except_around_wire_io(self):
        src = """
            from ..rpc import wire

            def serve(sock):
                try:
                    return wire.read_frame(sock)
                except Exception:
                    return None
        """
        found = lint(src, BroadExceptWireIORule(), "m3_tpu_torch/query/mod.py")
        assert rule_ids(found) == ["broad-except-wire-io"]
        assert "read_frame" in found[0].message

    def test_bare_except_and_write_frame_flag(self):
        src = """
            from ..rpc import wire

            def push(sock, v):
                try:
                    wire.write_frame(sock, v)
                except:
                    pass
        """
        assert rule_ids(lint(src, BroadExceptWireIORule())) == \
            ["broad-except-wire-io"]

    def test_typed_except_set_is_fine(self):
        src = """
            from ..rpc import wire

            def serve(sock):
                try:
                    while True:
                        wire.write_frame(sock, wire.read_dict_frame(sock))
                except (ConnectionError, OSError, ValueError):
                    pass
        """
        assert lint(src, BroadExceptWireIORule()) == []

    def test_inner_typed_try_owns_its_wire_calls(self):
        # the node_server shape: a broad handler for DISPATCH errors is
        # fine when the wire I/O has its own typed containment
        src = """
            from ..rpc import wire

            def handle(sock, dispatch):
                try:
                    while True:
                        try:
                            req = wire.read_dict_frame(sock)
                        except (ConnectionError, ValueError):
                            return
                        dispatch(req)
                except Exception:
                    pass
        """
        assert lint(src, BroadExceptWireIORule()) == []

    def test_broad_except_without_wire_io_is_out_of_scope(self):
        src = """
            def run(fn):
                try:
                    return fn()
                except Exception:
                    return None
        """
        assert lint(src, BroadExceptWireIORule()) == []

    def test_flags_broad_except_around_peer_streaming_in_bootstrap(self):
        # the pre-fix PeersBootstrapper.bootstrap hole: peers unavailable
        # silently claimed nothing
        src = """
            def bootstrap(ns, shard_id, ctx):
                try:
                    series = ctx.session.fetch_bootstrap_blocks_from_peers(
                        ns.name, shard_id, 0, 1)
                except Exception:
                    return None
        """
        found = lint(src, BroadExceptWireIORule(),
                     "m3_tpu_torch/storage/bootstrap.py")
        assert rule_ids(found) == ["broad-except-wire-io"]
        assert "peer-streaming" in found[0].message

    def test_flags_broad_except_around_tile_fetch_in_repair(self):
        src = """
            def sweep(self, ns, shard_id, plan):
                try:
                    tiles, failed = self.session.fetch_block_tiles(
                        ns.name, shard_id, plan)
                except Exception:
                    tiles, failed = {}, []
                return tiles
        """
        assert rule_ids(lint(src, BroadExceptWireIORule(),
                             "m3_tpu_torch/storage/repair.py")) == \
            ["broad-except-wire-io"]

    def test_peer_streaming_scope_covers_query_and_parallel(self):
        # the peer-I/O treatment covers query/ and parallel/
        # (remote fan-ins are wire I/O one hop removed there too); the
        # same shape in e.g. coordinator/ stays out of this extension
        src = """
            def mirror(session, ns):
                try:
                    return session.fetch_bootstrap_blocks_from_peers(
                        ns, 0, 0, 1)
                except Exception:
                    return {}
        """
        found = lint(src, BroadExceptWireIORule(), "m3_tpu_torch/query/mod.py")
        assert rule_ids(found) == ["broad-except-wire-io"]
        assert lint(src, BroadExceptWireIORule(),
                    "m3_tpu_torch/coordinator/mod.py") == []

    def test_broad_handler_with_bare_reraise_is_exempt(self):
        # settle-the-grant-then-raise (query/remote._exchange): a broad
        # handler ending in a bare re-raise FORWARDS the typed
        # classification — nothing is eaten
        src = """
            from . import wire

            def exchange(sock, req):
                try:
                    wire.write_frame(sock, req)
                except BaseException:
                    req["breaker"].record_failure()
                    raise
        """
        assert lint(src, BroadExceptWireIORule(),
                    "m3_tpu_torch/rpc/mod.py") == []

    def test_broad_handler_with_escaping_branch_still_flags(self):
        # the bare-raise exemption requires forwarding on EVERY path: an
        # early return inside the handler swallows the classification
        src = """
            from . import wire

            def exchange(sock, req, transient):
                try:
                    wire.write_frame(sock, req)
                except Exception:
                    if transient:
                        return None
                    raise
        """
        found = lint(src, BroadExceptWireIORule(), "m3_tpu_torch/rpc/mod.py")
        assert rule_ids(found) == ["broad-except-wire-io"]

    def test_loop_local_break_does_not_void_the_reraise_exemption(self):
        # break/continue bound to a loop INSIDE the handler never leave
        # the handler — the final bare raise still runs on every path
        src = """
            from . import wire

            def exchange(sock, req, attempts):
                try:
                    wire.write_frame(sock, req)
                except Exception:
                    for a in attempts:
                        if a.stale():
                            continue
                        a.cancel()
                        break
                    raise
        """
        assert lint(src, BroadExceptWireIORule(),
                    "m3_tpu_torch/rpc/mod.py") == []

    def test_typed_peer_skip_set_is_fine_in_bootstrap(self):
        # the post-fix shape: typed classification, counted skip
        src = """
            from ..client.session import PEER_SKIP_ERRORS

            def bootstrap(ns, shard_id, ctx):
                try:
                    tiles, tags, failed = \\
                        ctx.session.fetch_block_tiles_from_peers(
                            ns.name, shard_id, 0, 1)
                except PEER_SKIP_ERRORS:
                    return None
        """
        assert lint(src, BroadExceptWireIORule(),
                    "m3_tpu_torch/storage/bootstrap.py") == []

    def test_suppression_silences_with_justification(self):
        src = """
            from ..rpc import wire

            def relay(sock, work):
                try:
                    wire.write_frame(sock, work())
                # DELIBERATE: error-relay contract
                except Exception:  # m3lint: disable=broad-except-wire-io
                    pass
        """
        assert lint(src, BroadExceptWireIORule()) == []


class TestUnboundedQueueRule:
    """unbounded-queue: stdlib Queue()/deque() without a bound inside the
    buffering layers (storage/msg/coordinator/aggregator/rpc) turn
    overload into OOM instead of backpressure."""

    def test_flags_unbounded_deque_in_msg(self):
        src = """
            from collections import deque

            pending = deque()
        """
        found = lint(src, UnboundedQueueRule(), "m3_tpu_torch/msg/mod.py")
        assert rule_ids(found) == ["unbounded-queue"]

    def test_flags_unbounded_queue_in_storage(self):
        src = """
            import queue

            work = queue.Queue()
        """
        found = lint(src, UnboundedQueueRule(), "m3_tpu_torch/storage/mod.py")
        assert rule_ids(found) == ["unbounded-queue"]

    def test_flags_literal_unbounded_maxsize(self):
        # Queue semantics: maxsize <= 0 means infinite — a literal 0 or
        # negative bound is no bound
        src = """
            import queue

            a = queue.Queue(0)
            b = queue.Queue(maxsize=-1)
        """
        found = lint(src, UnboundedQueueRule(), "m3_tpu_torch/rpc/mod.py")
        assert rule_ids(found) == ["unbounded-queue", "unbounded-queue"]

    def test_simple_queue_always_flags(self):
        src = """
            import queue

            q = queue.SimpleQueue()
        """
        found = lint(src, UnboundedQueueRule(), "m3_tpu_torch/aggregator/mod.py")
        assert rule_ids(found) == ["unbounded-queue"]
        assert "no capacity bound" in found[0].message

    def test_bounded_forms_are_fine(self):
        src = """
            import queue
            from collections import deque

            a = queue.Queue(100)
            b = queue.Queue(maxsize=64)
            c = deque(maxlen=4096)
            d = deque([], 16)
        """
        assert lint(src, UnboundedQueueRule(), "m3_tpu_torch/msg/mod.py") == []

    def test_out_of_scope_dirs_are_ignored(self):
        src = """
            from collections import deque

            scratch = deque()
        """
        assert lint(src, UnboundedQueueRule(), "m3_tpu_torch/ops/mod.py") == []

    def test_local_helper_named_deque_is_not_stdlib(self):
        src = """
            def deque():
                return []

            pending = deque()
        """
        assert lint(src, UnboundedQueueRule(), "m3_tpu_torch/msg/mod.py") == []

    def test_dotted_non_stdlib_parent_is_ignored(self):
        src = """
            import mylib

            q = mylib.Queue()
        """
        assert lint(src, UnboundedQueueRule(), "m3_tpu_torch/msg/mod.py") == []

    def test_suppression_with_justification(self):
        src = """
            from collections import deque

            # DELIBERATE: control-plane only, bounded by topic count
            topics = deque()  # m3lint: disable=unbounded-queue
        """
        assert lint(src, UnboundedQueueRule(), "m3_tpu_torch/msg/mod.py") == []


class TestUnbudgetedDevicePut:
    """unbudgeted-device-put on the port: a raw host-to-device put on the
    storage/query serving path pins card memory the shared budget
    (utils/hbm.py) cannot see."""

    def test_flags_to_device_in_storage(self):
        src = """
            import torch

            def upload(words, dev):
                return torch.from_numpy(words).to(dev)
        """
        found = lint(src, UnbudgetedDevicePutRule(),
                     "m3_tpu_torch/storage/mod.py")
        assert rule_ids(found) == ["unbudgeted-device-put"]

    def test_flags_cuda_and_device_keyword_forms_in_query(self):
        src = """
            import torch

            def upload(grid, dev):
                a = grid.cuda()
                b = torch.as_tensor(grid, device=dev)
                c = torch.tensor(grid, dtype=torch.float32, device="cuda")
                d = grid.to(device=dev, dtype=torch.float32)
                return a, b, c, d
        """
        found = lint(src, UnbudgetedDevicePutRule(),
                     "m3_tpu_torch/query/mod.py")
        assert rule_ids(found) == ["unbudgeted-device-put"] * 4

    def test_casts_and_constant_tables_pass(self):
        src = """
            import torch

            _POW10 = [1.0, 10.0, 100.0]

            def prep(x, dev):
                a = x.to(torch.float32)           # a cast, not a put
                b = torch.tensor(_POW10, device=dev)
                c = torch.tensor([1, 2, 3], dtype=torch.int64, device=dev)
                d = torch.zeros(4, device=dev)    # made there, not moved
                return a, b, c, d
        """
        assert lint(src, UnbudgetedDevicePutRule(),
                    "m3_tpu_torch/ops/mod.py") == []

    def test_budgeted_put_is_fine(self):
        src = """
            import torch
            from m3_tpu_torch.utils import hbm

            dev = hbm.budgeted_put(words)
        """
        assert lint(src, UnbudgetedDevicePutRule(),
                    "m3_tpu_torch/storage/mod.py") == []

    def test_out_of_scope_dirs_are_ignored(self):
        src = """
            import torch

            t = frame.to(dev)
        """
        assert lint(src, UnbudgetedDevicePutRule(),
                    "m3_tpu_torch/testing/mod.py") == []

    def test_module_without_torch_import_is_skipped(self):
        src = """
            def upload(words, dev):
                return words.to(dev)
        """
        assert lint(src, UnbudgetedDevicePutRule(),
                    "m3_tpu_torch/storage/mod.py") == []

    def test_suppression_with_justification(self):
        src = """
            import torch

            # DELIBERATE: ingest staging, consumed and freed at once
            t = torch.from_numpy(tile).to(dev)  # m3lint: disable=unbudgeted-device-put
        """
        assert lint(src, UnbudgetedDevicePutRule(),
                    "m3_tpu_torch/parallel/mod.py") == []

    def test_every_put_on_the_tree_is_classified(self, port_tree):
        """Each raw put of storage/, query/, ops/ and parallel/ carries a
        one-line reason with its suppression (or goes through the
        budget): count them, so a new one is seen."""
        assert port_tree.of({"unbudgeted-device-put"}) == []
        assert port_tree.suppressed["unbudgeted-device-put"] == 32


class TestHotLoopUnderLock:
    """hot-loop-under-lock: per-item dict-mutation loops inside a
    `with <lock>` block in the storage/index/aggregator write paths —
    the shape the insert-queue rebuild removed from Shard.write_batch."""

    PRE_CHANGE_WRITE_BATCH = """
        import threading

        class Shard:
            def __init__(self):
                self.write_lock = threading.RLock()

            def write_batch(self, ids, ts, vals, tags):
                with self.write_lock:
                    for i, sid in enumerate(ids):
                        idx, is_new = self.registry.get_or_create(
                            sid, tags[i] if tags else None)
                        if is_new and self.on_new_series is not None:
                            self.on_new_series(sid, tags[i], idx)
                    self.buffer.write_batch(ids, ts, vals)
    """

    def test_flags_the_pre_change_shard_write_batch(self):
        # The seeded true positive: the EXACT pre-rebuild write path.
        found = lint(self.PRE_CHANGE_WRITE_BATCH, HotLoopUnderLockRule(),
                     "m3_tpu_torch/storage/shard.py")
        assert rule_ids(found) == ["hot-loop-under-lock"]
        assert "get_or_create" in found[0].message

    def test_flags_setdefault_and_insert_loops(self):
        src = """
            import threading

            class Index:
                def __init__(self):
                    self._lock = threading.Lock()

                def insert_all(self, items, docs):
                    with self._lock:
                        for sid, tags in items:
                            self._terms.setdefault(sid, []).append(tags)
                        i = 0
                        while i < len(docs):
                            self.mutable.insert(docs[i])
                            i += 1
        """
        found = lint(src, HotLoopUnderLockRule(), "m3_tpu_torch/index/mod.py")
        assert rule_ids(found) == ["hot-loop-under-lock"] * 2

    def test_batched_entrypoints_under_lock_are_fine(self):
        # The post-rebuild shape: one bulk apply per lock hold.
        src = """
            import threading

            class Shard:
                def __init__(self):
                    self.write_lock = threading.Lock()

                def drain(self, groups):
                    with self.write_lock:
                        for g in groups:
                            idxs, created = \\
                                self.registry.get_or_create_batch_tagged(
                                    g.ids, g.tags)
                            self.buffer.write_batch(idxs, g.ts, g.vals)

                def index_drain(self, docs):
                    with self._lock:
                        self.mutable.insert_batch(docs)
        """
        assert lint(src, HotLoopUnderLockRule(),
                    "m3_tpu_torch/storage/shard.py") == []

    def test_loop_outside_lock_is_fine(self):
        src = """
            import threading

            class Shard:
                def __init__(self):
                    self.write_lock = threading.Lock()

                def write_batch(self, ids):
                    entries = []
                    for sid in ids:
                        entries.append(self.groups.setdefault(sid, []))
                    with self.write_lock:
                        self.buffer.write_batch(entries)
        """
        assert lint(src, HotLoopUnderLockRule(),
                    "m3_tpu_torch/storage/shard.py") == []

    def test_nested_function_under_lock_not_attributed(self):
        src = """
            import threading

            class S:
                def __init__(self):
                    self._lock = threading.Lock()

                def setup(self):
                    with self._lock:
                        def later(items):
                            for it in items:
                                self.m.insert(it)
                        self.cb = later
        """
        assert lint(src, HotLoopUnderLockRule(),
                    "m3_tpu_torch/storage/mod.py") == []

    def test_out_of_scope_dirs_are_ignored(self):
        found = lint(self.PRE_CHANGE_WRITE_BATCH, HotLoopUnderLockRule(),
                     "m3_tpu_torch/query/mod.py")
        assert found == []

    def test_suppression_with_justification(self):
        src = """
            import threading

            class S:
                def __init__(self):
                    self._lock = threading.Lock()

                def rebuild(self, items):
                    with self._lock:
                        for it in items:
                            # DELIBERATE: cold recovery path, runs at boot
                            self.map.insert(it)  # m3lint: disable=hot-loop-under-lock
        """
        assert lint(src, HotLoopUnderLockRule(),
                    "m3_tpu_torch/storage/mod.py") == []


class TestObsRules:
    # the EXACT pre-fix rpc/node_server.py shape: uptime measured as a
    # wall-clock delta across methods (assignment in __init__, the
    # subtraction in a handler) — the rule's seeded positive.
    PRE_FIX_UPTIME = """
        import time

        class NodeService:
            def __init__(self):
                self.start_ns = time.time_ns()

            def rpc_health(self):
                return {"uptime_ns": time.time_ns() - self.start_ns}
    """

    def test_flags_pre_fix_uptime_pattern(self):
        found = lint(self.PRE_FIX_UPTIME, WallClockLatencyRule(),
                     "m3_tpu_torch/rpc/mod.py")
        assert rule_ids(found) == ["wall-clock-latency"]

    def test_flags_direct_latency_delta(self):
        src = """
            import time

            def handle(fn):
                t0 = time.time()
                fn()
                return time.time() - t0
        """
        found = lint(src, WallClockLatencyRule(), "m3_tpu_torch/storage/mod.py")
        assert rule_ids(found) == ["wall-clock-latency"]

    def test_flags_bare_import_form(self):
        src = """
            from time import time

            def measure(fn):
                start = time()
                fn()
                return time() - start
        """
        found = lint(src, WallClockLatencyRule(), "m3_tpu_torch/msg/mod.py")
        assert rule_ids(found) == ["wall-clock-latency"]

    def test_perf_counter_delta_is_fine(self):
        src = """
            import time

            def handle(fn):
                t0 = time.perf_counter()
                fn()
                return time.perf_counter() - t0
        """
        assert lint(src, WallClockLatencyRule(),
                    "m3_tpu_torch/storage/mod.py") == []

    def test_wall_reads_and_range_arithmetic_are_fine(self):
        # data timestamps and range math read the wall clock without
        # measuring elapsed time: a single wall operand never flags.
        src = """
            import time

            def default_range(window_s):
                end = time.time()
                start = end - window_s
                return start, end

            def stamp():
                return time.time_ns()
        """
        assert lint(src, WallClockLatencyRule(),
                    "m3_tpu_torch/query/mod.py") == []

    def test_out_of_scope_dirs_skipped(self):
        found = lint(self.PRE_FIX_UPTIME, WallClockLatencyRule(),
                     "m3_tpu_torch/coordinator/mod.py")
        assert found == []

    def test_suppression_silences(self):
        src = """
            import time

            def handle(fn):
                t0 = time.time()
                fn()
                # DELIBERATE: test fixture comparing against wall stamps
                return time.time() - t0  # m3lint: disable=wall-clock-latency
        """
        assert lint(src, WallClockLatencyRule(),
                    "m3_tpu_torch/storage/mod.py") == []


class TestHostSyncInPlan:
    # The pre-change per-op dispatch shape, transplanted into a lowering
    # rule: dispatch a kernel, np.asarray the result to the host, feed
    # the next operator — the round trip the whole-plan compiler removes.
    PRE_CHANGE_DISPATCH = """
        import numpy as np

        def _lower_rangefunc(ctx, node):
            out = ctx.kernel(ctx.grid)
            host = np.asarray(out)        # per-op host round trip
            return ctx.next_op(host)
    """

    def test_flags_pre_change_per_op_dispatch(self):
        found = lint(self.PRE_CHANGE_DISPATCH, HostSyncInPlanRule(),
                     "m3_tpu_torch/parallel/compile.py")
        assert rule_ids(found) == ["host-sync-in-plan"]
        assert "np.asarray" in found[0].message

    def test_flags_item_in_emit(self):
        src = """
            def _emit(ctx, node):
                val = ctx.cache[id(node)]
                if val.sum().item() > 0:   # traced-value host sync
                    return val
                return -val
        """
        found = lint(src, HostSyncInPlanRule(), "m3_tpu_torch/parallel/compile.py")
        assert rule_ids(found) == ["host-sync-in-plan"]
        assert ".item()" in found[0].message

    def test_flags_device_get_in_traced_body(self):
        src = """
            import jax

            def _plan_executable(stripped, geom):
                def body(fetch_flat, slots):
                    mid = jax.device_get(fetch_flat[0])
                    return mid + slots
                return jax.jit(body)
        """
        found = lint(src, HostSyncInPlanRule(), "m3_tpu_torch/parallel/compile.py")
        assert rule_ids(found) == ["host-sync-in-plan"]

    def test_flags_bare_from_import(self):
        src = """
            from numpy import asarray

            def _lower_aggregate(ctx, node):
                return asarray(ctx.cache[id(node)])
        """
        found = lint(src, HostSyncInPlanRule(), "m3_tpu_torch/parallel/compile.py")
        assert rule_ids(found) == ["host-sync-in-plan"]

    def test_host_finish_in_execute_is_fine(self):
        # execute() materializes AFTER the compiled program returns —
        # the legitimate sync point, outside the lowering surface.
        src = """
            import numpy as np

            def execute(bound, mesh):
                root_val = dispatch(bound)
                return np.asarray(root_val)[:4]
        """
        assert lint(src, HostSyncInPlanRule(),
                    "m3_tpu_torch/parallel/compile.py") == []

    def test_other_parallel_modules_skipped(self):
        found = lint(self.PRE_CHANGE_DISPATCH, HostSyncInPlanRule(),
                     "m3_tpu_torch/parallel/query.py")
        assert found == []

    def test_suppression_silences(self):
        src = """
            import numpy as np

            def _lower_fetch(ctx, node):
                # DELIBERATE: static bind-time constant, not a traced value
                shape = np.asarray(node.shape)  # m3lint: disable=host-sync-in-plan
                return ctx.fetch_ins[node][: shape[0]]
        """
        assert lint(src, HostSyncInPlanRule(),
                    "m3_tpu_torch/parallel/compile.py") == []


class TestHostSyncInPlanTorch:
    """host-sync-in-plan's torch shapes: the lowering rules run inside the
    CUDA-graph capture on the card, where a host sync is an error and a
    read value is baked into every replay."""

    def test_flags_tensor_to_host_methods(self):
        src = """
            import torch

            def _lower_rangefunc(ctx, node):
                v = ctx.fetch_ins[node]["value"][0]
                a = v.cpu()
                b = v.numpy()
                c = v.tolist()
                return a, b, c
        """
        found = lint(src, HostSyncInPlanRule(),
                     "m3_tpu_torch/parallel/compile.py", parity=False)
        assert rule_ids(found) == ["host-sync-in-plan"] * 3
        assert [m.message.split(" ")[0] for m in found] == [
            "`.cpu()`", "`.numpy()`", "`.tolist()`"]

    def test_flags_nonzero_and_bool(self):
        src = """
            import torch

            def _lower_rankagg(ctx, node):
                keep = torch.nonzero(ctx.mask)
                return ctx.v[keep], bool(ctx.mask.any())
        """
        found = lint(src, HostSyncInPlanRule(),
                     "m3_tpu_torch/parallel/compile.py", parity=False)
        assert rule_ids(found) == ["host-sync-in-plan"] * 2

    def test_flags_python_branch_on_a_tensor(self):
        src = """
            import torch

            def _range_body(ctx, f, ins):
                finite = torch.isfinite(ins["resid"][0])
                if finite.all():
                    return ins["resid"][0]
                return torch.where(finite, ins["resid"][0], 0.0)
        """
        found = lint(src, HostSyncInPlanRule(),
                     "m3_tpu_torch/parallel/compile.py", parity=False)
        assert rule_ids(found) == ["host-sync-in-plan"]
        assert "Python branch on a tensor" in found[0].message

    def test_branches_on_plan_structure_pass(self):
        # the port's lowering: branch on the node, the slot arity and the
        # geometry, compute with torch.where
        src = """
            import torch

            def _lower_instantfunc(ctx, node):
                v = _emit(ctx, node.arg)
                params = [ctx.slots[p.slot] for p in node.params]
                if node.func == "round":
                    if not params:
                        return torch.round(v)
                    return torch.round(v / params[0]) * params[0]
                if ctx.slices is not None and v.shape[0] > 1:
                    return v
                return torch.where(torch.isfinite(v), v, float("nan"))
        """
        assert lint(src, HostSyncInPlanRule(),
                    "m3_tpu_torch/parallel/compile.py", parity=False) == []


class TestUnboundedTelemetryTag:
    # The seeded positive: the explain work's easy mistake — tagging the
    # plan-fallback counter with the raw query string mints one registry
    # entry (and one self-scraped series) per distinct query, forever.
    SEEDED_POSITIVE = """
        from m3_tpu_torch.utils.instrument import ROOT

        def record_fallback(query, reason):
            ROOT.sub_scope("plan_fallback", query=query).counter("n").inc()
    """

    def test_flags_seeded_positive_query_tag(self):
        found = lint(self.SEEDED_POSITIVE, UnboundedTelemetryTagRule(),
                     "m3_tpu_torch/query/mod.py")
        assert rule_ids(found) == ["unbounded-telemetry-tag"]
        assert "query" in found[0].message

    def test_flags_fstring_metric_name(self):
        src = """
            from m3_tpu_torch.utils.instrument import ROOT

            def count(expr):
                ROOT.counter(f"fallback.{expr}").inc()
        """
        found = lint(src, UnboundedTelemetryTagRule(), "m3_tpu_torch/query/mod.py")
        assert rule_ids(found) == ["unbounded-telemetry-tag"]

    def test_flags_str_wrapped_selector_tag_value(self):
        src = """
            from m3_tpu_torch.utils.instrument import ROOT

            def record(selector):
                scope = ROOT.sub_scope("fetch", kind=str(selector))
                scope.counter("n").inc()
        """
        found = lint(src, UnboundedTelemetryTagRule(), "m3_tpu_torch/query/mod.py")
        assert rule_ids(found) == ["unbounded-telemetry-tag"]

    def test_flags_percent_format_sub_scope_name(self):
        src = """
            from m3_tpu_torch.utils.instrument import ROOT

            def record(pattern):
                ROOT.sub_scope("regexp.%s" % pattern).counter("n").inc()
        """
        found = lint(src, UnboundedTelemetryTagRule(), "m3_tpu_torch/index/mod.py")
        assert rule_ids(found) == ["unbounded-telemetry-tag"]

    def test_closed_set_enum_value_is_fine(self):
        # The shipped shape: the FallbackReason enum VALUE is a closed
        # set — `reason` is not in the unbounded vocabulary.
        src = """
            from m3_tpu_torch.utils.instrument import ROOT

            def plan_fallback(reason):
                ROOT.sub_scope("plan_fallback",
                               reason=reason).counter("count").inc()
        """
        assert lint(src, UnboundedTelemetryTagRule(),
                    "m3_tpu_torch/parallel/mod.py") == []

    def test_bounded_builder_and_kind_interpolations_are_fine(self):
        # telemetry.py / limits.py house shapes: builder names, limit
        # kinds, admission-gate names — all closed sets.
        src = """
            from m3_tpu_torch.utils.instrument import ROOT

            def jit_builder(name, kind):
                ROOT.sub_scope("jit", builder=name).counter("hits").inc()
                ROOT.counter(f"{kind}.exceeded").inc()
                ROOT.sub_scope(f"admission.{name}").gauge("depth")
        """
        assert lint(src, UnboundedTelemetryTagRule(),
                    "m3_tpu_torch/utils/mod.py") == []

    def test_literal_names_and_tags_are_fine(self):
        src = """
            from m3_tpu_torch.utils.instrument import ROOT

            SCOPE = ROOT.sub_scope("telemetry")

            def count():
                SCOPE.sub_scope("mesh", kernel="flush").counter("n").inc()
                SCOPE.histogram("compile_s", (0.1, 1.0)).record(0.5)
        """
        assert lint(src, UnboundedTelemetryTagRule(),
                    "m3_tpu_torch/parallel/mod.py") == []

    def test_non_scope_calls_ignored(self):
        # dict.get / collections.Counter / unrelated .counter-free calls
        # never match; only scope-method shapes do.
        src = """
            import collections

            def tally(query, counts):
                c = collections.Counter(query)
                counts.update(query=query)
                return c
        """
        assert lint(src, UnboundedTelemetryTagRule(),
                    "m3_tpu_torch/query/mod.py") == []

    def test_suppression_silences(self):
        src = """
            from m3_tpu_torch.utils.instrument import ROOT

            def record(query):
                # DELIBERATE: test-only registry, cleared per run
                ROOT.sub_scope("t", query=query).counter("n").inc()  # m3lint: disable=unbounded-telemetry-tag
        """
        assert lint(src, UnboundedTelemetryTagRule(),
                    "m3_tpu_torch/query/mod.py") == []


class TestUncheckedDiskIO:
    """unchecked-disk-io: broad handlers around direct file I/O in the
    persist plane without typed classification (persist/diskio.py's
    CorruptionError / DiskWriteError / classify_write_error taxonomy)."""

    # The seeded true positive: the pre-typed fileset-writer shape — an
    # ENOSPC swallowed whole, so nothing upstream ever trips the
    # read-only posture or withdraws the torn fileset.
    SEEDED = """
        import os

        def write_fileset(path, payload):
            try:
                with open(path, "wb") as f:
                    f.write(payload)
                os.replace(path, path[:-4])
            except Exception:
                return None
    """

    def test_seeded_positive_flags(self):
        found = lint(self.SEEDED, UncheckedDiskIORule(),
                     "m3_tpu_torch/persist/fs.py")
        assert rule_ids(found) == ["unchecked-disk-io"]
        assert "classify_write_error" in found[0].message

    def test_bare_except_around_seam_io_flags(self):
        src = """
            def sync(io, f):
                try:
                    io.fsync(f)
                except:
                    pass
        """
        # `io.fsync` matches the seam-owner shape (_io/diskio/os/io).
        assert rule_ids(lint(src, UncheckedDiskIORule(),
                             "m3_tpu_torch/persist/commitlog.py")) == \
            ["unchecked-disk-io"]

    def test_typed_handler_is_clean(self):
        src = """
            import os

            def remove(path):
                try:
                    os.remove(path)
                except OSError:
                    return False
                return True
        """
        assert lint(src, UncheckedDiskIORule(),
                    "m3_tpu_torch/persist/fs.py") == []

    def test_classifying_handler_is_clean(self):
        src = """
            from .diskio import classify_write_error

            def write(path, payload):
                try:
                    with open(path, "wb") as f:
                        f.write(payload)
                except Exception as e:
                    raise classify_write_error(e, path) from e
        """
        assert lint(src, UncheckedDiskIORule(),
                    "m3_tpu_torch/persist/fs.py") == []

    def test_bare_reraise_tail_is_clean(self):
        src = """
            import os

            def replace(src_p, dst_p, log):
                try:
                    os.replace(src_p, dst_p)
                except Exception:
                    log.warning("replace failed")
                    raise
        """
        assert lint(src, UncheckedDiskIORule(),
                    "m3_tpu_torch/persist/fs.py") == []

    def test_typed_raise_in_handler_is_clean(self):
        src = """
            from .diskio import CorruptionError

            def read(path):
                try:
                    with open(path, "rb") as f:
                        return f.read()
                except Exception as e:
                    raise CorruptionError(str(e), path=path)
        """
        assert lint(src, UncheckedDiskIORule(),
                    "m3_tpu_torch/persist/fs.py") == []

    def test_scoped_to_persist_and_seed_module_exempt(self):
        # Identical shape outside persist/ is another rule's business...
        assert lint(self.SEEDED, UncheckedDiskIORule(),
                    "m3_tpu_torch/query/mod.py") == []
        # ...and diskio.py itself is where broad->typed translation lives.
        assert lint(self.SEEDED, UncheckedDiskIORule(),
                    "m3_tpu_torch/persist/diskio.py") == []

    def test_non_io_try_is_clean(self):
        src = """
            def parse(blob):
                try:
                    return int(blob)
                except Exception:
                    return None
        """
        assert lint(src, UncheckedDiskIORule(),
                    "m3_tpu_torch/persist/fs.py") == []

    def test_inner_typed_try_owns_its_io(self):
        src = """
            import os

            def robust(path):
                try:
                    try:
                        os.remove(path)
                    except OSError:
                        return False
                    return True
                except Exception:
                    return None
        """
        # The inner try's typed handler owns the I/O call; the outer
        # broad handler guards no direct I/O.
        assert lint(src, UncheckedDiskIORule(),
                    "m3_tpu_torch/persist/fs.py") == []


class TestFlushCallbackLoop:
    """per-datapoint-callback-in-flush: loops on the aggregator
    flush/emit paths invoking a per-datapoint `*_fn(...)` callback —
    the shape the columnar flush rebuild removed from Elem.emit
    (retained `*_ref` oracles are exempt by design)."""

    # The seeded true positive: the EXACT pre-columnar Elem.emit loop.
    PRE_CHANGE_ELEM_EMIT = """
        class Elem:
            def emit(self, window_start, stats_row, quantile_row,
                     flush_fn, forward_fn=None):
                end_nanos = window_start + self.resolution_ns
                for at in self.agg_types:
                    q = at.quantile()
                    value = quantile_row[q] if q is not None else \\
                        _stat_value(at, stats_row)
                    if self.key.pipeline.is_empty():
                        flush_fn(self._out_ids[at], end_nanos, value,
                                 self.key.storage_policy)
                    else:
                        self._process_pipeline(at, end_nanos, value,
                                               flush_fn, forward_fn)
    """

    def test_flags_the_pre_change_elem_emit_loop(self):
        found = lint(self.PRE_CHANGE_ELEM_EMIT, FlushCallbackLoopRule(),
                     "m3_tpu_torch/aggregator/elem.py")
        assert rule_ids(found) == ["per-datapoint-callback-in-flush"]
        assert "flush_fn" in found[0].message

    def test_flags_forward_fn_loop_and_attribute_form(self):
        src = """
            def reduce_and_emit(jobs):
                for elem, start, vals, flush_fn, forward_fn in jobs:
                    forward_fn(elem.out_id, start, vals)

            class FlushManager:
                def flush(self, windows):
                    while windows:
                        w = windows.pop()
                        self._flush_fn(w.id, w.end, w.value, w.policy)
        """
        found = lint(src, FlushCallbackLoopRule(), "m3_tpu_torch/aggregator/x.py")
        assert rule_ids(found) == ["per-datapoint-callback-in-flush"] * 2

    def test_ref_oracle_functions_exempt(self):
        src = """
            def reduce_and_emit_ref(jobs):
                for elem, start, vals, flush_fn, forward_fn in jobs:
                    flush_fn(elem.out_id, start, vals, elem.policy)
        """
        assert lint(src, FlushCallbackLoopRule(),
                    "m3_tpu_torch/aggregator/list.py") == []

    def test_columnar_emit_and_map_shim_pass(self):
        # The post-rebuild shape: one columnar handler call per round,
        # per-datapoint compat driven by map (callback as ARGUMENT, not
        # a per-iteration call) — neither is the flagged loop shape.
        src = """
            def emit_batch(batch, flush_fn):
                for cls, rows in batch.classes.items():
                    ids = [e.out_id for e in rows.elems]
                    hb = getattr(flush_fn, "handle_columnar", None)
                    if hb is not None:
                        hb([(ids, rows.ends, rows.vals, cls.policy)])
                    else:
                        drain(map(flush_fn, ids, rows.ends, rows.vals))
        """
        assert lint(src, FlushCallbackLoopRule(),
                    "m3_tpu_torch/aggregator/list.py") == []

    def test_non_flush_functions_and_other_dirs_not_scanned(self):
        src = """
            def route(items, send_fn):
                for it in items:
                    send_fn(it)
        """
        assert lint(src, FlushCallbackLoopRule(),
                    "m3_tpu_torch/aggregator/client.py") == []
        flush_src = """
            def flush(items, flush_fn):
                for it in items:
                    flush_fn(it)
        """
        assert lint(flush_src, FlushCallbackLoopRule(),
                    "m3_tpu_torch/storage/shard.py") == []

    def test_suppression(self):
        src = """
            def flush(items, flush_fn):
                # compat shim for plain-callable sinks
                # m3lint: disable=per-datapoint-callback-in-flush
                for it in items:
                    flush_fn(it)
        """
        assert lint(src, FlushCallbackLoopRule(),
                    "m3_tpu_torch/aggregator/list.py") == []

    # The coordinator seeded true positive: the EXACT pre-change
    # Downsampler.write rollup loop — one add_untimed per rollup id per
    # ingested sample (metrics_appender.go SamplesAppender shape).
    PRE_CHANGE_DOWNSAMPLER_WRITE = """
        class Downsampler:
            def write(self, tags, t_nanos, value, metric_type):
                mid = _encode_tags(tags)
                result = self._matcher.match(mid)
                if result is None:
                    return False
                wrote = False
                for idm in result.for_new_rollup_ids:
                    mu = _to_union(metric_type, idm.id, value)
                    wrote = self._agg.add_untimed(mu, idm.metadatas) or wrote
                return wrote
    """

    def test_flags_the_pre_change_downsampler_write_loop(self):
        found = lint(self.PRE_CHANGE_DOWNSAMPLER_WRITE,
                     FlushCallbackLoopRule(),
                     "m3_tpu_torch/coordinator/downsample.py")
        assert rule_ids(found) == ["per-datapoint-callback-in-flush"]
        assert "add_untimed" in found[0].message

    def test_downsampler_write_ref_oracle_exempt(self):
        src = """
            class Downsampler:
                def write_ref(self, tags, t_nanos, value, metric_type):
                    result = self._matcher.match(_encode_tags(tags))
                    for idm in result.for_new_rollup_ids:
                        self._agg.add_untimed(
                            _to_union(metric_type, idm.id, value),
                            idm.metadatas)
        """
        assert lint(src, FlushCallbackLoopRule(),
                    "m3_tpu_torch/coordinator/downsample.py") == []

    def test_batched_downsampler_write_passes(self):
        # The post-change shape: grouped columnar adds — one
        # add_untimed_batch per (pipeline, policy) class, not one
        # add_untimed per datapoint. `add_untimed_batch` must NOT match
        # the exact-name `add_untimed` callback detector.
        src = """
            class Downsampler:
                def write_batch(self, samples):
                    groups = self._group(samples)
                    for _key, (metadatas, mus) in groups.items():
                        self._agg.add_untimed_batch(mus, metadatas)
        """
        assert lint(src, FlushCallbackLoopRule(),
                    "m3_tpu_torch/coordinator/downsample.py") == []


class TestPerSeriesResultDict:
    """per-series-result-dict: per-row dict materialization inside
    result-path functions on the serving tree (coordinator/ query/
    rpc/); `_ref`-named oracles exempt (render_rules.py)."""

    PATH = "m3_tpu_torch/coordinator/http_api.py"

    def test_flags_pre_change_matrix_renderer(self):
        # The EXACT pre-change coordinator renderer: one dict per
        # series, one [t, "v"] list per sample — the seeded positive
        # (bench r16 measured it at 1.07 responses/sec).
        src = '''
            import numpy as np

            def _prom_matrix(block):
                times = block.meta.times() / 1e9
                result = []
                for tags, row in zip(block.series_tags, block.values):
                    finite = np.isfinite(row)
                    if not finite.any():
                        continue
                    values = [[float(t), str(v)]
                              for t, v, ok in zip(times, row, finite) if ok]
                    result.append({"metric": dict(tags), "values": values})
                return {"status": "success",
                        "data": {"resultType": "matrix", "result": result}}
        '''
        from m3_tpu_torch.analysis.render_rules import PerSeriesResultDictRule

        found = lint(src, PerSeriesResultDictRule(), self.PATH)
        assert rule_ids(found) == ["per-series-result-dict"]
        assert "_prom_matrix" in found[0].message

    def test_flags_dict_comprehension_and_yield(self):
        from m3_tpu_torch.analysis.render_rules import PerSeriesResultDictRule

        src = """
            def render_series_result(block):
                return [{"metric": t, "values": list(r)}
                        for t, r in zip(block.series_tags, block.values)]
        """
        assert rule_ids(lint(src, PerSeriesResultDictRule(), self.PATH)) \
            == ["per-series-result-dict"]
        src = """
            def vector_rows(block):
                for t, r in zip(block.series_tags, block.values):
                    yield {"metric": t, "value": r[-1]}
        """
        assert rule_ids(lint(src, PerSeriesResultDictRule(), self.PATH)) \
            == ["per-series-result-dict"]

    def test_ref_oracles_exempt(self):
        from m3_tpu_torch.analysis.render_rules import PerSeriesResultDictRule

        src = """
            def prom_matrix_ref(block):
                result = []
                for tags, row in zip(block.series_tags, block.values):
                    result.append({"metric": dict(tags),
                                   "values": list(row)})
                return result
        """
        assert lint(src, PerSeriesResultDictRule(), self.PATH) == []

    def test_columnar_renderer_and_nonresult_functions_pass(self):
        from m3_tpu_torch.analysis.render_rules import PerSeriesResultDictRule

        # Columnar renderer: string chunks per series, no dicts.
        src = """
            def prom_matrix_bytes(block):
                chunks = []
                for r in range(len(block.series_tags)):
                    chunks.append("{...}")
                return ", ".join(chunks).encode()
        """
        assert lint(src, PerSeriesResultDictRule(), self.PATH) == []
        # Non-result-path function names are out of scope even with
        # per-row dicts (identity/tag metadata assembly is host work).
        src = """
            def rpc_fetch_tagged(ids):
                out = []
                for sid in ids:
                    out.append({"id": sid, "tags": {}})
                return out
        """
        assert lint(src, PerSeriesResultDictRule(), self.PATH) == []

    def test_out_of_scope_dirs_and_suppression(self):
        from m3_tpu_torch.analysis.render_rules import PerSeriesResultDictRule

        src = """
            def render_result(rows):
                return [{"r": r} for r in rows]
        """
        # aggregator/ is not on the serving result plane.
        assert lint(src, PerSeriesResultDictRule(),
                    "m3_tpu_torch/aggregator/flush.py") == []
        suppressed = """
            def render_result(rows):
                # m3lint: disable=per-series-result-dict
                return [{"r": r} for r in rows]
        """
        assert lint(suppressed, PerSeriesResultDictRule(), self.PATH) == []


class TestPerEntryReplay:
    """per-entry-replay: per-row registry/buffer loops on the recovery
    data plane (storage/bootstrap.py, persist/commitlog.py,
    persist/fs.py); `_ref`-named oracles exempt."""

    PATH = "m3_tpu_torch/storage/bootstrap.py"

    def test_flags_pre_change_snapshot_install_loop(self):
        # the EXACT pre-change CommitlogBootstrapper shape: per-row
        # get_or_create + per-row write_batch(np.full(...)) — the
        # seeded positive this rule exists to keep out of the tree
        src = """
            import numpy as np

            def load_snapshots(shard, ids, ts, vals, npoints):
                for row, sid in enumerate(ids):
                    idx, _ = shard.registry.get_or_create(sid)
                    n = int(npoints[row])
                    shard.buffer.write_batch(
                        np.full(n, idx, np.int32),
                        np.asarray(ts[row, :n], np.int64),
                        np.asarray(vals[row, :n], np.float64),
                    )
        """
        found = lint(src, PerEntryReplayRule(), self.PATH)
        assert rule_ids(found) == ["per-entry-replay"] * 2
        assert "get_or_create" in found[0].message
        assert "np.full" in found[1].message

    def test_flags_per_row_remap_comprehension(self):
        # the pre-change FilesystemBootstrapper remap: one registry
        # probe per row inside a listcomp
        src = """
            import numpy as np

            def bootstrap(shard, blk, ids):
                remap = np.array(
                    [shard.registry.get_or_create(sid)[0] for sid in ids],
                    np.int32)
                shard.load_block(blk, remap)
        """
        found = lint(src, PerEntryReplayRule(), self.PATH)
        assert rule_ids(found) == ["per-entry-replay"]

    def test_ref_oracles_exempt(self):
        src = """
            import numpy as np

            def load_snapshots_ref(shard, ids, npoints, ts, vals):
                for row, sid in enumerate(ids):
                    idx, _ = shard.registry.get_or_create(sid)
                    shard.buffer.write_batch(
                        np.full(int(npoints[row]), idx, np.int32),
                        ts[row], vals[row])
        """
        assert lint(src, PerEntryReplayRule(), self.PATH) == []

    def test_batched_paths_pass(self):
        src = """
            import numpy as np

            def load_snapshots(shard, blk, ids, batches):
                remap, _created = shard.registry.get_or_create_batch(ids)
                shard.load_block(blk, np.asarray(remap, np.int32))
                for b in batches:
                    sidx, _ = shard.registry.get_or_create_batch(
                        b.ids.tolist())
                    shard.buffer.write_batch(
                        np.asarray(sidx, np.int32), b.t_ns, b.values)
        """
        assert lint(src, PerEntryReplayRule(), self.PATH) == []

    def test_out_of_scope_modules_pass(self):
        src = """
            def write(shard, sid):
                for s in [sid]:
                    shard.registry.get_or_create(s)
        """
        assert lint(src, PerEntryReplayRule(), "m3_tpu_torch/storage/shard.py") == []
        assert lint(src, PerEntryReplayRule(), "m3_tpu_torch/aggregator/map.py") == []

    def test_suppression(self):
        src = """
            def cold_path(shard, ids):
                # one-off admin repair tool, not the recovery plane
                # m3lint: disable=per-entry-replay
                for sid in ids:
                    shard.registry.get_or_create(sid)
        """
        assert lint(src, PerEntryReplayRule(), self.PATH) == []


# ===================================================================
# whole-program analysis — callgraph, lifecycle dataflow,
# cross-module lock order, seeded historical shapes
# ===================================================================


from m3_tpu_torch.analysis.callgraph import (CrossModuleLockOrderRule,  # noqa: E402
                                       ProgramIndex)
from m3_tpu_torch.analysis.lifecycle_rules import (FinalizerUnderLockRule,  # noqa: E402
                                             LifecycleRule,
                                             ReleaseNoneParentLeakRule)


class TestCallGraphIndex:
    """ProgramIndex: import/alias resolution, receiver typing from
    __init__ assignments, return-type chaining, the global lock graph's
    Class.attr identities."""

    SRCS = {
        "m3_tpu_torch/utils/widget.py": """
            import threading

            class Widget:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.n = 0

                def poke(self) -> int:
                    with self._lock:
                        self.n += 1
                        return self.n


            def make_widget() -> Widget:
                return Widget()


            SHARED = Widget()
        """,
        "m3_tpu_torch/storage/holder.py": """
            import threading
            from ..utils import widget
            from ..utils.widget import Widget as W, make_widget, SHARED

            class Holder:
                def __init__(self):
                    self._mu = threading.Lock()
                    self.direct = W()
                    self.via_mod = widget.Widget()
                    self.via_fn = make_widget()

                def run(self):
                    with self._mu:
                        self.direct.poke()

                def run_global(self):
                    with self._mu:
                        SHARED.poke()
        """,
    }

    def _index(self):
        return ProgramIndex.from_sources({
            rel: textwrap.dedent(src) for rel, src in self.SRCS.items()})

    def test_import_alias_and_symbol_resolution(self):
        idx = self._index()
        h = "m3_tpu_torch.storage.holder"
        assert idx.resolve(h, "W") == ("class", "m3_tpu_torch.utils.widget.Widget")
        assert idx.resolve(h, "widget.Widget") == (
            "class", "m3_tpu_torch.utils.widget.Widget")
        assert idx.resolve(h, "make_widget") == (
            "func", "m3_tpu_torch.utils.widget.make_widget")
        assert idx.resolve(h, "widget")[0] == "module"

    def test_receiver_typing_from_init_assignments(self):
        idx = self._index()
        holder = idx.classes["m3_tpu_torch.storage.holder.Holder"]
        w = "m3_tpu_torch.utils.widget.Widget"
        # ctor by alias, ctor through a module alias, and a typed
        # factory return all land on the same class
        assert holder.attr_types["direct"] == w
        assert holder.attr_types["via_mod"] == w
        assert holder.attr_types["via_fn"] == w

    def test_module_global_singleton_typing(self):
        idx = self._index()
        assert idx.global_types["m3_tpu_torch.utils.widget.SHARED"] == \
            "m3_tpu_torch.utils.widget.Widget"

    def test_cross_module_lock_edges_use_class_attr_identity(self):
        idx = self._index()
        edges = idx.lock_edges()
        # Holder.run holds Holder._mu and calls Widget.poke, which
        # acquires Widget._lock — in ANOTHER module
        assert ("Holder._mu", "Widget._lock") in edges
        # the module-global singleton path resolves identically
        path, _line, via = edges[("Holder._mu", "Widget._lock")]
        assert path == "m3_tpu_torch/storage/holder.py"
        assert via.endswith("Widget.poke")

    def test_lock_kinds(self):
        idx = self._index()
        kinds = idx.lock_kinds()
        assert kinds["Widget._lock"] == "lock"
        assert kinds["Holder._mu"] == "lock"

    def test_condition_over_lock_aliases_to_wrapped_identity(self):
        # self._cv = Condition(self._mu): acquisitions through the
        # condition ARE acquisitions of _mu — the runtime witness sees
        # _mu's proxy, so the static identity must match
        srcs = {
            "m3_tpu_torch/storage/cv.py": """
                import threading

                class Waiter:
                    def __init__(self):
                        self._outer = threading.Lock()
                        self._mu = threading.Lock()
                        self._cv = threading.Condition(self._mu)

                    def run(self):
                        with self._outer:
                            with self._cv:
                                pass
            """,
        }
        idx = ProgramIndex.from_sources(
            {rel: textwrap.dedent(s) for rel, s in srcs.items()})
        edges = idx.lock_edges()
        assert ("Waiter._outer", "Waiter._mu") in edges
        assert not any(b == "Waiter._cv" for _a, b in edges)

    def test_sibling_with_items_record_an_edge(self):
        # `with a, b:` acquires sequentially — the witness records a->b,
        # so the static graph must too (ABBA written this way included)
        srcs = {
            "m3_tpu_torch/storage/sib.py": """
                import threading

                class Pair:
                    def __init__(self):
                        self._a = threading.Lock()
                        self._b = threading.Lock()

                    def both(self):
                        with self._a, self._b:
                            pass
            """,
        }
        idx = ProgramIndex.from_sources(
            {rel: textwrap.dedent(s) for rel, s in srcs.items()})
        assert ("Pair._a", "Pair._b") in idx.lock_edges()


class TestCrossModuleLockOrder:
    """The budget contract shape: tenant-lock -> budget-lock in storage/,
    budget-lock -> tenant-lock in utils/ — invisible per-module,
    detected on the program-wide graph."""

    SRCS = {
        "m3_tpu_torch/utils/budget.py": """
            import threading
            from ..storage.tile_cache import TileCache

            class Budget:
                def __init__(self, tenant: TileCache):
                    self._lock = threading.Lock()
                    self.tenant = tenant

                def reclaim(self):
                    with self._lock:
                        self.tenant.evict_one()
        """,
        "m3_tpu_torch/storage/tile_cache.py": """
            import threading

            class TileCache:
                def __init__(self, budget):
                    self._lock = threading.Lock()
                    self.budget = budget

                def put(self, k, v):
                    with self._lock:
                        self.budget.reclaim()

                def evict_one(self):
                    with self._lock:
                        return 1
        """,
    }

    def _index(self, extra=None):
        srcs = {rel: textwrap.dedent(s)
                for rel, s in {**self.SRCS, **(extra or {})}.items()}
        return ProgramIndex.from_sources(srcs)

    def test_cross_module_abba_detected(self):
        idx = self._index()
        # wire the one dynamic hop (budget param is untyped on the
        # storage side) the way the real code types it
        idx.classes["m3_tpu_torch.storage.tile_cache.TileCache"].attr_types[
            "budget"] = "m3_tpu_torch.utils.budget.Budget"
        found = list(CrossModuleLockOrderRule().check_program(idx))
        inv = [f for f in found if "inversion" in f.message]
        assert inv, [f.render() for f in found]
        msg = inv[0].message
        assert "TileCache._lock" in msg and "Budget._lock" in msg
        # both files are named so a reader sees the full loop
        assert "utils/budget.py" in msg or "tile_cache" in inv[0].path

    def test_one_consistent_order_is_clean(self):
        # budget never calls back into the tenant -> one global order
        extra = {
            "m3_tpu_torch/utils/budget.py": """
                import threading

                class Budget:
                    def __init__(self):
                        self._lock = threading.Lock()

                    def reclaim(self):
                        with self._lock:
                            return 0
            """,
        }
        idx = self._index(extra)
        idx.classes["m3_tpu_torch.storage.tile_cache.TileCache"].attr_types[
            "budget"] = "m3_tpu_torch.utils.budget.Budget"
        assert list(CrossModuleLockOrderRule().check_program(idx)) == []


class TestLifecycleRule:
    """Path-sensitive paired-op balance: gate admit/release, breaker
    allow/settle, spans — every path including the exceptional ones."""

    REL = "m3_tpu_torch/coordinator/mod.py"

    def test_admit_without_exception_protection_flags(self):
        src = """
            def ingest(self, payload):
                metrics = decode(payload)
                self.gate.admit(len(metrics))
                for m in metrics:
                    self.storage.write(m)
                self.gate.release(len(metrics))
        """
        found = lint(src, LifecycleRule(), self.REL)
        assert rule_ids(found) == ["lifecycle-exception-leak"]
        assert "gate-admit" in found[0].message

    def test_try_finally_release_is_balanced(self):
        src = """
            def ingest(self, payload):
                metrics = decode(payload)
                self.gate.admit(len(metrics))
                try:
                    for m in metrics:
                        self.storage.write(m)
                finally:
                    self.gate.release(len(metrics))
        """
        assert lint(src, LifecycleRule(), self.REL) == []

    def test_guard_conditioned_admit_release_mirror_is_balanced(self):
        # the coordinator M3MsgIngester shape: admit under a None-guard,
        # release mirror-guarded in the finally
        src = """
            def consume(self, payload):
                metrics = decode(payload)
                gate = self.gate
                if gate is not None:
                    gate.admit(len(metrics))
                try:
                    for m in metrics:
                        self.storage.write(m)
                finally:
                    if gate is not None:
                        gate.release(len(metrics))
        """
        assert lint(src, LifecycleRule(), self.REL) == []

    def test_held_context_form_is_balanced(self):
        src = """
            def handle(self, n):
                with self.gate.held(n):
                    self.storage.write(n)
        """
        assert lint(src, LifecycleRule(), self.REL) == []

    def test_breaker_allow_early_return_leaks(self):
        src = """
            def call_once(self):
                if not self.breaker.allow():
                    raise BreakerOpen("shed")
                resp = self.do_io()
                self.breaker.record_success()
                return resp
        """
        found = lint(src, LifecycleRule(), "m3_tpu_torch/client/mod.py")
        assert rule_ids(found) == ["lifecycle-exception-leak"]
        assert "breaker-allow" in found[0].message

    def test_guard_with_explicit_else_branch_is_balanced(self):
        # the grant lives in the ELSE of the negated guard
        src = """
            def call_once(self):
                if not self.breaker.allow():
                    raise BreakerOpen("shed")
                else:
                    try:
                        resp = self.do_io()
                    except BaseException:
                        self.breaker.record_failure()
                        raise
                    self.breaker.record_success()
                    return resp
        """
        assert lint(src, LifecycleRule(), "m3_tpu_torch/client/mod.py") == []

    def test_canonical_settle_every_exit_is_balanced(self):
        src = """
            def call_once(self):
                if not self.breaker.allow():
                    raise BreakerOpen("shed")
                try:
                    resp = self.do_io()
                except BaseException:
                    self.breaker.record_failure()
                    raise
                self.breaker.record_success()
                return resp
        """
        assert lint(src, LifecycleRule(), "m3_tpu_torch/client/mod.py") == []

    def test_settle_through_local_closure_and_callee_handoff(self):
        # the client/session.py shape: a local `record` closure settles
        # through self._record, and the grant is handed to the callee
        src = """
            def call_once(self):
                if not self.breaker.allow():
                    raise BreakerOpen("shed")
                recorded = [False]

                def record(ok):
                    if not recorded[0]:
                        recorded[0] = True
                        self._record(ok)

                try:
                    return self._on_conn(record)
                except BaseException:
                    record(False)
                    raise

            def _record(self, ok):
                if ok:
                    self.breaker.record_success()
                else:
                    self.breaker.record_failure()
        """
        assert lint(src, LifecycleRule(), "m3_tpu_torch/client/mod.py") == []

    def test_cross_method_protocol_is_exempt(self):
        # the insert-queue shape: admit on insert, release on drain
        src = """
            class Queue:
                def insert(self, group):
                    self.gate.admit(len(group))
                    self._pending.append(group)

                def _drain(self):
                    n = self._apply()
                    self.gate.release(n)
        """
        assert lint(src, LifecycleRule(), "m3_tpu_torch/storage/mod.py") == []

    def test_scope_owned_receiver_is_exempt(self):
        # the query-executor shape: the charge bills a thread-locally
        # installed enforcer whose OWNER releases in its finally
        src = """
            def _fetch(self, sel):
                series = self.storage.fetch_raw(sel)
                enforcer = getattr(self._local, "enforcer", None)
                if enforcer is not None:
                    enforcer.add(len(series))
                return series
        """
        assert lint(src, LifecycleRule(), "m3_tpu_torch/query/mod.py") == []

    def test_return_of_handle_is_a_legal_transfer(self):
        src = """
            def open_scope(self, n):
                self.gate.admit(n)
                return self.gate
        """
        assert lint(src, LifecycleRule(), self.REL) == []


class TestSpanUnfinished:
    """The straggler-replica shape: a manually-entered span left
    open on the early-quorum return path."""

    def test_straggler_early_return_flags(self):
        src = """
            from m3_tpu_torch.utils import tracing

            def fanout(self, hosts):
                sp = tracing.TRACER.span("replica.fanout")
                sp.__enter__()
                for h in hosts:
                    self.submit(h)
                    if self.quorum_met():
                        return
                sp.__exit__(None, None, None)
        """
        found = lint(src, LifecycleRule(), "m3_tpu_torch/client/mod.py")
        assert rule_ids(found) == ["span-unfinished"]
        assert "straggler" in found[0].message

    def test_with_form_is_balanced(self):
        src = """
            from m3_tpu_torch.utils import tracing

            def fanout(self, hosts):
                with tracing.TRACER.span("replica.fanout") as sp:
                    for h in hosts:
                        self.submit(h)
                        if self.quorum_met():
                            return
        """
        assert lint(src, LifecycleRule(), "m3_tpu_torch/client/mod.py") == []

    def test_enter_with_try_finally_exit_is_balanced(self):
        src = """
            from m3_tpu_torch.utils import tracing

            def fanout(self, hosts):
                sp = tracing.TRACER.span("replica.fanout")
                sp.__enter__()
                try:
                    for h in hosts:
                        self.submit(h)
                        if self.quorum_met():
                            return
                finally:
                    sp.__exit__(None, None, None)
        """
        assert lint(src, LifecycleRule(), "m3_tpu_torch/client/mod.py") == []


class TestReleaseNoneParentLeak:
    """The historical Enforcer.release(None) leak, reintroduced."""

    PRE_FIX = """
        class Enforcer:
            def __init__(self, limit=None, parent=None):
                self.parent = parent
                self._current = 0.0

            def release(self, cost=None):
                with self._lock:
                    if cost is None:
                        self._current = 0.0
                    else:
                        self._current -= cost
                if self.parent is not None and cost:
                    self.parent.release(cost)
    """

    def test_flags_the_pre_fix_enforcer_shape(self):
        found = lint(self.PRE_FIX, ReleaseNoneParentLeakRule(),
                     "m3_tpu_torch/utils/mycost.py")
        assert rule_ids(found) == ["release-none-parent-leak"]
        assert "truthiness" in found[0].message or \
            "maybe-None" in found[0].message

    def test_flags_forwarding_the_raw_param(self):
        src = """
            class Enforcer:
                def __init__(self, parent=None):
                    self.parent = parent

                def release(self, cost=None):
                    self._current -= cost or self._current
                    if self.parent is not None:
                        self.parent.release(cost)
        """
        found = lint(src, ReleaseNoneParentLeakRule(), "m3_tpu_torch/utils/c.py")
        assert rule_ids(found) == ["release-none-parent-leak"]

    def test_fixed_captured_amount_shape_is_clean(self):
        src = """
            class Enforcer:
                def __init__(self, parent=None):
                    self.parent = parent
                    self._current = 0.0

                def release(self, cost=None):
                    with self._lock:
                        released = self._current if cost is None else cost
                        self._current -= released
                    if self.parent is not None and released:
                        self.parent.release(released)
        """
        assert lint(src, ReleaseNoneParentLeakRule(),
                    "m3_tpu_torch/utils/c.py") == []


class TestFinalizerUnderLock:
    """The HBMBudget shape: a weakref.finalize callback acquiring
    the budget lock — a latent self-deadlock at any bytecode boundary."""

    def test_flags_locking_finalizer(self):
        src = """
            import threading
            import weakref

            class Budget:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._transient = 0

                def _release_transient(self, n):
                    with self._lock:
                        self._transient -= n

                def device_put(self, dev, n):
                    weakref.finalize(dev, self._release_transient, n)
        """
        found = lint(src, FinalizerUnderLockRule(), "m3_tpu_torch/utils/b.py")
        assert rule_ids(found) == ["finalizer-under-lock"]
        assert "_release_transient" in found[0].message

    def test_flags_one_call_level_deep(self):
        src = """
            import threading
            import weakref

            class Budget:
                def __init__(self):
                    self._lock = threading.Lock()

                def _locked_sub(self, n):
                    with self._lock:
                        return n

                def _release(self, n):
                    self._locked_sub(n)

                def device_put(self, dev, n):
                    weakref.finalize(dev, self._release, n)
        """
        found = lint(src, FinalizerUnderLockRule(), "m3_tpu_torch/utils/b.py")
        assert rule_ids(found) == ["finalizer-under-lock"]

    def test_lock_free_append_drain_pattern_is_clean(self):
        src = """
            import threading
            import weakref

            class Budget:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._released = []

                def _release_transient(self, n):
                    self._released.append(n)

                def usage(self):
                    with self._lock:
                        while self._released:
                            self._transient -= self._released.pop()

                def device_put(self, dev, n):
                    weakref.finalize(dev, self._release_transient, n)
        """
        assert lint(src, FinalizerUnderLockRule(), "m3_tpu_torch/utils/b.py") == []


class TestNewFamiliesTreeGate:
    """Zero-findings gate for ONLY the lifecycle families and the
    whole-program rules — isolates a regression in these rules from the
    umbrella TestTreeGate (read from the shared tree run)."""

    def test_tree_clean_under_lifecycle_families(self, port_tree):
        ids = {LifecycleRule.id, ReleaseNoneParentLeakRule.id,
               FinalizerUnderLockRule.id, "span-unfinished",
               "lifecycle-leak", "lifecycle-exception-leak"}
        found = port_tree.of(ids)
        rendered = "\n".join(f.render() for f in found)
        assert found == [], f"lifecycle findings on the tree:\n{rendered}"

    def test_tree_clean_under_program_rules(self, port_tree):
        ids = {r.id for r in port_core.program_registry()} | {
            "capture-traced-branch", "capture-host-sync",
            "unguarded-shared-write", "inconsistent-guard",
            "unsafe-publication", "racy-check-then-act"}
        found = port_tree.of(ids)
        rendered = "\n".join(f.render() for f in found)
        assert found == [], f"program findings on the tree:\n{rendered}"


class TestNumericDtypeRule:
    """numeric_rules dtype dataflow: f64-downcast-on-exact-path /
    f64-reduce-of-f32 / abs-f32-comparison — the exact-contract plane
    (ops/, parallel/, query/plan.py)."""

    def test_flags_silent_downcast_of_f64_plane(self):
        # The historical exact-contract downcast shape: a counter grid
        # staged f32 with no residual split — the f64 host-reduce
        # exactness silently gone.
        src = """
            import numpy as np

            def stage(raw):
                grid = np.asarray(raw, dtype=np.float64)
                return grid.astype(np.float32)
        """
        found = lint(src, DtypeDataflowRule(), "m3_tpu_torch/parallel/stage.py")
        assert rule_ids(found) == ["f64-downcast-on-exact-path"]

    def test_residual_split_is_fine(self):
        # temporal.center's own shape: the downcast operand IS the
        # residual (a difference), which is downcast-safe by contract.
        src = """
            import numpy as np

            def center(values):
                values = np.asarray(values, dtype=np.float64)
                finite = np.isfinite(values)
                baseline = np.where(finite.any(axis=1), values[:, 0], 0.0)
                resid = (values - baseline[:, None]).astype(np.float32)
                return resid, baseline
        """
        assert lint(src, DtypeDataflowRule(), "m3_tpu_torch/ops/t.py") == []

    def test_double_f32_split_is_fine(self):
        # The `value2` exact split (topk ranking): hi is a lossy
        # downcast but gp also feeds the lo-residual subtraction.
        src = """
            import numpy as np

            def split(raw):
                gp = np.asarray(raw, dtype=np.float64)
                hi = gp.astype(np.float32)
                lo = (gp - hi.astype(np.float64)).astype(np.float32)
                return hi, lo
        """
        assert lint(src, DtypeDataflowRule(), "m3_tpu_torch/parallel/s.py") == []

    def test_live_f64_companion_is_fine(self):
        # temporal._resid_args: base32 rides BESIDE the f64 base (the
        # host finish reads the exact plane) — not a silent downcast.
        src = """
            import numpy as np

            def center(values):
                return values, values[:, 0]

            def resid_args(g):
                g = np.asarray(g, dtype=np.float64)
                resid, base = center(g)
                base32 = base.astype(np.float32)
                return resid, base, base32
        """
        found = [f for f in lint(src, DtypeDataflowRule(), "m3_tpu_torch/ops/t.py")
                 if f.rule == "f64-downcast-on-exact-path"]
        assert found == []

    def test_center_baseline_signature_downcast_flags(self):
        # The dropped-baseline shape: center()'s f64 baseline downcast
        # with neither a residual companion nor the f64 plane kept.
        src = """
            import numpy as np
            from m3_tpu_torch.ops.temporal import center

            def stage(gp):
                resid, base = center(gp)
                return [resid, base.astype(np.float32)]
        """
        found = lint(src, DtypeDataflowRule(), "m3_tpu_torch/parallel/c.py")
        assert rule_ids(found) == ["f64-downcast-on-exact-path"]

    def test_flags_f64_reduce_of_f32(self):
        # Upcast-after-accumulation-input: the f64 dtype on the reduce
        # recovers nothing the f32 plane already lost.
        src = """
            import numpy as np

            def total(raw):
                v32 = np.zeros((4, 4), dtype=np.float32)
                v32[:] = raw
                return v32.astype(np.float64).sum(axis=0)
        """
        found = lint(src, DtypeDataflowRule(), "m3_tpu_torch/ops/r.py")
        assert rule_ids(found) == ["f64-reduce-of-f32"]

    def test_flags_dtype_kwarg_reduce_of_f32(self):
        src = """
            import numpy as np

            def total(raw):
                v32 = np.asarray(raw, dtype=np.float32)
                return np.sum(v32, dtype=np.float64)
        """
        found = lint(src, DtypeDataflowRule(), "m3_tpu_torch/ops/r.py")
        assert rule_ids(found) == ["f64-reduce-of-f32"]

    def test_residual_provenance_reduce_is_fine(self):
        # Residual-space f32 feeding an f64 reduce is exactly the
        # sanctioned decomposition (device residual sum + host baseline).
        src = """
            import numpy as np

            def total(values, baseline):
                resid = (values - baseline[:, None]).astype(np.float32)
                return np.sum(resid, dtype=np.float64)
        """
        assert lint(src, DtypeDataflowRule(), "m3_tpu_torch/ops/r.py") == []

    def test_flags_comparison_on_lossy_f32_plane(self):
        # The abs-comparison bug class the interpreter-fallback policy
        # dodges: thresholding a downcast counter plane.
        src = """
            import numpy as np

            def filt(raw, threshold):
                grid = np.asarray(raw, dtype=np.float64)
                v = grid.astype(np.float32)
                w = v * 1.0
                return w > threshold
        """
        found = lint(src, DtypeDataflowRule(), "m3_tpu_torch/query/plan.py")
        assert "abs-f32-comparison" in rule_ids(found)

    def test_comparison_on_f64_or_residual_plane_is_fine(self):
        src = """
            import numpy as np

            def filt(raw, threshold):
                grid = np.asarray(raw, dtype=np.float64)
                resid = (grid - grid[:, :1]).astype(np.float32)
                return (grid > threshold) | (resid > 0.5)
        """
        found = [f for f in lint(src, DtypeDataflowRule(),
                                 "m3_tpu_torch/query/plan.py")
                 if f.rule == "abs-f32-comparison"]
        assert found == []

    def test_ref_oracles_exempt(self):
        src = """
            import numpy as np

            def stage_ref(raw):
                grid = np.asarray(raw, dtype=np.float64)
                return grid.astype(np.float32)
        """
        assert lint(src, DtypeDataflowRule(), "m3_tpu_torch/ops/t.py") == []

    def test_out_of_scope_dirs_skipped(self):
        src = """
            import numpy as np

            def stage(raw):
                grid = np.asarray(raw, dtype=np.float64)
                return grid.astype(np.float32)
        """
        assert lint(src, DtypeDataflowRule(), "m3_tpu_torch/storage/db.py") == []
        # query/ outside plan.py is host label algebra, out of scope
        assert lint(src, DtypeDataflowRule(), "m3_tpu_torch/query/render.py") == []

    def test_suppression_silences(self):
        src = """
            import numpy as np

            def stage(raw):
                grid = np.asarray(raw, dtype=np.float64)
                # exactness recovered on host  # m3lint: disable=f64-downcast-on-exact-path
                return grid.astype(np.float32)
        """
        assert lint(src, DtypeDataflowRule(), "m3_tpu_torch/ops/t.py") == []


class TestSentinelTaintRule:
    """numeric_rules sentinel taint: pad-lane-aggregate /
    unmasked-sentinel-gather — NaN row padding and -1 index sentinels
    must meet a mask/where/clamp before aggregates and gathers."""

    def test_flags_padding_lanes_into_psum_aggregate(self):
        # Historical shape 1: NaN-padded rows folding straight into a
        # segment reduce + psum fan-in (no where-mask).
        src = """
            import jax
            import jax.numpy as jnp
            import numpy as np

            def fan_in(grid, gids, g_pad):
                padded = np.full((8, 16), np.nan)
                padded[:4, :12] = grid
                s = jax.ops.segment_sum(padded, gids, num_segments=g_pad)
                return jax.lax.psum(s, "shard")
        """
        found = lint(src, SentinelTaintRule(), "m3_tpu_torch/parallel/c.py")
        assert rule_ids(found) == ["pad-lane-aggregate"]

    def test_where_mask_before_reduce_is_fine(self):
        # The padding contract negative: every segment reduce behind
        # jnp.where(mask, v, 0.0).
        src = """
            import jax
            import jax.numpy as jnp
            import numpy as np

            def fan_in(grid, gids, g_pad):
                padded = np.full((8, 16), np.nan)
                padded[:4, :12] = grid
                mask = jnp.isfinite(padded)
                z = jnp.where(mask, padded, 0.0)
                s = jax.ops.segment_sum(z, gids, num_segments=g_pad)
                return jax.lax.psum(s, "shard")
        """
        assert lint(src, SentinelTaintRule(), "m3_tpu_torch/parallel/c.py") == []

    def test_flags_unmasked_vv_gather(self):
        # Historical shape 2: the vv index map gathered raw — the -1
        # sentinel wraps to the LAST row and replays its live values.
        src = """
            import numpy as np

            def vv(many_v, pairs, r_pad):
                many_idx = np.full(r_pad, -1, dtype=np.int32)
                many_idx[:len(pairs)] = pairs
                return many_v[many_idx]
        """
        found = lint(src, SentinelTaintRule(), "m3_tpu_torch/parallel/c.py")
        assert rule_ids(found) == ["unmasked-sentinel-gather"]

    def test_clamped_gather_is_fine(self):
        # The `_sub_gather`/vv contract negative: clamp + valid
        # mask.
        src = """
            import jax.numpy as jnp
            import numpy as np

            def vv(many_v, pairs, r_pad):
                many_idx = np.full(r_pad, -1, dtype=np.int32)
                many_idx[:len(pairs)] = pairs
                valid = (many_idx >= 0)[:, None]
                a = many_v[jnp.maximum(many_idx, 0)]
                return jnp.where(valid, a, jnp.nan)
        """
        assert lint(src, SentinelTaintRule(), "m3_tpu_torch/parallel/c.py") == []

    def test_flags_where_built_sentinel_into_take(self):
        # plan.py's packed-column construction (np.where(valid, c, -1))
        # IS the sentinel source; consuming it untreated flags.
        src = """
            import jax.numpy as jnp
            import numpy as np

            def packed(arr, cols, valid):
                cmap = np.where(valid, cols, -1)
                return jnp.take(arr, cmap, axis=1)
        """
        found = lint(src, SentinelTaintRule(), "m3_tpu_torch/query/plan.py")
        assert rule_ids(found) == ["unmasked-sentinel-gather"]

    def test_flags_neg1_ids_into_segment_and_add_at(self):
        src = """
            import jax
            import numpy as np

            def agg(v, n, g):
                gids = np.full(n, -1, dtype=np.int64)
                out = np.zeros((g, v.shape[1]))
                np.add.at(out, gids, v)
                return jax.ops.segment_sum(v, gids, num_segments=g)
        """
        found = rule_ids(lint(src, SentinelTaintRule(), "m3_tpu_torch/ops/a.py"))
        assert found == ["unmasked-sentinel-gather"] * 2

    def test_pad_neutral_ops_pass(self):
        src = """
            import jax.numpy as jnp
            import numpy as np

            def reduce(grid):
                padded = np.full((8, 16), np.nan)
                padded[:4] = grid
                return jnp.nansum(padded, axis=0), np.nanmax(padded)
        """
        assert lint(src, SentinelTaintRule(), "m3_tpu_torch/ops/t.py") == []

    def test_pad_grid_source_flags_and_masked_passes(self):
        src = """
            import jax.numpy as jnp

            def _pad_grid(g, s, t):
                return g

            def bad(g):
                gp = _pad_grid(g, 8, 16)
                return jnp.sum(gp, axis=0)

            def good(g):
                gp = _pad_grid(g, 8, 16)
                return jnp.sum(jnp.where(jnp.isfinite(gp), gp, 0.0), axis=0)
        """
        found = lint(src, SentinelTaintRule(), "m3_tpu_torch/parallel/c.py")
        assert rule_ids(found) == ["pad-lane-aggregate"]

    def test_method_sum_on_padded_receiver_flags(self):
        src = """
            import numpy as np

            def total(grid):
                padded = np.full((8, 16), np.nan)
                padded[:4] = grid
                return padded.sum(axis=0)
        """
        found = lint(src, SentinelTaintRule(), "m3_tpu_torch/ops/t.py")
        assert rule_ids(found) == ["pad-lane-aggregate"]

    def test_ref_oracles_and_out_of_scope_skipped(self):
        src = """
            import numpy as np

            def total_ref(grid):
                padded = np.full((8, 16), np.nan)
                padded[:4] = grid
                return padded.sum(axis=0)
        """
        assert lint(src, SentinelTaintRule(), "m3_tpu_torch/ops/t.py") == []
        bad = src.replace("total_ref", "total")
        assert lint(bad, SentinelTaintRule(), "m3_tpu_torch/storage/db.py") == []

    def test_suppression_with_justification(self):
        src = """
            import numpy as np

            def total(grid):
                padded = np.full((8, 16), np.nan)
                padded[:4] = grid
                # pad-neutral by construction (all-finite input)
                # m3lint: disable=pad-lane-aggregate
                return padded.sum(axis=0)
        """
        assert lint(src, SentinelTaintRule(), "m3_tpu_torch/ops/t.py") == []


class TestMeshSpecRule:
    """The torch mesh-spec checker over parallel/mesh's shard_map and
    collectives: mesh-axis-unbound / shard-spec-arity /
    unannotated-out-sharding (the counterparts of the reference's
    TestMeshSpecRule and its review regressions)."""

    def test_flags_psum_axis_absent_from_mesh(self):
        # a collective over an axis name the bound mesh does not carry
        # (typo'd "shards" vs "shard")
        src = """
            import torch
            from . import mesh as pmesh

            def make(devs):
                return pmesh.make(devs, (2, 2), ("shard", "time"))

            def fan_in(vals, mesh):
                return pmesh.psum(vals, mesh, "shards")
        """
        found = lint(src, MeshSpecRule(), "m3_tpu_torch/parallel/q.py")
        assert rule_ids(found) == ["mesh-axis-unbound"]
        assert "'shards'" in found[0].message

    def test_bound_axes_and_spec_vocabulary_pass(self):
        # axes declared by the mesh constructor and by shard_map spec
        # literals (tuple-grouped axes included) all count
        src = """
            import torch
            from . import mesh as pmesh

            def make(devs):
                return pmesh.Mesh(devs, ("shard", "time"))

            def fan_in(vals, blk, mesh, fn):
                pmesh.shard_map(fn, mesh, in_specs=((("shard", "time"),
                                                     None),),
                                out_specs=(("shard", "time"), None))
                s = pmesh.psum(vals, mesh, "shard")
                return pmesh.pmin(blk, mesh, axes="time"), s
        """
        assert lint(src, MeshSpecRule(), "m3_tpu_torch/parallel/i.py") == []

    def test_module_without_declared_axes_is_skipped(self):
        # parallel/query.py's shape: the mesh comes from the executor
        src = """
            import torch
            from . import mesh as pmesh

            def fan_in(vals, mesh):
                return pmesh.psum(vals, mesh, "shard")
        """
        assert lint(src, MeshSpecRule(), "m3_tpu_torch/parallel/h.py") == []

    def test_flags_in_specs_arity_mismatch(self):
        src = """
            import torch
            from . import mesh as pmesh

            def build(mesh):
                def local(values, counts):
                    return values

                return pmesh.shard_map(local, mesh, in_specs=(("shard",),),
                                       out_specs=("shard",))
        """
        found = lint(src, MeshSpecRule(), "m3_tpu_torch/parallel/a.py")
        assert rule_ids(found) == ["shard-spec-arity"]

    def test_matching_arity_name_bound_and_vararg_pass(self):
        src = """
            import torch
            from . import mesh as pmesh

            def build(mesh):
                def local(values, counts):
                    return values

                def spread(*planes):
                    return planes[0]

                rows, rowc = (mesh.axis_names,), (mesh.axis_names, None)
                specs = (rowc, rows)
                a = pmesh.shard_map(local, mesh, in_specs=specs,
                                    out_specs=rowc)
                b = pmesh.shard_map(spread, mesh, (rowc, rowc, rowc), rowc)
                return a, b
        """
        assert lint(src, MeshSpecRule(), "m3_tpu_torch/parallel/a.py") == []

    def test_defaulted_params_tolerated_but_excess_specs_flag(self):
        src = """
            import torch
            from . import mesh as pmesh

            def build(mesh):
                def local(values, counts=None):
                    return values

                ok = pmesh.shard_map(local, mesh, in_specs=(("shard",),),
                                     out_specs=("shard",))
                bad = pmesh.shard_map(local, mesh,
                                      in_specs=(("shard",), ("shard",),
                                                ("shard",)),
                                      out_specs=("shard",))
                return ok, bad
        """
        found = lint(src, MeshSpecRule(), "m3_tpu_torch/parallel/a.py")
        assert rule_ids(found) == ["shard-spec-arity"]

    def test_flags_unconditional_sharded_out_spec_in_compile(self):
        src = """
            import torch
            from . import mesh as pmesh

            def plan_executable(body, mesh):
                return pmesh.shard_map(body, mesh, in_specs=(("shard", None),),
                                       out_specs=(("shard", None),))
        """
        found = lint(src, MeshSpecRule(), "m3_tpu_torch/parallel/compile.py")
        assert "unannotated-out-sharding" in rule_ids(found)

    def test_edge_annotated_out_spec_passes(self):
        src = """
            import torch
            from . import mesh as pmesh

            SHARDED = "shard"

            def plan_executable(body, mesh, root_edge):
                out_root_spec = (("shard", None)
                                 if root_edge.sharding == SHARDED else ())
                specs = (out_root_spec, ())
                return pmesh.shard_map(body, mesh, in_specs=(("shard", None),),
                                       out_specs=specs)
        """
        found = [f for f in lint(src, MeshSpecRule(),
                                 "m3_tpu_torch/parallel/compile.py")
                 if f.rule == "unannotated-out-sharding"]
        assert found == []

    def test_out_spec_annotation_not_required_outside_compile(self):
        src = """
            import torch
            from . import mesh as pmesh

            def build(mesh):
                def local(rows):
                    return rows

                return pmesh.shard_map(local, mesh, in_specs=(("shard",),),
                                       out_specs=(("shard",),))
        """
        assert lint(src, MeshSpecRule(),
                    "m3_tpu_torch/parallel/ingest.py") == []

    def test_suppression_silences(self):
        src = """
            import torch
            from . import mesh as pmesh

            def make(devs):
                return pmesh.make(devs, (4,), ("shard",))

            def fan_in(vals, mesh):
                # cross-module mesh carries this axis
                # m3lint: disable=mesh-axis-unbound
                return pmesh.psum(vals, mesh, "stage")
        """
        assert lint(src, MeshSpecRule(), "m3_tpu_torch/parallel/q.py") == []


class TestHostSyncInPlanHelpers:
    """host-sync-in-plan's widened scope: the SubqueryFunc/RankAgg
    lowering helpers (`_range_body`, `_sub_gather`) are lowering surface
    too."""

    def test_flags_sync_in_range_body(self):
        src = """
            import numpy as np
            import jax

            def _range_body(ctx, f, ins):
                adj = ins["diff"][0]
                host = np.asarray(adj)
                return host
        """
        from m3_tpu_torch.analysis.obs_rules import HostSyncInPlanRule
        found = lint(src, HostSyncInPlanRule(), "m3_tpu_torch/parallel/compile.py")
        assert rule_ids(found) == ["host-sync-in-plan"]

    def test_flags_item_in_sub_gather(self):
        src = """
            import jax.numpy as jnp
            import jax

            def _sub_gather(arr, cols, fill):
                first = cols[0].item()
                return arr[:, jnp.maximum(cols, 0)], first
        """
        from m3_tpu_torch.analysis.obs_rules import HostSyncInPlanRule
        found = lint(src, HostSyncInPlanRule(), "m3_tpu_torch/parallel/compile.py")
        assert rule_ids(found) == ["host-sync-in-plan"]

    def test_pure_jnp_helpers_pass(self):
        src = """
            import jax.numpy as jnp
            import jax

            def _sub_gather(arr, cols, fill):
                valid = (cols >= 0)[None, :]
                g = arr[:, jnp.maximum(cols, 0)]
                return jnp.where(valid, g, fill)
        """
        from m3_tpu_torch.analysis.obs_rules import HostSyncInPlanRule
        assert lint(src, HostSyncInPlanRule(),
                    "m3_tpu_torch/parallel/compile.py") == []


class TestNumericFamiliesTreeGate:
    """Zero-findings gate for ONLY the numerics families — isolates a
    regression in these rules from the umbrella TestTreeGate — plus the
    --stats timing contract for the family."""

    IDS = {"numeric-dtype", "f64-downcast-on-exact-path",
           "sentinel-taint", "mesh-spec", "mesh-axis-unbound",
           "shard-spec-arity", "unannotated-out-sharding"}

    def test_tree_clean_under_numeric_families(self, port_tree):
        found = port_tree.of(self.IDS)
        rendered = "\n".join(f.render() for f in found)
        assert found == [], f"numeric findings on the tree:\n{rendered}"

    def test_numeric_family_suppressions_are_in_use(self, port_tree):
        # The documented deliberate site (compile.py baseline staging)
        # rides a justified suppression, not silence.
        assert sum(port_tree.suppressed[k] for k in self.IDS) >= 1

    def test_stats_timing_covers_new_family(self):
        src = "import numpy as np\n"
        mod = Module.from_source(src, "m3_tpu_torch/ops/t.py")
        timings = {}
        run_module(mod, [DtypeDataflowRule(), SentinelTaintRule(),
                         MeshSpecRule()], timings=timings)
        assert {"numeric-dtype", "sentinel-taint",
                "mesh-spec"} <= set(timings)


class TestFindingsCacheRulesDigest:
    """The warm findings cache covers the new family: entries are keyed
    on the analyzer's own rules-source digest, so editing any rule
    module (numeric_rules.py included) invalidates the whole cache."""

    def _run_cli(self, tmp_path, target):
        import json as _json
        import subprocess as _sp

        proc = _sp.run(
            [sys.executable, "-m", "m3_tpu_torch.analysis", str(target)],
            cwd=tmp_path, capture_output=True, text=True,
            env={**__import__("os").environ,
                 "PYTHONPATH": str(REPO)})
        return proc

    def test_cache_hit_then_rules_digest_invalidation(self, tmp_path):
        import json as _json

        target = tmp_path / "mod.py"
        target.write_text("import numpy as np\n\n\ndef f(x):\n"
                          "    return np.asarray(x)\n")
        first = self._run_cli(tmp_path, target)
        assert first.returncode == 0, first.stdout + first.stderr
        assert "(0 cached)" in first.stdout
        cache = tmp_path / ".m3lint_torch_cache.json"
        assert cache.exists()
        second = self._run_cli(tmp_path, target)
        assert "(1 cached)" in second.stdout
        # A rules-source edit changes the digest: simulate by tampering
        # the stored digest — every entry must be recomputed, not served.
        payload = _json.loads(cache.read_text())
        assert payload["rules"]  # digest present
        payload["rules"] = "0" * 40
        cache.write_text(_json.dumps(payload))
        third = self._run_cli(tmp_path, target)
        assert "(0 cached)" in third.stdout


# ===================================================================
# concurrency-plane race analysis — thread-spawn discovery,
# lock-protection inference, the lock-free ledger, seeded historical and
# mid-__init__ leak shapes, widened hot-loop/wall-clock scopes
# ===================================================================

from m3_tpu_torch.analysis.race_rules import (SharedStateRaceRule,  # noqa: E402
                                        load_ledger, protection_model)


def race_findings(srcs, ledger=None):
    """Race-family findings over synthetic sources with a CONTROLLED
    ledger (default empty: the real tree ledger must not leak into
    shape tests)."""
    idx = ProgramIndex.from_sources(
        {rel: textwrap.dedent(s) for rel, s in srcs.items()})
    rule = SharedStateRaceRule(ledger=ledger if ledger is not None else {})
    return list(rule.check_program(idx))


class TestSeededRegistryPublishBeforeAppend:
    """Historical shape 1 (the pre-fix registry): the series index
    entry was published BEFORE the id/tags lists were appended, so a
    lock-free reader resolving through the index could read past the
    end of the lists. Reconstructed beside the fixed (append-first,
    publish-last) ordering that shipped."""

    PRE_FIX = {
        "m3_tpu_torch/storage/registry.py": """
            import threading

            class SeriesRegistry:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._index = {}
                    self._ids = []
                    self._tags = []

                def start(self):
                    threading.Thread(target=self._writer).start()

                def _writer(self):
                    self.get_or_create(b"s", None)

                def get_or_create(self, series_id, tags):
                    with self._lock:
                        idx = len(self._ids)
                        self._index[series_id] = idx
                        self._ids.append(series_id)
                        self._tags.append(tags)
                        return idx

                def get(self, series_id):
                    return self._index.get(series_id)
        """,
    }

    def test_pre_fix_ordering_flags_unsafe_publication(self):
        found = race_findings(self.PRE_FIX)
        pubs = [f for f in found if f.rule == "unsafe-publication"]
        assert len(pubs) == 1, [f.render() for f in found]
        assert "SeriesRegistry.'_index'" in pubs[0].message
        assert "'_ids'" in pubs[0].message
        assert "append first, publish last" in pubs[0].message

    def test_fixed_append_first_publish_last_is_clean(self):
        fixed = {
            "m3_tpu_torch/storage/registry.py": self.PRE_FIX[
                "m3_tpu_torch/storage/registry.py"].replace(
                    """idx = len(self._ids)
                        self._index[series_id] = idx
                        self._ids.append(series_id)
                        self._tags.append(tags)""",
                    """idx = len(self._ids)
                        self._ids.append(series_id)
                        self._tags.append(tags)
                        self._index[series_id] = idx"""),
        }
        found = race_findings(fixed)
        assert [f for f in found if f.rule == "unsafe-publication"] == []

    def test_ledger_never_exempts_unsafe_publication(self):
        # Declaring the registry protocol grants the GUARD exemption
        # only; the publication ORDER stays machine-checked.
        ledger = {"SeriesRegistry._index": "publish-last",
                  "SeriesRegistry._ids": "append-only"}
        found = race_findings(self.PRE_FIX, ledger=ledger)
        assert [f.rule for f in found] == ["unsafe-publication"]


class TestSeededDegradedFlagGuard:
    """Historical shape 2 (the sticky `_degraded` flag): the flag
    is read and cleared under the reconcile lock, but one writer set it
    lock-free — racing the guarded sites. Reconstructed beside the
    fixed (every access under the one lock) shape."""

    def _srcs(self, mark_body):
        return {
            "m3_tpu_torch/aggregator/elem.py": f"""
                import threading

                class Elem:
                    def __init__(self):
                        self._lock = threading.Lock()
                        self._mu = threading.Lock()
                        self._degraded = False

                    def start(self):
                        threading.Thread(target=self._consume).start()

                    def _consume(self):
                        with self._lock:
                            if self._degraded:
                                return

                    def reconcile(self):
                        with self._lock:
                            self._degraded = False

                    def mark_degraded(self):
                {mark_body}
            """,
        }

    def test_lock_free_write_beside_guarded_sites_flags(self):
        found = race_findings(self._srcs("        self._degraded = True"))
        assert [f.rule for f in found] == ["unguarded-shared-write"]
        msg = found[0].message
        assert "Elem._degraded" in msg and "Elem._lock" in msg

    def test_write_under_the_wrong_lock_is_inconsistent_guard(self):
        found = race_findings(self._srcs(
            "        with self._mu:\n"
            "                            self._degraded = True"))
        assert [f.rule for f in found] == ["inconsistent-guard"]
        msg = found[0].message
        assert "Elem._lock" in msg and "Elem._mu" in msg

    def test_fixed_every_access_under_one_lock_is_clean(self):
        found = race_findings(self._srcs(
            "        with self._lock:\n"
            "                            self._degraded = True"))
        assert found == []

    def test_ledger_declares_the_protocol(self):
        found = race_findings(self._srcs("        self._degraded = True"),
                              ledger={"Elem._degraded": "sticky flag"})
        assert found == []


class TestSeededInitHandleLeak:
    """Historical shape 3: a drainer thread started mid-`__init__`,
    before the batch buffer it reads is assigned — the spawned consumer
    can observe a half-constructed instance. Reconstructed beside the
    shipped insert-queue shape (construct fully, spawn from start())."""

    LEAK = {
        "m3_tpu_torch/storage/insert_queue.py": """
            import threading

            class InsertQueue:
                def __init__(self, shard):
                    self.shard = shard
                    self._lock = threading.Lock()
                    self._thread = threading.Thread(
                        target=self._drain, daemon=True)
                    self._thread.start()
                    self._batch = []

                def _drain(self):
                    with self._lock:
                        self._batch.clear()
        """,
    }

    def test_mid_init_spawn_before_assignment_flags(self):
        found = race_findings(self.LEAK)
        assert [f.rule for f in found] == ["unsafe-publication"]
        msg = found[0].message
        assert "self._drain" in msg and "'_batch'" in msg
        assert "spawn from start()" in msg

    def test_fixed_spawn_from_start_is_clean(self):
        fixed = {
            "m3_tpu_torch/storage/insert_queue.py": """
                import threading

                class InsertQueue:
                    def __init__(self, shard):
                        self.shard = shard
                        self._lock = threading.Lock()
                        self._batch = []
                        self._thread = threading.Thread(
                            target=self._drain, daemon=True)

                    def start(self):
                        self._thread.start()

                    def _drain(self):
                        with self._lock:
                            self._batch.clear()
            """,
        }
        assert race_findings(fixed) == []

    def test_handoff_escape_before_assignment_flags(self):
        # The non-thread escape: `self` handed to a foreign registry
        # before __init__ finishes.
        srcs = {
            "m3_tpu_torch/msg/consumer.py": """
                class Consumer:
                    def __init__(self, registry):
                        registry.register(self)
                        self._queue = []
            """,
        }
        found = race_findings(srcs)
        assert [f.rule for f in found] == ["unsafe-publication"]
        assert "escapes half-constructed" in found[0].message


class TestRacyCheckThenAct:
    """Rule 4: a read-test-write of a shared attr with no lock spanning
    the test and the act."""

    def _srcs(self, get_body):
        return {
            "m3_tpu_torch/storage/cache.py": f"""
                import threading

                class Cache:
                    def __init__(self):
                        self._lock = threading.Lock()
                        self._m = {{}}

                    def start(self):
                        threading.Thread(target=self._work).start()

                    def _work(self):
                        self.get(b"k")

                    def get(self, k):
                {get_body}

                    def size(self):
                        return len(self._m)
            """,
        }

    UNLOCKED = """        if k not in self._m:
                            self._m[k] = 1
                        return self._m[k]"""
    LOCKED = """        with self._lock:
                            if k not in self._m:
                                self._m[k] = 1
                            return self._m[k]"""

    def test_unlocked_test_then_store_flags(self):
        found = race_findings(self._srcs(self.UNLOCKED))
        assert [f.rule for f in found] == ["racy-check-then-act"]
        assert "Cache._m" in found[0].message

    def test_lock_spanning_test_and_act_is_clean(self):
        assert race_findings(self._srcs(self.LOCKED)) == []

    def test_ledger_declared_single_flight_passes(self):
        found = race_findings(self._srcs(self.UNLOCKED),
                              ledger={"Cache._m": "idempotent insert"})
        assert found == []


class TestLockFreeLedger:
    def test_parse_idents_and_invariants(self, tmp_path):
        p = tmp_path / "ledger.txt"
        p.write_text("# header comment\n"
                     "\n"
                     "Foo._bar  # sticky flag: set once\n"
                     "Baz.q\n")
        got = load_ledger(p)
        assert got == {"Foo._bar": "sticky flag: set once", "Baz.q": ""}

    def test_missing_file_is_empty(self, tmp_path):
        assert load_ledger(tmp_path / "absent.txt") == {}

    def test_tree_ledger_entries_carry_invariants(self):
        # The review contract: every declared attr has a Class.attr
        # identity and a non-empty one-line invariant.
        ledger = load_ledger()
        assert ledger  # the tree declares its lock-free protocols
        for ident, reason in ledger.items():
            cls, _, attr = ident.partition(".")
            assert cls and attr, ident
            assert reason, f"{ident} has no invariant line"


class TestRaceFamilyTreeGate:
    """Zero-findings gate for ONLY the race family, against the REAL
    tree ledger — isolates a regression in these rules (or an undeclared
    new race) from the umbrella TestTreeGate."""

    def test_tree_clean_under_race_family(self, port_tree):
        found = port_tree.of({"unguarded-shared-write", "inconsistent-guard",
                              "unsafe-publication", "racy-check-then-act"})
        rendered = "\n".join(f.render() for f in found)
        assert found == [], f"race findings on the tree:\n{rendered}"

    def test_protection_model_is_populated(self):
        model = protection_model(str(REPO / "m3_tpu_torch"))
        # the witness acceptance surface: dozens of attrs with an
        # inferred protecting lock, named in Class.attr form
        assert len(model) >= 20
        for ident, locks in model.items():
            assert "." in ident and locks, (ident, locks)

    def test_stats_timing_covers_the_race_family(self):
        from m3_tpu_torch.analysis.core import run_program

        srcs = {"m3_tpu_torch/ops/t.py": "X = 1\n"}
        idx = ProgramIndex.from_sources(srcs)
        timings = {}
        run_program(list(idx.modules.values()),
                    program_rules=[SharedStateRaceRule(ledger={})],
                    timings=timings)
        assert "shared-state-race" in timings


class TestRulesDigestCoversLedger:
    def test_ledger_edit_changes_the_digest(self):
        # The findings cache keys on the analyzer digest; the lock-free
        # ledger is an INPUT to the race family, so a ledger edit must
        # invalidate the cache exactly like a rule-source edit.
        from m3_tpu_torch.analysis.__main__ import _rules_digest

        before = _rules_digest()
        probe = (REPO / "m3_tpu_torch" / "analysis" /
                 "zz_digest_probe_test.txt")
        try:
            probe.write_text("Probe._x  # test entry\n")
            assert _rules_digest() != before
        finally:
            probe.unlink()
        assert _rules_digest() == before


class TestWidenedRuleScopes:
    """hot-loop-under-lock and wall-clock-latency now cover parallel/
    and testing/ — the harness and mesh planes hold locks and measure
    latency too."""

    HOT_LOOP = """
        import threading

        class Collector:
            def __init__(self):
                self._lock = threading.Lock()

            def absorb(self, items):
                with self._lock:
                    for sid, tags in items:
                        self._terms.setdefault(sid, []).append(tags)
    """

    WALL_DELTA = """
        import time

        def handle(fn):
            t0 = time.time()
            fn()
            return time.time() - t0
    """

    def test_hot_loop_flags_in_parallel_and_testing(self):
        for rel in ("m3_tpu_torch/parallel/mod.py", "m3_tpu_torch/testing/mod.py"):
            found = lint(self.HOT_LOOP, HotLoopUnderLockRule(), rel)
            assert rule_ids(found) == ["hot-loop-under-lock"], rel

    def test_wall_clock_flags_in_parallel_and_testing(self):
        for rel in ("m3_tpu_torch/parallel/mod.py", "m3_tpu_torch/testing/mod.py"):
            found = lint(self.WALL_DELTA, WallClockLatencyRule(), rel)
            assert rule_ids(found) == ["wall-clock-latency"], rel

    def test_unlisted_dirs_stay_out_of_scope(self):
        assert lint(self.HOT_LOOP, HotLoopUnderLockRule(),
                    "m3_tpu_torch/tools/mod.py") == []
        assert lint(self.WALL_DELTA, WallClockLatencyRule(),
                    "m3_tpu_torch/tools/mod.py") == []


class TestUnguardedKernelDispatch:
    """unguarded-kernel-dispatch (the counterpart of
    unguarded-pallas-dispatch): a module calling into the compiled
    extension names its card oracle, its chip_smoke.py phase and a plain
    twin of every launching wrapper; wrappers run under the guard; an
    except never falls back to a plain twin."""

    CLEAN = """
        import torch

        _CARD_ORACLE = "tests/test_torch_cuda.py"
        _CHIP_SMOKE_PHASE = "3. kernels against their plain versions"

        def build():
            from torch.utils.cpp_extension import load
            return load(name="k", sources=[])

        def scale_plain(x):
            return x * 2

        def scale(x):
            if x.device.type == "cpu":
                return scale_plain(x)
            out = torch.empty_like(x)
            build().scale(x, out)
            return out
    """

    def test_clean_kernel_module_passes(self):
        assert lint(self.CLEAN, UnguardedKernelDispatchRule()) == []

    def test_missing_oracle_decl_flags(self):
        src = self.CLEAN.replace(
            '_CARD_ORACLE = "tests/test_torch_cuda.py"', "")
        found = lint(src, UnguardedKernelDispatchRule())
        assert rule_ids(found) == ["unguarded-kernel-dispatch"]
        assert "_CARD_ORACLE" in found[0].message

    def test_nonexistent_oracle_path_flags(self):
        src = self.CLEAN.replace("tests/test_torch_cuda.py",
                                 "tests/test_gone_forever.py")
        found = lint(src, UnguardedKernelDispatchRule())
        assert rule_ids(found) == ["unguarded-kernel-dispatch"]
        assert "does not exist" in found[0].message

    def test_missing_or_moved_chip_smoke_phase_flags(self):
        gone = self.CLEAN.replace(
            '_CHIP_SMOKE_PHASE = "3. kernels against their plain versions"',
            "")
        found = lint(gone, UnguardedKernelDispatchRule())
        assert rule_ids(found) == ["unguarded-kernel-dispatch"]
        assert "_CHIP_SMOKE_PHASE" in found[0].message
        moved = self.CLEAN.replace("3. kernels against their plain versions",
                                   "99. a phase that never was")
        found = lint(moved, UnguardedKernelDispatchRule())
        assert rule_ids(found) == ["unguarded-kernel-dispatch"]
        assert "not in chip_smoke.py" in found[0].message

    def test_launching_wrapper_without_plain_twin_flags(self):
        src = self.CLEAN.replace("def scale_plain(x):",
                                 "def scale_host(x):").replace(
            "return scale_plain(x)", "return scale_host(x)")
        found = lint(src, UnguardedKernelDispatchRule())
        assert rule_ids(found) == ["unguarded-kernel-dispatch"]
        assert "scale_plain" in found[0].message

    def test_except_calling_the_plain_twin_flags(self):
        # the fallback the port does not have: an extension call that
        # fails on the card silently answers with the plain version
        src = self.CLEAN.replace(
            """    out = torch.empty_like(x)
            build().scale(x, out)
            return out""",
            """    out = torch.empty_like(x)
            try:
                build().scale(x, out)
            except RuntimeError:
                return scale_plain(x)
            return out""")
        found = lint(src, UnguardedKernelDispatchRule())
        assert rule_ids(found) == ["unguarded-kernel-dispatch"]
        assert "falls back to the plain twin scale_plain()" in \
            found[0].message

    def test_wrapper_called_outside_the_guard_flags(self):
        src = """
            import torch
            from . import codec_kernels

            def encode(c0, c1, c2, nb, mw):
                return codec_kernels.pack_chunks(c0, c1, c2, nb, mw)
        """
        found = lint(src, UnguardedKernelDispatchRule())
        assert rule_ids(found) == ["unguarded-kernel-dispatch"]
        assert "pack_chunks" in found[0].message

    def test_wrappers_under_dispatch_and_guarded_builders_pass(self):
        src = """
            import functools
            import torch
            from . import codec_kernels, window_kernels
            from ..parallel import guard

            def encode(c0, c1, c2, nb, mw):
                return guard.dispatch("codec.encode", lambda:
                                      codec_kernels.pack_chunks(
                                          c0, c1, c2, nb, mw))

            @guard.guarded_builder("temporal.over_time")
            @functools.lru_cache(maxsize=8)
            def over_time_fn(W: int, stat: str):
                def fn(resid):
                    return window_kernels.window_stat(resid, W, 1, stat)
                return fn

            def plain(x):
                # the twins, the build and the counters are not launches
                n = codec_kernels.pack_chunks.launches
                codec_kernels.build()
                return codec_kernels.pack_chunks_plain(x, x, x, x, n)
        """
        assert lint(src, UnguardedKernelDispatchRule()) == []

    def test_guarded_call_with_plain_fallback_flags(self):
        src = """
            import torch
            from . import codec_kernels
            from ..parallel import guard

            def encode(c0, c1, c2, nb, mw):
                try:
                    return guard.dispatch("codec.encode", lambda:
                                          codec_kernels.pack_chunks(
                                              c0, c1, c2, nb, mw))
                except Exception:
                    return codec_kernels.pack_chunks_plain(c0, c1, c2, nb, mw)
        """
        found = lint(src, UnguardedKernelDispatchRule())
        assert rule_ids(found) == ["unguarded-kernel-dispatch"]
        assert "no fallback" in found[0].message

    def test_repo_kernel_modules_conform(self):
        for rel in ("m3_tpu_torch/ops/codec_kernels.py",
                    "m3_tpu_torch/ops/window_kernels.py"):
            path = REPO / rel
            mod = Module(str(path), rel, path.read_text())
            findings, _ = run_module(mod, [UnguardedKernelDispatchRule()])
            assert findings == [], rel


class TestUnclassifiedDeviceDispatch:
    """unclassified-device-dispatch on the port: a broad except around an
    extension call, a CUDA-graph replay or a device put must classify
    into the ComputeError taxonomy or re-raise."""

    # the pre-guard shape: a graph replay under `except Exception: return
    # None` — a CUDA fault absorbed here never reaches the breaker,
    # the quarantine or the telemetry
    SEEDED = """
        import torch

        def execute(exe, fetch):
            try:
                exe.graph.replay()
                return exe.out
            except Exception:
                return None
    """

    def test_seeded_replay_flags(self):
        found = lint(self.SEEDED, UnclassifiedDeviceDispatchRule(),
                     "m3_tpu_torch/parallel/mod.py")
        assert rule_ids(found) == ["unclassified-device-dispatch"]
        assert "ComputeError taxonomy" in found[0].message
        assert "guard.dispatch" in found[0].message

    def test_extension_call_flags(self):
        src = """
            import torch
            from .codec_kernels import build

            def run(x, out):
                try:
                    build().window(x, out)
                except:
                    return None
                return out
        """
        found = lint(src, UnclassifiedDeviceDispatchRule())
        assert rule_ids(found) == ["unclassified-device-dispatch"]

    def test_device_put_under_runtime_error_flags(self):
        # torch raises CUDA faults (an OOM included) as RuntimeError
        src = """
            import torch

            def upload(arr, dev):
                try:
                    return torch.from_numpy(arr).to(dev)
                except RuntimeError:
                    return None
        """
        found = lint(src, UnclassifiedDeviceDispatchRule(),
                     "m3_tpu_torch/storage/mod.py")
        assert rule_ids(found) == ["unclassified-device-dispatch"]

    def test_classifying_handler_is_clean(self):
        # the guard seam's shape: classify() and re-raise the rest
        src = """
            import torch
            from ..parallel import guard

            def execute(exe):
                try:
                    exe.graph.replay()
                except Exception as exc:
                    err = guard.classify(exc, "plan")
                    if err is None:
                        raise
                    return err
        """
        assert lint(src, UnclassifiedDeviceDispatchRule()) == []

    def test_reraising_and_taxonomy_handlers_are_clean(self):
        assert lint(self.SEEDED.replace("return None", "raise"),
                    UnclassifiedDeviceDispatchRule()) == []
        assert lint(self.SEEDED.replace(
            "return None", 'raise KernelFault("plan", "boom")'),
            UnclassifiedDeviceDispatchRule()) == []

    def test_narrow_handler_and_no_dispatch_are_out_of_scope(self):
        assert lint(self.SEEDED.replace("except Exception:",
                                        "except ValueError:"),
                    UnclassifiedDeviceDispatchRule()) == []
        src = """
            import torch

            def parse(raw, x):
                try:
                    return int(raw), x.to(torch.float32)
                except Exception:
                    return 0, None
        """
        assert lint(src, UnclassifiedDeviceDispatchRule()) == []

    def test_out_of_scope_dirs_are_skipped(self):
        assert lint(self.SEEDED, UnclassifiedDeviceDispatchRule(),
                    "m3_tpu_torch/coordinator/mod.py") == []

    def test_guard_seam_itself_is_clean(self):
        rel = "m3_tpu_torch/parallel/guard.py"
        path = REPO / rel
        mod = Module(str(path), rel, path.read_text())
        findings, _ = run_module(mod, [UnclassifiedDeviceDispatchRule()])
        assert findings == []
