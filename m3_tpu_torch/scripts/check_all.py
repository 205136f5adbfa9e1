"""One command over the port's robustness tiers (counterpart of
scripts/check_all.sh), in the reference's order: m3lint, then the four
fuzz campaigns, the multi-process integration smoke and the two soaks,
each on the campaign device (the CUDA card unless `--device cpu`). For
every other tier of check_all.sh it prints the chip_smoke.py phase that
covers it on the card. Any failing tier stops the run (non-zero exit).

Full counts: 200 codec, 500 index, 200 durability and 3 cluster rounds
(10 ops each), seed 7; `--quick`: 40, 100, 40 and 1. The soaks run
SOAK_SECONDS (default 30, the floor the aggregator soak needs to close
whole windows, --quick included).

Usage:  python -m m3_tpu_torch.scripts.check_all [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

from ..device import resolve
from . import (device_arg, fuzz_cluster, fuzz_codec, fuzz_durability,
               fuzz_index, integration_smoke, soak, soak_aggregator)

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

FULL = {"codec": 200, "index": 500, "durability": 200, "cluster": 3}
QUICK = {"codec": 40, "index": 100, "durability": 40, "cluster": 1}
SEED = 7

# check_all.sh's other tiers, each with the chip_smoke.py phase that
# drives it on the card (the reference's scripts read its package).
COVERED = (
    ("index microbench smoke", "7 (b): the namespace index under "
     "LocalStorage queries"),
    ("block-cache smoke", "7 (a): warm hits, cached reads equal bypassed "
     "reads, the budget"),
    ("codec-kernel smoke", "3: each kernel against its plain version"),
    ("chaos smoke", "13 (b) and 17 (b): fault proxies under load"),
    ("overload smoke", "15 (a): 429 from a held gate"),
    ("write-path smoke", "7 (a) and 18 (b): write, seal, the mesh encode"),
    ("churn smoke", "17 (b): the churn drill"),
    ("lockdep witness", "17 (a): the kill drill's child under lockdep"),
    ("restart smoke", "16 (b) and 17 (a): SIGKILL and restart"),
    ("rules smoke", "11 (d) and 14 (e): the rules engine"),
    ("diskfault smoke", "17 (c): the disk-fault drill"),
    ("computefault smoke", "8 (c) and 17 (d): the guard and the "
     "compute-fault drill"),
    ("observability smoke", "14 (b): /debug/vars and traced rounds"),
    ("plan-compiler smoke", "10: the compiled plan against the "
     "interpreter"),
    ("serve smoke", "14 (b): every response equal to render_result_ref"),
    ("explain smoke", "6 and 7 (b): each query's route and fallback "
     "reason"),
    ("aggregator smoke", "11: the aggregator tier against "
     "reduce_and_emit_ref"),
    ("numerics witness", "none: on the CPU only, "
     "tests/test_torch_numerics_witness.py (utils/numwatch.py over plan "
     "and aggregator flushes against analysis/witness)"),
    ("race witness", "17 (a): the kill drill's child under racewatch"),
    ("test suite", "on the CPU: tests/test_torch_*.py (tier-1)"),
    ("multichip dryrun", "18 (f): dryrun_multichip"),
    ("instrumentation-overhead guard", "none yet: it reads the port's "
     "benchmark baseline, which the benchmark PR brings"),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    dflag = [] if args.device is None else ["--device", args.device]
    n = QUICK if args.quick else FULL
    os.environ.setdefault("SOAK_SECONDS", "30")
    t0 = time.monotonic()

    def tier(title: str, fn) -> None:
        print(f"== {title} ==", flush=True)
        t = time.monotonic()
        rc = fn()
        if rc != 0:
            raise SystemExit(f"check_all: {title} exited {rc}")
        print(f"== {title}: ok in {time.monotonic() - t:.1f} s ==",
              flush=True)

    tier("static analysis", lambda: subprocess.run(
        [sys.executable, "-m", "m3_tpu_torch.analysis", "--jobs", "0",
         "m3_tpu_torch/"], cwd=_ROOT).returncode)
    for name, phase in COVERED:
        where = f"chip_smoke.py phase {phase}" if phase[0].isdigit() \
            else phase
        print(f"== {name}: {where} ==", flush=True)
    seed = ["--seed", str(SEED)]
    tier("fuzz campaigns: codec", lambda: fuzz_codec.main(
        ["--rounds", str(n["codec"]), *seed, *dflag]))
    tier("fuzz campaigns: index", lambda: fuzz_index.main(
        ["--rounds", str(n["index"]), *seed, *dflag]))
    tier("fuzz campaigns: durability", lambda: fuzz_durability.main(
        ["--rounds", str(n["durability"]), *seed, *dflag]))
    tier("fuzz campaigns: cluster", lambda: fuzz_cluster.main(
        ["--rounds", str(n["cluster"]), "--ops", "10", *seed, *dflag]))
    tier("multi-process smoke", lambda: integration_smoke.main(dflag))
    tier("soak: dbnode", lambda: soak.main(dflag))
    tier("soak: aggregator", lambda: soak_aggregator.main(dflag))
    print(f"ALL TIERS PASS on {dev} in {time.monotonic() - t0:.0f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
