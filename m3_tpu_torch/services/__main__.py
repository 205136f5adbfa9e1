"""Service CLI: `python -m m3_tpu_torch.services <service> -f config.yml
[--device cpu]` (port of m3_tpu/services/__main__.py; reference:
src/cmd/services/*/main/main.go — one '-f' flag per binary).

The config files are the reference's. `--device` is the one flag the
reference lacks: the service runs on the CUDA card unless it names
another device, and without a card it exits non-zero before it reads a
file or opens a listener. The first line printed names the device; the
listen lines follow ("... listening on HOST:PORT" is what em parses).
SIGTERM and SIGINT close the service and exit 0; the last line then
printed is the kernels' launches in this process, as JSON
("m3_tpu_torch <service> kernel launches {...}")."""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading


def main(argv=None):
    parser = argparse.ArgumentParser(prog="m3_tpu_torch.services")
    parser.add_argument("service",
                        choices=["dbnode", "coordinator", "aggregator",
                                 "collector", "kv"])
    parser.add_argument("-f", "--config", required=False, default=None,
                        help="yaml config file (defaults apply if omitted)")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    args = parser.parse_args(argv)
    # Installed before anything starts: a SIGTERM during startup closes
    # the service as soon as it is up.
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())

    from ..device import resolve

    try:
        dev = resolve(args.device)
    except RuntimeError as err:
        print(err, file=sys.stderr)
        return 1
    print(f"m3_tpu_torch {args.service} device {dev}", flush=True)

    from . import config as cfgmod
    from . import run as runmod

    if args.config:
        cfg = cfgmod.load_file(args.config, args.service)
    else:
        cfg = cfgmod.load_dict({}, args.service)

    if args.service == "dbnode":
        handle = runmod.run_dbnode(cfg, device=dev)
        print(f"m3_tpu_torch dbnode listening on {handle.endpoint}", flush=True)
        if handle.coordinator is not None:
            print(f"embedded coordinator on {handle.coordinator.endpoint}",
                  flush=True)
    elif args.service == "aggregator":
        handle = runmod.run_aggregator(
            cfg,
            on_placement=lambda shards: print(
                f"placement update: owned={shards}", flush=True),
            device=dev)
        print(f"m3_tpu_torch aggregator listening on {handle.endpoint}",
              flush=True)
        if handle.admin is not None:
            print(f"m3_tpu_torch aggregator admin on {handle.admin_endpoint}",
                  flush=True)
    elif args.service == "kv":
        handle = runmod.run_kv(cfg)
        print(f"m3_tpu_torch kv listening on {handle.endpoint}", flush=True)
    elif args.service == "coordinator":
        if not cfg.kv_endpoint:
            print("standalone coordinator requires kv_endpoint (or use "
                  "dbnode with a coordinator section for the single-binary "
                  "quickstart)", file=sys.stderr)
            return 2
        handle = runmod.run_coordinator_standalone(cfg, device=dev)
        print(f"m3_tpu_torch coordinator listening on {handle.endpoint}",
              flush=True)
        carbon = getattr(handle, "carbon", None)
        if carbon is not None:
            print(f"m3_tpu_torch carbon listening on {carbon.endpoint}",
                  flush=True)
    else:
        print("collector runs embedded; see "
              "m3_tpu_torch.services.run.run_collector", file=sys.stderr)
        return 2

    stop.wait()
    handle.close()
    from ..ops import kernel_launches

    print(f"m3_tpu_torch {args.service} kernel launches "
          f"{json.dumps(kernel_launches())}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
