"""The coordinator's standing rules engine (port of
m3_tpu/coordinator/rules_engine.py); the rest of the coordinator waits for
the host-stack slice."""
