"""Ops tools (port of m3_tpu/tools; reference: src/cmd/tools — fileset
inspection / verification CLIs built on the persist readers). Run as
`python -m m3_tpu_torch.tools <tool> [args] [--device cpu]`."""
