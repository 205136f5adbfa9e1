"""Host copies of the reference's metrics modules that the port needs
(m3_tpu/metrics), kept here because the port imports nothing of m3_tpu."""
