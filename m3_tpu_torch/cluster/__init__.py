"""Host copies of the reference's cluster modules that the aggregator's
flush needs (m3_tpu/cluster): the in-memory KV store and the lease-based
leader service."""
