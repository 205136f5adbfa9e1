"""Host copies of the reference's cluster modules (m3_tpu/cluster): the
versioned KV store with its watches, the placement and its algorithms,
the topology with its consistency levels, service discovery, heartbeats
and leader election, and the composed cluster client."""
