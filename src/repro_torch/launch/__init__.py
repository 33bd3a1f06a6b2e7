"""Command-line drivers of the port (counterparts of ``repro/launch``):
``serve`` (one engine) and ``fleet`` (N replicas), sharing the traffic,
policy and fault flags of ``flags``."""
