"""Observability: the span tracer, the metrics registry and its HTTP
endpoint, health alerts, the profilers, the perf and comm accounting,
the lineage record a checkpoint carries, and the fleet's trace merger and
telemetry aggregator.  Importing the package imports none of them."""
