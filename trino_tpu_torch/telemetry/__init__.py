"""Telemetry plane of the torch port: the metrics registry, the query and
task registries, the flight recorder's timeline profiler and the durable
query journal (see module docstrings)."""
