"""Objectives of the port: the parts of `geovpr.objectives` that geopose
serving reads (the target codec, the geopose metric suite, the geopose
objective's decode and metrics)."""
