"""Training of the port (the counterpart of `geovpr.train`)."""
