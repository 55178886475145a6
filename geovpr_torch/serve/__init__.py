"""Serving helpers of the port (the eval sums and summary of
`geovpr.train.steps`)."""
