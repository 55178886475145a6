"""Prediction export of the port."""
