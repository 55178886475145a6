"""Regression heads of the port."""
