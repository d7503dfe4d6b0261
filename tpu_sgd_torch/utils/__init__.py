"""Numpy helpers of the port."""
