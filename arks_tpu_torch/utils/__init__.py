"""Stdlib helpers of the port."""
