"""Losses, metrics, ramps and small host helpers of the port."""
