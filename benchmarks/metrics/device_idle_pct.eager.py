"""`device_idle_pct` (metrics/device_idle_pct.py) of the eager cell, where it moves
`train_img_per_s.eager`."""

from benchmarks.registry import reader

read = reader("device_idle_pct")
