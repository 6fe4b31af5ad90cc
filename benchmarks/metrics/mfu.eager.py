"""`mfu` (metrics/mfu.py) of the eager cell, where it moves
`train_img_per_s.eager`."""

from benchmarks.registry import reader

read = reader("mfu")
