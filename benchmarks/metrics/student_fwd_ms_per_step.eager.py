"""`student_fwd_ms_per_step` (metrics/student_fwd_ms_per_step.py) of the eager cell, where it
moves `train_img_per_s.eager`."""

from benchmarks.registry import reader

read = reader("student_fwd_ms_per_step")
