"""PyTorch/CUDA port of ust_run_tpu (UST-RUN semi-supervised segmentation).

The JAX package `ust_run_tpu` is the reference; this package imports none
of it and no JAX. Entry point: `python -m ust_run_tpu_torch.train`.
"""
