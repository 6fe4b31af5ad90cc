"""The port's train step on 2 ranks against the JAX step for BUSI
(softmax, 1 channel) at epoch 1 with choice_th 2.0 (every sample simple:
the queue refreshes), with the bars of test_torch_parallel_jax.py."""

from test_torch_parallel_jax import check_two_ranks_against_jax


def test_busi_step_on_two_ranks_matches_jax(tmp_path):
    check_two_ranks_against_jax(tmp_path, "BUSI", 1, 2.0, 2)
