"""The Unet2D train step on a 2 x 2 mesh (4 Gloo ranks: data 2 x space 2)
against the JAX step, unsharded, with the bars and the setup of
test_torch_spatial_zoo_step.py, whose docstring says why the JAX step
does not run on `make_mesh(4, spatial=2)` here."""

from test_torch_spatial_zoo_step import UNET2D_SEED, check_unet2d_step


def test_unet2d_step_on_2x2_matches_jax(tmp_path):
    check_unet2d_step(tmp_path, 4, UNET2D_SEED)
