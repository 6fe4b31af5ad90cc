"""The plain float32 reference of the SSL training step.

It imports nothing of ust_run_tpu_torch, JAX or the JAX package, and takes
nothing the program made: the benchmark hands it the same weights, corpus
and index rows, and it works out the augmented inputs, the pseudo-labels,
the losses, the gradients and the state again itself.

Frozen copies of the port's plain pieces, as they stood at commit
c2363ab84ea4635247ab87861fe9e0ff2bb35866:

  ops.py     ust_run_tpu_torch/ops/rng.py (philox4x32_10, _mulhilo,
             split_seed, the body of _plain, draw_seed),
             ops/resample.py (bilinear_gather, nearest_gather,
             _reflect_tap_matrices, separable_gaussian_blur,
             gaussian_kernel), ops/augment.py (_gauss_band_matrix,
             weak_draws, weak_augment_apply and weak_augment_batch as
             weak_augment, strong_draws and strong_augment_apply as
             strong_augment, normalize, denormalize, blur_radius_for),
             ops/fda.py (fda_batch and what it calls, as fda),
             ops/cutmix.py (HostDraws, cutmix_box_params, box_masks,
             all_cover_box), utils/ramps.py (sigmoid_rampup,
             consistency_weight), semisup/state.py (lr_at),
             semisup/step.py (ema_alpha);
  losses.py  ust_run_tpu_torch/utils/losses.py (ce_plus_dice without a
             mesh and its helpers), utils/metrics.py (_dice,
             dice_per_part);
  step.py    ust_run_tpu_torch/semisup/step.py (decode_mask,
             _pseudo_from_logits, _mix_labels, _part_dice_parts,
             build_inputs, loss_terms, apply_update, update_queue,
             draw_feed's order of host draws) and semisup/state.py (the
             state's initial values and generator seeds), with each
             model call made per group and the SGD update and EMA written
             out.

The model families (families/unet.py, families/deeplabv2.py, found by
name through models.build) are written from the papers and upstream's
layout, not copied: torch.nn.BatchNorm2d per group stands for the port's
GroupedBatchNorm, F.interpolate for its interpolation-matrix resize.
models.py holds the layers whose precision the control lowers.
"""
