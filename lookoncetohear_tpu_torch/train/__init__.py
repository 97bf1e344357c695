"""Training (counterpart of `lookoncetohear_tpu/train/`): the tasks,
the plateau scheduler, npz checkpoints and the single-device trainer."""
