"""Offline data-prep CLIs (counterpart of `lookoncetohear_tpu/data/prep/`),
each run as `python -m lookoncetohear_tpu_torch.data.prep.<script>`."""
