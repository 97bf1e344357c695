"""Host-side data of the port (counterpart of `lookoncetohear_tpu/data/`):
the synthetic test split and its batching. Numpy only; the batches
reach the card as float32 tensors in the eval loop."""
