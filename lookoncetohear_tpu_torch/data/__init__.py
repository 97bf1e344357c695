"""Host-side data of the port (counterpart of `lookoncetohear_tpu/data/`):
the synthetic split, the MixLibriSpeech datasets of the reference
configs with their scene renderer and spatializers, the prep CLIs, and
batching. Numpy, plus scipy's wav IO, `resample_poly`, `lfilter` and
`fftconvolve` (this package is the only part of the port that imports
scipy); the batches reach the card as float32 tensors in the training
and eval loops."""
