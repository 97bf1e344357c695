"""Multi-process training and the rank's device (counterpart of
`lookoncetohear_tpu/parallel/`): `distributed.maybe_initialize` joins a
`torch.distributed` process group from the environment, and `mesh`
keeps the rank's device and `pad_batch_to`."""
