"""Losses of the port (counterpart of `lookoncetohear_tpu/losses/`): the
SNR / SI-SDR family and the embedding losses. `LossFn`, the spectral
losses and CDPAM come with training."""

from lookoncetohear_tpu_torch.losses.embedding import (cosine_embedding_loss,
                                                       cosine_similarity)
from lookoncetohear_tpu_torch.losses.sdr import (neg_sdr, pairwise_neg_sisdr,
                                                 si_sdr, si_snr, snr, snr_loss)

__all__ = ["cosine_embedding_loss", "cosine_similarity", "neg_sdr",
           "pairwise_neg_sisdr", "si_sdr", "si_snr", "snr", "snr_loss"]
