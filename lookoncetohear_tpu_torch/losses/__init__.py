"""Losses of the port (counterpart of `lookoncetohear_tpu/losses/`): the
SNR / SI-SDR family, the embedding losses, the name registry `LossFn`
(with 2-source PIT), the multi-resolution spectral losses and CDPAM."""

from lookoncetohear_tpu_torch.losses.cdpam import CDPAM
from lookoncetohear_tpu_torch.losses.embedding import (cosine_embedding_loss,
                                                       cosine_similarity)
from lookoncetohear_tpu_torch.losses.loss_fn import LossFn
from lookoncetohear_tpu_torch.losses.sdr import (neg_sdr, pairwise_neg_sisdr,
                                                 si_sdr, si_snr, snr, snr_loss)
from lookoncetohear_tpu_torch.losses.spectral import (
    L1_Mel, MultiResolutionMelSpecLoss, multi_resolution_stft_loss)

__all__ = ["CDPAM", "L1_Mel", "LossFn", "MultiResolutionMelSpecLoss",
           "cosine_embedding_loss", "cosine_similarity",
           "multi_resolution_stft_loss", "neg_sdr", "pairwise_neg_sisdr",
           "si_sdr", "si_snr", "snr", "snr_loss"]
