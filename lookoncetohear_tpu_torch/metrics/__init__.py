"""Eval metrics of the port (counterpart of `lookoncetohear_tpu/metrics/`)."""

from lookoncetohear_tpu_torch.metrics.binaural import (compute_ild,
                                                       compute_itd, ild_diff,
                                                       itd_diff)
from lookoncetohear_tpu_torch.metrics.improvement import metric_improvement

__all__ = ["compute_ild", "compute_itd", "ild_diff", "itd_diff",
           "metric_improvement"]
