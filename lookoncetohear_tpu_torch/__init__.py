"""PyTorch/CUDA port of the target-speech hearing system: the
enrollment net and the streaming separator.

Mirrors the layout of the JAX package `lookoncetohear_tpu`: each module
here has a counterpart of the same path there (`entry.py` and
`bench.py` stand for the repo root's `__graft_entry__.py` and
`bench.py`). The port imports `torch`, `numpy` and the standard library
only. The Pallas kernels are replaced by CUDA kernels for Hopper
(`csrc/`), built with one `nvcc` call at first use (`_build.py`).

Entry points (`models.net.Net`, `EmbedNet`, `OfflineSeparatorNet`,
`serve.engine.StreamingEngine`, `entry.entry`) run on the GPU unless
the caller passes `device="cpu"`; on the CPU every kernel wrapper uses
its plain PyTorch version.
"""


def resolve_device(device):
    """`device` as a `torch.device`; raise when CUDA is asked for (the
    default) and no card is present, so nothing runs quietly on the
    CPU."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
