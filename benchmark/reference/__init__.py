"""Plain PyTorch references that decide `correct`. They import neither
the port nor the JAX package, and take nothing the program made.

A configuration's `reference` names one module of this package; it
provides what the loops of the configuration's cells call:
`param_table(mp)` (every weight, by the program's state-dict names), and
per traffic kind its entry point (`serve_outputs`; `forward`). A
training configuration's `train_reference` names the module whose
`steps` takes the task's first training steps (`train.py`)."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision(mode: str):
    """TF32 on for "tf32", off otherwise, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    on = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
