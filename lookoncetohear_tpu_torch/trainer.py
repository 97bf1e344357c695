"""The port's trainer CLI (counterpart of `lookoncetohear_tpu/trainer.py`):

    python3 -m lookoncetohear_tpu_torch.trainer --config configs/tsh_synthetic_5k.json \\
        --run_dir runs/port_tsh [--test|--resume|--ckpt PATH|--frac F|--epochs N] \\
        [--device cpu]

Runs on the card unless `--device cpu`. `--prerender DIR` (or the
config key `prerender_dir`, or `LOOKONCE_PRERENDER`) renders each split
once into DIR and trains from there (`data/prep/prerender.py`). Under
torchrun with `LOOKONCE_DIST=auto`, or with `LOOKONCE_COORDINATOR`,
`LOOKONCE_NUM_PROCESSES` and `LOOKONCE_PROCESS_ID` set, every process
joins one process group, one device each, and above one process the
model trains under DDP (`parallel/distributed.py`):

    LOOKONCE_DIST=auto torchrun --nproc_per_node 4 \
        -m lookoncetohear_tpu_torch.trainer --config ... --run_dir ...
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from lookoncetohear_tpu_torch import utils
from lookoncetohear_tpu_torch.parallel.distributed import maybe_initialize
from lookoncetohear_tpu_torch.train.trainer import main


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, required=True,
                   help="experiment config JSON")
    p.add_argument("--run_dir", type=str, required=True)
    p.add_argument("--test", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--frac", type=float, default=1.0,
                   help="fraction of batches per epoch (smoke runs)")
    p.add_argument("--epochs", type=int, default=None,
                   help="override the config's epoch count; the config "
                        "file is not modified")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain versions of the kernels)")
    p.add_argument("--prerender", type=str, default=None,
                   help="directory of a render-ahead cache: each split is "
                        "rendered there once (a process pool) and epochs "
                        "read its npz shards. Also the config key "
                        "'prerender_dir' or the variable LOOKONCE_PRERENDER")
    return p.parse_args(argv)


def run(argv=None) -> None:
    args = parse_args(argv)
    # run-dir collision guard
    last = os.path.join(args.run_dir, "last.ckpt")
    if os.path.exists(last) and not (args.resume or args.test or args.ckpt):
        raise FileExistsError(
            f"{args.run_dir} already has a checkpoint; pass --resume to "
            "continue training or choose a new run_dir")
    hparams = utils.Params(args.config)
    if args.epochs:
        hparams.epochs = args.epochs
    # join the process group the environment asks for (no-op otherwise)
    joined = maybe_initialize(args.device)
    try:
        main(args, hparams)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    run()
