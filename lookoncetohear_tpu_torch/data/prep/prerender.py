"""Render a dataset's items to disk once, as npz shards (counterpart of
`lookoncetohear_tpu/data/prep/prerender.py`, same shard format).

An item of the MixLibriSpeech datasets costs two scene renders and up to
eight long BRIR convolutions on the host. This tool writes the arrays a
task's device batch needs, one `{idx:08d}.npz` per item, so that epochs
afterwards only read files:

  python -m lookoncetohear_tpu_torch.data.prep.prerender \\
      --config configs/tsh.json --which val --out data/prerendered/val

The trainer does the same for each split with `--prerender DIR` (or the
config key `prerender_dir`, or `LOOKONCE_PRERENDER`); a config may also
name `lookoncetohear_tpu_torch.data.prep.prerender.PrerenderedDataset`
with `{"root": DIR}` as a split's dataset. A shard holds `in_<key>` for
the keys of `DEVICE_KEYS_IN` in the item's inputs, `tgt_<key>` for
those of `DEVICE_KEYS_TGT` in its targets, and `tgt_embedding_neg`
stacked; strings and metadata are not kept. Shards written by either
package read back equal in the other.

A split whose items draw from the global random streams (a training
split of the MixLibriSpeech datasets) is frozen at one render per
scene, like any offline render; the deterministic splits (val, test,
the synthetic corpus) are the live dataset's items exactly.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

DEVICE_KEYS_IN = ("mixture", "enrollments", "enrollments_clean",
                  "mixture_sisnr", "enrollments_sisnr",
                  "enrollments_id", "tgt_idx", "tgt_shift",
                  "tgt_ang_vel", "tgt_enroll_error")
DEVICE_KEYS_TGT = ("target", "embedding_gt", "tgt_spk_idx")


def shard_path(out_dir: str, i: int) -> str:
    return os.path.join(out_dir, f"{i:08d}.npz")


def render_split(dataset, out_dir: str, limit: int | None = None,
                 num_workers: int = 0) -> None:
    """Write the first `limit` items (all with None) of `dataset` to npz
    shards in out_dir. Resumable: a shard already there is skipped, so
    an interrupted render (or a second process) continues where it
    stopped. Each shard is written to a temporary name and renamed, so
    a crash leaves no truncated shard. With num_workers > 0 the items
    are rendered by a pool of spawned processes."""
    os.makedirs(out_dir, exist_ok=True)
    n = len(dataset) if limit is None else min(limit, len(dataset))
    todo = [i for i in range(n) if not os.path.exists(shard_path(out_dir, i))]
    if not todo:
        return
    job = _RenderOne(dataset, out_dir)
    if num_workers > 0:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(num_workers, mp_context=ctx) as pool:
            list(pool.map(job, todo, chunksize=4))
    else:
        for i in todo:
            job(i)


class _RenderOne:
    """Render item i of the dataset into its shard (picklable, for the
    pool)."""

    def __init__(self, dataset, out_dir: str) -> None:
        self.dataset = dataset
        self.out_dir = out_dir

    def __call__(self, i: int) -> None:
        inputs, targets = self.dataset[i]
        arrays = {}
        for k in DEVICE_KEYS_IN:
            if k in inputs:
                arrays[f"in_{k}"] = np.asarray(inputs[k])
        for k in DEVICE_KEYS_TGT:
            if k in targets:
                arrays[f"tgt_{k}"] = np.asarray(targets[k])
        neg = targets.get("embedding_neg")
        if neg is not None:
            arrays["tgt_embedding_neg"] = np.stack(
                [np.asarray(x) for x in neg])
        path = shard_path(self.out_dir, i)
        tmp = path[:-4] + ".tmp.npz"        # np.savez adds .npz otherwise
        np.savez(tmp, **arrays)
        os.replace(tmp, path)


class PrerenderedDataset:
    """The shards of `render_split` as a dataset: (inputs, targets) with
    the live dataset's keys, numeric fields only."""

    def __init__(self, root: str, **_ignored) -> None:
        self.root = root
        self.files = sorted(
            f for f in os.listdir(root)
            if f.endswith(".npz") and not f.endswith(".tmp.npz"))

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int):
        with np.load(os.path.join(self.root, self.files[idx])) as z:
            inputs = {k[3:]: z[k] for k in z.files if k.startswith("in_")}
            targets = {k[4:]: z[k] for k in z.files
                       if k.startswith("tgt_") and k != "tgt_embedding_neg"}
            if "tgt_embedding_neg" in z.files:
                neg = z["tgt_embedding_neg"]
                targets["embedding_neg"] = [neg[i] for i in range(len(neg))]
        return inputs, targets


def main(argv=None) -> None:
    from lookoncetohear_tpu_torch import utils

    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--which", default="val", choices=["train", "val", "test"])
    p.add_argument("--out", required=True)
    p.add_argument("--num", type=int, default=None)
    p.add_argument("--num_workers", type=int, default=8)
    args = p.parse_args(argv)
    cfg = utils.Params(args.config)
    ds = utils.import_attr(getattr(cfg, f"{args.which}_dataset"))(
        **getattr(cfg, f"{args.which}_data_args"))
    render_split(ds, args.out, limit=args.num, num_workers=args.num_workers)
    print(f"rendered {args.num or len(ds)} samples -> {args.out}")


if __name__ == "__main__":
    main()
