"""Serving-precision quality study on a trained checkpoint (counterpart
of `perf/kv_quality_study.py`).

    python3 -m lookoncetohear_tpu_torch.kv_quality \\
        [--config configs/tsh_synthetic_5k.json] \\
        [--ckpt checkpoints/tsh_r5_5k_best.npz] [--n 64] [--device cpu]

Streams the first `n` scenes of the config's test split through the
serving path, as `n` streams of one `StreamingEngine` (a CUDA graph per
step on the card; 8 ms chunks, whole chunks only), with each scene's
ground-truth d-vector, at three serving precisions:

  f32 / f32 K/V    full precision
  bf16 / bf16 K/V  bf16 params, activations and ring
  bf16 / int8 K/V  the serving configuration (`bench.py`)

and prints the mean SI-SNRi of each beside the JAX package's figures
from a TPU (docs/perf_r5/kv_quality_r5.log). The engine's output lags
one chunk (its algorithmic latency); that chunk is dropped before
scoring. Runs on the GPU unless `--device cpu`, float32 with TF32 off.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from lookoncetohear_tpu_torch import resolve_device, utils
from lookoncetohear_tpu_torch.data.loader import batches, stop_workers
from lookoncetohear_tpu_torch.losses import si_snr
from lookoncetohear_tpu_torch.serve.engine import StreamingEngine
from lookoncetohear_tpu_torch.weights import load_checkpoint

# label, compute dtype, K/V ring dtype (None: the compute dtype)
PRECISIONS = (("f32 / f32 K/V", torch.float32, None),
              ("bf16 / bf16 K/V", torch.bfloat16, None),
              ("bf16 / int8 K/V", torch.bfloat16, torch.int8))
# the JAX package on one TPU v5e, 64 scenes of the 5k test split
# (docs/perf_r5/kv_quality_r5.log); context, not a target
TPU_DB = {"f32 / f32 K/V": 9.369, "bf16 / bf16 K/V": 9.295,
          "bf16 / int8 K/V": 9.294}


def load_scenes(config, n: int, num_workers: int = 0):
    """(mixture [n, M, N], target [n, S, N], embedding_gt [n, E]) of the
    first n scenes of the config's test split, float32."""
    ds = utils.import_attr(config.test_dataset)(**config.test_data_args)
    if n > len(ds):
        raise ValueError(f"{n} scenes asked, the split has {len(ds)}")
    mix, tgt, emb = [], [], []
    for inputs, targets in batches(torch.utils.data.Subset(ds, range(n)),
                                   4, num_workers):
        mix.append(inputs["mixture"])
        tgt.append(targets["target"])
        emb.append(targets["embedding_gt"][:, 0])
    return tuple(np.concatenate(a).astype(np.float32)
                 for a in (mix, tgt, emb))


def stream_scores(net, mix, tgt, emb, dtype, kv_dtype, device) -> np.ndarray:
    """Per-scene SI-SNRi of the scenes streamed as len(mix) streams of
    one engine at the given precision."""
    b = mix.shape[0]
    eng = StreamingEngine(net, max_streams=b, dtype=dtype, kv_dtype=kv_dtype,
                          device=device)
    for s in range(b):
        eng.add_stream(s, emb[s])
    chunk = eng.chunk
    n = mix.shape[-1] - mix.shape[-1] % chunk
    x = torch.from_numpy(mix[..., :n]).to(device)
    outs = [eng.step(x[..., i:i + chunk]) for i in range(0, n, chunk)]
    # engine output lags one chunk (algorithmic latency)
    est = torch.cat(outs, -1).float()[..., chunk:]
    m = est.shape[-1]
    t_al = torch.from_numpy(tgt[..., :m]).to(device)
    sisnri = si_snr(est, t_al).mean(-1) - si_snr(x[..., :m], t_al).mean(-1)
    return sisnri.cpu().numpy()


def run(config_path: str, ckpt: str, n: int = 64, device=None,
        num_workers: int = 0) -> dict:
    """{label: per-scene SI-SNRi [n]} for each serving precision."""
    device = resolve_device(device)
    config = utils.Params(config_path)
    module_args = config.pl_module_args
    net = utils.import_attr(module_args["model"])(
        **module_args["model_params"], device="cpu")
    load_checkpoint(net, ckpt)
    mix, tgt, emb = load_scenes(config, n, num_workers)
    with utils.full_float32():
        return {label: stream_scores(net, mix, tgt, emb, dt, kv, device)
                for label, dt, kv in PRECISIONS}


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="configs/tsh_synthetic_5k.json")
    p.add_argument("--ckpt", default="checkpoints/tsh_r5_5k_best.npz")
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    try:
        scores = run(args.config, args.ckpt, args.n, args.device,
                     args.num_workers)
    finally:
        stop_workers()
    dev = resolve_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev
    print(f"{args.n} test scenes, {args.n} streams of one streaming engine "
          f"on {where}:")
    for tag, v in scores.items():
        print(f"  {tag:18s} SI-SNRi {float(np.mean(v)):7.3f} dB   (JAX "
              f"package on a TPU: {TPU_DB[tag]:.3f} dB)")


if __name__ == "__main__":
    main()
