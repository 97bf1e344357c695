"""Offline end-to-end evaluation, the two-stage TSE pipeline
(enrollment net -> separator) over the val/test split, with per-sample
metadata gathered into a CSV (counterpart of
`lookoncetohear_tpu/ts_hear_test.py`, same flags, columns and file name).

    python3 -m lookoncetohear_tpu_torch.ts_hear_test \\
        --config configs/tsh_synthetic_5k.json --run_dir runs/eval5k \\
        --ckpt checkpoints/tsh_r5_5k_best.npz \\
        --enroll_config configs/embed_synthetic_5k.json \\
        --enroll_run_dir runs/embed_r5_5k \\
        --enroll_ckpt checkpoints/embed_r5_5k_best.npz [--device cpu]

`--enroll_config '' --enroll_run_dir ''` runs the oracle mode (the
separator gets each scene's ground-truth d-vector). `--embed_from_wav`
re-embeds the enrollment net's output audio with resemblyzer's
`VoiceEncoder` (the optional `resemblyzer` package and its pretrained
weights). Runs on the GPU unless `--device cpu`, in full float32 (TF32
off). Prints the mean SI-SNRi and mean embedding cosine similarity and
writes `{run_dir}/results_{dset}_{enroll_cfg}.csv`, never over an
existing file. A checkpoint is a `p//` npz export
(`weights.load_checkpoint`) or a reference PyTorch/Lightning file
(`convert`), told apart by content and loaded strictly; the model is
built from the config's `pl_module_args.model` and `model_params`.
"""

from __future__ import annotations

import argparse
import csv
import math
import os
import time
import zipfile

import numpy as np
import torch

from lookoncetohear_tpu_torch import convert, resolve_device, utils
from lookoncetohear_tpu_torch.data.loader import batches, stop_workers
from lookoncetohear_tpu_torch.losses import cosine_similarity, si_snr
from lookoncetohear_tpu_torch.metrics.binaural import ild_diff, itd_diff
from lookoncetohear_tpu_torch.weights import PARAM_PREFIX, load_checkpoint

NO_CHECKPOINT = (
    "{ckpt}: not a checkpoint file. The port loads `p//` npz checkpoints "
    "(the committed checkpoints/*.npz, the port trainer's .ckpt files) "
    "and reference PyTorch/Lightning files; orbax run dirs are not read, "
    "and a missing checkpoint is not replaced by a fresh init")


def is_npz_checkpoint(path: str) -> bool:
    """Whether `path` is a `p//` npz checkpoint. Both it and a PyTorch
    checkpoint are zip archives, and the port's trainer writes npz under
    the name `best.ckpt`, so the content decides: an npz whose keys
    start with `p//`."""
    if not zipfile.is_zipfile(path):
        return False
    with np.load(path, allow_pickle=False) as z:
        return any(k.startswith(PARAM_PREFIX) for k in z.files)


def load_model(config, run_dir: str, ckpt: str | None, device):
    """The config's model on `device`, its weights loaded strictly from
    `ckpt`, else `{run_dir}/best.ckpt`: a `p//` npz checkpoint, or a
    reference PyTorch/Lightning checkpoint converted by `convert`. A
    directory (orbax) or a missing file is refused."""
    ckpt = ckpt or os.path.join(run_dir, "best.ckpt")
    if not os.path.isfile(ckpt):
        raise ValueError(NO_CHECKPOINT.format(ckpt=ckpt))
    module_args = config.pl_module_args
    model = utils.import_attr(module_args["model"])(
        **module_args["model_params"], device=device)
    if is_npz_checkpoint(ckpt):
        print(f"Loading (npz) {ckpt}")
        load_checkpoint(model, ckpt)
    else:
        print(f"Loading (torch) {ckpt}")
        convert.load_reference(model, convert.load_torch_checkpoint(ckpt))
    return model.eval()


def resemblyzer_api():
    """resemblyzer's (VoiceEncoder, preprocess_wav), imported when
    called; an ImportError naming the package when it is absent."""
    try:
        from resemblyzer import VoiceEncoder, preprocess_wav
    except ImportError as e:
        raise ImportError(
            "--embed_from_wav needs the optional resemblyzer package "
            "(pretrained VoiceEncoder), which is not installed") from e
    return VoiceEncoder, preprocess_wav


def dvector_from_audio(x: torch.Tensor, sr: int, encoder,
                       preprocess_wav) -> torch.Tensor:
    """[B, S, N] audio -> [B, E] resemblyzer d-vectors on x's device,
    one utterance a row (each row's mean over S)."""
    embs = [encoder.embed_utterance(
        preprocess_wav(x[i].cpu().numpy().mean(0), sr))
        for i in range(x.shape[0])]
    return torch.as_tensor(np.stack(embs), dtype=torch.float32,
                           device=x.device)


def _trim_duration(x: np.ndarray, sr: int, top_db: float = 30.0,
                   frame_length: int = 2048, hop: int = 512) -> float:
    """librosa.effects.trim-equivalent speech duration in seconds:
    trim leading/trailing frames quieter than top_db below peak RMS."""
    x = np.asarray(x)
    if x.ndim > 1:
        x = x.mean(0)
    n = len(x)
    if n < frame_length:
        frames = np.abs(x[None, :])
    else:
        nf = 1 + (n - frame_length) // hop
        idx = np.arange(frame_length)[None, :] + hop * \
            np.arange(nf)[:, None]
        frames = x[idx]
    rms = np.sqrt(np.mean(frames ** 2, axis=-1) + 1e-12)
    db = 20 * np.log10(rms / (rms.max() + 1e-12) + 1e-12)
    keep = np.where(db > -top_db)[0]
    if len(keep) == 0:
        return 0.0
    start = keep[0] * hop
    end = min(n, keep[-1] * hop + frame_length)
    return (end - start) / sr


def _item(x):
    """A collated field's entry: a 0-d array as a Python scalar."""
    return x.item() if np.ndim(x) == 0 else x


def _cos(a, b) -> float:
    a, b = np.asarray(a).reshape(-1), np.asarray(b).reshape(-1)
    return float(np.dot(a, b)
                 / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-8))


def _sample_rows(inputs, targets) -> list[dict]:
    """Per-sample metadata rows (the JAX CLI's `_sample_to_df`), from
    the fields `SyntheticTSEDataset` gives every scene; a dataset that
    lacks one raises."""
    sf, gi = inputs["source_files"], inputs["speaker_info"]
    esf = inputs["enrollments_source_files"]
    embeds = inputs["mixture_embeddings"]
    gt, neg = targets["embedding_gt"], targets["embedding_neg"]
    rows = []
    for i in range(len(inputs["mixture"])):
        row = {}
        for k in range(3):
            row[f"s{k+1}"] = os.path.basename(sf[k + 1][i])
            row[f"s{k+1}g"] = gi[k][1][i]
        row["input_sisnr"] = _item(inputs["mixture_sisnr"][i])
        t = int(inputs["tgt_idx"][i])
        row["input_embed_dist"] = max(
            _cos(embeds[t][i], embeds[j][i])
            for j in range(len(embeds)) if j != t)
        for k in range(3):
            row[f"e{k+1}"] = os.path.basename(esf[k + 1][i])
        row["enroll_sisnr"] = _item(inputs["enrollments_sisnr"][i])
        row["enroll_embed_dist"] = max(_cos(gt[i], neg[0][i]),
                                       _cos(gt[i], neg[1][i]))
        row["tgt_enroll_error"] = _item(inputs["tgt_enroll_error"][i])
        row["tgt_ang_vel"] = _item(inputs["tgt_ang_vel"][i])
        rows.append(row)
    return rows


def _csv_field(v) -> str:
    """A value as pandas' `to_csv` writes it: NaN and None empty, a
    float32 in its shortest float32 form, other floats in their shortest
    float64 form."""
    if v is None or (isinstance(v, (float, np.floating)) and math.isnan(v)):
        return ""
    if isinstance(v, np.float32):
        return str(v)
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    return str(v)


def write_csv(path: str, rows: list[dict]) -> None:
    with open(path, "x", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(list(rows[0]))
        w.writerows([_csv_field(v) for v in row.values()] for row in rows)


def _mean(rows: list[dict], key: str) -> np.float32:
    return np.float32(np.mean([r[key] for r in rows], dtype=np.float64))


@torch.no_grad()
def run(args) -> list[dict]:
    """Evaluate; returns the CSV's rows (one dict per scene, in the
    CSV's column order)."""
    enroll_cfg_name = os.path.basename(args.enroll_run_dir) \
        if args.enroll_run_dir else "clean"
    results_file = os.path.join(
        args.run_dir, f"results_{args.dset}_{enroll_cfg_name}.csv")
    if os.path.exists(results_file):
        raise FileExistsError(f"{results_file} already exists")
    resemblyzer = resemblyzer_api() \
        if getattr(args, "embed_from_wav", False) else None
    device = resolve_device(getattr(args, "device", None))
    with utils.full_float32():
        return _run(args, device, results_file, resemblyzer)


def _run(args, device, results_file: str, resemblyzer) -> list[dict]:
    config = utils.Params(args.config)
    model = load_model(config, args.run_dir, getattr(args, "ckpt", None),
                       device)
    enroll_model = None
    if args.enroll_config:
        enroll_model = load_model(
            utils.Params(args.enroll_config), args.enroll_run_dir,
            getattr(args, "enroll_ckpt", None), device)
    encoder = None
    if enroll_model is not None and resemblyzer is not None:
        # re-embed the enrollment net's output audio with resemblyzer
        voice_encoder, preprocess_wav = resemblyzer
        encoder = voice_encoder(device=device)

    ds = utils.import_attr(getattr(config, f"{args.dset}_dataset"))(
        **getattr(config, f"{args.dset}_data_args"))
    sr = getattr(ds, "sr", 16000)
    binaural = getattr(args, "binaural", False)

    def gpu(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    results = []
    # seconds waiting for the loader's next batch (scene rendering not
    # hidden behind the model), and in all
    t0 = t_ready = time.perf_counter()
    waited = 0.0
    for i, (inputs, targets) in enumerate(batches(
            ds, 4, getattr(args, "num_workers", 0))):
        waited += time.perf_counter() - t_ready
        mixture = gpu(inputs["mixture"])
        gt_emb = gpu(targets["embedding_gt"])              # [B, 1, E]
        if encoder is not None:
            sep = enroll_model(gpu(inputs["enrollments"][:, 0]))
            embedding = dvector_from_audio(sep, sr, encoder,
                                           preprocess_wav)[:, None]
        elif enroll_model is not None:
            embedding = enroll_model(gpu(inputs["enrollments"][:, 0]))[:, None]
        else:
            embedding = gt_emb
        outputs = model(mixture, embedding)

        target = gpu(targets["target"])
        out_si = si_snr(outputs, target)                   # [B, C]
        out_sisnr = out_si.mean(1).cpu().numpy()
        sisnri = (out_si - si_snr(mixture, target)).mean(1).cpu().numpy()
        emb_sim = cosine_similarity(embedding[:, 0],
                                    gt_emb[:, 0]).cpu().numpy()

        rows = _sample_rows(inputs, targets)
        if binaural:
            est = outputs.cpu().numpy().astype(np.float64)
            gt = targets["target"].astype(np.float64)
            ild, itd = ild_diff(est, gt), itd_diff(est, gt, sr)
        for j, row in enumerate(rows):
            row["output_sisnr"] = out_sisnr[j]
            row["si_snr_i"] = sisnri[j]
            row["embedding_sim"] = emb_sim[j]
            if binaural:
                row["delta_ild_db"] = ild[j]
                row["delta_itd_us"] = itd[j]
            row["enroll_duration"] = _trim_duration(
                inputs["enrollments_clean"][j, 0], sr)
        results.extend(rows)
        t_ready = time.perf_counter()

        if args.sample and i == 3:
            for row in results:
                print(row)
            print("Average SI-SNRi:", _mean(rows, "si_snr_i"))
            return results

    secs = time.perf_counter() - t0
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else device
    print(f"{len(results)} scenes in {secs:.1f} s ({secs / len(results):.3f} "
          f"s per scene, scene rendering included; {waited:.1f} s waiting "
          f"for scenes) on {where}")
    print("Average SI-SNRi:", _mean(results, "si_snr_i"))
    print("Average cosine similarity:", _mean(results, "embedding_sim"))
    print(f"Writing results to {results_file}")
    os.makedirs(args.run_dir, exist_ok=True)
    write_csv(results_file, results)
    return results


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dset", type=str, default="test")
    parser.add_argument("--sample", action="store_true", default=False)
    parser.add_argument("--config", type=str, default="configs/tsh.json")
    parser.add_argument("--run_dir", type=str, default="runs/tsh")
    parser.add_argument("--enroll_config", type=str,
                        default="configs/embed.json")
    parser.add_argument("--enroll_run_dir", type=str,
                        default="runs/embed")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="separator checkpoint: a `p//` .npz export "
                             "or a reference PyTorch/Lightning .ckpt "
                             "(default: run_dir/best.ckpt)")
    parser.add_argument("--enroll_ckpt", type=str, default=None,
                        help="same, for the enrollment net")
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--embed_from_wav", action="store_true",
                        default=False,
                        help="re-embed the enrollment net's output audio "
                             "with resemblyzer (optional package)")
    parser.add_argument("--binaural", action="store_true",
                        default=False,
                        help="add ΔILD (dB) / ΔITD (µs) spatial-cue "
                             "columns to the per-sample CSV")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; cpu runs the "
                             "plain PyTorch versions of the kernels)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    try:
        run(parse_args())
    finally:
        stop_workers()
