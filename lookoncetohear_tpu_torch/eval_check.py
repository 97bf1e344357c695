"""Hold an eval CSV of the port (`ts_hear_test`) against a reference CSV
of the same split, row by row.

    python3 -m lookoncetohear_tpu_torch.eval_check GOT.csv WANT.csv

Columns and their tolerances (`TOL`):
  * metadata strings (speakers, files): equal;
  * the scene's own metrics, computed on the host by the dataset's
    numpy code: input_embed_dist, enroll_embed_dist, tgt_enroll_error,
    tgt_ang_vel, enroll_duration, and delta_itd_us (an argmax): equal
    as float32; input_sisnr and enroll_sisnr (float32 numpy sums, whose
    rounding order depends on the numpy build): equal as float32 under
    the numpy the committed CSVs were written with (`CSV_NUMPY`), else
    within 1e-5 dB (`tolerances`);
  * si_snr_i and output_sisnr: 0.01 dB; embedding_sim: 1e-5;
    delta_ild_db: 1e-3 dB (the model's output, float32 in another
    summation order).

Prints the largest deviation of each numeric column, the means of
si_snr_i and embedding_sim in both files, and exits 1 when a header or
a row differs beyond its tolerance.
"""

from __future__ import annotations

import csv
import json
import math
import sys

import numpy as np

TOL = {"si_snr_i": 1e-2, "output_sisnr": 1e-2, "embedding_sim": 1e-5,
       "delta_ild_db": 1e-3}
EXACT_F32 = frozenset({"input_sisnr", "enroll_sisnr", "input_embed_dist",
                       "enroll_embed_dist", "tgt_enroll_error",
                       "tgt_ang_vel", "enroll_duration", "delta_itd_us"})
# the numpy under which the dataset reproduces the committed CSVs'
# input_sisnr and enroll_sisnr bit for bit (tests/test_torch_eval.py);
# under numpy 2.3.5 they came out up to 2.2e-6 dB apart
CSV_NUMPY = "2.0.2"
HOST_SISNR_TOL = 1e-5


def tolerances(numpy_version: str = np.__version__) -> dict:
    """TOL, plus 1e-5 dB for input_sisnr and enroll_sisnr unless this
    numpy is the one the committed CSVs were written with."""
    if numpy_version == CSV_NUMPY:
        return dict(TOL)
    return TOL | dict.fromkeys(("input_sisnr", "enroll_sisnr"),
                               HOST_SISNR_TOL)


def read_csv(path: str) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _f32(s: str) -> float:
    return float(np.float32(s)) if s else math.nan


def compare(got: list[dict], want: list[dict], tol: dict | None = None
            ) -> dict:
    """{"rows", "max_dev" {column: largest |got - want|}, "means"
    {column: [got, want]}, "failures" [(row, column, got, want)], "tol",
    "numpy"}; the columns in `tol` (default: `tolerances()`) are held to
    it, those in EXACT_F32 to float32 equality, every other column to
    string equality."""
    tol = tolerances() if tol is None else tol
    if len(got) != len(want):
        raise ValueError(f"{len(got)} rows against {len(want)}")
    if got and list(got[0]) != list(want[0]):
        raise ValueError(f"header {list(got[0])} against {list(want[0])}")
    max_dev: dict = {}
    failures = []
    for i, (g, w) in enumerate(zip(got, want)):
        for col, gv in g.items():
            wv = w[col]
            if col in tol or col in EXACT_F32:
                a, b = _f32(gv), _f32(wv)
                dev = 0.0 if (math.isnan(a) and math.isnan(b)) \
                    else abs(a - b)
                max_dev[col] = max(max_dev.get(col, 0.0), dev)
                ok = dev <= tol[col] if col in tol else \
                    (a == b or (math.isnan(a) and math.isnan(b)))
            else:
                ok = gv == wv
            if not ok:
                failures.append((i, col, gv, wv))
    means = {col: [float(np.mean([_f32(r[col]) for r in rows]))
                   for rows in (got, want)]
             for col in ("si_snr_i", "embedding_sim") if got and col in got[0]}
    return dict(rows=len(got), max_dev=max_dev, means=means,
                failures=failures, tol=tol, numpy=np.__version__)


def report(res: dict) -> str:
    lines = [f"{res['rows']} rows; numpy {res['numpy']} (the committed "
             f"CSVs: {CSV_NUMPY}); largest |got - want| per column:"]
    for col, dev in res["max_dev"].items():
        bound = f"tolerance {res['tol'][col]}" if col in res["tol"] \
            else "equal as float32"
        lines.append(f"  {col:18s} {dev:.3e} ({bound})")
    for col, (g, w) in res["means"].items():
        lines.append(f"  mean {col}: {g:.6f} against {w:.6f}")
    for i, col, g, w in res["failures"][:20]:
        lines.append(f"  row {i} {col}: {g!r} against {w!r}")
    lines.append(f"{len(res['failures'])} values out of tolerance")
    return "\n".join(lines)


def main(argv=None) -> int:
    got, want = (argv or sys.argv[1:])[:2]
    res = compare(read_csv(got), read_csv(want))
    print(report(res))
    print(json.dumps({k: res[k] for k in ("rows", "numpy", "max_dev",
                                          "means")}
                     | {"failures": len(res["failures"])}))
    return 1 if res["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
