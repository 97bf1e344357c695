"""The numbers that decide `correct`, each a gap between what the
program produced and what the plain reference produces from the same
inputs. `PERF.md` gives the readings each limit was set from."""

from __future__ import annotations

import numpy as np


def chunk_error(program: np.ndarray, reference: np.ndarray) -> float:
    """Serving: the worst chunk. program, reference [streams, chunks,
    ...] (a chunk's output samples of every source). Each chunk's error
    norm over the larger of its reference norm and the stream's median
    chunk norm (a quiet chunk is not judged against its own norm), the
    largest over every stream and chunk."""
    p = program.reshape(program.shape[0], program.shape[1], -1)
    r = reference.reshape(p.shape).astype(np.float64)
    err = np.linalg.norm(p - r, axis=-1)
    norm = np.linalg.norm(r, axis=-1)
    floor = np.median(norm, axis=1, keepdims=True)
    gap = err / np.maximum(norm, floor)
    return float(np.nan_to_num(gap, nan=np.inf).max())


def norm_gap(program: dict, reference: dict, keep=None) -> float:
    """Training, by the median leaf: each leaf's |‖program leaf‖ -
    ‖reference leaf‖| over the larger of the reference leaf's norm and
    the median leaf's, the median over the leaves. program, reference:
    {name: norm}; keep: the names compared (all by default). Not the
    worst leaf: the keys' projections of the first block read up to
    2e-3 in a second float32 implementation of the reference (PERF.md)."""
    names = sorted(reference if keep is None else keep)
    median = float(np.median([reference[n] for n in names]))
    gaps = [abs(program[n] - reference[n]) / max(reference[n], median)
            for n in names]
    return float(np.nan_to_num(np.median(gaps), nan=np.inf))


def loss_gap(program: list, reference: list) -> float:
    """Training: the relative gap of the first step's loss. The later
    steps' losses follow Adam's first, sign-like steps, which turn
    round-off in near-zero gradient entries into steps of the learning
    rate (PERF.md)."""
    return float(np.nan_to_num(abs(program[0] - reference[0])
                               / abs(reference[0]), nan=np.inf))


def moving(ref_grad_norms: dict) -> list:
    """The leaves whose change is compared: those whose reference
    gradient reaches a thousandth of the median leaf's. A leaf below
    it (a key's shift under softmax) moves under Adam by round-off
    alone."""
    median = float(np.median(list(ref_grad_norms.values())))
    return [n for n, v in ref_grad_norms.items() if v >= 1e-3 * median]
