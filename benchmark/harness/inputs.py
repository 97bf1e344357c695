"""Inputs drawn from `--seed`: the weights of a reference's table (on the
device, in one draw), the serving cells' pool of binaural chunks and
d-vectors and the offline cells' pool of binaural scenes (on the host,
where a client holds its audio), and the training cells' pool of
batches (on the device). Every seed gives the same sizes."""

from __future__ import annotations

import math

import numpy as np
import torch

SAMPLE_RATE = 16000


def seed64(seed: int) -> int:
    return int(seed) % 2 ** 64


def weights(table: list, seed: int, device, dtype=torch.float32) -> dict:
    """{name: tensor} of every weight of a reference's `param_table`
    ((name, shape, offset, scale) rows), from one uniform draw on
    `device` by a generator seeded with `seed`, in the dtype the weights
    are served in."""
    sizes = [math.prod(shape) for _, shape, _, _ in table]
    g = torch.Generator(device=device)
    g.manual_seed(seed64(seed))
    u = torch.rand(sum(sizes), generator=g, device=device) * 2 - 1
    out, off = {}, 0
    for (name, shape, offset, scale), n in zip(table, sizes):
        out[name] = (offset + scale * u[off:off + n]).reshape(shape) \
            .to(dtype)
        off += n
    return out


def _voices(rng, n: int, length: int) -> np.ndarray:
    """n voiced sources [n, length]: 4 harmonics of a pitch of 90-300
    Hz with a slow vibrato and syllable-rate envelope, plus a little
    noise, at about 0.1 rms."""
    t = np.arange(length) / SAMPLE_RATE
    f0 = rng.uniform(90, 300, (n, 1))
    vib = 1 + 0.03 * np.sin(2 * np.pi * rng.uniform(3, 6, (n, 1)) * t)
    phase = 2 * np.pi * np.cumsum(f0 * vib, axis=1) / SAMPLE_RATE
    x = np.zeros((n, length))
    for k in range(1, 5):
        x += rng.uniform(0.2, 1.0, (n, 1)) / k * np.sin(
            k * phase + rng.uniform(0, 2 * np.pi, (n, 1)))
    env = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(2, 5, (n, 1)) * t
                             + rng.uniform(0, 2 * np.pi, (n, 1)))
    x = x * env + 0.05 * rng.standard_normal((n, length))
    return 0.1 * x / np.sqrt((x ** 2).mean(axis=1, keepdims=True))


def binaural(rng, mono: np.ndarray) -> np.ndarray:
    """[n, L] -> [n, 2, L]: the right ear delayed by 0-16 samples and
    scaled by 0.6-1.0 (an interaural time and level difference)."""
    n, length = mono.shape
    delay = rng.integers(0, 17, n)
    gain = rng.uniform(0.6, 1.0, n)
    right = np.stack([np.concatenate([np.zeros(d), m[:length - d]])
                      for d, m in zip(delay, mono)]) * gain[:, None]
    return np.stack([mono, right], axis=1)


def serve_pool(seed: int, streams: int, mics: int, chunk: int,
               pool_chunks: int):
    """chunks [pool_chunks, streams, mics, chunk] float32: each stream a
    target voice and an interfering voice at -3 dB, binaural, cut into
    chunks; the serving loop's step k feeds chunks[k % pool_chunks]."""
    if mics != 2:
        raise ValueError("the pool is binaural")
    rng = np.random.default_rng([seed64(seed), 1])
    length = pool_chunks * chunk
    mix = binaural(rng, _voices(rng, streams, length)) + 0.7 * binaural(
        rng, _voices(rng, streams, length))
    pool = mix.reshape(streams, mics, pool_chunks, chunk).transpose(2, 0, 1,
                                                                    3)
    return np.ascontiguousarray(pool, dtype=np.float32)


def dvectors(seed: int, n: int, dim: int) -> np.ndarray:
    """n seeded unit d-vectors [n, dim] float32."""
    e = np.random.default_rng([seed64(seed), 2]).standard_normal((n, dim))
    return (e / np.linalg.norm(e, axis=1, keepdims=True)).astype(np.float32)


def train_batches(seed: int, n_batches: int, batch: int, seconds: float,
                  embed_dim: int, device) -> list:
    """n_batches target-speech batches on `device`, every row different: a
    binaural target voice, the mixture of it with an interfering voice
    at -3 dB and noise, and the target's unit d-vector [B, 1, E]."""
    g = torch.Generator(device=device)
    g.manual_seed(seed64(seed) ^ 0x5EED)
    n = int(round(seconds * SAMPLE_RATE))
    t = torch.arange(n, device=device) / SAMPLE_RATE

    def voice():
        f0 = 90 + 210 * torch.rand(batch, 1, generator=g, device=device)
        phase = 2 * math.pi * f0 * t
        x = torch.zeros(batch, n, device=device)
        for k in range(1, 5):
            a = 0.2 + 0.8 * torch.rand(batch, 1, generator=g, device=device)
            p0 = 2 * math.pi * torch.rand(batch, 1, generator=g,
                                          device=device)
            x = x + a / k * torch.sin(k * phase + p0)
        env = 0.6 + 0.4 * torch.sin(2 * math.pi * 3 * t + 2 * math.pi * (
            torch.rand(batch, 1, generator=g, device=device)))
        x = x * env
        x = 0.1 * x / x.pow(2).mean(dim=1, keepdim=True).sqrt()
        gain = 0.6 + 0.4 * torch.rand(batch, 1, generator=g, device=device)
        right = torch.roll(x, shifts=7, dims=1) * gain
        return torch.stack([x, right], dim=1)               # [B, 2, N]

    out = []
    for _ in range(n_batches):
        target = voice()
        noise = 0.01 * torch.randn(batch, 2, n, generator=g, device=device)
        emb = torch.randn(batch, 1, embed_dim, generator=g, device=device)
        out.append({"mixture": target + 0.7 * voice() + noise,
                    "target": target,
                    "embedding_gt": emb / emb.norm(dim=-1, keepdim=True)})
    return out


def enrollments(seed: int, lengths: list, mics: int) -> list:
    """One seeded binaural scene [mics, length] float32 a length: the
    enrolled voice alike on both ears (the wearer faces it), an
    interfering voice at -3 dB with an interaural delay and level
    difference, and a little white noise (as the serving pool and the
    training batches mix them)."""
    if mics != 2:
        raise ValueError("the scenes are binaural")
    rng = np.random.default_rng([seed64(seed), 5])
    out = []
    for n in lengths:
        target = np.repeat(_voices(rng, 1, n), 2, axis=0)
        other = binaural(rng, _voices(rng, 1, n))[0]
        noise = 0.01 * rng.standard_normal((2, n))
        out.append((target + 0.7 * other + noise).astype(np.float32))
    return out
