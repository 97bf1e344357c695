"""The port's entry point (counterpart of `__graft_entry__.py::entry`):
the flagship streaming separator's full-utterance forward and example
arguments.

    fn, args = entry()          # on the card; entry(device="cpu") on the CPU
    y = fn(*args)               # [2, 2, 16000] separated audio
"""

from __future__ import annotations

import torch

from lookoncetohear_tpu_torch import resolve_device
from lookoncetohear_tpu_torch.models.net import Net

# configs/tsh.json model_params: the flagship separator
FLAGSHIP = dict(embed_dim=256, stft_chunk_size=128, stft_pad_size=64,
                num_ch=2, D=64, L=4, I=1, J=1, B=3, H=64,
                local_atten_len=50, use_attn=True, lookahead=True,
                chunk_causal=True)


def entry(device=None):
    """(fn, (x, embeds)): fn(x, embeds) is the flagship's forward over a
    batch of 2 x 1 s of 16 kHz binaural audio, x [2, 2, 16000] and
    embeds [2, 1, 256] (zeros, as in the JAX entry). The parameters are
    drawn by the modules' default initializers from a CPU generator
    seeded with 0, as the JAX entry fixes PRNGKey(0); the global
    generator is left as it was."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = Net(**FLAGSHIP, device="cpu")
    net = net.to(dev).eval()
    x = torch.zeros((2, 2, 16000), device=dev)
    embeds = torch.zeros((2, 1, FLAGSHIP["embed_dim"]), device=dev)

    def fn(x, embeds):
        with torch.no_grad():
            return net(x, embeds)

    return fn, (x, embeds)
