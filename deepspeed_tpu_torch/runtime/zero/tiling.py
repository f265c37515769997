"""TiledLinear: bound activation memory for huge linears. The port of
``deepspeed_tpu/runtime/zero/tiling.py``.

Reference ``TiledLinear`` (``runtime/zero/tiling.py:32``) splits a linear
into an in_splits x out_splits grid of sub-linears so that no full-size
activation exists at once. As in the JAX package there is one weight
tensor, ``kernel [in, out]`` (the flax layout, so weights carry across), and
the computation is tiled: column tiles one after another, each summing its
row tiles, optionally recomputed in the backward
(``torch.utils.checkpoint`` per tile).
"""

import math

import torch
from torch import nn


def tiled_matmul(x: torch.Tensor, w: torch.Tensor, out_splits: int = 1,
                 in_splits: int = 1, remat: bool = False) -> torch.Tensor:
    """y = x @ w computed in tiles. x: [..., K]; w: [K, N].

    ``out_splits`` walks column tiles of ``w`` (bounds the live output
    activation); ``in_splits`` accumulates over row tiles (bounds the live
    input slice in the backward)."""
    k, n = w.shape
    if n % out_splits or k % in_splits:
        raise ValueError(f"w {tuple(w.shape)} not divisible by splits "
                         f"({in_splits}, {out_splits})")

    def one_tile(x, w_tile):
        xs = torch.chunk(x, in_splits, dim=-1)
        ws = torch.chunk(w_tile, in_splits, dim=0)
        out = xs[0] @ ws[0]
        for xi, wi in zip(xs[1:], ws[1:]):
            out = out + xi @ wi
        return out

    tiles = []
    for w_tile in torch.chunk(w, out_splits, dim=1):
        if remat:
            tiles.append(torch.utils.checkpoint.checkpoint(one_tile, x, w_tile,
                                                           use_reentrant=False))
        else:
            tiles.append(one_tile(x, w_tile))
    return torch.cat(tiles, dim=-1)


class TiledLinear(nn.Module):
    """Reference-shaped module; ``forward`` runs :func:`tiled_matmul` on the
    input's dtype. ``kernel`` is drawn as flax's ``lecun_normal`` (a normal
    truncated at two standard deviations, variance 1 / in_features) from
    ``seed`` on ``device`` (the card unless the caller passes ``"cpu"``);
    ``bias`` starts at zero."""

    def __init__(self, in_features: int, out_features: int, in_splits: int = 1,
                 out_splits: int = 1, use_bias: bool = True, remat: bool = False, *,
                 seed: int = 0, device="cuda"):
        super().__init__()
        from ...accelerator import resolve_device

        dev = resolve_device(device)
        self.in_features, self.out_features = in_features, out_features
        self.in_splits, self.out_splits = in_splits, out_splits
        self.use_bias, self.remat = use_bias, remat
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        # flax variance_scaling(1, fan_in, truncated_normal): the std of the
        # standard normal truncated to [-2, 2] is 0.87962566103423978
        std = math.sqrt(1.0 / in_features) / 0.87962566103423978
        kernel = torch.empty(in_features, out_features, device=dev)
        nn.init.trunc_normal_(kernel, std=std, a=-2 * std, b=2 * std, generator=gen)
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(torch.zeros(out_features, device=dev)) if use_bias else None

    def forward(self, x):
        y = tiled_matmul(x, self.kernel.to(x.dtype), self.out_splits, self.in_splits,
                         self.remat)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y
