"""Convert raw TP-sharded checkpoints to a universal (reshardable) checkpoint.

    python -m deepspeed_tpu_torch.checkpoint.ds_to_universal \\
        --input shard0.npz shard1.npz ... --output ckpt_dir \\
        [--version 2] [--num-heads N] [--format raw|megatron] [--config args.json]

The port's counterpart of the repository's ``bin/ds_to_universal``, with its
command line. Reference: ``deepspeed/checkpoint/ds_to_universal.py``
(``main:469``) turns ZeRO / 3D shards into per-parameter fragments that
reload under another dp / tp / pp layout. Here a universal checkpoint is
the whole tree in one file: the shards are merged on the host by the
state-dict factory (both fused-QKV layouts), Megatron-GPT names are mapped
to the model's parameter tree when asked (``--format megatron``, with the
Megatron args as json), and the tree is written through
``TorchCheckpointEngine`` (``<output>/state.pt``, float32 tensors).
:func:`load_universal` reads it back; its tree is what ``initialize``
takes as ``model_parameters``.
"""

import argparse
import json
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch


def load_universal(path: str) -> Any:
    """The tree a universal checkpoint holds, as CPU tensors."""
    from .engine import TorchCheckpointEngine

    return TorchCheckpointEngine().load(os.path.abspath(path))


def _dotted(tree, prefix: str = "", out: Optional[dict] = None) -> dict:
    """A nested tree read from ``.npz`` shards back to dotted Megatron keys."""
    out = {} if out is None else out
    for k, v in tree.items():
        if isinstance(v, dict):
            _dotted(v, f"{prefix}{k}.", out)
        else:
            out[prefix + k] = v
    return out


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(prog="ds_to_universal")
    p.add_argument("--input", nargs="+", required=True,
                   help="TP shard files (.npz) in rank order, or one merged file")
    p.add_argument("--output", required=True, help="output checkpoint directory")
    p.add_argument("--version", type=int, default=2,
                   help="fused-QKV checkpoint version (Megatron convention)")
    p.add_argument("--num-heads", type=int, default=None,
                   help="attention heads (needed to split fused QKV)")
    p.add_argument("--format", choices=["raw", "megatron"], default="raw",
                   help="'megatron': also map Megatron-GPT names to model "
                        "params (needs --config with the model args)")
    p.add_argument("--config", default=None,
                   help="json of Megatron args (hidden_size, num_layers, ...)")
    args = p.parse_args(argv)

    from .engine import TorchCheckpointEngine
    from .state_dict_factory import SDLoaderFactory

    # megatron inputs are torch [out, in] weights with dotted names: the
    # explicit layout table drives the merge (the flax name rules would
    # merge QKV along the wrong axis and replicate row-parallel dense)
    loader = SDLoaderFactory.get_sd_loader(
        args.input, version=args.version, num_heads=args.num_heads,
        layout="megatron" if args.format == "megatron" else "flax")
    merged = loader.load(1, 0)
    print(f"merged {len(args.input)} shard(s)")

    if args.format == "megatron":
        if not args.config:
            raise SystemExit("--format megatron needs --config (model args json)")
        from ..inference.megatron import megatron_config, megatron_params

        with open(args.config) as f:
            margs = json.load(f)
        flat = _dotted(merged)
        cfg = megatron_config(margs, sd=flat)
        merged = megatron_params(flat, cfg, version=args.version)
        print(f"mapped megatron naming -> model params "
              f"({cfg.num_layers} layers, {cfg.num_heads} heads)")

    out = os.path.abspath(args.output)
    TorchCheckpointEngine().save(_to_torch(merged), out)
    print(f"universal checkpoint written to {out}")


if __name__ == "__main__":
    main()
