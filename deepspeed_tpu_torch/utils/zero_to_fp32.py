"""Consolidate a checkpoint into a flat fp32 ``.npz`` of parameters.

    python -m deepspeed_tpu_torch.utils.zero_to_fp32 <checkpoint_dir> <out.npz> [--tag TAG]

The port's counterpart of the repository's ``bin/zero_to_fp32``, with its
command line; reference ``deepspeed/utils/zero_to_fp32.py``, the script
DeepSpeed drops into every checkpoint directory. The port's checkpoints hold
whole tensors at every ZeRO stage and world size, so consolidation is a read
(``checkpoint/engine.zero_to_fp32``), which takes the host masters of the
ZeRO-Offload tier where the tag has them. The keys are the parameters'
``"/"``-joined paths.
"""

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(prog="zero_to_fp32")
    p.add_argument("checkpoint_dir", help="dir containing 'latest' and tag dirs")
    p.add_argument("output_file", help="output .npz of fp32 params")
    p.add_argument("--tag", default=None, help="checkpoint tag (default: latest)")
    args = p.parse_args(argv)

    from ..checkpoint.engine import zero_to_fp32

    flat = zero_to_fp32(args.checkpoint_dir, args.output_file, tag=args.tag)
    print(f"wrote {len(flat)} fp32 tensors to {args.output_file}")


if __name__ == "__main__":
    main()
