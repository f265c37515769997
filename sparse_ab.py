#!/usr/bin/env python3
"""Time the sparse forward kernel of this checkout against another
checkout's (a parent commit unpacked with ``git archive``) on one GPU.

    python3 sparse_ab.py OTHER_CHECKOUT [--blocks 64,128] [--extra 16,32,256]
                         [--dims 128,64]

Each side runs in a process of its own, with its kernels built from its own
sources into its own ``build/``, in turns: other, this, this, other. Each
times ``launch_sparse_fwd`` on both routes at Llama-2-7B's attention widths
(B 1, S 4096, H 32, bigbird seed 0, causal, bf16) at each head dim of
``--dims`` and each block of ``--blocks`` (``--extra``: blocks timed on this
side only, which the other may not build), back to back and replayed from
a CUDA graph (chip_smoke.py's ``cuda_ms`` and ``graph_ms``), and prints one
JSON line per process: ``{"D128 block64 wgmma": [ms, graph_ms], ...}``.
Compare the sides only within one run; the card's name and power limit
come first.
"""

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def child(root: str, label: str, blocks: str, dims: str) -> int:
    sys.path.insert(0, root)
    import torch

    sa = importlib.import_module("deepspeed_tpu_torch.ops.sparse_attention")
    # the timing helpers of this checkout's chip_smoke.py, whichever side runs
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cuda_ms, graph_ms, sparse_case = smoke.cuda_ms, smoke.graph_ms, smoke.sparse_case

    B, S, H = 1, 4096, 32
    out = {}
    for D in (int(d) for d in dims.split(",")):
        for block in (int(b) for b in blocks.split(",")):
            layout = sa.bigbird_layout(H, S // block, seed=0)
            q, k, v = sparse_case(torch.bfloat16, B, S, H, D, 300)
            sl = sa._compact_layout(layout, True, q.device)
            o = torch.empty_like(q)
            for route in ("wgmma", "mma_sync"):
                f = lambda: sa.launch_sparse_fwd(q, k, v, o, sl, causal=True,
                                                 sm_scale=D ** -0.5, block=block, route=route)
                out[f"D{D} block{block} {route}"] = [cuda_ms(f, iters=100), graph_ms(f)]
    print(label, json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="a checkout of the commit to compare with")
    ap.add_argument("--blocks", default="64,128")
    ap.add_argument("--extra", default="", help="blocks timed on this side only")
    ap.add_argument("--dims", default="128,64")
    ap.add_argument("--child", nargs=2, metavar=("ROOT", "LABEL"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(*args.child, args.blocks, args.dims)
    import torch

    if not torch.cuda.is_available():
        print("sparse_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    other = str(Path(args.other).resolve())
    if not (Path(other) / "deepspeed_tpu_torch" / "ops" / "csrc").is_dir():
        print(f"sparse_ab: {other} is not a checkout of the repository", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    these = ",".join(b for b in (args.blocks, args.extra) if b)
    for root, label, blocks in ((other, "other", args.blocks), (str(HERE), "this", these),
                                (str(HERE), "this", these), (other, "other", args.blocks)):
        subprocess.run([sys.executable, __file__, other, "--blocks", blocks, "--dims", args.dims,
                        "--child", root, label], check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
