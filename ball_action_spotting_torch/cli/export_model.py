"""Seal a trained checkpoint into a serving artifact (port of the JAX
package's ``scripts/export_model.py``).

Exports the BN-folded frame-carry chunk program, weights inside, with
``torch.export`` (``predict/export.py``), so that a serving host needs the
port's ops and no model code or checkpoint parsing. The program is traced
on ``--device`` through the depthwise kernel's op, whatever that device
is; the loader moves it to the device it serves on, where the op launches
the kernel.

    python -m ball_action_spotting_torch.cli.export_model \\
        --checkpoint data/ball_action/experiments/NAME/fold_0/model-032-0.983.ckpt \\
        --output artifacts/ball_b0_tta.bastorx --tta --chunk_size 128 [--device cuda]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from ball_action_spotting_torch.predict.export import export_chunked_predictor
from ball_action_spotting_torch.predict.streaming import ChunkedVideoPredictor


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint", required=True, type=Path, help="a .ckpt file")
    parser.add_argument("--output", required=True, type=Path)
    parser.add_argument("--tta", action="store_true",
                        help="seal hflip TTA into the program (the ball recipe's default)")
    parser.add_argument("--chunk_size", type=int, default=256,
                        help="predictions per chunk program (the export always seals "
                             "the frame-carry program)")
    parser.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    parser.add_argument("--device", default="cuda", type=str,
                        help="the device the program is traced on")
    parser.add_argument("--no_fold_bn", action="store_true")
    return parser.parse_args(argv)


def main(argv=None) -> Path:
    args = parse_arguments(argv)
    predictor = ChunkedVideoPredictor(
        args.checkpoint, tta=args.tta,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        fold_bn=not args.no_fold_bn, chunk_size=args.chunk_size, device=args.device,
        dw3d_use_kernel=True)
    out = export_chunked_predictor(predictor, args.output)
    print(f"Exported {args.checkpoint} -> {out} ({out.stat().st_size / 1e6:.1f} MB, "
          f"traced on {args.device}, tta={args.tta}, chunk={args.chunk_size}, "
          f"dtype={args.dtype})")
    return out


if __name__ == "__main__":
    main()
