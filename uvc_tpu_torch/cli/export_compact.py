"""Export a physically compacted serving model from a UVC checkpoint
(counterpart of ``uvc_tpu/cli/export_compact.py``).

  python -m uvc_tpu_torch.cli.export_compact \\
      --model_type deit_small_patch16_224 \\
      --checkpoint out/run/deit_small_patch16_224_30.ckpt \\
      --save_file compact.ckpt

Slices the pruned heads and MLP units out and drops the skipped blocks
(``infer/compact.py::compact_model``), reports the compact model's share
of the dense FLOPs, and saves ``{"layers", "top", "model_type",
"img_size", "num_classes", "token_ratio", "flops_fraction"}`` as a
``.ckpt``, which ``apply_compact`` serves.  ``--export_stablehlo`` (an
ahead-of-time TPU artifact) raises: ``infer/export.py`` is not ported
(ROADMAP.md queue A item 8).
"""

from __future__ import annotations

import argparse

import torch

from uvc_tpu_torch.configs import get_config

NOT_PORTED_EXPORT = ("--export_stablehlo needs infer/export.py, which is "
                     "not ported yet; see ROADMAP.md queue A item 8")


def main(argv=None):
    p = argparse.ArgumentParser("uvc_tpu_torch compact export")
    p.add_argument("--model_type", default="deit_small_patch16_224")
    p.add_argument("--checkpoint", required=True,
                   help="stage-1/2 .ckpt with params (+ masks)")
    p.add_argument("--save_file", required=True)
    p.add_argument("--img_size", default=224, type=int)
    p.add_argument("--num_classes", default=1000, type=int)
    p.add_argument("--token_ratio", default=None, type=float,
                   help="physically drop tokens at serving: keep the "
                        "scorer's top int(ratio*N) patches per image "
                        "(use the discovered --patch_ratio); default "
                        "keeps the full sequence")
    p.add_argument("--export_stablehlo", default=None,
                   help="not ported (ROADMAP.md queue A item 8)")
    p.add_argument("--serve_batches", default="8",
                   help="comma-separated batch sizes to export (with "
                        "--export_stablehlo)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the compact layers are built")
    args = p.parse_args(argv)
    if args.export_stablehlo:
        raise NotImplementedError(NOT_PORTED_EXPORT)

    from uvc_tpu_torch.compress.masks import build_masks
    from uvc_tpu_torch.infer.compact import (compact_flops_fraction,
                                             compact_model)
    from uvc_tpu_torch.utils.checkpoint import (load_checkpoint, params_of,
                                                save_checkpoint)

    cfg = get_config(args.model_type).replace(
        img_size=args.img_size, num_classes=args.num_classes)
    ck = load_checkpoint(args.checkpoint)
    params = params_of(ck)
    if ck.get("masks"):
        masks = {"attn": ck["masks"]["attn"].float(),
                 "mlp": ck["masks"]["mlp"].float()}
    else:
        cs = ck["cstate"]
        masks = build_masks(params, torch.ceil(cs["s"].float()),
                            torch.ceil(cs["r"].float()), cfg)

    layers, top = compact_model(params, masks, cfg, device=args.device)
    frac = compact_flops_fraction(layers, cfg, token_ratio=args.token_ratio)
    print(f"compact model: {len(layers)} blocks kept, "
          f"{frac * 100:.2f}% of dense FLOPs")
    save_checkpoint(args.save_file, {
        "layers": layers, "top": top, "model_type": args.model_type,
        "img_size": args.img_size, "num_classes": args.num_classes,
        "token_ratio": (-1.0 if args.token_ratio is None
                        else float(args.token_ratio)),
        "flops_fraction": float(frac)})
    print(f"saved to {args.save_file}")


if __name__ == "__main__":
    main()
