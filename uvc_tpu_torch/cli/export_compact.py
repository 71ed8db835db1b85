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
``.ckpt``, which ``apply_compact`` serves.  ``--export_stablehlo PATH``
(the JAX package's flag name) also writes the serving artifact,
``torch.export`` programs at the ``--serve_batches`` sizes
(``infer/export.py``), which ``infer.export.load_serving`` serves with no
model code.
"""

from __future__ import annotations

import argparse

import torch

from uvc_tpu_torch.configs import get_config


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
                   help="also write an ahead-of-time serving artifact "
                        "(.npz of torch.export programs, one per batch "
                        "size) that runs with uvc_tpu_torch.ops alone, no "
                        "model code; see uvc_tpu_torch/infer/export.py")
    p.add_argument("--serve_batches", default="8",
                   help="comma-separated batch sizes to export")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the compact layers are built")
    args = p.parse_args(argv)

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

    if args.export_stablehlo:
        from uvc_tpu_torch.infer.export import export_serving, save_serving
        batches = [int(s) for s in args.serve_batches.split(",") if s]
        arts = export_serving(
            layers, top, cfg, batch_sizes=batches,
            token_ratio=args.token_ratio)
        save_serving(args.export_stablehlo, arts)
        print(f"torch.export serving artifact (batches {batches}) "
              f"saved to {args.export_stablehlo}")


if __name__ == "__main__":
    main()
