#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``uvc_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only   # phases 1-3 and phase 7's kernel
                                           # rows, then the card line (no
                                           # phases 4-13)
    python3 chip_smoke.py --backbones-only # phase 3 at R50-ViT-B/16's block
                                           # shape and phase 14, then the
                                           # card line
    python3 chip_smoke.py --ddp-only       # phase 15 (data parallelism)
                                           # alone, then the card line
    python3 chip_smoke.py --export-only    # phase 16 (the serving export)
                                           # alone, then the card line
    python3 chip_smoke.py --tp-only        # phase 17 (tensor parallelism)
                                           # alone, then the card line
    python3 chip_smoke.py --images-only    # phase 19 (real images without
                                           # PIL) alone, then the card line
    python3 chip_smoke.py --config-only    # phase 20 (--config and
                                           # --enable_writer 1 without yaml
                                           # or tensorboard) alone, then
                                           # the card line
    python3 chip_smoke.py --digests        # phase 3's digests at the shapes
                                           # the parent's kernels take (A8's
                                           # at "se" and "ragged"), and
                                           # phase 7's performer kernels'
    python3 chip_smoke_new.py --kernels-only --refused-ok
                                           # this script in an older
                                           # checkout: a phase-3 row whose
                                           # kernel refuses its shape is
                                           # printed, not failed

Phases, each of which stops the run with a non-zero exit on failure:

1. device  -- the card's name and power limit; exits 1 without CUDA.
2. build   -- compiles the hand-written kernels (``uvc_tpu_torch/csrc``).
3. kernels -- each kernel against its plain PyTorch version on the card,
   with its time, the plain version's, one PyTorch library composition's
   (a yardstick only) and the least time the card could take.  Forward
   kernels at the shapes the serving paths give them (B=64, dm=384:
   "eval", the masked-dense eval step after the token drop, N=138, 6
   heads, F=1536; "compact", the compacted layers, N=138, 3 heads, F=768),
   at the dense shape without the token drop (N=197, 6 heads, F=1536) and
   at ViT-H/14's stage-1 shape ("vit_h": B=32, N=257, dm=1280, 16 heads of
   80, F=5120); backward kernels at the stage-1 train shape ("train": B=64,
   N=197, 6 heads, F=1536) and a ragged one ("ragged": B=3, so B*N=591);
   the sublayer kernels K1, A2 and A7 at head dim 12 ("resnext": B=64,
   N=197, dm=384, 32 heads) and 80 ("h80": B=8, N=257, dm=640, 8 heads);
   A7's forward and the four backward kernels (A2, A4, A6, A7's) at
   "vit_h" too (dm 1280, where ViT-H/14's student runs A2 and A4 and a
   part-gated one A7), and A7's forward at "long" (B=4, N=1025, dm=1280,
   16 heads of 80: past the 624 keys that its staged core once held); the
   stage-2 paths' backward shapes of phase 11 (B=64, N=138, dm=384): A2 at
   "compact_ft" (3 heads, da 192) and "one_head" (da 64), A6 at
   "compact_ft" (F 768, W1 / b1 / W2 zero past 700 units, all-ones mask:
   the padding slots' gradients exactly zero), A4 at "stage2" (F 1536, d
   (0, 1)) and "stage2_skip" (d (1, 0): every gradient into the block
   exactly zero, dxin = do), and T2T-ViT-14's at N 197: A2 and A6 at
   "t2t_compact" (3 heads, F 640, W1 / b1 / W2 zero past 576 units), A4
   at "t2t_stage2" and "t2t_stage2_skip" (F 1152, d (0, 1) and (1, 0)),
   each output also within 1/64 of its largest value, and each also
   under ``--digests``; K1, K2, A2 and A6 at "synflow" (B=1, N=197,
   dm=384, 6 heads, F=1536: phase 13's SynFlow scoring pass on one
   all-ones image); DeiT-Tiny at 64 px, phase 18's shapes at batch 128:
   K1, K2, K3, A2 and A4 at "tiny" (N=18, dm=192, 3 heads, F=768), K1,
   K3, A2 and A4 at "tiny_slim" (N=13, after the token ratio 0.7), K1
   and K2 at "tiny_compact" (N=13, 2 heads, F=384: a compacted layer);
   every forward kernel's two launches bit for bit; K1's four launches
   (LayerNorm, qkv GEMM, attention core, projection GEMM) and K2's and
   K3's three (LayerNorm, fc1 GEMM, fc2 GEMM) one by one at "vit_h" and
   "eval", and
   A7's forward's three (qkv GEMM, core, projection GEMM) at "dense" and
   "h80", from a profile, with the GEMMs' rates and the host time of one
   call, each of the model's blocks (32, 12) with its own weights, and K1
   and K2 interleaved block by block as a forward pass issues them (K1's
   and K2's through their dispatcher operators, beside the operators' CUDA
   implementations called directly: what the operator adds); with
   ``--kernels-only``, A2's sixteen and A7's backward's
   fourteen launches one by one at each of their shapes the same way, and
   A6's and A4's twelve at "train" and "vit_h", with their GEMMs' rates
   and the LayerNorm backward's time (in another tree's
   sequence, under the kernels' own names), and A9's backward's (the pack where its operands take it,
   the query side, the key side; on contiguous heads and on head views)
   at every core shape and A8's at its shapes, under the kernels' own
   names; the attention
   core A9 at "se" (B=64, H=6, N=197,
   dh=64), "dense_odd" (H=8, dh=41), "dense_wide" (H=8, dh=74), "ragged"
   (B=3, H=2, N=50, dh=24), "vit_h" (B=32, H=16, N=257, dh=80) and "long"
   (B=4, H=16, N=1025, dh=80: past the 624 keys that the staged forward
   core held), every output, two forward and two
   backward launches bit for bit, the same operands as head views of one
   packed buffer (the models' layout, at strides that need narrower
   copies) bit for bit, beside ``scaled_dot_product_attention`` (its
   backend pinned: flash where it takes the shape); and A8
   (``attention_bwd_ctx``, A9's backward with the context) at "vit_h",
   "se" and "ragged", every output, two launches bit for bit, its dq, dk,
   dv bit for bit A9's, beside SDPA forward and backward.  Each line ends
   with a digest of the kernel's output bits: two trees whose digests
   agree (``--digests`` run in each) have bit-identical kernels at these
   inputs.
4. serving -- DeiT-Small at full width with seeded random weights and a
   seeded discovered architecture (3 of 6 heads, random within-head dims
   and half the MLP units pruned; 2 of 12 blocks gated off): 5 passes
   over 8 request batches of 64 images through ``compact_model`` +
   ``apply_compact`` (token ratio 0.7) and through ``eval_step``, timed
   as one window, counting kernel launches;
   then compact vs masked-dense logits, device time by kernel for one
   batch of each path (torch.profiler), and the card vs the plain path on
   the CPU.
5. training -- the stage-1 UVC step (``build_stage1_step``) on DeiT-Small
   at full width, seeded random student and teacher, bench.py's flagship
   settings (Gumbel block gating, Gumbel token top-k at ratio 0.9,
   mixup / cutmix, soft distillation, bf16, tau 5.0) at batch 64: 3
   untimed steps, then 10 steps timed as one window with their kernel
   launches counted; a gating-warmup step that must leave the gating
   logits unchanged; 2 steps with block gating off (the A6 path); 2 steps
   with part gating on (the bare attention sublayer, A7, and the composed
   MLP in the student); peak memory; device time by kernel for one step;
   and one step at batch 8 on the card against the same step on the CPU
   plain path, for the flagship and the part-gated settings.
6. baseline -- the baseline fine-tune step (``build_baseline_step``) on
   DeiT-Small at full width and batch 64, seeded random weights, a
   one-shot global magnitude mask at half density and the DeiT recipe of
   the baseline CLI (drop-path 0.1, pixel random erasing at 0.25, mixup /
   cutmix, label smoothing 0.1, AdamW, bf16, no teacher, no EMA): 3
   untimed steps, then 10 timed as one window with their launches
   counted, the masked coordinates' gradients checked to be exactly zero,
   peak memory, device time by kernel for one step, and one step at batch
   8 on the card against the CPU plain path.

7. T2T-ViT-14 -- the token-performer kernels (``performer``, forward,
   and ``performer_bwd``, the ports of A10 / A11) against their plain
   versions at "t2t_stage1" (B=64, N=3136, dim 192 with the 147 live slots
   of the space-to-depth layout), "t2t_stage2" (B=64, N=784, dim 576) and
   "ragged" (B=3, N=50), every output, two backward launches bit for bit,
   the backward without dx (the stem's first stage) against the plain
   version's and its gradients bit for bit the full backward's, beside a
   PyTorch composition of the stage as the yardstick (with
   ``--kernels-only`` too, and each launch of the forward, the backward
   and the dx-less backward at the two stages with its bytes, GB/s and
   TFLOP/s); then
   T2T-ViT-14 at full width and depth with seeded random weights: the
   stage-1 step with bench.py's flagship settings and a dense teacher (3
   untimed + 10 timed steps, per step ``performer`` 4, ``performer_bwd``
   2, ``layer_attention_ln`` 28, ``mlp_ln`` 14, ``mlp_ln_blend`` 14,
   ``layer_attention_ln_bwd`` 14, ``mlp_ln_blend_bwd`` 14), a profiled
   step (with the performer kernels' device ms a step) and one batch-8
   step against the CPU plain path; and serving a
   seeded discovered architecture (3 of 6 heads, 576 of 1152 units, 2 of
   14 blocks gated off) through ``compact_model`` + ``apply_compact`` and
   ``eval_step`` (5 passes of 8 batches of 64, ``performer`` 2 per
   batch), compact vs masked dense, and the card vs the CPU.

8. T2T ablations -- the baseline fine-tune of phase 6 on the three
   ablations at full width and depth, through the attention core (A9):
   T2T-ViT-14-SE timed as phase 6 times DeiT-Small (per step
   ``performer`` 2, ``performer_bwd`` 2, ``attention`` 14,
   ``attention_bwd`` 14 and 0 of every other kernel), T2T-ViT-16-Ghost
   and T2T-ViT-Dense 2 steps each (16 and 19 of each ``attention`` kernel
   per step), each with one batch-8 step against the CPU plain path; and
   T2T-ViT-14-SE eval (``build_baseline_eval_step``, 5 passes of 8
   batches of 64, ``performer`` 2 and ``attention`` 14 per batch) with its
   logits on the card against the CPU.

9. ViT-H/14 -- the stage-1 step at full width and depth (32 blocks, dm
   1280, 16 heads of 80, F 5120, 224 px, patch 14) with bench.py's
   flagship settings and a dense teacher at batch 32: 3 untimed + 10 timed
   steps, per step ``layer_attention_ln`` 64, ``mlp_ln`` 32,
   ``mlp_ln_blend`` 32 forward and, dm 1280 being within the LayerNorm
   backward's width, ``layer_attention_ln_bwd`` (A2) 32 and
   ``mlp_ln_blend_bwd`` (A4) 32 backward, no composed route and no A8; a
   gating-warmup step that must leave the gating logits unchanged bit for
   bit; peak memory; a profiled step (with the device time of A2's first
   launches, the core backward, A4's h and dam0 GEMMs with the activation
   backward, the LayerNorm backward, the in-order sums, K1's, K2's and
   K3's launches, K1's attention core, K2's and K3's fc1 GEMMs and the
   LayerNorm passes); the same step's device time by autograd node and
   that of the gradient accumulation's adds and fills; one block's
   backward by either route timed alone (A2 and A4 beside the composed
   routes, with A8 and the composed route's f32 product); and one step at
   depth 4 and batch 2 on the card against the CPU plain path.

10. T2T-ViT-14-resnext -- the stage-1 step of phase 7 on the resnext
   structure ablation (32 heads of 12): 1 untimed + 5 timed steps at
   batch 64 (per step ``layer_attention_ln_bwd`` 14 at head dim 12), a
   profiled step, and one batch-8 step against the CPU plain path.

11. stage 2 -- DeiT-Small at full width with phase 4's seeded discovered
   architecture (3 of 6 heads, random within-head dims, blocks 3 and 8
   gated off) keeping 700 of 1536 MLP units per layer, a seeded random
   dense teacher and the post_train recipe (soft distillation, mixup /
   cutmix, smoothing 0.1, AdamW, bf16, token ratio 0.7), batch 64: the
   dense stage-2 step (``build_stage2_step``; per step
   ``layer_attention_ln`` 24, ``mlp_ln`` 12, ``mlp_ln_blend`` 12,
   ``layer_attention_ln_bwd`` 12, ``mlp_ln_blend_bwd`` 12) and compact_ft
   (``compact_train_tree`` + ``build_compact_stage2_step`` on the dense
   run's state, 10 layers of 3 heads and fk 768; per step
   ``layer_attention_ln`` 22, ``mlp_ln`` 22, ``layer_attention_ln_bwd``
   10, ``mlp_ln_bwd`` 10), each 3 untimed + 10 timed steps with 0 of
   every other kernel; ``block_gating`` and ``token_scorer`` unchanged bit
   for bit; AdamW's first moment exactly 0 at every coordinate whose
   gradient is (the skipped blocks, the pruned units, the heads pruned
   whole, the pruned dims' v and proj); compact_ft's padding slots and
   v-masked moments exactly 0; one step of each from one state with one
   draw (loss and grad_norm, and ``scatter_to_dense`` of the compact
   result on the kept coordinates, within 2e-2, the qkv biases' key
   thirds, whose gradient is rounding noise, within the step's lr); a
   profiled step of each; one batch-8 step of each against the CPU plain
   path.  Then T2T-ViT-14 with phase 7's seeded architecture (blocks 4
   and 9 off): the dense and compact stage-2 steps, 1 untimed + 2 counted
   steps each (``performer`` 4 and ``performer_bwd`` 2 per step), the
   compact run's padding slots and v-masked moments exactly 0, and one
   batch-8 compact step against the CPU.

12. pipeline -- the two-stage pipeline through its CLIs, in this process
   (so that the launch counters see it), in a temporary directory, on
   DeiT-Small at full width and depth with random weights from the seed:
   ``cli/joint_train.py`` with bench.py's flagship compression settings
   (Gumbel block gating, Gumbel token top-k at ratio 0.9, mixup / cutmix,
   soft distillation from the same dense weights) on ``--dataset
   procedural`` at 224 px, batch 64, 12 steps an epoch, 2 stage-1 epochs
   (1 warmup) and 1 inline stage-2 epoch, 8 eval batches a validation,
   with a torch.profiler window over steps 3-7; its launches exactly 36
   train steps' and 24 eval batches' (per step K1 24, K2 12, K3 12, A2
   12, A4 12; per eval batch K1 12, K3 12; 0 of every other kernel and
   composed route); both epoch checkpoints and the stage-2 one read back
   through the codec bit for bit as the drivers held them when they saved;
   ``metrics.jsonl``'s epoch reports; each epoch's img/s as joint_train
   logs it beside phase 5's step alone, the procedural loader's host ms a
   batch and the profiled window's device-busy share; ``device_prefetch``'s
   batches on the card bit for bit the loader's.  Then a resume from the
   epoch-1 checkpoint (its epoch-2 checkpoint against the first run's:
   every leaf within 2e-2 relative Frobenius, step / epoch / key_seed
   equal, the leaves bit for bit counted); ``cli/post_train.py
   --compact_train`` for 1 epoch (per step K1 and K2 12 + the kept blocks,
   A2 and A6 the kept blocks), its dense-layout checkpoint's pruned
   coordinates bit for bit stage 1's; and ``cli/export_compact.py`` at
   token ratio 0.7, the file read back with the codec and 8 batches of 64
   served through ``apply_compact`` (K1 and K2 the kept blocks a batch)
   against ``eval_step``'s forward on the dense-layout params with their
   masks (within 2e-2).

13. baseline suite -- the baseline-pruning suite through its CLIs, in this
   process, in a temporary directory, on DeiT-Small at full width and
   depth (1000 classes) with seeded random weights written as a timm
   ``.pth`` by ``models/convert.py::to_torch_state_dict`` and read back bit
   for bit (``load_torch_checkpoint``, ``joint_train``'s ``load_params``):
   ``cli/generate_mask.py`` on ``--dataset synthetic`` at density 0.5 for
   mag (global and local), synflow (100 rounds at batch 1), taylor (4
   batches of 128) and sp (one batch of 128), each with its wall seconds,
   its remaining density against ``--sparsity`` and its exact launches
   (per scoring pass K1, K2, A2 and A6 12 each; 0 for mag); the scorers
   held at batch 8 in bf16 against the plain versions on the card (the
   four wrappers swapped for them): magnitude bit for bit, Taylor's scores
   within 2e-2 per leaf and its kept sets' Jaccard at least 0.99, SP's
   head and unit scores within 2e-2 and its masks equal in every layer
   whose cut the score differences cannot move, SynFlow's kernels no
   further from the f32 CPU plain path than 1.25 times the plain bf16
   versions at the first, middle and last round of the plain trajectory
   (each round's kernel vs plain scores and kept sets, and the two whole
   runs' overlap, recorded: bf16 SynFlow is ill-conditioned, see
   SYNFLOW_F32_RATIO); against the f32 CPU plain path
   each type's overlap recorded (SynFlow at depth 4 when its 100 rounds
   would take over 60 s there); ``cli/baseline_train.py`` from the
   ``.pth`` on ``--dataset procedural`` (10 classes: the head
   re-initialised), batch 64, 12 steps an epoch, 8 eval batches: 2
   epochs with a magnitude mask and EMA (per step A7 forward and
   backward 12, per eval batch K1 and K2 12), its epoch img/s beside
   phase 6's step alone and the loader's host ms a batch, AdamW's moments
   exactly 0 at every masked coordinate of its checkpoint, a resume from
   epoch 0 whose epoch-1 checkpoint is bit for bit the first run's, a GMP
   run whose two pruning events follow ``cubic_sparsity``, and
   ``--eval --resume`` at the run's own epoch-1 accuracy; then
   ``cli/show_gradient_sparsity.py`` over 4 batches of 64 (K1, K2, A2,
   A6 48 each).

14. other backbones -- (a) R50-ViT-B/16 at full width and depth (the
   (3, 4, 9) ResNetV2 stem at width 1, 12 blocks of 768, 12 heads of 64,
   F 3072, 224 px, 1000 classes) with seeded weights written as an
   upstream ``.npz`` (all 16 stem units) and read back through
   ``load_npz_checkpoint`` equal to what was written: the stage-1 step
   with phase 5's flagship settings and the same weights as a dense
   teacher at batch 64 (3 untimed + 10 timed steps, per step K1 24, K2 12,
   K3 12, A2 12, A4 12; a profiled step), one step at depth 2 and batch 2
   (the full stem at 224 px) on the card against the CPU plain path; a
   seeded discovered architecture on the trained weights (3 of 12 heads
   off each layer, half the units, blocks 3 and 8 gated off) served
   through ``compact_model`` + ``apply_compact`` at token ratio 0.7 and
   through ``eval_step`` (5 passes of 4 batches of 64, exact launches),
   compact vs masked dense; the dense stage-2 step and compact_ft (1 +
   3 steps each, exact launches; compact_ft's padding and v-masked
   coordinates exactly 0) and one step of each from one state.  (b)
   CaiT-S24-224 (24 blocks of 384, 8 heads of 48, 2 class-attention
   blocks): ``cli/generate_mask.py --type mag`` at density 0.5 on seeded
   weights, then phase 6's baseline fine-tune under that mask (3 untimed
   + 10 timed steps, no kernel launched: the talking heads are a
   composition; AdamW's moments exactly 0 at every masked coordinate; a
   profiled step; one batch-8 step at depth 2 against the CPU plain path)
   and the eval step's img/s.  (c) ``cli/post_train.py`` from a
   reference-layout torch stage-1 ``.pth.tar`` (DeiT-Small with phase 11's
   architecture, a ``*.mask`` buffer on every weighted module): the masks
   it reads bit for bit the masks written, 1 epoch of 4 steps with exact
   launches, AdamW's first moment exactly 0 at every coordinate the masks,
   the pruned heads and the skipped blocks freeze.
15. data parallelism -- (a) two ranks on the one card over gloo (NCCL
   takes one rank a GPU), each ``python -m uvc_tpu_torch.parallel.dryrun``
   on spec files: DeiT-Small at full width, a global batch of 64 (32 a
   rank), stage 1 with the flagship settings (1 warmup and 4 UVC steps,
   mixup off), one stage-1 step with mixup / cutmix (the partners the
   flipped global batch's, across the ranks), one step each of stage 2,
   compact_ft (phase 11's architecture) and the baseline fine-tune
   (drop-path, random erasing, mixup): after every step the ranks' states
   bit for bit equal, loss / grad_norm / resource within 2e-2 of this
   process's single-process run on the concatenated batch, each rank's
   launches exact, the gloo all-reduce's time a step.  (b)
   ``joint_train`` under NCCL at world size 1, started as torchrun starts
   a rank: phase 12's run with its checkpoints and exact launches, the
   all-reduce's host and device time a step, the epoch rates beside phase
   12's, and the stage-1 step alone with and without the mesh, in turns.
16. serving export -- phase 4's DeiT-Small and phase 7's T2T-ViT-14
   compact models (bf16) exported through ``torch.export`` at batches 8
   and 64 (``infer/export.py::export_serving``; K1, K2 and the performer
   forward are the operators ``uvc_tpu_torch.layer_attention_ln``,
   ``mlp_ln`` and ``performer``), saved, then loaded and served in a
   fresh interpreter that imports ``uvc_tpu_torch.infer.export`` alone
   (no ``models``, ``infer.compact``, ``train`` or JAX module): its logits
   against ``apply_compact``'s at the same batch, bit for bit or within
   2e-2, a batch of 5 padded to 8, its launches a batch equal to
   ``apply_compact``'s (DeiT-Small K1 10 and K2 10; T2T-ViT-14
   ``performer`` 2, K1 12, K2 12); the export seconds, the artifact's MiB,
   and the artifact's img/s beside ``apply_compact``'s over the same
   windows, in turns.  Phase 12's ``export_compact`` also writes the
   artifact (``--export_stablehlo``) and serves its batches through it.
17. tensor parallelism -- four ranks on the one card over gloo at 2 dp x
   2 mp (``make_mesh``: rank r at (r // 2, r % 2)), each holding its
   shard of the blocks' qkv / proj / fc1 / fc2 leaves: phase 15's
   DeiT-Small specs (global batch 64) of stage 1 (1 warmup and 4 UVC
   steps), dense stage 2 and the baseline fine-tune with EMA; after every
   step the four ranks' gathered states bit for bit equal, the metrics and
   the whole params within 2e-2 of this process's single-process run,
   each rank's tensor-parallel leaves half their bytes, each rank's
   launches exactly one process's at batch 32 (a stage-1 step: K1 24, K2
   12, K3 12, A2 12, A4 12), the all-gather's and the all-reduce's ms a
   step; compact stage 2 at mp 2 raising ``ValueError``.
18. evidence harnesses -- ``uvc_tpu_torch/scripts/e2e_accuracy.py`` and
   ``scripts/trajectory_fidelity.py`` through their ``run`` functions in
   this process, on DeiT-Tiny (distilled) at 64 px at full width and depth
   (12 blocks of 192, 3 heads of 64, F 768), at a cut horizon: e2e at
   batch 128, 8 batches an epoch, a 1-epoch dense pretrain extended once
   while below its target, stage 1 of 2 epochs (1 warmup) with token
   selection, stage 2 of 1 epoch, compaction and slimmed serving over 2
   eval batches; fidelity at its ``UVC_FID_SMOKE`` sizes (2 batches of 8
   an epoch), both scenarios.  Held: each training step's launches exact
   (a distilling step K1 24, K2 12, K3 12, A2 12, A4 12; a pretrain step,
   which runs no teacher, K1 12, K3 12, A2 12, A4 12); every logged
   metric finite; each FLOPs series one entry an epoch; the compact
   model's full-token logits within 2e-2 of the masked-dense forward at
   the same frozen decision; z, y, p, s >= 0 at the end (gates T5, B5);
   each record written with the JAX harness's keys.  Printed, not gated:
   each gate at the cut horizon, each stage's wall seconds, each kind of
   step's median host ms, the two loaders' host ms a batch at 128, and
   the e2e stage 1 run again on the CPU plain path in f32 from the same
   weights, batches and draws against the card's (FLOPs reports, minimax
   state, params).
19. real images -- the input path on real image files, each part in a
   child process whose first line makes PIL unimportable: (a)
   ``tests/image_check.py`` recomputes every record of
   ``tests/fixtures/images/digests.json`` (each fixture's decode, the PIL
   path's and the native path's train and eval crops at 224 px, both
   filters, and RandAugment's 15 ops at 5 levels, colour jitter and the
   whole policy on one crop) and holds it to the digest of PIL and the JAX
   package, bit for bit (a crop that differs is printed with the box this
   host drew beside the recorded one); (b) ``cli/joint_train.py --dataset
   imagenet`` on a folder of fixture symlinks in 4 class folders (768
   train files, all six photo-sized JPEGs ``imagenet_*.jpg``, 500x375 to
   333x500 as ImageNet's, so that the times are a real file's; 128 val
   files, every fixture: each JPEG kind, PNG, BMP, which the native path
   hands to the PIL path's decoder) on DeiT-Small at 224 px, batch 64, one
   stage-1 epoch of 12 steps and its validation, four runs in turns on
   the native path and with ``native_loader.available`` off (native, PIL,
   PIL, native), launches exact (per
   step K1 24, K2 12, K3 12, A2 12, A4 12; per eval batch K1 12, K3 12),
   the epoch's img/s, the folder loader's host ms a batch, the eval
   accuracy finite; (c) ``cli/baseline_train.py`` on the folder with
   ``--aa rand-m9-mstd0.5-inc1 --train-interpolation bicubic``, 12 steps
   (A7 12 forward and 12 backward a step), img/s and RandAugment's host
   ms a batch; (d) ``--dataset cifar10 --img_size 224`` on CIFAR-layout
   pickles written here, 4 steps, launches exact; (e)
   ``uvc_tpu_torch/scripts/data_bench.py`` at 2 batches of 256 on the
   photo-sized JPEGs.
20. config and event files -- ``--config`` and ``--enable_writer 1`` on
   the card's machine, in a child process whose first lines make yaml,
   tensorboard (``torch.utils.tensorboard`` with it) and protobuf
   unimportable: ``cli/joint_train.py -c args.yaml --enable_writer 1``, a
   timm-style file written here (a block sequence, null, a bool, a quoted
   numeric string, ``1.0e-04`` and ``1e-4``) on DeiT-Small at 224 px,
   batch 64 (the command line's, over the file's 32), procedural data, one
   warmup and one stage-1 epoch of 12 steps and their validations (per
   step K1 24, K2 12, K3 12, A2 12, A4 12; per eval batch K1 12, K3 12);
   the file's values read back from the run's printed parameters; the
   event file read by ``tests/event_check.py`` (both CRCs of every record)
   and every float scalar of ``metrics.jsonl`` found there in order, at
   its step, equal to its float32; each epoch's img/s beside phase 12's;
   then ``cli/baseline_train.py -c ... --enable_writer 1`` for 4 steps (A7
   12 forward and 12 backward a step), its event file the header alone.

The last three lines are the card's name and power limit as nvidia-smi
reports them, one JSON object of per-kernel numbers (each kernel at the
shape of the path that launches it most: K1 and K3 at "eval", K2 at
"compact", A7's forward at "dense", the sublayer backward kernels at
"train", the performer kernels at "t2t_stage1", the attention core at
"se", A8 at "vit_h"; its other shapes under "other_shapes"), and
``{"ok": true, "device": {...}}``.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
# kernel vs plain, both bf16 on the card: they differ only by f32
# summation order, i.e. by one-ulp bf16 flips of single outputs
# (2**-8 relative each), so the relative Frobenius error stays far below
# 1e-2 and no output moves by more than 2 ulp of the largest one (1/64).
KERNEL_REL_TOL = 1e-2
KERNEL_MAX_TOL = 1.0 / 64
# whole-model logits, bf16 residual stream through 10-12 blocks: compact vs
# masked dense differ only by exact zeros, card vs CPU by summation order
MODEL_REL_TOL = 2e-2

N_BATCHES, BATCH, TOKEN_RATIO = 8, 64, 0.7
# tokens entering the blocks after the physical token drop: the class
# token and the top int(0.7 * 196) patches
N_KEPT = 1 + int(TOKEN_RATIO * 196)
N_PASSES = 5
SKIPPED_BLOCKS = (3, 8)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def rel_err(out, ref):
    out, ref = out.float(), ref.float()
    return ((out - ref).norm() / ref.norm()).item(), \
        (out - ref).abs().max().item()


def digest(outs):
    """The first 12 hex digits of the SHA-256 of the outputs' bits."""
    h = hashlib.sha256()
    for o in outs:
        h.update(o.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:12]


# cycles of the kernel that holds the card while the timed calls queue up
# behind it (~50 ms, longer than the host takes to issue them)
QUEUE_CYCLES = 100_000_000


def time_ms(fn, iters):
    """Device time of one call of fn, in ms: the calls queue up behind a
    sleeping kernel and then run back to back, so events around them time
    the card alone and not the host's cost per call (checks, allocation,
    launches), which exceeds the device time of the small kernels."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device) if torch.is_tensor(tree) else tree


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernels
# ---------------------------------------------------------------------------


def _inputs(gen, b, n, dm, heads, f, dh=64):
    def rn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * std).to(dtype)

    def keep(k):
        return (torch.rand(k, generator=gen, device="cuda") > 0.25).to(
            torch.bfloat16)

    da = dh * heads
    return dict(
        x=rn(b, n, dm), xin=rn(b, n, dm),
        g=1 + rn(dm, std=0.1, dtype=torch.float32),
        b=rn(dm, std=0.1, dtype=torch.float32),
        wqkv=rn(dm, 3 * da, std=dm ** -0.5), bqkv=rn(3 * da, std=0.1),
        wproj=rn(da, dm, std=da ** -0.5), bproj=rn(dm, std=0.1),
        amask=keep(da),
        w1=rn(dm, f, std=dm ** -0.5), b1=rn(f, std=0.1),
        w2=rn(f, dm, std=f ** -0.5), b2=rn(dm, std=0.1), fmask=keep(f),
        d=torch.tensor([0.25, 0.75], device="cuda"),
        heads=heads, dh=dh)


def _library_attention(t, eps):
    """One PyTorch composition of the attention sublayer (yardstick)."""
    x = t["x"]
    b, n, dm = x.shape
    heads, dh = t["heads"], t["dh"]
    wqkv_t, wproj_t = t["wqkv"].t().contiguous(), t["wproj"].t().contiguous()

    def run():
        a = F.layer_norm(x.float(), (dm,), t["g"], t["b"], eps).to(x.dtype)
        qkv = F.linear(a, wqkv_t, t["bqkv"])
        q, k, v = qkv.view(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
        ctx = F.scaled_dot_product_attention(q, k, v, scale=dh ** -0.5)
        ctx = ctx.transpose(1, 2).reshape(b, n, dh * heads) * t["amask"]
        return x + F.linear(ctx, wproj_t, t["bproj"])
    return run


def _library_sublayer(t):
    """One PyTorch composition of the bare attention sublayer (no
    LayerNorm, no residual): the yardstick of kernel A7."""
    x = t["x"]
    b, n, dm = x.shape
    heads, dh = t["heads"], t["dh"]
    wqkv_t, wproj_t = t["wqkv"].t().contiguous(), t["wproj"].t().contiguous()

    def run():
        qkv = F.linear(x, wqkv_t, t["bqkv"])
        q, k, v = qkv.view(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
        ctx = F.scaled_dot_product_attention(q, k, v, scale=dh ** -0.5)
        ctx = ctx.transpose(1, 2).reshape(b, n, dh * heads) * t["amask"]
        return F.linear(ctx, wproj_t, t["bproj"])
    return run


def _library_mlp(t, eps, blend):
    x = t["x"]
    dm = x.shape[-1]
    w1_t, w2_t = t["w1"].t().contiguous(), t["w2"].t().contiguous()

    def run():
        a = F.layer_norm(x.float(), (dm,), t["g"], t["b"], eps).to(x.dtype)
        h = F.gelu(F.linear(a, w1_t, t["b1"])) * t["fmask"]
        out = x + F.linear(h, w2_t, t["b2"])
        if blend:
            out = t["d"][1] * out + t["d"][0] * t["xin"]
        return out
    return run


# (B, N, dm, heads, F, head dim, the kernels held there): the serving
# paths' shapes; ViT-H/14's stage 1 (K1 in student and teacher, K2 in the
# teacher, K3 in the student; A7's forward in a part-gated student); the
# sublayers at head dim 12 (t2t_vit_14_resnext) and at head dim 80 at a
# width the fused backward takes ("h80"); A7's forward at N = 1025
# ("long")
ALL_FWD = ("layer_attention_ln", "layer_attention", "mlp_ln", "mlp_ln_blend")
FWD_SHAPES = {
    "eval": (BATCH, N_KEPT, 384, 6, 1536, 64, ALL_FWD),
    "compact": (BATCH, N_KEPT, 384, 3, 768, 64, ALL_FWD),
    "dense": (BATCH, 197, 384, 6, 1536, 64, ALL_FWD),
    "vit_h": (32, 257, 1280, 16, 5120, 80, ALL_FWD),
    "resnext": (BATCH, 197, 384, 32, 1152, 12,
                ("layer_attention_ln", "layer_attention")),
    "h80": (8, 257, 640, 8, 2560, 80, ("layer_attention_ln",
                                       "layer_attention")),
    # A7's forward past the 624 keys that its staged core once held at
    # head dim 80
    "long": (4, 1025, 1280, 16, 5120, 80, ("layer_attention",)),
    # SynFlow's scoring pass on DeiT-Small: one all-ones image
    "synflow": (1, 197, 384, 6, 1536, 64, ("layer_attention_ln", "mlp_ln")),
    # R50-ViT-B/16's blocks (phase 14): dm 768, 12 heads of 64, F 3072
    "vit_b": (BATCH, 197, 768, 12, 3072, 64,
              ("layer_attention_ln", "mlp_ln", "mlp_ln_blend")),
    # DeiT-Tiny at 64 px (phase 18's harnesses), batch 128: N 18 (16
    # patches, cls and dist), dm 192, 3 heads of 64, F 768 (K1 and K3 in
    # the student, K1 and K2 in the teacher); N 13 after the token ratio
    # 0.7 (stage 2's student, the masked-dense eval); a compacted layer,
    # 2 heads (da 128) and fk 384, as the slimmed serving runs it
    "tiny": (128, 18, 192, 3, 768, 64,
             ("layer_attention_ln", "mlp_ln", "mlp_ln_blend")),
    "tiny_slim": (128, 13, 192, 3, 768, 64,
                  ("layer_attention_ln", "mlp_ln_blend")),
    "tiny_compact": (128, 13, 192, 2, 384, 64,
                     ("layer_attention_ln", "mlp_ln")),
}
# the shapes that the parent commit's kernels take as well (head dim 64):
# ``--digests`` holds the kernels there only, so that the same script can
# run in a checkout of the parent
PARENT_SHAPES = ("eval", "compact", "dense", "train", "ragged", "se",
                 "dense_odd", "dense_wide", "compact_ft", "one_head",
                 "stage2", "stage2_skip", "t2t_compact", "t2t_stage2",
                 "t2t_stage2_skip", "synflow")


def kernel_phase(eps, digests_only=False, refused_ok=False, only=None):
    from uvc_tpu_torch.ops.attention import (layer_attention,
                                             layer_attention_ln,
                                             layer_attention_ln_plain,
                                             layer_attention_plain)
    from uvc_tpu_torch.ops.mlp import (mlp_ln, mlp_ln_blend,
                                       mlp_ln_blend_plain, mlp_ln_plain)

    gen = torch.Generator(device="cuda").manual_seed(1)
    results = {}
    for shape, (b, n, dm, heads, f, dh, kernels) in FWD_SHAPES.items():
        if (digests_only and shape not in PARENT_SHAPES) or (
                only and shape not in only):
            continue
        t = _inputs(gen, b, n, dm, heads, f, dh)
        x = t["x"]
        da = dh * heads
        rows = b * n
        akw = dict(num_heads=heads, scale=dh ** -0.5, eps=eps)
        aargs = (x, t["g"], t["b"], t["wqkv"], t["bqkv"], t["wproj"],
                 t["bproj"], t["amask"])
        sargs = (x, t["wqkv"], t["bqkv"], t["wproj"], t["bproj"], t["amask"])
        skw = dict(num_heads=heads, scale=dh ** -0.5)
        margs = (t["g"], t["b"], t["w1"], t["b1"], t["w2"], t["b2"],
                 t["fmask"])
        act = rows * dm * 2
        a_bytes = (2 * act + 2 * dm * 4 + (4 * da * dm + 3 * da + dm + da)
                   * 2)
        a_flops = (2 * rows * dm * 3 * da + 4 * b * heads * n * n * dh
                   + 2 * rows * da * dm)
        m_bytes = 2 * act + 2 * dm * 4 + (2 * dm * f + 2 * f + dm) * 2
        m_flops = 4 * rows * dm * f
        cases = {
            "layer_attention_ln": (
                lambda: layer_attention_ln(*aargs, **akw),
                lambda: layer_attention_ln_plain(*aargs, **akw),
                _library_attention(t, eps), a_flops, a_bytes),
            # A7: no LayerNorm parameters to read
            "layer_attention": (
                lambda: layer_attention(*sargs, **skw),
                lambda: layer_attention_plain(*sargs, **skw),
                _library_sublayer(t), a_flops, a_bytes - 2 * dm * 4),
            "mlp_ln": (
                lambda: mlp_ln(x, *margs, eps=eps),
                lambda: mlp_ln_plain(x, *margs, eps=eps),
                _library_mlp(t, eps, blend=False), m_flops, m_bytes),
            "mlp_ln_blend": (
                lambda: mlp_ln_blend(x, t["xin"], t["d"], *margs, eps=eps),
                lambda: mlp_ln_blend_plain(x, t["xin"], t["d"], *margs,
                                           eps=eps),
                _library_mlp(t, eps, blend=True), m_flops, m_bytes + act + 8),
        }
        for name in kernels:
            kern, plain, library, flops, nbytes = cases[name]
            try:
                out = kern()
            except ValueError as e:
                if not refused_ok:
                    raise
                print(f"kernel {name:18s} [{shape:7s}] refused: {e}",
                      flush=True)
                continue
            torch.cuda.synchronize()
            check(torch.equal(kern(), out),
                  f"{name} [{shape}]: two launches differ")
            ref = plain()
            rel, mx = rel_err(out, ref)
            max_tol = KERNEL_MAX_TOL * ref.float().abs().max().item()
            check(torch.isfinite(out).all().item(),
                  f"{name} [{shape}]: non-finite output")
            check(rel <= KERNEL_REL_TOL and mx <= max_tol,
                  f"{name} [{shape}]: kernel vs plain rel_fro {rel:.3e} "
                  f"(tol {KERNEL_REL_TOL}), max_abs {mx:.3e} "
                  f"(tol {max_tol:.3e})")
            if digests_only:
                print(f"kernel {name:18s} [{shape:7s}] rel_fro={rel:.2e} "
                      f"digest={digest([out])}", flush=True)
                continue
            bound_ms, bound_by = bound(flops, nbytes)
            r = dict(shape=shape, rel_fro=rel, max_abs_err=mx,
                     ms=time_ms(kern, 50), plain_ms=time_ms(plain, 10),
                     library_ms=time_ms(library, 50), bound_ms=bound_ms,
                     bound_by=bound_by, flops=flops, bytes=nbytes)
            results[(name, shape)] = r
            print(f"kernel {name:18s} [{shape:7s} B={b} N={n} dm={dm} "
                  f"da={da} H={heads} dh={dh} F={f}] rel_fro={rel:.2e} "
                  f"max_abs={mx:.2e} (tol {KERNEL_REL_TOL:g} / "
                  f"{max_tol:.2e}) ms={r['ms']:.4f} "
                  f"plain_ms={r['plain_ms']:.4f} "
                  f"library_ms={r['library_ms']:.4f} "
                  f"bound={bound_ms * 1e3:.1f}us ({bound_by}) two launches "
                  f"bit-identical digest={digest([out])}", flush=True)
    return results


# The forward kernels profiled launch by launch: each kernel's label, its
# launches in their order, and the shapes at which one call is profiled,
# each with the blocks of the model that runs the kernel there (ViT-H/14:
# 32, DeiT-Small: 12, a part-gated DeiT-Small for A7's forward), whose
# weights are each block's own
FWD_BREAKDOWNS = {
    "layer_attention_ln": ("K1", ("layer norm", "qkv GEMM", "core",
                                  "projection GEMM"),
                           {"vit_h": 32, "eval": 12}),
    "mlp_ln": ("K2", ("layer norm", "fc1 GEMM", "fc2 GEMM"),
               {"vit_h": 32, "eval": 12}),
    "mlp_ln_blend": ("K3", ("layer norm", "fc1 GEMM", "fc2 GEMM"),
                     {"vit_h": 32, "eval": 12}),
    "layer_attention": ("A7 forward", ("qkv GEMM", "core",
                                       "projection GEMM"),
                        {"dense": 12, "h80": 12}),
}


def _host_us(calls):
    """The host's time to issue ``calls`` back to back, over their number,
    in us: the median of 5 runs (and the runs)."""
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for call in calls:
            call()
        host.append((time.perf_counter() - t0) / len(calls) * 1e6)
        torch.cuda.synchronize()
    return sorted(host)[len(host) // 2], host


def _kernel_name(event):
    """A profiler event's kernel name without its return type, namespace and
    parameter list (its template arguments kept)."""
    name = event.name.split("(")[0]
    return name.replace("void ", "").replace("uvc::", "")


def _period(names, calls):
    """The launches of one call: the least p for which the last calls * p
    kernel names repeat with period p, or None."""
    for p in range(1, len(names) // calls + 1):
        tail = names[len(names) - calls * p:]
        if all(a == b for a, b in zip(tail, tail[p:])):
            return p
    return None


def launch_breakdown(label, shape, run, card, names=None, gemm_flops=(),
                     calls=10):
    """The device time of each launch of one call of ``run``
    (torch.profiler over ``calls`` + 1 calls, the device events taken in
    their order, those of the last ``calls`` calls kept: the profiler now
    and then drops an event, most often the window's first), each under
    its label in ``names`` or, where those are not given or the call
    launches another number of kernels (another tree's sequence), under
    the kernel's own name; the GEMM launches (kernels named ``gemm``, or
    cuBLAS's ``nvjet``) with their rates, ``gemm_flops`` giving their
    operations in launch order.
    Prints one line and returns the times in ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls + 1):
                run()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and e.device_time_total > 0),
                     key=lambda e: e.time_range.start)
        per = _period([_kernel_name(e) for e in evs], calls)
        if per:
            break
    check(per, f"{label} [{shape}]: {len(evs)} device events in "
          f"{calls + 1} calls repeat with no period")
    evs = evs[len(evs) - calls * per:]
    ms = [sum(evs[per * c + i].device_time_total for c in range(calls))
          / calls / 1e3 for i in range(per)]
    kernels = [_kernel_name(evs[i]) for i in range(per)]
    labels = list(names) if names and len(names) == per else kernels
    gemms = [i for i, k in enumerate(kernels)
             if "gemm" in k or "nvjet" in k]
    rates = {i: f / ms[i] / 1e9 for i, f in zip(gemms, gemm_flops)}
    print(f"{label} launches [{shape}, one call]: " + ", ".join(
        f"{lab} {t:.4f} ms"
        + (f" ({rates[i]:.0f} TFLOP/s)" if i in rates else "")
        for i, (lab, t) in enumerate(zip(labels, ms)))
        + f" (sum {sum(ms):.4f}) [{card}]", flush=True)
    return ms


def _fwd_calls(name, t, eps, stream):
    """One forward kernel's calls at the inputs ``t``: (the names of the
    weights that each block owns, a maker of wrapper calls and one of calls
    of the library's entry point alone on fixed scratch, each taking the
    block's weights, and the operations of the kernel's GEMMs in launch
    order, and, for K1 and K2, whose wrappers go through a dispatcher
    operator, a maker of calls of the operator's CUDA implementation
    alone: the wrapper as it was before the operator)."""
    from uvc_tpu_torch.ops import _cuda
    from uvc_tpu_torch.ops import attention as tatt
    from uvc_tpu_torch.ops import mlp as tmlp
    from uvc_tpu_torch.ops.attention import layer_attention, layer_attention_ln
    from uvc_tpu_torch.ops.mlp import mlp_ln, mlp_ln_blend

    x = t["x"]
    b, n, dm = x.shape
    heads, dh = t["heads"], t["dh"]
    da, rows, f = heads * dh, b * n, t["w1"].shape[1]
    scale = dh ** -0.5

    def empty(*widths):
        return [torch.empty(rows, w, dtype=torch.bfloat16, device="cuda")
                for w in widths] + [torch.empty_like(x)]

    def ptrs(*ts):
        return [a.data_ptr() for a in ts]

    if name in ("mlp_ln", "mlp_ln_blend"):
        lib, scratch = _cuda.library("mlp"), empty(dm, f)
        keys = ("w1", "b1", "w2", "b2")
        # K3 (mlp_ln_blend) takes the block's input xin and the gating
        # distribution d after x
        blend = (t["xin"], t["d"]) if name == "mlp_ln_blend" else ()
        fn, c_fn = ((mlp_ln_blend, lib.uvc_mlp_ln_blend) if blend
                    else (mlp_ln, lib.uvc_mlp_ln))

        def call(w):
            return lambda: fn(x, *blend, t["g"], t["b"], w["w1"], w["b1"],
                              w["w2"], w["b2"], t["fmask"], eps=eps)

        def entry(w):
            args = (*ptrs(x, *blend, t["g"], t["b"], w["w1"], w["b1"],
                          w["w2"], w["b2"], t["fmask"], *scratch), rows, dm,
                    f, float(eps), stream)
            return lambda: c_fn(*args)

        def impl(w):
            return lambda: tmlp._mlp_ln_cuda(
                x, t["g"], t["b"], w["w1"], w["b1"], w["w2"], w["b2"],
                t["fmask"], float(eps))
        return (keys, call, entry, (2 * rows * dm * f, 2 * rows * f * dm),
                None if blend else impl)

    lib = _cuda.library("attention")
    keys = ("wqkv", "bqkv", "wproj", "bproj")
    flops = (2 * rows * dm * 3 * da, 2 * rows * da * dm)
    if name == "layer_attention_ln":
        scratch = empty(dm, 3 * da, da)

        def call(w):
            return lambda: layer_attention_ln(
                x, t["g"], t["b"], w["wqkv"], w["bqkv"], w["wproj"],
                w["bproj"], t["amask"], num_heads=heads, scale=scale,
                eps=eps)

        def entry(w):
            args = (*ptrs(x, t["g"], t["b"], w["wqkv"], w["bqkv"],
                          w["wproj"], w["bproj"], t["amask"], *scratch),
                    b, n, dm, da, heads, float(scale), float(eps), stream)
            return lambda: lib.uvc_layer_attention_ln(*args)

        def impl(w):
            return lambda: tatt._layer_attention_ln_cuda(
                x, t["g"], t["b"], w["wqkv"], w["bqkv"], w["wproj"],
                w["bproj"], t["amask"], heads, float(scale), float(eps))
        return keys, call, entry, flops, impl

    scratch = empty(3 * da, da)

    def call(w):
        return lambda: layer_attention(
            x, w["wqkv"], w["bqkv"], w["wproj"], w["bproj"], t["amask"],
            num_heads=heads, scale=scale)

    def entry(w):
        args = (*ptrs(x, w["wqkv"], w["bqkv"], w["wproj"], w["bproj"],
                      t["amask"], *scratch), b, n, dm, da, heads,
                float(scale), stream)
        return lambda: lib.uvc_layer_attention(*args)
    return keys, call, entry, flops, None


def _print_host(what, shape, calls, host, card):
    print(f"{what} host time of one call [{shape}, {calls} calls]: "
          + ", ".join(f"{way} {med:.1f} us (runs "
                      + ", ".join(f"{h:.1f}" for h in runs) + ")"
                      for way, (med, runs) in host.items())
          + f" [{card}]", flush=True)


def forward_breakdowns(eps, card, calls=10):
    """K1's, K2's and A7's forward launches one by one
    (``launch_breakdown``) at the shapes of FWD_BREAKDOWNS, with their
    GEMMs' rates, and the host time of one call issued as a model step
    issues them: each block with its own weights, two calls a block
    (student and teacher, or forward and a second pass), so that no tensor
    map of a weight is met again before every other block's has been;
    beside it, the same number of calls on one block's weights; and at the
    shapes where K1 and K2 both run, the two interleaved block by block as
    a forward pass issues them; and the yardstick of A7's forward, the
    library composition, launch by launch beside it.  The host time is
    taken of the wrapper (checks, allocation, the library call) and of the
    library's entry point alone on fixed scratch (the tensor maps and the
    launches), whose runs spread far less; for K1 and K2 also of the
    operator's CUDA implementation called directly ("no operator": the
    wrapper without the dispatcher's route through
    ``uvc_tpu_torch.layer_attention_ln`` / ``mlp_ln``), so that the row
    shows what the operator adds to a call."""
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(3)
    made = {}
    for name, (label, launches, shapes) in FWD_BREAKDOWNS.items():
        for shape, blocks in shapes.items():
            b, n, dm, heads, f, dh, _ = FWD_SHAPES[shape]
            t = _inputs(gen, b, n, dm, heads, f, dh)
            keys, call, entry, flops, impl = _fwd_calls(name, t, eps,
                                                        stream)
            ways = (("wrapper", call),) + (
                (("no operator", impl),) if impl else ()) + (
                ("entry", entry),)
            launch_breakdown(label, shape, call(t), card, launches, flops,
                             calls)
            if name == "layer_attention":
                # the yardstick's launches: what the library does faster
                launch_breakdown(f"{label}'s library", shape,
                                 _library_sublayer(t), card, None, flops,
                                 calls)
            own = [{k: t[k].clone() for k in keys} for _ in range(blocks)]
            for what, ws in ((f"{blocks} blocks' own weights", own),
                             ("one block's weights", [t] * blocks)):
                host = {}
                for way, make in ways:
                    cs = [make(w) for w in ws]
                    warm = [c() for c in cs]
                    check(way != "entry" or not any(warm),
                          f"{label} [{shape}]: the entry point returned "
                          f"{warm}")
                    host[way] = _host_us(cs * 2)
                _print_host(f"{label} ({what})", shape, 2 * blocks, host,
                            card)
            made[name, shape] = (dict(ways), own)
    # K1 and K2 block by block, as a forward pass issues them, each on its
    # library's cache of tensor maps
    for shape, blocks in FWD_BREAKDOWNS["mlp_ln"][2].items():
        k1, k2 = made["layer_attention_ln", shape], made["mlp_ln", shape]
        host = {}
        for way in ("wrapper", "no operator", "entry"):
            cs = [c for w1, w2 in zip(k1[1], k2[1])
                  for c in (k1[0][way](w1), k2[0][way](w2))]
            for c in cs:
                c()
            host[way] = _host_us(cs * 2)
        _print_host(f"K1 + K2 interleaved ({blocks} blocks' own weights)",
                    shape, 4 * blocks, host, card)


# A2's and A7's backward launches in their order: sublayer_bwd's eleven
# (csrc/attention.cu) inside A2's LayerNorm pass and LN backward (whose
# pass over do gives dbproj), and before A7's dbproj column sums and dx
# product
SUBLAYER_BWD_LAUNCHES = (
    "qkv GEMM", "t GEMM", "core q", "core kv", "dmask sum", "dWqkv GEMM",
    "dWqkv sum", "dWproj GEMM", "dWproj sum", "dbqkv colsum", "dbqkv sum")
LN_BWD_LAUNCHES = ("LN backward", "LN sums", "LN finish")
A2_LAUNCHES = (("layer norm",) + SUBLAYER_BWD_LAUNCHES + ("d a_in GEMM",)
               + LN_BWD_LAUNCHES)
A7_BWD_LAUNCHES = SUBLAYER_BWD_LAUNCHES + ("dbproj colsum", "dbproj sum",
                                           "dx GEMM")
# A6's and A4's (csrc/mlp.cu::mlp_backward), where the weight gradients
# are split over the rows (at "vit_h" they are not: no sums, the breakdown
# then goes by the kernels' names)
MLP_BWD_LAUNCHES = (
    "layer norm", "h and dam0 GEMMs + act", "dmask sum", "db1 sum",
    "dW2 GEMM", "dW2 sum", "dW1 GEMM", "dW1 sum", "dmi GEMM") \
    + LN_BWD_LAUNCHES


def _breakdown_or_refused(refused_ok, label, shape, *args):
    """``launch_breakdown``, or with ``refused_ok`` a line saying that the
    kernel refuses the shape (an older tree's wrapper raising ValueError)."""
    try:
        launch_breakdown(label, shape, *args)
    except ValueError as e:
        if not refused_ok:
            raise
        print(f"{label} launches [{shape}]: refused: {e}", flush=True)


def sublayer_bwd_breakdown(eps, card, refused_ok=False):
    """A2's and A7's backward launch by launch (``launch_breakdown``) at
    every shape of BWD_SHAPES that holds them, with the five GEMMs' rates
    (in launch order: the qkv recompute, t = do . Wproj^T, dWqkv, dWproj,
    d a_in or dx); A6's and A4's at "train" and "vit_h", with theirs (h and
    dam0 in one launch, dW2, dW1, dmi) and the LayerNorm backward's
    time."""
    from uvc_tpu_torch.ops.attention import (layer_attention_bwd,
                                             layer_attention_ln_bwd)
    from uvc_tpu_torch.ops.mlp import mlp_ln_blend_bwd, mlp_ln_bwd

    gen = torch.Generator(device="cuda").manual_seed(4)
    for shape, (b, n, dm, heads, f, dh, kernels) in BWD_SHAPES.items():
        t = _inputs(gen, b, n, dm, heads, f, dh)
        do = (torch.randn(b, n, dm, generator=gen, device="cuda")
              * 0.1).to(torch.bfloat16)
        da, rows = heads * dh, b * n
        gemm_flops = tuple(2 * rows * dm * w for w in
                           (3 * da, da, 3 * da, da, 3 * da))
        skw = dict(num_heads=heads, scale=dh ** -0.5)
        if "layer_attention_ln_bwd" in kernels:
            _breakdown_or_refused(
                refused_ok, "A2", shape, lambda: layer_attention_ln_bwd(
                    t["x"], t["g"], t["b"], t["wqkv"], t["bqkv"], t["wproj"],
                    t["bproj"], t["amask"], do, eps=eps, **skw),
                card, A2_LAUNCHES, gemm_flops)
        if "layer_attention_bwd" in kernels:
            launch_breakdown(
                "A7 backward", shape, lambda: layer_attention_bwd(
                    t["x"], t["wqkv"], t["bqkv"], t["wproj"], t["bproj"],
                    t["amask"], do, **skw),
                card, A7_BWD_LAUNCHES, gemm_flops)
        if shape not in ("train", "vit_h"):
            continue
        margs = (t["g"], t["b"], t["w1"], t["b1"], t["w2"], t["b2"],
                 t["fmask"], do)
        # h and dam0 in one launch, then dW2, dW1, dmi
        mflops = (4 * rows * dm * f,) + (2 * rows * dm * f,) * 3
        _breakdown_or_refused(
            refused_ok, "A6", shape,
            lambda: mlp_ln_bwd(t["x"], *margs, eps=eps), card,
            MLP_BWD_LAUNCHES, mflops)
        _breakdown_or_refused(
            refused_ok, "A4", shape,
            lambda: mlp_ln_blend_bwd(t["x"], t["xin"], t["d"], *margs,
                                     eps=eps),
            card, MLP_BWD_LAUNCHES, mflops)


def core_bwd_breakdown(card):
    """A9's backward (``attention_bwd``) launch by launch
    (``launch_breakdown``, under the kernels' own names: the pack where the
    operands take it, the query side, the key side) at every shape of
    CORE_SHAPES, on contiguous heads and on head views of one packed
    buffer (``_packed_views``, the models' layout), and A8
    (``attention_bwd_ctx``) at BWD_CTX_SHAPES."""
    from uvc_tpu_torch.ops.attention import attention_bwd, attention_bwd_ctx

    gen = torch.Generator(device="cuda").manual_seed(18)
    for shape, (b, h, n, dh) in CORE_SHAPES.items():
        ops = [torch.randn(b, h, n, dh, generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(4)]
        views = _packed_views(*ops)
        scale = dh ** -0.5
        launch_breakdown("A9 backward", shape,
                         lambda: attention_bwd(*ops, scale), card)
        launch_breakdown("A9 backward on head views", shape,
                         lambda: attention_bwd(*views, scale), card)
        if shape in BWD_CTX_SHAPES:
            launch_breakdown("A8", shape,
                             lambda: attention_bwd_ctx(*ops, scale), card)


# backward kernels against their plain backwards at the stage-1 train shape
# and a ragged one (B*N = 591 rows, not a multiple of 8, as K of the weight
# gradient products): every output of the kernel against the plain version
# on the same inputs, both on the card.  They round at the same places and
# sum in another order: f32 partial sums over 128-row blocks and
# tensor-core tiles against PyTorch's reductions, so a bf16 intermediate
# (dctx, probs, ds, dqkv, am, dh) now and then rounds the other way and
# carries a one-ulp difference (2**-8 relative) into the sums after it.
# Each output's relative Frobenius error stays below 1e-2.
BWD_REL_TOL = 1e-2
# (B, N, dm, heads, F, head dim, the kernels held there)
ALL_BWD = ("layer_attention_ln_bwd", "layer_attention_bwd",
           "mlp_ln_blend_bwd", "mlp_ln_bwd")
BWD_SHAPES = {
    "train": (BATCH, 197, 384, 6, 1536, 64, ALL_BWD),
    "ragged": (3, 197, 384, 6, 1536, 64, ALL_BWD),
    "resnext": (BATCH, 197, 384, 32, 1152, 12,
                ("layer_attention_ln_bwd", "layer_attention_bwd")),
    "h80": (8, 257, 640, 8, 2560, 80,
            ("layer_attention_ln_bwd", "layer_attention_bwd")),
    # ViT-H/14's stage 1 (A2 and A4 in the student, A7's backward in a
    # part-gated one, A6 with block gating off): dm 1280, the LayerNorm
    # backward's widest
    "vit_h": (32, 257, 1280, 16, 5120, 80, ALL_BWD),
    # the stage-2 paths of phase 11, after the token drop (N 138), each
    # with its own seed: A2 at compact_ft's sliced attention widths, da 192
    # (3 heads) and 64 (one head) below dm 384; A6 at a compact layer's
    # padded width, W1 / b1 / W2 zero past its 700 kept units and an
    # all-ones mask, whose padding slots must get exactly zero gradients;
    # A4 with the frozen gating's one-hot d, a kept block (0, 1) and a
    # skipped one (1, 0), whose gradients into the block must be exactly 0
    "compact_ft": (BATCH, N_KEPT, 384, 3, 768, 64,
                   ("layer_attention_ln_bwd", "mlp_ln_bwd"),
                   dict(seed=31, units=700)),
    "one_head": (BATCH, N_KEPT, 384, 1, 768, 64,
                 ("layer_attention_ln_bwd",), dict(seed=32)),
    "stage2": (BATCH, N_KEPT, 384, 6, 1536, 64, ("mlp_ln_blend_bwd",),
               dict(seed=33, d=(0.0, 1.0))),
    "stage2_skip": (BATCH, N_KEPT, 384, 6, 1536, 64, ("mlp_ln_blend_bwd",),
                    dict(seed=34, d=(1.0, 0.0))),
    # the T2T-ViT-14 stage-2 paths of phase 11 (N 197: no token drop): A2
    # at 3 heads and A6 at fk 640 with 576 kept units; A4 at F 1152 with
    # the one-hot d of a kept and of a skipped block
    "t2t_compact": (BATCH, 197, 384, 3, 640, 64,
                    ("layer_attention_ln_bwd", "mlp_ln_bwd"),
                    dict(seed=35, units=576)),
    "t2t_stage2": (BATCH, 197, 384, 6, 1152, 64, ("mlp_ln_blend_bwd",),
                   dict(seed=36, d=(0.0, 1.0))),
    "t2t_stage2_skip": (BATCH, 197, 384, 6, 1152, 64, ("mlp_ln_blend_bwd",),
                        dict(seed=37, d=(1.0, 0.0))),
    # SynFlow's scoring pass on DeiT-Small (one all-ones image), whose
    # backward runs A2 and A6
    "synflow": (1, 197, 384, 6, 1536, 64, ("layer_attention_ln_bwd",
                                           "mlp_ln_bwd")),
    # R50-ViT-B/16's stage 1 (A2, A4), stage 2 (A2, A4) and compact_ft (A6)
    "vit_b": (BATCH, 197, 768, 12, 3072, 64,
              ("layer_attention_ln_bwd", "mlp_ln_blend_bwd", "mlp_ln_bwd")),
    # DeiT-Tiny at 64 px (phase 18), batch 128: stage 1 at N 18, stage 2's
    # physical token drop at N 13
    "tiny": (128, 18, 192, 3, 768, 64,
             ("layer_attention_ln_bwd", "mlp_ln_blend_bwd")),
    "tiny_slim": (128, 13, 192, 3, 768, 64,
                  ("layer_attention_ln_bwd", "mlp_ln_blend_bwd")),
}


def _library_backward(run, leaves, do):
    """One PyTorch autograd backward through a library composition (the
    forward built once, its graph kept): the yardstick of a backward
    kernel."""
    out = run()
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)


def backward_kernel_phase(eps, digests_only=False, refused_ok=False,
                          only=None):
    from uvc_tpu_torch.ops.attention import (layer_attention_bwd,
                                             layer_attention_bwd_plain,
                                             layer_attention_ln_bwd,
                                             layer_attention_ln_bwd_plain)
    from uvc_tpu_torch.ops.mlp import (mlp_ln_blend_bwd,
                                       mlp_ln_blend_bwd_plain, mlp_ln_bwd,
                                       mlp_ln_bwd_plain)

    gen = torch.Generator(device="cuda").manual_seed(3)
    results = {}
    for shape, (b, n, dm, heads, f, dh, kernels, *opt) in BWD_SHAPES.items():
        if (digests_only and shape not in PARENT_SHAPES) or (
                only and shape not in only):
            continue
        opt = opt[0] if opt else {}
        g = (torch.Generator(device="cuda").manual_seed(opt["seed"])
             if "seed" in opt else gen)
        t = _inputs(g, b, n, dm, heads, f, dh)
        do = (torch.randn(b, n, dm, generator=g, device="cuda")
              * 0.1).to(torch.bfloat16)
        units = opt.get("units", f)
        if "units" in opt:
            # a compact layer: the padding slots past the kept units are
            # zero in W1, b1 and W2, and the hidden mask is all ones
            t["w1"][:, units:] = 0
            t["b1"][units:] = 0
            t["w2"][units:] = 0
            t["fmask"] = torch.ones_like(t["fmask"])
        if "d" in opt:
            t["d"] = torch.tensor(opt["d"], device="cuda")
        da = dh * heads
        rows = b * n
        act = rows * dm * 2
        akw = dict(num_heads=heads, scale=dh ** -0.5, eps=eps)
        aargs = (t["x"], t["g"], t["b"], t["wqkv"], t["bqkv"], t["wproj"],
                 t["bproj"], t["amask"], do)
        sargs = (t["x"], t["wqkv"], t["bqkv"], t["wproj"], t["bproj"],
                 t["amask"], do)
        skw = dict(num_heads=heads, scale=dh ** -0.5)
        margs = (t["g"], t["b"], t["w1"], t["b1"], t["w2"], t["b2"],
                 t["fmask"])
        # work: recompute qkv, t, dWproj, d a_in, dWqkv; the attention core
        # recomputes the logits and forms ctx, dv, dp, dq, dk: 12 N^2 dh
        a_flops = (2 * rows * dm * 3 * da * 3 + 2 * rows * dm * da * 2
                   + 12 * b * heads * n * n * dh)
        a_bytes = (3 * act + 2 * (4 * da * dm + 3 * da + dm + da) * 2
                   + 4 * dm * 4)
        m_flops = 5 * 2 * rows * dm * f
        m_bytes = 3 * act + 2 * (2 * dm * f + f + dm + f) * 2 + 4 * dm * 4
        leaves = {k: v.detach().requires_grad_() if torch.is_tensor(v)
                  and v.is_floating_point() else v for k, v in t.items()}
        names = ("g", "b", "wqkv", "bqkv", "wproj", "bproj", "amask")
        lib_a = _library_backward(_library_attention(leaves, eps),
                                  [leaves["x"]] + [leaves[k] for k in names],
                                  do)
        lib_s = _library_backward(
            _library_sublayer(leaves),
            [leaves["x"]] + [leaves[k] for k in names[2:]], do)
        mnames = ("g", "b", "w1", "b1", "w2", "b2", "fmask")
        lib_m = _library_backward(_library_mlp(leaves, eps, blend=False),
                                  [leaves["x"]] + [leaves[k] for k in mnames],
                                  do)
        lib_b = _library_backward(
            _library_mlp(leaves, eps, blend=True),
            [leaves["x"], leaves["xin"], leaves["d"]]
            + [leaves[k] for k in mnames], do)
        cases = {
            "layer_attention_ln_bwd": (
                lambda: layer_attention_ln_bwd(*aargs, **akw),
                lambda: layer_attention_ln_bwd_plain(*aargs, **akw),
                lib_a, a_flops, a_bytes),
            # A7: the same products, no LayerNorm parameters or their
            # gradients
            "layer_attention_bwd": (
                lambda: layer_attention_bwd(*sargs, **skw),
                lambda: layer_attention_bwd_plain(*sargs, **skw),
                lib_s, a_flops, a_bytes - 4 * dm * 4),
            "mlp_ln_blend_bwd": (
                lambda: mlp_ln_blend_bwd(t["x"], t["xin"], t["d"], *margs, do,
                                         eps=eps),
                lambda: mlp_ln_blend_bwd_plain(t["x"], t["xin"], t["d"],
                                               *margs, do, eps=eps),
                lib_b, m_flops, m_bytes + 2 * act + 16),
            "mlp_ln_bwd": (
                lambda: mlp_ln_bwd(t["x"], *margs, do, eps=eps),
                lambda: mlp_ln_bwd_plain(t["x"], *margs, do, eps=eps),
                lib_m, m_flops, m_bytes),
        }
        for name in kernels:
            kern, plain, library, flops, nbytes = cases[name]
            try:
                outs = kern()
            except ValueError as e:
                if not refused_ok:
                    raise
                print(f"kernel {name:22s} [{shape:6s}] refused: {e}",
                      flush=True)
                continue
            torch.cuda.synchronize()
            again = kern()
            refs = plain()
            errs = []
            for i, (o, r) in enumerate(zip(outs, refs)):
                check(o.shape == r.shape and o.dtype == r.dtype,
                      f"{name} [{shape}] output {i}: {o.shape} {o.dtype} vs "
                      f"{r.shape} {r.dtype}")
                check(torch.isfinite(o).all().item(),
                      f"{name} [{shape}] output {i}: non-finite")
                check(torch.equal(o, again[i]),
                      f"{name} [{shape}] output {i}: two launches differ")
                if not r.any():
                    # a gradient that is exactly zero (a skipped block's)
                    # must come out exactly zero
                    check(not o.any().item(),
                          f"{name} [{shape}] output {i}: nonzero where the "
                          f"plain version is exactly zero")
                    errs.append((0.0, 0.0))
                    continue
                errs.append(rel_err(o, r))
                if opt:
                    # the stage-2 rows are held to the forward kernels'
                    # max-abs rule too, output by output
                    max_tol = KERNEL_MAX_TOL * r.float().abs().max().item()
                    check(errs[-1][1] <= max_tol,
                          f"{name} [{shape}] output {i}: max_abs "
                          f"{errs[-1][1]:.3e} (tol {max_tol:.3e})")
            if name == "mlp_ln_bwd" and units < f:
                # dwfc1, dbfc1, dwfc2, dmask at the padding slots
                pad = (outs[3][:, units:], outs[4][units:], outs[5][units:],
                       outs[7][units:])
                check(not any(p.any().item() for p in pad),
                      f"{name} [{shape}]: a padding slot got a gradient")
            if opt.get("d") == (1.0, 0.0):
                # dx, dg2, db2, dwfc1, dbfc1, dwfc2, dbfc2, dmask
                check(not any(outs[k].any().item() for k in
                              (0, 3, 4, 5, 6, 7, 8, 9)),
                      f"{name} [{shape}]: a skipped block got a gradient")
                check(torch.equal(outs[1], do),
                      f"{name} [{shape}]: dxin is not do")
            worst = max(e[0] for e in errs)
            mx = max(e[1] for e in errs)
            check(worst <= BWD_REL_TOL,
                  f"{name} [{shape}]: kernel vs plain rel_fro per output "
                  f"{[f'{e[0]:.2e}' for e in errs]} (tol {BWD_REL_TOL})")
            if digests_only:
                print(f"kernel {name:22s} [{shape:6s}] rel_fro={worst:.2e} "
                      f"digest={digest(outs)}", flush=True)
                continue
            bound_ms, bound_by = bound(flops, nbytes)
            r = dict(shape=shape, rel_fro=worst, max_abs_err=mx,
                     rel_fro_per_output=[e[0] for e in errs],
                     ms=time_ms(kern, 20), plain_ms=time_ms(plain, 3),
                     library_ms=time_ms(library, 20), bound_ms=bound_ms,
                     bound_by=bound_by, flops=flops, bytes=nbytes)
            results[(name, shape)] = r
            print(f"kernel {name:22s} [{shape:6s} B={b} N={n} dm={dm} "
                  f"da={da} H={heads} dh={dh} F={f}] rel_fro per output "
                  f"{' '.join(f'{e[0]:.1e}' for e in errs)} (tol "
                  f"{BWD_REL_TOL:g}) max_abs={mx:.2e} ms={r['ms']:.4f} "
                  f"plain_ms={r['plain_ms']:.4f} "
                  f"library_ms={r['library_ms']:.4f} "
                  f"bound={bound_ms * 1e3:.1f}us ({bound_by}) "
                  f"digest={digest(outs)}", flush=True)
    return results


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------


def passes(fn):
    """N_PASSES passes over the request batches, timed as one window on the
    host clock from an idle card to the last pass's synchronise, so that a
    stall anywhere in it counts; CUDA events between the passes give each
    pass's share.  Returns (window seconds, per-pass seconds, the first
    pass's result)."""
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(N_PASSES + 1)]
    first = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marks[0].record()
    for i in range(N_PASSES):
        res = fn()
        marks[i + 1].record()
        if first is None:
            first = res
    torch.cuda.synchronize()
    window = time.perf_counter() - t0
    return window, [a.elapsed_time(b) / 1e3
                    for a, b in zip(marks, marks[1:])], first


def _served_model(name, seed, skipped):
    """The seeded discovered architecture that phase 4 (DeiT-Small, seed
    0) and phase 7 (T2T-ViT-14, seed 15) serve and phase 16 exports:
    seeded random weights with a random head (the zero-initialised one
    gives all-zero logits), 3 of the heads and half the MLP units kept in
    every block with random within-head dims pruned, the blocks
    ``skipped`` gated off.  Returns (cfg, params, masks, layers, top), the
    compact model in bf16 on the card."""
    from uvc_tpu_torch.compress.masks import build_masks
    from uvc_tpu_torch.configs import get_config
    from uvc_tpu_torch.infer.compact import compact_model
    from uvc_tpu_torch.models import get_model

    cfg = get_config(name)
    gen = torch.Generator().manual_seed(seed)
    params = get_model(cfg).init_params(gen, cfg)
    params["head"]["kernel"] = 0.05 * torch.randn(
        params["head"]["kernel"].shape, generator=gen).cuda()
    ln = cfg.depth
    s = torch.tensor([[3.0, cfg.mlp_hidden / 2]] * ln)
    r = torch.randint(0, cfg.head_size // 4 + 1, (ln, cfg.num_heads),
                      generator=gen).float()
    masks = build_masks(params, s.cuda(), r.cuda(), cfg)
    for i in skipped:
        params["block_gating"][i] = torch.tensor([1.0, -1.0])
    layers, top = compact_model(params, masks, cfg)
    return cfg, params, masks, layers, top


def serving_phase(card):
    from uvc_tpu_torch.compress.state import MinimaxHParams
    from uvc_tpu_torch.infer.compact import (apply_compact,
                                             compact_flops_fraction)
    from uvc_tpu_torch.models import vit
    from uvc_tpu_torch.ops import launch_counts, reset_launch_counts
    from uvc_tpu_torch.train.step import eval_step

    cfg, params, masks, layers, top = _served_model(
        "deit_small_patch16_224", 0, SKIPPED_BLOCKS)
    check(cfg.seq_len - cfg.num_patches + int(TOKEN_RATIO * cfg.num_patches)
          == N_KEPT,
          "the kernel phase's token count is not the serving paths'")
    ln = cfg.depth
    kept = ln - len(SKIPPED_BLOCKS)
    check(len(layers) == kept, f"compact model has {len(layers)} layers")
    for blk in layers:
        check(blk["num_heads"] == 3 and blk["fc1"]["kernel"].shape[1] == 768,
              "compact layer widths are not 3 heads / F=768")
    frac = compact_flops_fraction(layers, cfg, TOKEN_RATIO)

    igen = torch.Generator(device="cuda").manual_seed(2)
    images = [torch.randn(BATCH, cfg.img_size, cfg.img_size, cfg.in_chans,
                          generator=igen, device="cuda")
              for _ in range(N_BATCHES)]
    labels = [torch.randint(0, cfg.num_classes, (BATCH,), generator=igen,
                            device="cuda") for _ in range(N_BATCHES)]
    labels[-1][-5:] = -1                     # padding rows of the last batch
    hp = MinimaxHParams(enable_block_gating=True, enable_patch_gating=2,
                        patch_ratio=TOKEN_RATIO)
    n_img = N_BATCHES * BATCH

    def serve():
        return [apply_compact(layers, top, xb, cfg, token_ratio=TOKEN_RATIO)
                .logits for xb in images]

    def evaluate():
        # summed on the card, read once per pass, as a validation loop does
        tot = {"correct": 0, "loss_sum": 0.0, "count": 0}
        for xb, yb in zip(images, labels):
            m = eval_step(params, masks, xb, yb, cfg, hp)
            tot = {k: tot[k] + m[k] for k in tot}
        return {k: v.item() for k, v in tot.items()}

    with torch.no_grad():
        apply_compact(layers, top, images[0], cfg, token_ratio=TOKEN_RATIO)
        eval_step(params, masks, images[0], labels[0], cfg, hp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        reset_launch_counts()
        w_serve, p_serve, logits = passes(serve)
        serve_counts = launch_counts()

        reset_launch_counts()
        w_eval, p_eval, ev = passes(evaluate)
        eval_counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()

    runs = N_PASSES * N_BATCHES
    want_serve = {"layer_attention_ln": kept * runs, "mlp_ln": kept * runs,
                  "mlp_ln_blend": 0, "layer_attention": 0, "performer": 0,
                  "attention": 0}
    want_eval = {"layer_attention_ln": ln * runs, "mlp_ln": 0,
                 "mlp_ln_blend": ln * runs, "layer_attention": 0,
                 "performer": 0, "attention": 0}
    print(f"launches compact serving {serve_counts} (expected {want_serve})")
    print(f"launches eval_step       {eval_counts} (expected {want_eval})")
    check(serve_counts == want_serve, "compact serving launch counts differ")
    check(eval_counts == want_eval, "eval_step launch counts differ")
    for lg in logits:
        check(lg.shape == (BATCH, cfg.num_classes)
              and torch.isfinite(lg).all().item(),
              "compact logits not finite or of the wrong shape")
    check(ev["count"] == n_img - 5, f"eval count {ev['count']} != {n_img - 5}")
    check(0 <= ev["correct"] <= ev["count"]
          and ev["loss_sum"] == ev["loss_sum"], f"eval metrics {ev}")
    print(f"eval_step: correct={ev['correct']} count={ev['count']} "
          f"mean_loss={ev['loss_sum'] / ev['count']:.4f}")
    for label, window, secs in (
            (f"compact serving (token ratio {TOKEN_RATIO})", w_serve,
             p_serve),
            ("eval_step (masked dense)", w_eval, p_eval)):
        rates = ", ".join(f"{n_img / s:.1f}" for s in secs)
        print(f"{label}: {N_PASSES * n_img / window:.1f} img/s "
              f"({N_PASSES} passes of {N_BATCHES} batches of {BATCH} in "
              f"{window:.4f} s; per pass, CUDA events: {rates} img/s) "
              f"[{card}]")
    print(f"compact_flops_fraction={frac:.4f} (token ratio {TOKEN_RATIO})")
    print(f"max_memory_allocated={peak} bytes ({peak / 2**20:.1f} MiB) "
          f"[{card}]")

    # compact vs masked dense, with and without the token drop
    keep = (params["block_gating"][:, 1] > params["block_gating"][:, 0])
    gating = torch.stack([1.0 - keep.float(), keep.float()], dim=-1)
    x0 = images[0]
    with torch.no_grad():
        for ratio, mode in ((None, 0), (TOKEN_RATIO, 2)):
            dense = vit.apply(params, x0, cfg, gating_distrib=gating,
                              masks=masks, patch_gate_mode=mode,
                              patch_ratio=TOKEN_RATIO, patch_physical=True,
                              dtype=torch.bfloat16).logits
            comp = apply_compact(layers, top, x0, cfg,
                                 token_ratio=ratio).logits
            rel, mx = rel_err(comp, dense)
            print(f"compact vs masked dense (token ratio {ratio}): "
                  f"rel_fro={rel:.2e} max_abs={mx:.2e} "
                  f"(tol {MODEL_REL_TOL})")
            check(rel <= MODEL_REL_TOL, "compact and masked dense disagree")

        profile_phase(
            card, {"compact serving": lambda: apply_compact(
                layers, top, x0, cfg, token_ratio=TOKEN_RATIO),
                "eval_step": lambda: eval_step(params, masks, x0, labels[0],
                                               cfg, hp)})

        # the card against the plain path on the CPU, on 8 images
        layers_cpu = [_tree_to(blk, "cpu") for blk in layers]
        ref = apply_compact(layers_cpu, _tree_to(top, "cpu"), x0[:8].cpu(),
                            cfg, token_ratio=TOKEN_RATIO).logits
        rel, mx = rel_err(logits[0][:8].cpu(), ref)
        print(f"compact serving, card vs CPU plain path (8 images): "
              f"rel_fro={rel:.2e} max_abs={mx:.2e} (tol {MODEL_REL_TOL})")
        check(rel <= MODEL_REL_TOL, "card and CPU plain path disagree")
    return {k: serve_counts[k] + eval_counts[k] for k in serve_counts}


def profile_phase(card, runs, top=8, batch=BATCH, watch=None, host_top=0):
    """Device time by kernel for one batch of each path (torch.profiler),
    and the device's busy share of the wall time (the profiler's own host
    overhead is inside the wall time, so the busy share is a lower
    bound).  Only events on the device are summed: a CPU range (an
    autograd Function, an aten op) is charged the time of the kernels
    launched inside it, which would count them twice.  ``watch``: {label:
    kernel-name substring, or a tuple of them}, each label's device time
    summed and printed: of every kernel whose name holds the substring, or
    of every run of consecutive kernels (in launch order) whose names hold
    the tuple's substrings in turn, one kernel's launches told apart from
    another's that share some of their kernels.  ``host_top``: that many
    host ops by their own host time, the profiler's overhead inside."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for label, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        by_name = {}
        evs = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and e.device_time_total > 0),
                     key=lambda e: e.time_range.start)
        for e in evs:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.device_time_total, n + 1)
        rows = sorted(((t, n, key) for key, (t, n) in by_name.items()),
                      reverse=True)
        busy = sum(r[0] for r in rows)
        check(busy > 0, f"profile of {label}: no device time recorded")
        print(f"profile {label} (batch {batch}): device busy {busy:.1f} us "
              f"of {wall_us:.1f} us wall ({100 * busy / wall_us:.1f}%), "
              f"{sum(r[1] for r in rows)} device events [{card}]")
        own = [r for r in rows if "uvc::" in r[2]]
        own_us = sum(r[0] for r in own)
        print(f"  the port's kernels {own_us:.1f} us "
              f"({100 * own_us / busy:.1f}%) in {sum(r[1] for r in own)} "
              f"events; PyTorch's and the libraries' {busy - own_us:.1f} us "
              f"in {sum(r[1] for r in rows) - sum(r[1] for r in own)}")
        for t, n, key in rows[:top]:
            print(f"  {100 * t / busy:5.1f}%  {t:9.1f} us  x{n:<3d} "
                  f"{key[:110]}")
        for what, part in (watch or {}).items():
            if isinstance(part, str):
                hit = [r for r in rows if part in r[2]]
                t, count = sum(r[0] for r in hit), sum(r[1] for r in hit)
            else:
                t, count, i = 0.0, 0, 0
                while i + len(part) <= len(evs):
                    run = evs[i:i + len(part)]
                    if all(p in e.name for p, e in zip(part, run)):
                        t += sum(e.device_time_total for e in run)
                        count += 1
                        i += len(part)
                    else:
                        i += 1
            print(f"  {what}: {t / 1e3:.3f} ms in {count} "
                  f"{'events' if isinstance(part, str) else 'calls'} "
                  f"({100 * t / busy:.1f}% of the device time)")
        if host_top:
            ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
            print(f"  host: {sum(a.self_cpu_time_total for a in ops) / 1e3:.2f} "
                  f"ms of own host time in {sum(a.count for a in ops)} ops; "
                  f"the most:")
            for a in ops[:host_top]:
                print(f"    {a.self_cpu_time_total / 1e3:8.3f} ms  x{a.count:<5d} "
                      f"{a.key[:90]}")


# ---------------------------------------------------------------------------
# phase 5: training
# ---------------------------------------------------------------------------

TRAIN_WARM, TRAIN_TIMED, TRAIN_TAU = 3, 10, 5.0
# phase 5's step-only rates, which phase 12 prints beside the drivers'
STEP_RATES = {}
# card vs CPU plain path, one bf16 step from one state with one set of
# draws: the kernels and the plain versions round at the same places, and
# the differences of summation order (one-ulp bf16 flips) pass through
# 12 blocks forward and back into the loss, the global gradient norm and
# the resource
TRAIN_REL_TOL = 2e-2


def _state_to(state, device):
    """A TrainState (dataclasses of tensors and trees) on ``device``."""
    import dataclasses

    def conv(v):
        if dataclasses.is_dataclass(v):
            return dataclasses.replace(v, **{
                f.name: conv(getattr(v, f.name))
                for f in dataclasses.fields(v)})
        if isinstance(v, dict):
            return _tree_to(v, device)
        return v.to(device) if torch.is_tensor(v) else v

    return conv(state)


def training_phase(card):
    import dataclasses

    from uvc_tpu_torch.compress.minimax import init_compression_state
    from uvc_tpu_torch.compress.resource import build_macs_table
    from uvc_tpu_torch.compress.state import MinimaxHParams
    from uvc_tpu_torch.configs import get_config
    from uvc_tpu_torch.models import vit
    from uvc_tpu_torch.ops import (backward_launch_counts, launch_counts,
                                   reset_launch_counts)
    from uvc_tpu_torch.train.state import TrainHParams, create_train_state
    from uvc_tpu_torch.train.step import build_stage1_step, draw_stage1_noise

    cfg = get_config("deit_small_patch16_224")
    ln = cfg.depth
    # bench.py's flagship: MinimaxHParams(enable_patch_gating=2,
    # gating_interval=100), default TrainHParams (bf16)
    hp = MinimaxHParams(enable_patch_gating=2, gating_interval=100)
    thp = TrainHParams()
    gen = torch.Generator().manual_seed(5)
    params = vit.init_params(gen, cfg)
    teacher = vit.init_params(gen, cfg)
    # zero-initialised heads would give all-zero logits; randomise them
    for tree in (params, teacher):
        tree["head"]["kernel"] = 0.05 * torch.randn(
            tree["head"]["kernel"].shape, generator=gen).cuda()
    table = build_macs_table(cfg)
    state = create_train_state(params, thp,
                               init_compression_state(cfg, hp, "cuda"))
    step = build_stage1_step(cfg, table, hp, thp, warmup=False)
    igen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(BATCH, cfg.img_size, cfg.img_size, cfg.in_chans,
                    generator=igen, device="cuda")
    labels = torch.randint(0, cfg.num_classes, (BATCH,), generator=igen,
                           device="cuda")
    ngen = torch.Generator().manual_seed(7)       # every draw of every step

    def run(st, fn, hps, n, b=BATCH, xb=x, yb=labels, device="cuda"):
        losses = []
        for _ in range(n):
            noise = draw_stage1_noise(ngen, cfg, hps, thp, b, device)
            st, m = fn(st, teacher, xb, yb, noise, TRAIN_TAU)
            losses.append(m["loss"])
        return st, losses, m

    t0 = time.perf_counter()
    state, _, _ = run(state, step, hp, TRAIN_WARM)
    torch.cuda.synchronize()
    print(f"train: {TRAIN_WARM} untimed steps in "
          f"{time.perf_counter() - t0:.2f} s (first-call set-up included)",
          flush=True)

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    state, losses, m = run(state, step, hp, TRAIN_TIMED)
    issued = time.perf_counter() - t0      # the host's share: no sync yet
    torch.cuda.synchronize()
    window = time.perf_counter() - t0
    counts = {**launch_counts(), **backward_launch_counts()}
    peak = torch.cuda.max_memory_allocated()
    want = {"layer_attention_ln": 2 * ln * TRAIN_TIMED,   # student, teacher
            "mlp_ln": ln * TRAIN_TIMED,                   # teacher
            "mlp_ln_blend": ln * TRAIN_TIMED,             # gated student
            "layer_attention_ln_bwd": ln * TRAIN_TIMED,
            "mlp_ln_blend_bwd": ln * TRAIN_TIMED, "mlp_ln_bwd": 0,
            "layer_attention": 0, "layer_attention_bwd": 0, "performer": 0,
            "performer_bwd": 0, "attention": 0, "attention_bwd": 0,
            "attention_bwd_ctx": 0}
    print(f"launches stage-1 train   {counts} (expected {want})")
    check(counts == want, "stage-1 step launch counts differ")
    losses = torch.stack(losses).float().cpu()
    check(torch.isfinite(losses).all().item(),
          f"non-finite stage-1 losses {losses.tolist()}")
    STEP_RATES["stage-1 step"] = TRAIN_TIMED * BATCH / window
    print(f"stage-1 train step (DeiT-Small, batch {BATCH}, bf16): "
          f"{TRAIN_TIMED * BATCH / window:.1f} img/s ({TRAIN_TIMED} steps in "
          f"{window:.4f} s, {1e3 * window / TRAIN_TIMED:.2f} ms/step; the "
          f"host had issued them after {issued:.4f} s) [{card}]")
    print(f"  losses {[round(v, 4) for v in losses.tolist()]}; last step "
          f"grad_norm={float(m['grad_norm']):.4f} "
          f"resource={float(m['resource']):.4f} z={float(m['z']):.4f}")
    print(f"  s[0]={state.cstate.s[0].tolist()} "
          f"r[0]={state.cstate.r[0].tolist()}")
    print(f"train max_memory_allocated={peak} bytes "
          f"({peak / 2**20:.1f} MiB) [{card}]")

    # gating warmup: the gating logits must not move, bit for bit
    wstep = build_stage1_step(cfg, table, hp, thp, warmup=True)
    before = state.params["block_gating"].clone()
    wstate, wl, _ = run(state, wstep, hp, 1)
    check(torch.equal(wstate.params["block_gating"], before),
          "the warmup step moved block_gating")
    check(torch.isfinite(wl[0]).item(), "non-finite warmup loss")
    print(f"warmup step: block_gating unchanged bit for bit, "
          f"loss={float(wl[0]):.4f}")

    # block gating off: the ungated student runs K2 forward and A6 back
    hp_off = dataclasses.replace(hp, enable_block_gating=False)
    ostep = build_stage1_step(cfg, table, hp_off, thp, warmup=False)
    reset_launch_counts()
    _, ol, _ = run(state, ostep, hp_off, 2)
    torch.cuda.synchronize()
    off_counts = {**launch_counts(), **backward_launch_counts()}
    want_off = {"layer_attention_ln": 4 * ln, "mlp_ln": 4 * ln,
                "mlp_ln_blend": 0, "layer_attention_ln_bwd": 2 * ln,
                "mlp_ln_blend_bwd": 0, "mlp_ln_bwd": 2 * ln,
                "layer_attention": 0, "layer_attention_bwd": 0,
                "performer": 0, "performer_bwd": 0, "attention": 0,
                "attention_bwd": 0, "attention_bwd_ctx": 0}
    print(f"launches gating off      {off_counts} (expected {want_off})")
    check(off_counts == want_off, "gating-off launch counts differ")
    check(all(torch.isfinite(v).item() for v in ol),
          "non-finite gating-off loss")

    # part gating on: the student's sublayers run A7 and the composed MLP,
    # the block-gating blend after the block; the teacher the fused kernels
    hp_part = dataclasses.replace(hp, enable_part_gating=True)
    pstep = build_stage1_step(cfg, table, hp_part, thp, warmup=False)
    reset_launch_counts()
    _, pl, _ = run(state, pstep, hp_part, 2)
    torch.cuda.synchronize()
    part_counts = {**launch_counts(), **backward_launch_counts()}
    want_part = {name: 0 for name in part_counts}
    want_part.update(layer_attention=2 * ln, layer_attention_bwd=2 * ln,
                     layer_attention_ln=2 * ln, mlp_ln=2 * ln)
    print(f"launches part-gated      {part_counts} (expected {want_part})")
    check(part_counts == want_part, "part-gated launch counts differ")
    check(all(torch.isfinite(v).item() for v in pl),
          "non-finite part-gated loss")
    print(f"part-gated stage-1 steps: losses "
          f"{[round(float(v), 4) for v in pl]}")

    profile_phase(card, {"stage-1 train step": lambda: run(
        state, step, hp, 1)}, top=14)

    # the card against the CPU plain path: one step at batch 8 from the
    # same state with the same draws
    small = 8
    for label, fn, hps in (("stage-1", step, hp),
                           ("part-gated stage-1", pstep, hp_part)):
        noise = draw_stage1_noise(ngen, cfg, hps, thp, small, "cpu")
        _, gm = fn(state, teacher, x[:small], labels[:small],
                   _noise_to(noise, "cuda"), TRAIN_TAU)
        _, cm = fn(_state_to(state, "cpu"), _tree_to(teacher, "cpu"),
                   x[:small].cpu(), labels[:small].cpu(), noise, TRAIN_TAU)
        card_vs_cpu(f"{label} step", small, gm, cm,
                    ("loss", "grad_norm", "resource"))
    return counts, off_counts, part_counts


def _noise_to(noise, device):
    """A step's noise (named tuples of tensors, None where nothing was
    drawn) on ``device``."""
    if isinstance(noise, tuple):
        return type(noise)(*(_noise_to(v, device) for v in noise))
    return noise.to(device) if torch.is_tensor(noise) else noise


def card_vs_cpu(label, small, gm, cm, keys):
    for k in keys:
        a, b = float(gm[k]), float(cm[k])
        rel = abs(a - b) / abs(b)
        print(f"{label} card vs CPU plain path (batch {small}): {k} "
              f"{a:.6f} vs {b:.6f}, rel {rel:.2e} (tol {TRAIN_REL_TOL})")
        check(rel <= TRAIN_REL_TOL, f"{label}: card and CPU disagree on {k}")


# ---------------------------------------------------------------------------
# phase 6: the baseline fine-tune
# ---------------------------------------------------------------------------

# the baseline CLI's DeiT recipe (uvc_tpu/cli/baseline_train.py defaults)
BASE_DROP_PATH, BASE_REPROB, BASE_DENSITY = 0.1, 0.25, 0.5


def baseline_phase(card, per_step, cfg_name="deit_small_patch16_224",
                   label="DeiT-Small", seed=8, timed=True, init=None,
                   cpu_depth=None):
    """The baseline fine-tune step on ``cfg_name`` at full width and batch
    64, seeded random weights, under a one-shot global magnitude mask with
    the recipe above (``init``: the (params, weight masks) to start from
    instead).  ``per_step``: the launches each step must make (0 of every
    other kernel).  Timed: 3 untimed steps, then 10 timed as one window,
    peak memory, AdamW's moments at the masked coordinates, a profiled
    step; else 2 steps.  Then one batch-8 step on the card against the CPU
    plain path (at the first ``cpu_depth`` blocks, from a fresh state,
    where it is given).  Returns (launch counts, state, masks)."""
    from uvc_tpu_torch.baselines.finetune import (build_baseline_step,
                                                  create_baseline_state,
                                                  draw_baseline_noise)
    from uvc_tpu_torch.baselines.pruning import (global_threshold_mask,
                                                 magnitude_scores,
                                                 mask_sparsity)
    from uvc_tpu_torch.configs import get_config
    from uvc_tpu_torch.models import get_model
    from uvc_tpu_torch.ops import (backward_launch_counts, launch_counts,
                                   reset_launch_counts)
    from uvc_tpu_torch.train.state import TrainHParams
    from uvc_tpu_torch.utils.tree import leaf_at, tree_leaves_with_path

    cfg = get_config(cfg_name)
    thp = TrainHParams()                   # AdamW, mixup / cutmix, bf16
    if init is None:
        gen = torch.Generator().manual_seed(seed)
        params = get_model(cfg).init_params(gen, cfg)
        params["head"]["kernel"] = 0.05 * torch.randn(
            params["head"]["kernel"].shape, generator=gen).cuda()
        wmasks = global_threshold_mask(magnitude_scores(params),
                                       BASE_DENSITY)
    else:
        params, wmasks = init
    density = mask_sparsity(wmasks)
    check(abs(density - BASE_DENSITY) < 1e-3, f"mask density {density}")
    recipe = dict(drop_path_rate=BASE_DROP_PATH, re_prob=BASE_REPROB)
    step = build_baseline_step(cfg, thp, **recipe)
    state = create_baseline_state(params, thp)
    igen = torch.Generator(device="cuda").manual_seed(seed + 1)
    x = torch.randn(BATCH, cfg.img_size, cfg.img_size, cfg.in_chans,
                    generator=igen, device="cuda")
    labels = torch.randint(0, cfg.num_classes, (BATCH,), generator=igen,
                           device="cuda")
    ngen = torch.Generator().manual_seed(seed + 2)

    def run(st, n, b=BATCH):
        losses = []
        for _ in range(n):
            noise = draw_baseline_noise(ngen, cfg, thp, b, device="cuda",
                                        **recipe)
            st, m = step(st, None, wmasks, x[:b], labels[:b], noise, -1.0)
            losses.append(m["loss"])
        return st, losses, m

    n_steps = TRAIN_TIMED if timed else 2
    if timed:
        t0 = time.perf_counter()
        state, _, _ = run(state, TRAIN_WARM)
        torch.cuda.synchronize()
        print(f"baseline {label}: {TRAIN_WARM} untimed steps in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    state, losses, m = run(state, n_steps)
    issued = time.perf_counter() - t0
    torch.cuda.synchronize()
    window = time.perf_counter() - t0
    counts = {**launch_counts(), **backward_launch_counts()}
    peak = torch.cuda.max_memory_allocated()
    want = {name: 0 for name in counts}
    want.update({k: v * n_steps for k, v in per_step.items()})
    print(f"launches baseline {label:14s} {counts} (expected {want})")
    check(counts == want, f"baseline {label} step launch counts differ")
    losses = torch.stack(losses).float().cpu()
    check(torch.isfinite(losses).all().item(),
          f"non-finite baseline {label} losses {losses.tolist()}")
    print(f"  losses {[round(v, 4) for v in losses.tolist()]}; last step "
          f"grad_norm={float(m['grad_norm']):.4f}")
    if timed:
        if label == "DeiT-Small":
            STEP_RATES["baseline step"] = TRAIN_TIMED * BATCH / window
        print(f"baseline fine-tune step ({label}, batch {BATCH}, bf16, mask "
              f"density {density:.4f}, drop-path {BASE_DROP_PATH}, reprob "
              f"{BASE_REPROB}): {TRAIN_TIMED * BATCH / window:.1f} img/s "
              f"({TRAIN_TIMED} steps in {window:.4f} s, "
              f"{1e3 * window / TRAIN_TIMED:.2f} ms/step; the host had "
              f"issued them after {issued:.4f} s) [{card}]")
        print(f"baseline {label} max_memory_allocated={peak} bytes "
              f"({peak / 2**20:.1f} MiB) [{card}]")

        # a gradient at a masked coordinate is exactly zero in every step:
        # AdamW's moments there have stayed exactly zero
        masked = leaked = 0
        for path, mk in tree_leaves_with_path(wmasks):
            off = mk == 0
            masked += int(off.sum())
            for moments in (state.opt_state.mu, state.opt_state.nu):
                leaked += int((leaf_at(moments, path)[off] != 0).sum())
        print(f"baseline {label} masked coordinates: {masked}, with a nonzero "
              f"first or second gradient moment after "
              f"{TRAIN_WARM + TRAIN_TIMED} steps: {leaked}")
        check(masked > 0 and leaked == 0,
              "a masked coordinate received a gradient")
        profile_phase(card, {f"baseline fine-tune step ({label})":
                             lambda: run(state, 1)}, top=14)

    small = 8
    c_state, c_masks, c_cfg, c_step = state, wmasks, cfg, step
    if cpu_depth is not None:
        cut, c_cfg = _cut_depth(state.params, cfg, cpu_depth)
        c_masks, _ = _cut_depth(wmasks, cfg, cpu_depth)
        c_state = create_baseline_state(cut, thp)
        c_step = build_baseline_step(c_cfg, thp, **recipe)
    noise = draw_baseline_noise(ngen, c_cfg, thp, small, device="cpu",
                                **recipe)
    _, gm = c_step(c_state, None, c_masks, x[:small], labels[:small],
                   _noise_to(noise, "cuda"), -1.0)
    _, cm = c_step(_state_to(c_state, "cpu"), None, _tree_to(c_masks, "cpu"),
                   x[:small].cpu(), labels[:small].cpu(), noise, -1.0)
    card_vs_cpu(f"baseline {label} step"
                + (f" (depth {cpu_depth})" if cpu_depth else ""), small, gm,
                cm, ("loss", "grad_norm"))
    return counts, state, wmasks

# ---------------------------------------------------------------------------
# phase 7: T2T-ViT-14, the token-performer kernels
# ---------------------------------------------------------------------------

# (B, N, dim, the stage-1 space-to-depth slot mask): stage 1 with 147 live
# slots of 192, stage 2 dense, and a ragged shape (B * N = 150 rows)
PERF_SHAPES = {"t2t_stage1": (BATCH, 3136, 192, True),
               "t2t_stage2": (BATCH, 784, 576, False),
               "ragged": (3, 50, 192, True)}
PEAK_F32_FLOPS = 67e12       # H100 SXM float32 outside the tensor cores
T2T_SKIPPED_BLOCKS = (4, 9)


def _performer_inputs(gen, b, n, dim, masked):
    """The kernels' operands as ``fused_performer`` builds them: dead slots
    of the kqv rows and the LN1 affine zeroed, orthogonal random features
    scaled by sqrt(m), f32 LayerNorm parameters."""
    from uvc_tpu_torch.ops.performer import s2d_stage1_inputs

    f32 = torch.float32

    def rn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * std).to(dtype)

    fmask = torch.ones(dim, device="cuda")
    if masked:
        _, idx = s2d_stage1_inputs(torch.zeros(1, 8, 8, 3))
        fmask = torch.as_tensor(idx >= 0, dtype=f32, device="cuda")
    q, _ = torch.linalg.qr(torch.randn(64, 32, generator=gen, device="cuda"))
    ops = [rn(b, n, dim), (1 + rn(dim, std=0.1, dtype=f32)) * fmask,
           rn(dim, std=0.1, dtype=f32) * fmask,
           (rn(dim, 192, std=dim ** -0.5).float() * fmask[:, None]).to(
               torch.bfloat16), rn(192, std=0.1),
           (q.T * 32 ** 0.5).contiguous(), fmask,
           rn(64, 64, std=0.125), rn(64, std=0.1),
           1 + rn(64, std=0.1, dtype=f32), rn(64, std=0.1, dtype=f32),
           rn(64, 64, std=0.125), rn(64, std=0.1), rn(64, 64, std=0.125),
           rn(64, std=0.1)]
    return ops, float(fmask.sum().item())


def _library_performer(ops):
    """One PyTorch composition of the stage (a yardstick of time only, no
    single call computes it): F.layer_norm over all slots (no slot mask),
    F.linear, the random features and the linear attention as matmuls,
    F.gelu."""
    (x, g1, b1, wkqv, bkqv, w, _, wproj, bproj, g2, b2, wfc1, bfc1, wfc2,
     bfc2) = ops
    bf = torch.bfloat16
    dim = x.shape[-1]
    wk_t, wp_t, w1_t, w2_t = (t.t().contiguous()
                              for t in (wkqv, wproj, wfc1, wfc2))

    def prm(t):
        t = t.float()
        return torch.exp(t @ w.t() - (t * t).sum(-1, keepdim=True) / 2) \
            / 32 ** 0.5

    def run():
        xn = F.layer_norm(x, (dim,), g1.to(bf), b1.to(bf), 1e-5)
        k, q, v = F.linear(xn, wk_t, bkqv).chunk(3, dim=-1)
        kp, qp = prm(k).to(bf), prm(q)
        kptv = v.transpose(1, 2) @ kp
        d = (qp * kp.float().sum(1, keepdim=True)).sum(-1, keepdim=True)
        y = (qp.to(bf) @ kptv.transpose(1, 2)) / (d + 1e-8)
        attn = v + F.linear(y.to(bf), wp_t, bproj)
        h = F.layer_norm(attn, (64,), g2.to(bf), b2.to(bf), 1e-5)
        return attn + F.linear(F.gelu(F.linear(h, w1_t, bfc1)), w2_t, bfc2)
    return run


def _performer_bound(b, n, dim, backward):
    """(ms, "bytes" or "operations", bf16 FLOP, bytes) of the stage: the
    larger of the bytes' time (inputs read once, outputs written once) and
    the operations' time, itself the larger of the bf16 matrix products at
    the tensor-core peak and the random features' f32 products at the f32
    peak (the two kinds of unit run side by side)."""
    rows, e, m = b * n, 64, 32
    weights = (dim * 3 * e + 3 * e + 3 * e * e + 3 * e) * 2 \
        + (2 * dim + 4 * e + m * e) * 4
    if backward:
        mm = 2 * rows * (3 * dim * e + e * m + 2 * e * e      # recompute
                         + 6 * e * e + 6 * e * m + 8 * dim * e)
        nbytes = 2 * rows * dim * 2 + rows * e * 2 + 2 * weights \
            + b * (e * m + m) * 4
    else:
        mm = 2 * rows * (3 * dim * e + 2 * e * m + 3 * e * e)
        nbytes = rows * dim * 2 + rows * e * 2 + weights \
            + b * (e * m + m) * 4
    t_ops = max(mm / PEAK_BF16_FLOPS, 2 * 2 * rows * e * m / PEAK_F32_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", mm, nbytes)


def _check_outputs(name, shape, outs, refs, rel_tol, again=None):
    """Each output finite, of the plain version's shape and type, within
    rel_tol (relative Frobenius) and 1/64 of the largest reference value;
    with ``again``, bit for bit equal to a second launch.  Returns the
    (rel, max_abs) of each output."""
    errs = []
    for i, (o, r) in enumerate(zip(outs, refs)):
        check(o.shape == r.shape and o.dtype == r.dtype,
              f"{name} [{shape}] output {i}: {o.shape} {o.dtype} vs "
              f"{r.shape} {r.dtype}")
        check(torch.isfinite(o).all().item(),
              f"{name} [{shape}] output {i}: non-finite")
        if again is not None:
            check(torch.equal(o, again[i]),
                  f"{name} [{shape}] output {i}: two launches differ")
        rel, mx = rel_err(o, r)
        max_tol = KERNEL_MAX_TOL * r.float().abs().max().item()
        check(rel <= rel_tol and mx <= max_tol,
              f"{name} [{shape}] output {i}: kernel vs plain rel_fro "
              f"{rel:.3e} (tol {rel_tol}), max_abs {mx:.3e} (tol "
              f"{max_tol:.3e})")
        errs.append((rel, mx))
    return errs


def _performer_nodx(shape, ops, kptv, kpsum, do, fc, grads, refused_ok):
    """The dx-less backward (the stem's first stage) against the plain
    version's, and its gradients bit for bit the full backward's; returns
    a call of it, or None where ``refused_ok`` and the kernel takes no
    ``dx`` (another tree's)."""
    from uvc_tpu_torch.ops.performer import performer_bwd, performer_bwd_plain

    def run():
        return performer_bwd(*ops, kptv, kpsum, do, fcount=fc, dx=False)
    try:
        nodx = run()
    except TypeError:
        if not refused_ok:
            raise
        print(f"kernel performer_bwd  [{shape:10s}] no dx: refused")
        return None
    torch.cuda.synchronize()
    check(nodx[0] is None, f"performer_bwd [{shape}] without dx gave a dx")
    nrefs = performer_bwd_plain(*ops, kptv, kpsum, do, fcount=fc, dx=False)
    _check_outputs("performer_bwd (no dx)", shape, nodx[1:], nrefs[1:],
                   BWD_REL_TOL)
    check(all(torch.equal(a, b) for a, b in zip(nodx[1:], grads[1:])),
          f"performer_bwd [{shape}]: the dx-less gradients differ from the "
          f"full backward's")
    return run


def performer_kernel_phase(digests_only=False, refused_ok=False):
    from uvc_tpu_torch.ops.performer import (performer, performer_bwd,
                                             performer_bwd_plain,
                                             performer_plain)

    gen = torch.Generator(device="cuda").manual_seed(11)
    results = {}
    for shape, (b, n, dim, masked) in PERF_SHAPES.items():
        ops, fc = _performer_inputs(gen, b, n, dim, masked)
        do = (torch.randn(b, n, 64, generator=gen, device="cuda")
              * 0.1).to(torch.bfloat16)
        outs = performer(*ops, fcount=fc)
        torch.cuda.synchronize()
        refs = performer_plain(*ops, fcount=fc)
        ferrs = _check_outputs("performer", shape, outs, refs,
                               KERNEL_REL_TOL)
        kptv, kpsum = refs[1], refs[2]
        grads = performer_bwd(*ops, kptv, kpsum, do, fcount=fc)
        torch.cuda.synchronize()
        again = performer_bwd(*ops, kptv, kpsum, do, fcount=fc)
        grefs = performer_bwd_plain(*ops, kptv, kpsum, do, fcount=fc)
        berrs = _check_outputs("performer_bwd", shape, grads, grefs,
                               BWD_REL_TOL, again=again)
        if digests_only:
            print(f"kernel performer      [{shape:10s}] "
                  f"digest={digest(outs)}")
            print(f"kernel performer_bwd  [{shape:10s}] "
                  f"digest={digest(grads)}", flush=True)
            continue
        nodx = _performer_nodx(shape, ops, kptv, kpsum, do, fc, grads,
                               refused_ok)
        library = _library_performer(ops)
        names = ("x", "g1", "b1", "wkqv", "bkqv", "w", "fmask", "wproj",
                 "bproj", "g2", "b2", "wfc1", "bfc1", "wfc2", "bfc2")
        leaves = [t.detach().requires_grad_() if k not in ("w", "fmask")
                  else t for k, t in zip(names, ops)]
        lib_bwd = _library_backward(
            _library_performer(leaves),
            [t for k, t in zip(names, leaves) if k not in ("w", "fmask")],
            do)
        for name, errs, kern, plain, lib, bwd in (
                ("performer", ferrs,
                 lambda: performer(*ops, fcount=fc),
                 lambda: performer_plain(*ops, fcount=fc), library, False),
                ("performer_bwd", berrs,
                 lambda: performer_bwd(*ops, kptv, kpsum, do, fcount=fc),
                 lambda: performer_bwd_plain(*ops, kptv, kpsum, do,
                                             fcount=fc), lib_bwd, True)):
            bound_ms, bound_by, flops, nbytes = _performer_bound(b, n, dim,
                                                                 bwd)
            r = dict(shape=shape, rel_fro=max(e[0] for e in errs),
                     max_abs_err=max(e[1] for e in errs),
                     rel_fro_per_output=[e[0] for e in errs],
                     ms=time_ms(kern, 10), plain_ms=time_ms(plain, 2),
                     library_ms=time_ms(lib, 10), bound_ms=bound_ms,
                     bound_by=bound_by, flops=flops, bytes=nbytes,
                     library="composition")
            if bwd and nodx is not None:
                r["nodx_ms"] = time_ms(nodx, 10)
            results[(name, shape)] = r
            print(f"kernel {name:13s} [{shape:10s} B={b} N={n} dim={dim} "
                  f"live={int(fc)}] rel_fro per output "
                  f"{' '.join(f'{e[0]:.1e}' for e in errs)} (tol "
                  f"{KERNEL_REL_TOL:g}) max_abs={r['max_abs_err']:.2e} "
                  f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                  f"library_ms(composition)={r['library_ms']:.4f} "
                  f"bound={bound_ms * 1e3:.1f}us ({bound_by})"
                  + (f" no-dx ms={r['nodx_ms']:.4f} (the other gradients bit "
                     f"for bit)" if "nodx_ms" in r else "")
                  + (" two launches bit-identical" if bwd else "")
                  + f" digest={digest(grads if bwd else outs)}",
                  flush=True)
    return results


# the performer kernels' launches: the forward's two, the backward's q and
# k|v kernels, its four products (dWkqv, dWfc2, dWfc1, dWproj), the dWkqv
# assembly and the sums
PERF_FWD_LAUNCHES = ("fwd_sums", "fwd_apply")
# their device time in a profiled step: the forward's two launches and
# the backward's eight, each run in launch order
PERFORMER_WATCH = {
    "performer (A10 forward)": ("performer::fwd_sums_kernel",
                                "performer::fwd_apply_kernel"),
    "performer_bwd (A10 backward)": (
        "performer::bwd_q_kernel", "performer::bwd_kv_kernel",
        "gemm_wg_kernel", "gemm_wg_kernel", "gemm_wg_kernel",
        "gemm_wg_kernel", "performer::assemble_dw_kernel",
        "performer::finish_kernel")}
PERF_BWD_LAUNCHES = ("bwd_q", "bwd_kv", "dWkqv GEMM", "dWfc2 GEMM",
                     "dWfc1 GEMM", "dWproj GEMM", "assemble dWkqv", "finish")


def _performer_launch_work(b, n, dim, dx=True):
    """(bytes, bf16 FLOP) of each launch of PERF_FWD_LAUNCHES and
    PERF_BWD_LAUNCHES: each input read once, each output written once (the
    partials and the weights left out), the products' operations."""
    rows, e, m = b * n, 64, 32
    x, h, st = rows * dim * 2, rows * e * 2, rows * 4 * 4
    fwd = [(x + rows * m * 4 + h, 2 * rows * (3 * dim * e)),
           (rows * m * 4 + 2 * h, 2 * rows * (m * e + 3 * e * e))]
    front, vjp = 2 * rows * 2 * dim * e, 2 * rows * 2 * e * dim
    # the q kernel: x, do -> xn, [dq | dattn], [y | h2 | a | dhh], the row
    # statistics; the k|v kernel: x, the statistics, [dq | dattn] -> [dk |
    # dv] (and dx): both halves of LN1's VJP, twice with dx
    bwd = [(x + h + x + 2 * h + 4 * h + st,
            front + 2 * rows * (m * e + 5 * e * e + 3 * e * m)),
           (x + st + 4 * h + (x if dx else 0),
            front + 2 * rows * (3 * e * m) + 2 * vjp * (2 if dx else 1)),
           (x + 4 * h, 2 * rows * dim * 4 * e)] + \
        [(2 * h, 2 * rows * e * e)] * 3 + [(0, 0)] * 2
    return fwd, bwd


def performer_breakdown(card, refused_ok=False):
    """The performer kernels launch by launch (``launch_breakdown``) at
    "t2t_stage1" and "t2t_stage2", forward, backward and the backward
    without dx, each launch's bytes with its GB/s and its products'
    TFLOP/s (under the kernels' own names where another tree launches
    another sequence)."""
    from uvc_tpu_torch.ops.performer import performer, performer_bwd

    gen = torch.Generator(device="cuda").manual_seed(11)
    for shape in ("t2t_stage1", "t2t_stage2"):
        b, n, dim, masked = PERF_SHAPES[shape]
        ops, fc = _performer_inputs(gen, b, n, dim, masked)
        do = (torch.randn(b, n, 64, generator=gen, device="cuda")
              * 0.1).to(torch.bfloat16)
        _, kptv, kpsum = performer(*ops, fcount=fc)
        fwd, bwd = _performer_launch_work(b, n, dim)
        _, bwd_nodx = _performer_launch_work(b, n, dim, dx=False)
        runs = [("A10 forward", lambda: performer(*ops, fcount=fc),
                 PERF_FWD_LAUNCHES, fwd),
                ("A10 backward", lambda: performer_bwd(
                    *ops, kptv, kpsum, do, fcount=fc), PERF_BWD_LAUNCHES,
                 bwd)]
        try:
            performer_bwd(*ops, kptv, kpsum, do, fcount=fc, dx=False)
            runs.append(("A10 backward without dx", lambda: performer_bwd(
                *ops, kptv, kpsum, do, fcount=fc, dx=False),
                PERF_BWD_LAUNCHES, bwd_nodx))
        except TypeError:
            if not refused_ok:
                raise
        for label, run, names, work in runs:
            ms = launch_breakdown(label, shape, run, card, names)
            if len(ms) != len(names):
                continue
            print(f"{label} [{shape}] per launch: " + ", ".join(
                f"{nm} {nb / 1e6:.1f} MB {nb / t / 1e6:.0f} GB/s"
                + (f" {fl / t / 1e9:.1f} TFLOP/s" if fl else "")
                for nm, t, (nb, fl) in zip(names, ms, work) if t > 0)
                + f" [{card}]", flush=True)


def _t2t_model(gen, cfg):
    from uvc_tpu_torch.models import t2t_vit

    params = t2t_vit.init_params(gen, cfg)
    # the head is zero-initialised; randomise it so logits are not all 0
    params["head"]["kernel"] = 0.05 * torch.randn(
        params["head"]["kernel"].shape, generator=gen).cuda()
    return params


def t2t_training_phase(card, name="t2t_vit_14", label="T2T-ViT-14", seed=12,
                       warm=TRAIN_WARM, timed=TRAIN_TIMED):
    """The stage-1 step on the T2T-ViT ``name`` at full width and batch 64
    with a dense teacher: ``warm`` untimed steps, ``timed`` steps timed as
    one window with their launches counted, the frozen random features
    checked, a profiled step, and one batch-8 step against the CPU plain
    path.  Returns the launch counts of the timed window."""
    from uvc_tpu_torch.compress.minimax import init_compression_state
    from uvc_tpu_torch.compress.resource import build_macs_table
    from uvc_tpu_torch.compress.state import MinimaxHParams
    from uvc_tpu_torch.configs import get_config
    from uvc_tpu_torch.ops import (backward_launch_counts, composed_counts,
                                   launch_counts, reset_launch_counts)
    from uvc_tpu_torch.ops.attention import _MAX_DM_BWD
    from uvc_tpu_torch.train.state import TrainHParams, create_train_state
    from uvc_tpu_torch.train.step import build_stage1_step, draw_stage1_noise

    cfg = get_config(name)
    ln = cfg.depth
    hp = MinimaxHParams(enable_patch_gating=2, gating_interval=100)
    thp = TrainHParams()
    gen = torch.Generator().manual_seed(seed)
    params, teacher = _t2t_model(gen, cfg), _t2t_model(gen, cfg)
    state = create_train_state(params, thp,
                               init_compression_state(cfg, hp, "cuda"))
    step = build_stage1_step(cfg, build_macs_table(cfg), hp, thp,
                             warmup=False)
    igen = torch.Generator(device="cuda").manual_seed(seed + 1)
    x = torch.randn(BATCH, cfg.img_size, cfg.img_size, cfg.in_chans,
                    generator=igen, device="cuda")
    labels = torch.randint(0, cfg.num_classes, (BATCH,), generator=igen,
                           device="cuda")
    ngen = torch.Generator().manual_seed(seed + 2)

    def run(st, n):
        losses = []
        for _ in range(n):
            noise = draw_stage1_noise(ngen, cfg, hp, thp, BATCH, "cuda")
            st, m = step(st, teacher, x, labels, noise, TRAIN_TAU)
            losses.append(m["loss"])
        return st, losses, m

    t0 = time.perf_counter()
    state, _, _ = run(state, warm)
    torch.cuda.synchronize()
    print(f"{label} train: {warm} untimed steps in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    state, losses, m = run(state, timed)
    issued = time.perf_counter() - t0
    torch.cuda.synchronize()
    window = time.perf_counter() - t0
    counts = {**launch_counts(), **backward_launch_counts(),
              **composed_counts()}
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in counts}
    want.update(performer=4 * timed, performer_bwd=2 * timed,
                layer_attention_ln=2 * ln * timed, mlp_ln=ln * timed,
                mlp_ln_blend=ln * timed, layer_attention_ln_bwd=ln * timed,
                mlp_ln_blend_bwd=ln * timed)
    print(f"launches {label} stage-1 {counts} (expected {want})")
    check(counts == want, f"{label} stage-1 step launch counts differ")
    losses = torch.stack(losses).float().cpu()
    check(torch.isfinite(losses).all().item(),
          f"non-finite {label} stage-1 losses {losses.tolist()}")
    w0 = params["t2t"]["attention1"]["prm_w"]
    check(torch.equal(state.params["t2t"]["attention1"]["prm_w"], w0),
          "the frozen random features moved")
    print(f"stage-1 train step ({label}, {cfg.num_heads} heads of "
          f"{cfg.head_size}, batch {BATCH}, bf16): "
          f"{timed * BATCH / window:.1f} img/s ({timed} steps in "
          f"{window:.4f} s, {1e3 * window / timed:.2f} ms/step; the "
          f"host had issued them after {issued:.4f} s) [{card}]")
    print(f"  losses {[round(v, 4) for v in losses.tolist()]}; last step "
          f"grad_norm={float(m['grad_norm']):.4f} "
          f"resource={float(m['resource']):.4f}")
    print(f"{label} train max_memory_allocated={peak} bytes "
          f"({peak / 2**20:.1f} MiB) [{card}]")

    profile_phase(card, {f"{label} stage-1 train step":
                         lambda: run(state, 1)}, top=14,
                  watch=PERFORMER_WATCH)

    small = 8
    noise = draw_stage1_noise(ngen, cfg, hp, thp, small, "cpu")
    _, gm = step(state, teacher, x[:small], labels[:small],
                 _noise_to(noise, "cuda"), TRAIN_TAU)
    _, cm = step(_state_to(state, "cpu"), _tree_to(teacher, "cpu"),
                 x[:small].cpu(), labels[:small].cpu(), noise, TRAIN_TAU)
    card_vs_cpu(f"{label} stage-1 step", small, gm, cm,
                ("loss", "grad_norm", "resource"))
    return counts


def t2t_serving_phase(card):
    from uvc_tpu_torch.compress.state import MinimaxHParams
    from uvc_tpu_torch.infer.compact import (apply_compact,
                                             compact_flops_fraction)
    from uvc_tpu_torch.models import t2t_vit
    from uvc_tpu_torch.ops import launch_counts, reset_launch_counts
    from uvc_tpu_torch.train.step import eval_step

    cfg, params, masks, layers, top = _served_model(
        "t2t_vit_14", 15, T2T_SKIPPED_BLOCKS)
    ln = cfg.depth
    kept = ln - len(T2T_SKIPPED_BLOCKS)
    check(len(layers) == kept, f"compact T2T has {len(layers)} layers")
    for blk in layers:
        check(blk["num_heads"] == 3 and blk["fc1"]["kernel"].shape[1] == 640,
              "compact T2T layers are not 3 heads / 576 units (padded 640)")
    frac = compact_flops_fraction(layers, cfg)

    igen = torch.Generator(device="cuda").manual_seed(16)
    images = [torch.randn(BATCH, cfg.img_size, cfg.img_size, cfg.in_chans,
                          generator=igen, device="cuda")
              for _ in range(N_BATCHES)]
    labels = [torch.randint(0, cfg.num_classes, (BATCH,), generator=igen,
                            device="cuda") for _ in range(N_BATCHES)]
    hp = MinimaxHParams(enable_block_gating=True)
    n_img = N_BATCHES * BATCH

    def serve():
        return [apply_compact(layers, top, xb, cfg).logits for xb in images]

    def evaluate():
        tot = {"correct": 0, "loss_sum": 0.0, "count": 0}
        for xb, yb in zip(images, labels):
            m = eval_step(params, masks, xb, yb, cfg, hp)
            tot = {k: tot[k] + m[k] for k in tot}
        return {k: v.item() for k, v in tot.items()}

    with torch.no_grad():
        apply_compact(layers, top, images[0], cfg)
        eval_step(params, masks, images[0], labels[0], cfg, hp)
        torch.cuda.synchronize()
        reset_launch_counts()
        w_serve, p_serve, logits = passes(serve)
        serve_counts = launch_counts()
        reset_launch_counts()
        w_eval, p_eval, ev = passes(evaluate)
        eval_counts = launch_counts()

    runs = N_PASSES * N_BATCHES
    want_serve = {name: 0 for name in serve_counts}
    want_serve.update(performer=2 * runs, layer_attention_ln=kept * runs,
                      mlp_ln=kept * runs)
    want_eval = {name: 0 for name in eval_counts}
    want_eval.update(performer=2 * runs, layer_attention_ln=ln * runs,
                     mlp_ln_blend=ln * runs)
    print(f"launches T2T compact     {serve_counts} (expected {want_serve})")
    print(f"launches T2T eval_step   {eval_counts} (expected {want_eval})")
    check(serve_counts == want_serve, "T2T compact launch counts differ")
    check(eval_counts == want_eval, "T2T eval_step launch counts differ")
    for lg in logits:
        check(lg.shape == (BATCH, cfg.num_classes)
              and torch.isfinite(lg).all().item(),
              "T2T compact logits not finite or of the wrong shape")
    check(ev["count"] == n_img and 0 <= ev["correct"] <= ev["count"]
          and ev["loss_sum"] == ev["loss_sum"], f"T2T eval metrics {ev}")
    for label, window, secs in (("T2T-ViT-14 compact serving", w_serve,
                                 p_serve),
                                ("T2T-ViT-14 eval_step (masked dense)",
                                 w_eval, p_eval)):
        rates = ", ".join(f"{n_img / s:.1f}" for s in secs)
        print(f"{label}: {N_PASSES * n_img / window:.1f} img/s "
              f"({N_PASSES} passes of {N_BATCHES} batches of {BATCH} in "
              f"{window:.4f} s; per pass, CUDA events: {rates} img/s) "
              f"[{card}]")
    print(f"T2T compact_flops_fraction={frac:.4f}")

    keep = (params["block_gating"][:, 1] > params["block_gating"][:, 0])
    gating = torch.stack([1.0 - keep.float(), keep.float()], dim=-1)
    x0 = images[0]
    with torch.no_grad():
        dense = t2t_vit.apply(params, x0, cfg, gating_distrib=gating,
                              masks=masks, dtype=torch.bfloat16).logits
        comp = apply_compact(layers, top, x0, cfg).logits
        rel, mx = rel_err(comp, dense)
        print(f"T2T compact vs masked dense: rel_fro={rel:.2e} "
              f"max_abs={mx:.2e} (tol {MODEL_REL_TOL})")
        check(rel <= MODEL_REL_TOL, "T2T compact and masked dense disagree")
        profile_phase(card, {
            "T2T compact serving": lambda: apply_compact(layers, top, x0,
                                                         cfg),
            "T2T eval_step": lambda: eval_step(params, masks, x0, labels[0],
                                               cfg, hp)})
        ref = apply_compact([_tree_to(blk, "cpu") for blk in layers],
                            _tree_to(top, "cpu"), x0[:8].cpu(), cfg).logits
        rel, mx = rel_err(logits[0][:8].cpu(), ref)
        print(f"T2T compact serving, card vs CPU plain path (8 images): "
              f"rel_fro={rel:.2e} max_abs={mx:.2e} (tol {MODEL_REL_TOL})")
        check(rel <= MODEL_REL_TOL, "T2T card and CPU plain path disagree")
    return {k: serve_counts[k] + eval_counts[k] for k in serve_counts}


# ---------------------------------------------------------------------------
# phase 8: the T2T architecture ablations, the attention core (A9)
# ---------------------------------------------------------------------------

# (B, H, N, dh): the SE / Ghost blocks, the Dense variant's odd head dim 41
# and its widest, 74, a ragged shape (B * H * N = 300 rows), ViT-H/14's
# stage 1 (A8 in the composed backward of its 32 blocks), and a sequence
# past the 624 keys that the staged forward core held at head dim 80
# ("long")
CORE_SHAPES = {"se": (BATCH, 6, 197, 64), "dense_odd": (BATCH, 8, 197, 41),
               "dense_wide": (BATCH, 8, 197, 74), "ragged": (3, 2, 50, 24),
               "vit_h": (32, 16, 257, 80), "long": (4, 16, 1025, 80)}
# the shapes at which A8 (attention_bwd_ctx) is held beside A9
BWD_CTX_SHAPES = ("se", "ragged", "vit_h")
# (config, label, attention-core launches per step: one per block)
ABLATIONS = (("t2t_vit_14_se", "T2T-ViT-14-SE", 14),
             ("t2t_vit_16_ghost", "T2T-ViT-16-Ghost", 16),
             ("t2t_vit_dense", "T2T-ViT-Dense", 19))


def _core_bound(b, h, n, dh, kind):
    """(ms, "bytes" or "operations", FLOP, bytes) of the attention core:
    q, k, v read and ctx written ("fwd"), q, k, v, dO read and dq, dk, dv
    written ("bwd"), and ctx written besides ("bwd_ctx"), each once; 4 B H
    N^2 dh FLOP forward (q k^T and P v), 10 backward (the logits again, dv,
    dp, dq, dk), 12 with ctx (P v again)."""
    flops = {"fwd": 4, "bwd": 10, "bwd_ctx": 12}[kind] * b * h * n * n * dh
    nbytes = {"fwd": 4, "bwd": 7, "bwd_ctx": 8}[kind] * b * h * n * dh * 2
    return (*bound(flops, nbytes), flops, nbytes)


def _packed_views(*ts):
    """``[B, H, N, dh]`` tensors copied into one ``[B, N, len(ts) * H * dh
    + 2]`` buffer two elements in, as head views of it: the models' layout
    (heads split out of one projection), at strides and a base that allow
    the kernels 4-byte copies at most (one element at an odd dh)."""
    b, h, n, dh = ts[0].shape
    w = len(ts) * h * dh
    buf = torch.zeros(b, n, w + 2, dtype=ts[0].dtype, device=ts[0].device)
    packed = buf[..., 2:].view(b, n, len(ts), h, dh)
    views = []
    for i, t in enumerate(ts):
        packed[:, :, i].copy_(t.transpose(1, 2))
        views.append(packed[:, :, i].transpose(1, 2))
    return views


def _sdpa_pinned(q, k, v, scale):
    """The SDPA backend of the attention core's yardstick, pinned with
    ``torch.nn.attention.sdpa_kernel`` so that a run does not pick another
    one from call to call: flash attention where it admits the shape (bf16,
    a head dim that is a multiple of 8), else the memory-efficient kernel,
    else the math composition, each tried with one forward and backward.
    Returns (its name, a context manager that pins it)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for name, backend in (("flash", SDPBackend.FLASH_ATTENTION),
                          ("efficient", SDPBackend.EFFICIENT_ATTENTION),
                          ("math", SDPBackend.MATH)):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        try:
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(*leaves, scale=scale)
                torch.autograd.grad(out, leaves, torch.ones_like(out))
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return name, lambda: sdpa_kernel(backend)
    raise RuntimeError("no SDPA backend takes the core's shape")


def _pinned(pin, fn):
    """fn run under the pinned SDPA backend."""
    def run():
        with pin():
            return fn()
    return run


def core_kernel_phase(digests_only=False):
    from uvc_tpu_torch.ops.attention import (attention, attention_bwd,
                                             attention_bwd_ctx,
                                             attention_bwd_plain,
                                             attention_plain)

    gen = torch.Generator(device="cuda").manual_seed(17)
    results = {}
    for shape, (b, h, n, dh) in CORE_SHAPES.items():
        if digests_only and shape not in PARENT_SHAPES:
            continue
        q, k, v, do = (torch.randn(b, h, n, dh, generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        scale = dh ** -0.5
        out = attention(q, k, v, scale)
        torch.cuda.synchronize()
        ferrs = _check_outputs("attention", shape, [out],
                               [attention_plain(q, k, v, scale)],
                               KERNEL_REL_TOL,
                               again=[attention(q, k, v, scale)])
        grads = attention_bwd(q, k, v, do, scale)
        torch.cuda.synchronize()
        again = attention_bwd(q, k, v, do, scale)
        berrs = _check_outputs("attention_bwd", shape, grads,
                               attention_bwd_plain(q, k, v, do, scale),
                               BWD_REL_TOL, again=again)
        if digests_only:
            print(f"kernel attention      [{shape:10s}] "
                  f"digest={digest([out])}")
            print(f"kernel attention_bwd  [{shape:10s}] "
                  f"digest={digest(grads)}", flush=True)
            if shape in BWD_CTX_SHAPES:
                print(f"kernel attention_bwd_ctx [{shape:10s}] digest="
                      f"{digest(attention_bwd_ctx(q, k, v, do, scale))}",
                      flush=True)
            continue
        views = _packed_views(q, k, v, do)
        check(torch.equal(attention(*views[:3], scale), out)
              and all(torch.equal(a, b) for a, b in
                      zip(attention_bwd(*views, scale), grads)),
              f"attention [{shape}]: head views of a packed buffer and "
              f"contiguous operands differ")
        backend, pin = _sdpa_pinned(q, k, v, scale)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        with pin():
            lib_bwd = _library_backward(
                lambda: F.scaled_dot_product_attention(*leaves, scale=scale),
                leaves, do)
        for name, errs, kern, on_views, plain, lib, bwd in (
                ("attention", ferrs, lambda: attention(q, k, v, scale),
                 lambda: attention(*views[:3], scale),
                 lambda: attention_plain(q, k, v, scale),
                 lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                 False),
                ("attention_bwd", berrs,
                 lambda: attention_bwd(q, k, v, do, scale),
                 lambda: attention_bwd(*views, scale),
                 lambda: attention_bwd_plain(q, k, v, do, scale), lib_bwd,
                 True)):
            bound_ms, bound_by, flops, nbytes = _core_bound(
                b, h, n, dh, "bwd" if bwd else "fwd")
            r = dict(shape=shape, rel_fro=max(e[0] for e in errs),
                     max_abs_err=max(e[1] for e in errs),
                     rel_fro_per_output=[e[0] for e in errs],
                     ms=time_ms(kern, 20), views_ms=time_ms(on_views, 20),
                     plain_ms=time_ms(plain, 3),
                     library_ms=time_ms(_pinned(pin, lib), 20),
                     bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                     bytes=nbytes,
                     library=f"scaled_dot_product_attention ({backend})")
            results[(name, shape)] = r
            print(f"kernel {name:13s} [{shape:10s} B={b} H={h} N={n} "
                  f"dh={dh}] rel_fro per output "
                  f"{' '.join(f'{e[0]:.1e}' for e in errs)} (tol "
                  f"{KERNEL_REL_TOL:g}) max_abs={r['max_abs_err']:.2e} "
                  f"ms={r['ms']:.4f} views_ms={r['views_ms']:.4f} "
                  f"plain_ms={r['plain_ms']:.4f} "
                  f"library_ms(sdpa {backend})={r['library_ms']:.4f} "
                  f"bound={bound_ms * 1e3:.1f}us ({bound_by})"
                  + " two launches bit-identical"
                  + f" head views bit-identical digest="
                  f"{digest(grads if bwd else [out])}", flush=True)
        if shape in BWD_CTX_SHAPES:
            results[("attention_bwd_ctx", shape)] = _bwd_ctx_row(
                shape, q, k, v, do, scale, grads, backend, pin)
    return results


def _bwd_ctx_row(shape, q, k, v, do, scale, grads, backend, pin):
    """Kernel A8 (``attention_bwd_ctx``) against its plain version, every
    output, two launches bit for bit, and its dq, dk, dv bit for bit A9's
    (``grads``) on the same inputs; SDPA forward and backward as the
    yardstick (one PyTorch computation of ctx and the three gradients) on
    the pinned backend ``backend``."""
    from uvc_tpu_torch.ops.attention import (attention_bwd_ctx,
                                             attention_bwd_ctx_plain)

    b, h, n, dh = q.shape
    outs = attention_bwd_ctx(q, k, v, do, scale)
    torch.cuda.synchronize()
    again = attention_bwd_ctx(q, k, v, do, scale)
    errs = _check_outputs("attention_bwd_ctx", shape, outs,
                          attention_bwd_ctx_plain(q, k, v, do, scale),
                          BWD_REL_TOL, again=again)
    check(all(torch.equal(a, g) for a, g in zip(outs[1:], grads)),
          f"attention_bwd_ctx [{shape}]: dq, dk, dv differ from "
          f"attention_bwd's")
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def library():
        ctx = F.scaled_dot_product_attention(*leaves, scale=scale)
        return ctx, torch.autograd.grad(ctx, leaves, do)

    bound_ms, bound_by, flops, nbytes = _core_bound(b, h, n, dh, "bwd_ctx")
    r = dict(shape=shape, rel_fro=max(e[0] for e in errs),
             max_abs_err=max(e[1] for e in errs),
             rel_fro_per_output=[e[0] for e in errs],
             ms=time_ms(lambda: attention_bwd_ctx(q, k, v, do, scale), 20),
             plain_ms=time_ms(
                 lambda: attention_bwd_ctx_plain(q, k, v, do, scale), 3),
             library_ms=time_ms(_pinned(pin, library), 20),
             bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes,
             library=f"scaled_dot_product_attention ({backend})")
    print(f"kernel attention_bwd_ctx [{shape:10s} B={b} H={h} N={n} dh={dh}] "
          f"rel_fro per output (ctx dq dk dv) "
          f"{' '.join(f'{e[0]:.1e}' for e in errs)} (tol {BWD_REL_TOL:g}) "
          f"max_abs={r['max_abs_err']:.2e} ms={r['ms']:.4f} "
          f"plain_ms={r['plain_ms']:.4f} "
          f"library_ms(sdpa {backend} fwd+bwd)={r['library_ms']:.4f} "
          f"bound={bound_ms * 1e3:.1f}us ({bound_by}) two launches "
          f"bit-identical, dq dk dv bit-identical to attention_bwd "
          f"digest={digest(outs)}", flush=True)
    return r


def ablation_phase(card):
    """The three ablations' baseline fine-tune (SE timed, Ghost and Dense
    two steps each), then T2T-ViT-14-SE eval.  Returns the launch counts of
    all their runs."""
    from uvc_tpu_torch.baselines.finetune import build_baseline_eval_step
    from uvc_tpu_torch.baselines.pruning import apply_weight_masks
    from uvc_tpu_torch.configs import get_config
    from uvc_tpu_torch.models import t2t_ablations
    from uvc_tpu_torch.ops import launch_counts, reset_launch_counts
    from uvc_tpu_torch.train.state import TrainHParams

    total = {}
    for i, (name, label, n_attn) in enumerate(ABLATIONS):
        counts, state, wmasks = baseline_phase(
            card, dict(performer=2, performer_bwd=2, attention=n_attn,
                       attention_bwd=n_attn),
            name, label, seed=20 + 3 * i, timed=i == 0)
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        if i == 0:
            se = (get_config(name), label, n_attn, state.params, wmasks)

    cfg, label, n_attn, params, wmasks = se
    thp = TrainHParams()
    step = build_baseline_eval_step(cfg, thp)
    igen = torch.Generator(device="cuda").manual_seed(30)
    images = [torch.randn(BATCH, cfg.img_size, cfg.img_size, cfg.in_chans,
                          generator=igen, device="cuda")
              for _ in range(N_BATCHES)]
    labels = [torch.randint(0, cfg.num_classes, (BATCH,), generator=igen,
                            device="cuda") for _ in range(N_BATCHES)]
    n_img = N_BATCHES * BATCH

    def evaluate():
        tot = {"correct": 0, "loss_sum": 0.0, "count": 0}
        for xb, yb in zip(images, labels):
            m = step(params, wmasks, xb, yb)
            tot = {k: tot[k] + m[k] for k in tot}
        return {k: v.item() for k, v in tot.items()}

    evaluate()
    reset_launch_counts()
    window, secs, ev = passes(evaluate)
    counts = launch_counts()
    runs = N_PASSES * N_BATCHES
    want = {k: 0 for k in counts}
    want.update(performer=2 * runs, attention=n_attn * runs)
    print(f"launches {label} eval {counts} (expected {want})")
    check(counts == want, f"{label} eval launch counts differ")
    check(ev["count"] == n_img and 0 <= ev["correct"] <= ev["count"]
          and ev["loss_sum"] == ev["loss_sum"], f"{label} eval metrics {ev}")
    rates = ", ".join(f"{n_img / t:.1f}" for t in secs)
    print(f"{label} eval (build_baseline_eval_step, masked weights): "
          f"{N_PASSES * n_img / window:.1f} img/s ({N_PASSES} passes of "
          f"{N_BATCHES} batches of {BATCH} in {window:.4f} s; per pass, CUDA "
          f"events: {rates} img/s) [{card}]")
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n

    with torch.no_grad():
        x0 = images[0][:8]
        masked = apply_weight_masks(params, wmasks)
        logits = t2t_ablations.apply(masked, x0, cfg,
                                     dtype=torch.bfloat16).logits
        ref = t2t_ablations.apply(_tree_to(masked, "cpu"), x0.cpu(), cfg,
                                  dtype=torch.bfloat16).logits
    rel, mx = rel_err(logits.cpu(), ref)
    print(f"{label} eval logits, card vs CPU plain path (8 images): "
          f"rel_fro={rel:.2e} max_abs={mx:.2e} (tol {MODEL_REL_TOL})")
    check(torch.isfinite(logits).all().item() and rel <= MODEL_REL_TOL,
          f"{label}: card and CPU plain path disagree")
    return total


# ---------------------------------------------------------------------------
# phase 9: ViT-H/14 stage 1, the wide-model backward route and kernel A8
# ---------------------------------------------------------------------------

VIT_H_BATCH = 32
# card vs CPU: full width, depth cut to 4, batch 2, which keeps the CPU
# plain path's share of the run small
VIT_H_CPU_DEPTH, VIT_H_CPU_BATCH = 4, 2


def _grown_vit(cfg, seed):
    """ViT parameters in ``vit.init_params``'s layout at ``cfg``'s depth:
    ``init_params`` at depth 1, its blocks repeated to the depth with the
    four projection kernels drawn anew on the card (std 0.02 normals), and
    a random classifier head.  ``init_params`` draws truncated normals
    on the host, which is slow for ViT-H/14's 632 M weights."""
    from uvc_tpu_torch.models import vit
    from uvc_tpu_torch.utils.tree import tree_map

    params = vit.init_params(torch.Generator().manual_seed(seed),
                             cfg.replace(depth=1))
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def grow(t):
        return t.repeat(cfg.depth, *([1] * (t.dim() - 1)))

    params["blocks"] = tree_map(grow, params["blocks"])
    for sub in ("qkv", "proj", "fc1", "fc2"):
        k = params["blocks"][sub]["kernel"]
        params["blocks"][sub]["kernel"] = 0.02 * torch.randn(
            k.shape, generator=gen, device="cuda")
    for key in ("block_gating", "attn_gating", "mlp_gating"):
        params[key] = grow(params[key])
    params["head"]["kernel"] = 0.05 * torch.randn(
        params["head"]["kernel"].shape, generator=gen, device="cuda")
    return params


def vit_h_phase(card):
    """The stage-1 step on ViT-H/14 at full width and depth (32 blocks,
    dm 1280, 16 heads of 80, F 5120, N 257) with bench.py's flagship
    settings at batch 32: per step K1 64 (student and teacher), K3 32, K2
    32 forward, and per student block A2 and A4 (dm 1280, within the
    LayerNorm backward's width; past it the composed routes with A8).  3
    untimed and 10 timed steps, a gating-warmup step, a profiled step, one
    block's backward by either route timed alone, and one step at depth 4
    and batch 2 on the card against the CPU plain path.  Returns the timed
    window's launch counts."""
    from uvc_tpu_torch.compress.minimax import init_compression_state
    from uvc_tpu_torch.compress.resource import build_macs_table
    from uvc_tpu_torch.compress.state import MinimaxHParams
    from uvc_tpu_torch.configs import get_config
    from uvc_tpu_torch.ops import (backward_launch_counts, composed_counts,
                                   launch_counts, reset_launch_counts)
    from uvc_tpu_torch.ops.attention import _MAX_DM_BWD
    from uvc_tpu_torch.train.state import TrainHParams, create_train_state
    from uvc_tpu_torch.train.step import build_stage1_step, draw_stage1_noise
    from uvc_tpu_torch.utils.tree import tree_leaves

    cfg = get_config("ViT-H_14")
    ln, b = cfg.depth, VIT_H_BATCH
    hp = MinimaxHParams(enable_patch_gating=2, gating_interval=100)
    thp = TrainHParams()
    t0 = time.perf_counter()
    params, teacher = _grown_vit(cfg, 40), _grown_vit(cfg, 41)
    n_params = sum(t.numel() for t in tree_leaves(params))
    state = create_train_state(params, thp,
                               init_compression_state(cfg, hp, "cuda"))
    step = build_stage1_step(cfg, build_macs_table(cfg), hp, thp,
                             warmup=False)
    igen = torch.Generator(device="cuda").manual_seed(42)
    x = torch.randn(b, cfg.img_size, cfg.img_size, cfg.in_chans,
                    generator=igen, device="cuda")
    labels = torch.randint(0, cfg.num_classes, (b,), generator=igen,
                           device="cuda")
    ngen = torch.Generator().manual_seed(43)
    torch.cuda.synchronize()
    print(f"ViT-H/14: {n_params} parameters, student and teacher made in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    def run(st, fn, n):
        losses = []
        for _ in range(n):
            noise = draw_stage1_noise(ngen, cfg, hp, thp, b, "cuda")
            st, m = fn(st, teacher, x, labels, noise, TRAIN_TAU)
            losses.append(m["loss"])
        return st, losses, m

    t0 = time.perf_counter()
    state, _, _ = run(state, step, TRAIN_WARM)
    torch.cuda.synchronize()
    print(f"ViT-H/14 train: {TRAIN_WARM} untimed steps in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    state, losses, m = run(state, step, TRAIN_TIMED)
    issued = time.perf_counter() - t0
    torch.cuda.synchronize()
    window = time.perf_counter() - t0
    counts = {**launch_counts(), **backward_launch_counts(),
              **composed_counts()}
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in counts}
    # the student's backward: A2 and A4 up to the LayerNorm backward's
    # width, the composed routes (with A8) past it
    bwd = (dict(attention_bwd_ctx=ln, layer_attention_ln_bwd_composed=ln,
                mlp_ln_blend_bwd_composed=ln)
           if cfg.embed_dim > _MAX_DM_BWD else
           dict(layer_attention_ln_bwd=ln, mlp_ln_blend_bwd=ln))
    want.update({k: v * TRAIN_TIMED for k, v in dict(
        layer_attention_ln=2 * ln, mlp_ln=ln, mlp_ln_blend=ln,
        **bwd).items()})
    print(f"launches ViT-H/14 stage-1 {counts} (expected {want})")
    check(counts == want, "ViT-H/14 stage-1 step launch counts differ")
    losses = torch.stack(losses).float().cpu()
    check(torch.isfinite(losses).all().item(),
          f"non-finite ViT-H/14 stage-1 losses {losses.tolist()}")
    print(f"stage-1 train step (ViT-H/14, 32 blocks, dm 1280, 16 heads of "
          f"80, batch {b}, bf16): {TRAIN_TIMED * b / window:.1f} img/s "
          f"({TRAIN_TIMED} steps in {window:.4f} s, "
          f"{1e3 * window / TRAIN_TIMED:.2f} ms/step; the host had issued "
          f"them after {issued:.4f} s) [{card}]")
    print(f"  losses {[round(v, 4) for v in losses.tolist()]}; last step "
          f"grad_norm={float(m['grad_norm']):.4f} "
          f"resource={float(m['resource']):.4f}")
    print(f"ViT-H/14 train max_memory_allocated={peak} bytes "
          f"({peak / 2**30:.2f} GiB) [{card}]")

    wstep = build_stage1_step(cfg, build_macs_table(cfg), hp, thp,
                              warmup=True)
    before = state.params["block_gating"].clone()
    wstate, wl, _ = run(state, wstep, 1)
    check(torch.equal(wstate.params["block_gating"], before),
          "the ViT-H/14 warmup step moved block_gating")
    check(torch.isfinite(wl[0]).item(), "non-finite ViT-H/14 warmup loss")
    print(f"ViT-H/14 warmup step: block_gating unchanged bit for bit, "
          f"loss={float(wl[0]):.4f}")
    del wstate

    profile_phase(card, {"ViT-H/14 stage-1 train step": lambda: run(
        state, step, 1)}, top=30, batch=b,
        watch={"A2 (LayerNorm, qkv GEMM, t GEMM, core q, core kv, ...)": (
                   "layer_norm_kernel", "gemm_wg_kernel<0,",
                   "gemm_wg_kernel<5,", "core_bwd_q_wg_kernel",
                   "core_bwd_kv_wg_kernel"),
               "the core backward, query and key side (A2; A8 on the "
               "composed route)": "core_bwd_",
               "A4's h and dam0 GEMMs with the activation backward "
               "(gemm_act_bwd)": "gemm_act_bwd_kernel",
               "the LayerNorm backward (A2 and A4)": "ln_bwd_kernel",
               "the in-order sums (reduce_parts_kernel)":
                   "reduce_parts_kernel",
               "K1 (LayerNorm, qkv GEMM, core, projection GEMM)": (
                   "layer_norm_kernel", "gemm_wg_kernel<0,",
                   "core_fwd_wg_kernel", "gemm_wg_kernel<2,"),
               "K1's attention core (core_fwd_wg)": "core_fwd_wg_kernel",
               "K2 (LayerNorm, fc1 GEMM, fc2 GEMM)": (
                   "layer_norm_kernel", "gemm_wg_kernel<1,",
                   "gemm_wg_kernel<2,"),
               "K2's and K3's fc1 GEMMs (gemm_wg<EPI_GELU_MASK>)":
                   "gemm_wg_kernel<1,",
               "K3 (LayerNorm, fc1 GEMM, fc2 GEMM)": (
                   "layer_norm_kernel", "gemm_wg_kernel<1,",
                   "gemm_wg_kernel<3,"),
               "LayerNorm (K1 64, K2 32, K3 32, A2 32, A4 32 a step)":
                   "layer_norm_kernel"})
    autograd_profile(card, "ViT-H/14 stage-1 train step",
                     lambda: run(state, step, 1))
    composed_route_times(card, cfg)
    del state, params, teacher

    small = cfg.replace(depth=VIT_H_CPU_DEPTH)
    sb = VIT_H_CPU_BATCH
    sstate = create_train_state(_grown_vit(small, 44), thp,
                                init_compression_state(small, hp, "cuda"))
    steacher = _grown_vit(small, 45)
    sstep = build_stage1_step(small, build_macs_table(small), hp, thp,
                              warmup=False)
    noise = draw_stage1_noise(ngen, small, hp, thp, sb, "cpu")
    _, gm = sstep(sstate, steacher, x[:sb], labels[:sb],
                  _noise_to(noise, "cuda"), TRAIN_TAU)
    _, cm = sstep(_state_to(sstate, "cpu"), _tree_to(steacher, "cpu"),
                  x[:sb].cpu(), labels[:sb].cpu(), noise, TRAIN_TAU)
    card_vs_cpu(f"ViT-H/14 stage-1 step (depth {VIT_H_CPU_DEPTH})", sb, gm,
                cm, ("loss", "grad_norm", "resource"))
    return counts


# the PyTorch operations whose device time autograd_profile lists beside
# the autograd nodes: the gradient accumulation's adds and the fills of
# the zero gradients that a select's backward writes
GLUE_OPS = ("aten::add_", "aten::add", "aten::fill_", "aten::zero_",
            "aten::copy_", "aten::stack")


def autograd_profile(card, label, fn, top=12):
    """The device time of one call of fn by autograd node (torch.profiler's
    ``autograd::engine::evaluate_function`` ranges, each charged the
    kernels launched inside it, the gradient accumulation of its outputs
    included), the ``top`` nodes by total device ms, and the device time
    of GLUE_OPS wherever they run (forward, backward, optimizer)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    prefix = "autograd::engine::evaluate_function: "
    nodes = sorted(((e.device_time_total, e.count, e.key[len(prefix):])
                    for e in avgs if e.key.startswith(prefix)),
                   reverse=True)
    print(f"autograd nodes of one {label} by device time [{card}]:")
    for t, count, key in nodes[:top]:
        print(f"  {t / 1e3:9.3f} ms  x{count:<5d} {key}")
    glue = {e.key: (e.device_time_total, e.count) for e in avgs
            if e.key in GLUE_OPS}
    print("  glue ops (anywhere in the step): " + ", ".join(
        f"{k} {glue[k][0] / 1e3:.3f} ms x{glue[k][1]}" for k in GLUE_OPS
        if k in glue), flush=True)


def composed_route_times(card, cfg):
    """One block's backward at ViT-H/14's stage-1 shape by either route,
    each timed alone: the kernels A2 (``layer_attention_ln_bwd``) and A4
    (``mlp_ln_blend_bwd``) beside the composed routes, with the composed
    attention route's A8 and its f32 matmul of ``dmask`` (the one product
    it keeps in f32); the route whose block is faster is the one the
    autograd Functions should take at dm 1280 (``_MAX_DM_BWD``)."""
    from uvc_tpu_torch.ops.attention import (_MAX_DM_BWD, _rows_as_heads,
                                             attention_bwd_ctx,
                                             layer_attention_ln_bwd,
                                             layer_attention_ln_bwd_composed)
    from uvc_tpu_torch.ops.mlp import (mlp_ln_blend_bwd,
                                       mlp_ln_blend_bwd_composed)

    b, n, dm, heads, f = VIT_H_BATCH, cfg.seq_len, cfg.embed_dim, \
        cfg.num_heads, cfg.mlp_hidden
    dh = dm // heads
    gen = torch.Generator(device="cuda").manual_seed(46)
    t = _inputs(gen, b, n, dm, heads, f, dh)
    do = (torch.randn(b, n, dm, generator=gen, device="cuda")
          * 0.1).to(torch.bfloat16)
    eps = cfg.layer_norm_eps
    akw = dict(num_heads=heads, scale=dh ** -0.5, eps=eps)
    qkv = torch.randn(b, n, 3 * dm, generator=gen, device="cuda").to(
        torch.bfloat16)
    dctx = torch.randn(b, n, dm, generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = _rows_as_heads(qkv, 3, heads)
    dctx_h, = _rows_as_heads(dctx, 1, heads)
    wproj32 = t["wproj"].float()
    aargs = (t["x"], t["g"], t["b"], t["wqkv"], t["bqkv"], t["wproj"],
             t["bproj"], t["amask"], do)
    margs = (t["x"], t["xin"], t["d"], t["g"], t["b"], t["w1"], t["b1"],
             t["w2"], t["b2"], t["fmask"], do)
    times = {
        "layer_attention_ln_bwd_composed": time_ms(
            lambda: layer_attention_ln_bwd_composed(*aargs, **akw), 10),
        "  of it attention_bwd_ctx (A8)": time_ms(
            lambda: attention_bwd_ctx(q, k, v, dctx_h, dh ** -0.5), 10),
        "  of it the f32 matmul do . Wproj^T (dmask)": time_ms(
            lambda: do.float() @ wproj32.T, 10),
        "layer_attention_ln_bwd (A2)": time_ms(
            lambda: layer_attention_ln_bwd(*aargs, **akw), 10),
        "mlp_ln_blend_bwd_composed": time_ms(
            lambda: mlp_ln_blend_bwd_composed(*margs, eps=eps), 10),
        "mlp_ln_blend_bwd (A4)": time_ms(
            lambda: mlp_ln_blend_bwd(*margs, eps=eps), 10),
    }
    for name, ms in times.items():
        print(f"one block's backward at ViT-H/14 [B={b} N={n} dm={dm} "
              f"F={f}]: {name} {ms:.4f} ms [{card}]")
    route = "kernel" if dm <= _MAX_DM_BWD else "composed"
    for kern, comp in (("layer_attention_ln_bwd (A2)",
                        "layer_attention_ln_bwd_composed"),
                       ("mlp_ln_blend_bwd (A4)",
                        "mlp_ln_blend_bwd_composed")):
        faster = "kernel" if times[kern] < times[comp] else "composed"
        print(f"  {kern}: {times[kern]:.4f} ms against the composed "
              f"{times[comp]:.4f} ms: the {faster} route is faster; the "
              f"step takes the {route} route at dm {dm}")


# ---------------------------------------------------------------------------
# phase 11: stage 2 and compact stage 2
# ---------------------------------------------------------------------------

# MLP units each layer keeps in phase 11: 700 of DeiT-Small's 1536, so a
# compact layer's padded width fk is 768 with 68 padding slots (with 768
# kept units the padding checks would check nothing); T2T-ViT-14 keeps
# 576 of 1152 (fk 640), as in phase 7
S2_KEPT_UNITS = 700


def _stage2_model(cfg, seed, skipped, kept_units):
    """A seeded random student with phase 4's discovered architecture (3
    of the heads pruned whole, random within-head dims, ``kept_units`` MLP
    units kept in each layer, the blocks ``skipped`` gated off), its masks
    and a seeded random dense teacher."""
    from uvc_tpu_torch.compress.masks import build_masks
    from uvc_tpu_torch.models import get_model

    gen = torch.Generator().manual_seed(seed)
    model = get_model(cfg)
    params, teacher = (model.init_params(gen, cfg) for _ in range(2))
    for tree in (params, teacher):
        tree["head"]["kernel"] = 0.05 * torch.randn(
            tree["head"]["kernel"].shape, generator=gen).cuda()
    ln = cfg.depth
    # s[:, 1] counts the pruned units (compress/masks.py)
    s = torch.tensor([[3.0, float(cfg.mlp_hidden - kept_units)]] * ln)
    r = torch.randint(0, cfg.head_size // 4 + 1, (ln, cfg.num_heads),
                      generator=gen).float()
    masks = build_masks(params, s.cuda(), r.cuda(), cfg)
    for i in skipped:
        params["block_gating"][i] = torch.tensor([1.0, -1.0])
    check(bool((masks["mlp"].sum(dim=1) == kept_units).all()),
          "the masks do not keep the asked MLP units")
    return params, teacher, masks


def _stage2_runner(fn, cfg, thp, teacher, masks, x, labels, ngen):
    """``run(state, n, b)``: n steps of the stage-2 step ``fn`` on the
    first b images, each with a fresh draw from ``ngen``; returns (state,
    losses, the last metrics)."""
    from uvc_tpu_torch.train.step import draw_stage2_noise

    def run(st, n, b=BATCH):
        losses = []
        for _ in range(n):
            noise = draw_stage2_noise(ngen, cfg, thp, b, "cuda")
            st, m = fn(st, teacher, masks, x[:b], labels[:b], noise)
            losses.append(m["loss"])
        return st, losses, m
    return run


def _count_window(run, state, steps):
    """``steps`` steps timed as one window from an idle card, their
    launches counted; returns (state, losses, metrics, counts, window s,
    the host's issue s, peak bytes)."""
    from uvc_tpu_torch.ops import (backward_launch_counts, composed_counts,
                                   launch_counts, reset_launch_counts)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    state, losses, m = run(state, steps)
    issued = time.perf_counter() - t0
    torch.cuda.synchronize()
    window = time.perf_counter() - t0
    counts = {**launch_counts(), **backward_launch_counts(),
              **composed_counts()}
    return (state, torch.stack(losses).float().cpu(), m, counts, window,
            issued, torch.cuda.max_memory_allocated())


def _frozen_moment_leaks(mu, masks, cfg, skipped):
    """(coordinates, of them with a nonzero AdamW first moment) over every
    coordinate whose stage-2 gradient is exactly zero: each parameter of
    the skipped blocks; the pruned units' fc1 columns, fc1 biases and fc2
    rows; q, k, v (weights and biases) of each head pruned whole; the v
    columns and proj rows of each pruned dim.  A kept head's pruned dims
    keep their q and k gradients."""
    from uvc_tpu_torch.utils.tree import tree_leaves

    d, h, hs = cfg.embed_dim, cfg.num_heads, cfg.head_size
    blocks = mu["blocks"]
    picks = [leaf[i] for i in skipped for leaf in tree_leaves(blocks)]
    for i in range(cfg.depth):
        if i in skipped:
            continue
        units = masks["mlp"][i] == 0
        cols = masks["attn"][i] == 0
        whole = (~masks["attn"][i].reshape(h, hs).bool().any(dim=1)
                 ).repeat_interleave(hs)
        w, b = blocks["qkv"]["kernel"][i], blocks["qkv"]["bias"][i]
        picks += [blocks["fc1"]["kernel"][i][:, units],
                  blocks["fc1"]["bias"][i][units],
                  blocks["fc2"]["kernel"][i][units],
                  blocks["proj"]["kernel"][i][cols],
                  w[:, 2 * d:][:, cols], b[2 * d:][cols]]
        for part in (slice(0, d), slice(d, 2 * d)):
            picks += [w[:, part][:, whole], b[part][whole]]
    return (sum(p.numel() for p in picks),
            sum(int((p != 0).sum()) for p in picks))


def _compact_leaks(state, meta):
    """(padding and v-masked coordinates, of them nonzero): the fc1 / fc2
    padding slots of the compact weights and their first moments, and the
    first moments of the v-masked proj rows and qkv v columns."""
    picks = []
    for blk, mu, plan in zip(state.params["layers"],
                             state.opt_state.mu["layers"], meta.plans):
        nk = len(plan["kept_units"])
        for tree in (blk, mu):
            picks += [tree["fc1"]["kernel"][:, nk:], tree["fc1"]["bias"][nk:],
                      tree["fc2"]["kernel"][nk:]]
        rows = torch.as_tensor(plan["vmask"],
                               device=mu["proj"]["kernel"].device) == 0
        da = len(plan["vmask"])
        picks += [mu["proj"]["kernel"][rows],
                  mu["qkv"]["kernel"][:, 2 * da:][:, rows],
                  mu["qkv"]["bias"][2 * da:][rows]]
    return (sum(p.numel() for p in picks),
            sum(int((p != 0).sum()) for p in picks))


def _dense_layer_stubs(cfg):
    """``compact_flops_fraction``'s view of the dense student's blocks
    (all of them run in the dense step), on the meta device."""
    return [{"proj": {"kernel": torch.empty(cfg.embed_dim, cfg.embed_dim,
                                            device="meta")},
             "fc1": {"kernel": torch.empty(cfg.embed_dim, cfg.mlp_hidden,
                                           device="meta")}}
            for _ in range(cfg.depth)]


def _one_step_each(label, cfg, step, cstep, state, meta, masks, teacher,
                   thp, x, labels, ngen):
    """One dense stage-2 step and one compact_ft step from one state with
    one draw (the compact state the dense one's kept coordinates, moments
    and count included): loss and grad_norm, and ``scatter_to_dense`` of
    the compact result against the dense step on the kept coordinates,
    within TRAIN_REL_TOL; the qkv biases' key thirds within the step's
    lr."""
    import dataclasses

    from uvc_tpu_torch.train.compact_ft import (compact_train_tree,
                                                scatter_to_dense)
    from uvc_tpu_torch.train.state import AdamWState
    from uvc_tpu_torch.train.step import draw_stage2_noise
    from uvc_tpu_torch.utils.tree import tree_leaves, tree_leaves_with_path

    keep = meta.block_keep

    def project(tree):
        return compact_train_tree(tree, masks, cfg, block_keep=keep)[0]

    opt = state.opt_state
    c_one = dataclasses.replace(
        state, params=project(state.params),
        opt_state=AdamWState(opt.count, project(opt.mu), project(opt.nu)))
    noise = draw_stage2_noise(ngen, cfg, thp, BATCH, "cuda")
    d_new, dm_ = step(state, teacher, masks, x, labels, noise)
    c_new, cm_ = cstep(c_one, teacher, masks, x, labels, noise)
    for k in ("loss", "grad_norm"):
        a, b = float(cm_[k]), float(dm_[k])
        rel = abs(a - b) / abs(b)
        print(f"{label} compact vs dense stage-2 step (batch {BATCH}): {k} "
              f"{a:.6f} vs {b:.6f}, rel {rel:.2e} (tol {TRAIN_REL_TOL})")
        check(rel <= TRAIN_REL_TOL,
              f"{label}: compact and dense steps disagree on {k}")
    scattered = scatter_to_dense(c_new.params, meta, d_new.params)
    # the key third of the qkv bias gets a rounding-noise gradient (a
    # key's bias adds one constant to a query's logits): it is held to the
    # step's lr, the most that one AdamW step moves it, the rest relative
    lr = float(dm_["lr"])
    worst, key_bias = (0.0, ""), 0.0
    for (path, a), (_, b) in zip(tree_leaves_with_path(project(scattered)),
                                 tree_leaves_with_path(
                                     project(d_new.params))):
        if path[-2:] == ("qkv", "bias"):
            third = a.shape[0] // 3
            key_bias = max(key_bias, (a[third:2 * third]
                                      - b[third:2 * third]).abs().max().item())
            a, b = (torch.cat([t[:third], t[2 * third:]]) for t in (a, b))
        if b.any():
            worst = max(worst, (rel_err(a, b)[0], ".".join(path)))
    print(f"{label} scatter_to_dense(compact step) vs the dense step on the "
          f"kept coordinates: worst leaf rel_fro {worst[0]:.2e} ({worst[1]}) "
          f"(tol {TRAIN_REL_TOL}); the qkv biases' key thirds max_abs "
          f"{key_bias:.2e} (tol lr {lr:.3e})")
    check(worst[0] <= TRAIN_REL_TOL, f"{label}: compact and dense step "
          "results disagree on the kept coordinates")
    check(key_bias <= lr, f"{label}: the qkv biases' key thirds moved more "
          "than lr")
    mu_c = torch.cat([t.flatten() for t in tree_leaves(c_new.opt_state.mu)])
    mu_d = torch.cat([t.flatten() for t in tree_leaves(
        project(d_new.opt_state.mu))])
    print(f"  the step's first moments, compact vs dense, kept coordinates: "
          f"rel_fro {rel_err(mu_c, mu_d)[0]:.2e}")


def stage2_phase(card):
    """Phase 11 on DeiT-Small: the dense stage-2 step and compact_ft, each
    3 untimed + 10 timed steps with their exact launches, the frozen and
    padded coordinates checked, one step of each from one state, the card
    against the CPU, a profiled step of each.  Returns the launch counts
    of the two timed windows."""
    from uvc_tpu_torch.compress.state import MinimaxHParams
    from uvc_tpu_torch.configs import get_config
    from uvc_tpu_torch.infer.compact import compact_flops_fraction
    from uvc_tpu_torch.train.compact_ft import (build_compact_stage2_step,
                                                compact_train_tree)
    from uvc_tpu_torch.train.state import TrainHParams, create_train_state
    from uvc_tpu_torch.train.step import build_stage2_step, draw_stage2_noise
    from uvc_tpu_torch.utils.tree import tree_leaves

    cfg = get_config("deit_small_patch16_224")
    ln, kept = cfg.depth, cfg.depth - len(SKIPPED_BLOCKS)
    params, teacher, masks = _stage2_model(cfg, 60, SKIPPED_BLOCKS,
                                           S2_KEPT_UNITS)
    # the post_train recipe: soft distillation, mixup / cutmix, smoothing
    # 0.1, AdamW, bf16; the physical token drop at ratio 0.7
    hp = MinimaxHParams(enable_patch_gating=2, patch_ratio=TOKEN_RATIO)
    thp = TrainHParams()
    igen = torch.Generator(device="cuda").manual_seed(61)
    x = torch.randn(BATCH, cfg.img_size, cfg.img_size, cfg.in_chans,
                    generator=igen, device="cuda")
    labels = torch.randint(0, cfg.num_classes, (BATCH,), generator=igen,
                           device="cuda")
    ngen = torch.Generator().manual_seed(62)

    def runner(fn):
        return _stage2_runner(fn, cfg, thp, teacher, masks, x, labels, ngen)

    def window(label, run, state, want):
        t0 = time.perf_counter()
        state, _, _ = run(state, TRAIN_WARM)
        torch.cuda.synchronize()
        print(f"{label}: {TRAIN_WARM} untimed steps in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        state, losses, m, counts, secs, issued, peak = _count_window(
            run, state, TRAIN_TIMED)
        expect = {k: 0 for k in counts}
        expect.update({k: v * TRAIN_TIMED for k, v in want.items()})
        print(f"launches {label} {counts} (expected {expect})")
        check(counts == expect, f"{label} launch counts differ")
        check(torch.isfinite(losses).all().item(),
              f"non-finite {label} losses {losses.tolist()}")
        print(f"{label} (DeiT-Small, batch {BATCH}, bf16, token ratio "
              f"{TOKEN_RATIO}): {TRAIN_TIMED * BATCH / secs:.1f} img/s "
              f"({TRAIN_TIMED} steps in {secs:.4f} s, "
              f"{1e3 * secs / TRAIN_TIMED:.2f} ms/step; the host had issued "
              f"them after {issued:.4f} s) [{card}]")
        print(f"  losses {[round(v, 4) for v in losses.tolist()]}; last step "
              f"grad_norm={float(m['grad_norm']):.4f} lr={float(m['lr']):.3e}")
        print(f"{label} max_memory_allocated={peak} bytes "
              f"({peak / 2**20:.1f} MiB) [{card}]")
        return state, counts

    # dense stage 2: the student's 12 blocks run K1 and K3 forward, A2 and
    # A4 backward (a skipped block's blend with d = (1, 0) too); the
    # teacher K1 and K2
    step = build_stage2_step(cfg, hp, thp)
    run = runner(step)
    state, counts = window("stage-2 train step", run,
                           create_train_state(params, thp), dict(
                               layer_attention_ln=2 * ln, mlp_ln=ln,
                               mlp_ln_blend=ln, layer_attention_ln_bwd=ln,
                               mlp_ln_blend_bwd=ln))
    for key in ("block_gating", "token_scorer"):
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(state.params[key]), tree_leaves(params[key])))
        check(same, f"the stage-2 steps moved {key}")
    print("stage-2: block_gating and token_scorer unchanged bit for bit")
    n_zero, leaked = _frozen_moment_leaks(state.opt_state.mu, masks, cfg,
                                          SKIPPED_BLOCKS)
    print(f"stage-2 coordinates with an exactly-zero gradient: {n_zero}, "
          f"with a nonzero AdamW first moment: {leaked}")
    check(n_zero > 0 and leaked == 0,
          "a masked, pruned or skipped coordinate received a gradient")

    # compact_ft on the same state: 10 kept layers at 3 heads (da 192) and
    # fk 768; the student runs K1 / K2 forward, A2 / A6 backward
    ctree, meta = compact_train_tree(state.params, masks, cfg)
    check(len(meta.plans) == kept
          and all(p["hk"] == 3 and p["fk"] == 768 for p in meta.plans),
          "compact_ft layers are not 3 heads / fk 768")
    cstep = build_compact_stage2_step(cfg, hp, thp, meta)
    crun = runner(cstep)
    cstate, ccounts = window("compact stage-2 train step", crun,
                             create_train_state(ctree, thp), dict(
                                 layer_attention_ln=ln + kept,
                                 mlp_ln=ln + kept,
                                 layer_attention_ln_bwd=kept,
                                 mlp_ln_bwd=kept))
    n_pad, leaked = _compact_leaks(cstate, meta)
    print(f"compact_ft padding and v-masked coordinates: {n_pad}, nonzero: "
          f"{leaked}")
    check(n_pad > 0 and leaked == 0,
          "a compact padding slot or v-masked row moved")
    check(all(torch.equal(a, b) for a, b in zip(
        tree_leaves(cstate.params["top"]["token_scorer"]),
        tree_leaves(params["token_scorer"]))), "compact_ft moved the scorer")
    frac_c = compact_flops_fraction(ctree["layers"], cfg, TOKEN_RATIO)
    frac_d = compact_flops_fraction(_dense_layer_stubs(cfg), cfg,
                                    TOKEN_RATIO)
    print(f"student forward FLOPs, compact / dense stage 2: "
          f"{frac_c / frac_d:.4f} ({frac_c:.4f} / {frac_d:.4f} of the dense "
          f"model without the token drop)")

    _one_step_each("DeiT-Small", cfg, step, cstep, state, meta, masks,
                   teacher, thp, x, labels, ngen)

    profile_phase(card, {"stage-2 train step": lambda: run(state, 1),
                         "compact stage-2 train step":
                             lambda: crun(cstate, 1)}, top=14)

    # the card against the CPU plain path: one step of each at batch 8
    small = 8
    for label, fn, st in (("stage-2", step, state),
                          ("compact stage-2", cstep, cstate)):
        noise = draw_stage2_noise(ngen, cfg, thp, small, "cpu")
        _, gm = fn(st, teacher, masks, x[:small], labels[:small],
                   _noise_to(noise, "cuda"))
        _, cm = fn(_state_to(st, "cpu"), _tree_to(teacher, "cpu"),
                   _tree_to(masks, "cpu"), x[:small].cpu(),
                   labels[:small].cpu(), noise)
        card_vs_cpu(f"{label} step", small, gm, cm, ("loss", "grad_norm"))
    return counts, ccounts


def t2t_stage2_phase(card):
    """Phase 11 on T2T-ViT-14 with phase 7's seeded architecture (blocks 4
    and 9 gated off): the dense and compact stage-2 steps, 1 untimed + 2
    counted steps each at batch 64, and one batch-8 compact step on the
    card against the CPU.  Returns the launch counts."""
    from uvc_tpu_torch.compress.state import MinimaxHParams
    from uvc_tpu_torch.configs import get_config
    from uvc_tpu_torch.train.compact_ft import (build_compact_stage2_step,
                                                compact_train_tree)
    from uvc_tpu_torch.train.state import TrainHParams, create_train_state
    from uvc_tpu_torch.train.step import build_stage2_step, draw_stage2_noise

    cfg = get_config("t2t_vit_14")
    ln, kept = cfg.depth, cfg.depth - len(T2T_SKIPPED_BLOCKS)
    params, teacher, masks = _stage2_model(cfg, 63, T2T_SKIPPED_BLOCKS,
                                           cfg.mlp_hidden // 2)
    hp = MinimaxHParams()          # the T2T forward selects no tokens
    thp = TrainHParams()
    igen = torch.Generator(device="cuda").manual_seed(64)
    x = torch.randn(BATCH, cfg.img_size, cfg.img_size, cfg.in_chans,
                    generator=igen, device="cuda")
    labels = torch.randint(0, cfg.num_classes, (BATCH,), generator=igen,
                           device="cuda")
    ngen = torch.Generator().manual_seed(65)

    step = build_stage2_step(cfg, hp, thp)
    ctree, meta = compact_train_tree(params, masks, cfg)
    check(len(meta.plans) == kept
          and all(p["hk"] == 3 and p["fk"] == 640 for p in meta.plans),
          "compact T2T layers are not 3 heads / fk 640")
    cstep = build_compact_stage2_step(cfg, hp, thp, meta)
    # per step: the performer's two stages in student and teacher, the
    # student's backward through both (the first without dx)
    paths = (("T2T-ViT-14 stage-2", step, create_train_state(params, thp),
              dict(layer_attention_ln=2 * ln, mlp_ln=ln, mlp_ln_blend=ln,
                   layer_attention_ln_bwd=ln, mlp_ln_blend_bwd=ln)),
             ("T2T-ViT-14 compact stage-2", cstep,
              create_train_state(ctree, thp),
              dict(layer_attention_ln=ln + kept, mlp_ln=ln + kept,
                   layer_attention_ln_bwd=kept, mlp_ln_bwd=kept)))
    all_counts = []
    for label, fn, st, want in paths:
        run = _stage2_runner(fn, cfg, thp, teacher, masks, x, labels, ngen)
        st, _, _ = run(st, 1)
        st, losses, m, counts, secs, issued, _ = _count_window(run, st, 2)
        expect = {k: 0 for k in counts}
        expect.update({k: 2 * v for k, v in dict(
            want, performer=4, performer_bwd=2).items()})
        print(f"launches {label} {counts} (expected {expect})")
        check(counts == expect, f"{label} launch counts differ")
        check(torch.isfinite(losses).all().item(),
              f"non-finite {label} losses {losses.tolist()}")
        check(torch.equal(st.params["t2t"]["attention1"]["prm_w"]
                          if "t2t" in st.params else
                          st.params["top"]["t2t"]["attention1"]["prm_w"],
                          params["t2t"]["attention1"]["prm_w"]),
              f"{label}: the frozen random features moved")
        print(f"{label} step (batch {BATCH}, bf16): 2 steps in {secs:.4f} s "
              f"({2 * BATCH / secs:.1f} img/s; issued after {issued:.4f} s) "
              f"losses {[round(v, 4) for v in losses.tolist()]} [{card}]")
        all_counts.append(counts)
        last = (fn, st)

    n_pad, leaked = _compact_leaks(last[1], meta)
    print(f"T2T-ViT-14 compact_ft padding and v-masked coordinates: {n_pad}, "
          f"nonzero: {leaked}")
    check(n_pad > 0 and leaked == 0,
          "a T2T compact padding slot or v-masked row moved")

    fn, st = last
    small = 8
    noise = draw_stage2_noise(ngen, cfg, thp, small, "cpu")
    _, gm = fn(st, teacher, masks, x[:small], labels[:small],
               _noise_to(noise, "cuda"))
    _, cm = fn(_state_to(st, "cpu"), _tree_to(teacher, "cpu"),
               _tree_to(masks, "cpu"), x[:small].cpu(), labels[:small].cpu(),
               noise)
    card_vs_cpu("T2T-ViT-14 compact stage-2 step", small, gm, cm,
                ("loss", "grad_norm"))
    return {k: sum(c[k] for c in all_counts) for k in all_counts[0]}


# ---------------------------------------------------------------------------
# phase 12: the two-stage pipeline through its CLIs
# ---------------------------------------------------------------------------

PIPE_MODEL = "deit_small_patch16_224"
PIPE_STEPS, PIPE_EVAL_BATCHES, PIPE_CLASSES = 12, 8, 10
PIPE_TOKEN_RATIO = 0.7
# every leaf of the resumed run's epoch-2 checkpoint against the first
# run's, relative Frobenius
RESUME_REL_TOL = 2e-2
# the flagship settings' launches on DeiT-Small's 12 blocks: a train step
# runs the student's and the teacher's K1, the teacher's K2, the gated
# student's K3, and the student's A2 and A4; an eval batch (masked dense,
# hard gating) K1 and K3 in every block, whichever blocks the gating
# keeps, since the blend kernel passes a skipped block's input through
PIPE_TRAIN_STEP = {"layer_attention_ln": 24, "mlp_ln": 12,
                   "mlp_ln_blend": 12, "layer_attention_ln_bwd": 12,
                   "mlp_ln_blend_bwd": 12}
PIPE_EVAL_BATCH = {"layer_attention_ln": 12, "mlp_ln_blend": 12}


class _Tee:
    """A stream that writes to several."""

    def __init__(self, *outs):
        self.outs = outs

    def write(self, s):
        for o in self.outs:
            o.write(s)
        return len(s)

    def flush(self):
        for o in self.outs:
            o.flush()


def _run_cli(main, argv):
    """Run a CLI's ``main`` in this process (so that the kernels' launch
    counters see it), its output printed and returned, with the launches
    it made."""
    import contextlib
    import io

    from uvc_tpu_torch.ops import (backward_launch_counts, composed_counts,
                                   launch_counts, reset_launch_counts)

    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_launch_counts()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        main(argv)
    torch.cuda.synchronize()
    return buf.getvalue(), {**launch_counts(), **backward_launch_counts(),
                            **composed_counts()}


def _want(counts, **per):
    """The expected launches: ``per`` maps (per-unit counts, units) pairs;
    every other kernel and composed route 0."""
    want = {name: 0 for name in counts}
    for unit, n in per.values():
        for name, k in unit.items():
            want[name] += k * n
    return want


class _HeldTrees:
    """Wraps ``save_checkpoint`` in ``train/stage1.py`` and
    ``train/stage2.py``: keeps each tree as ``run_stage1`` / ``run_stage2``
    held it when they saved, copied to the host, by file name."""

    def __init__(self):
        from uvc_tpu_torch.train import stage1, stage2
        self.modules = (stage1, stage2)
        self.real = stage1.save_checkpoint
        self.trees = {}

    def _save(self, path, tree):
        self.trees[os.path.basename(path)] = _host_tree(tree)
        self.real(path, tree)

    def __enter__(self):
        for m in self.modules:
            m.save_checkpoint = self._save
        return self

    def __exit__(self, *exc):
        for m in self.modules:
            m.save_checkpoint = self.real


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host_tree(v) for v in tree]
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    return tree


def _held_mismatches(loaded, held):
    """(leaves, leaves that differ) between a checkpoint read back and the
    tree that was saved: tensors and arrays bit for bit with their
    dtypes, scalars by value, None as None."""
    import numpy as np
    if isinstance(held, (dict, list)):
        items = held.items() if isinstance(held, dict) else enumerate(held)
        n = bad = 0
        for k, v in items:
            a, b = _held_mismatches(loaded[str(k)], v)
            n, bad = n + a, bad + b
        return n, bad
    if held is None:
        return 1, int(loaded is not None)
    if torch.is_tensor(held) or isinstance(held, np.ndarray):
        h = torch.as_tensor(held)
        ok = (torch.is_tensor(loaded) and loaded.dtype == h.dtype
              and loaded.shape == h.shape and torch.equal(loaded, h))
        return 1, int(not ok)
    return 1, int(loaded.item() != held)


def _trace_busy(trace_dir):
    """(device-busy us, window us, device events, trace file MB) of the
    one Chrome trace in ``trace_dir``: the union of the kernel, copy and
    fill intervals over the span of every event."""
    import glob
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    check(len(files) == 1, f"expected one trace in {trace_dir}: {files}")
    with open(files[0]) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    check(len(dev) > 0, "the profiled window holds no device event")
    busy, end = 0.0, -1.0
    for a, b in dev:
        if b > end:
            busy += b - max(a, end)
            end = b
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    return busy, t1 - t0, len(dev), os.path.getsize(files[0]) / 2 ** 20


def _ckpt_rel_errs(a, b):
    """Per tensor leaf of two checkpoints read back: (path, relative
    Frobenius error, bit for bit)."""
    from uvc_tpu_torch.utils.tree import tree_leaves_with_path
    la = dict(tree_leaves_with_path(a))
    out = []
    for path, ref in tree_leaves_with_path(b):
        if not torch.is_tensor(ref) or ref.dim() == 0:
            continue
        x = la[path]
        r, o = ref.double(), x.double()
        den = r.norm().item()
        err = (o - r).norm().item() / den if den else (o - r).abs().max()
        out.append((".".join(path), float(err), torch.equal(x, ref)))
    return out


def _pruned_coordinates(p1, p2, masks, keep):
    """(pruned coordinates, of them changed from stage 1, kept
    coordinates, of them changed) between the stage-1 params ``p1`` and
    the compact stage-2 checkpoint's dense-layout params ``p2``: every
    parameter of a skipped block, a kept block's proj rows of the pruned
    attention columns, and the pruned MLP units' fc1 columns, fc1 biases
    and fc2 rows."""
    b1, b2 = p1["blocks"], p2["blocks"]
    pruned = kept = moved_pruned = moved_kept = 0
    for i, k in enumerate(keep):
        if not k:
            for grp in b1:
                for leaf in b1[grp]:
                    a, b = b1[grp][leaf][i], b2[grp][leaf][i]
                    pruned += a.numel()
                    moved_pruned += int((a != b).sum())
            continue
        cols, units = masks["attn"][i] == 0, masks["mlp"][i] == 0
        for sel, ksel in (
                ((b1["proj"]["kernel"][i][cols], b2["proj"]["kernel"][i][cols]),
                 (b1["proj"]["kernel"][i][~cols],
                  b2["proj"]["kernel"][i][~cols])),
                ((b1["fc1"]["kernel"][i][:, units],
                  b2["fc1"]["kernel"][i][:, units]),
                 (b1["fc1"]["kernel"][i][:, ~units],
                  b2["fc1"]["kernel"][i][:, ~units])),
                ((b1["fc1"]["bias"][i][units], b2["fc1"]["bias"][i][units]),
                 (b1["fc1"]["bias"][i][~units],
                  b2["fc1"]["bias"][i][~units])),
                ((b1["fc2"]["kernel"][i][units],
                  b2["fc2"]["kernel"][i][units]),
                 (b1["fc2"]["kernel"][i][~units],
                  b2["fc2"]["kernel"][i][~units]))):
            pruned += sel[0].numel()
            moved_pruned += int((sel[0] != sel[1]).sum())
            kept += ksel[0].numel()
            moved_kept += int((ksel[0] != ksel[1]).sum())
    return pruned, moved_pruned, kept, moved_kept


def pipeline_phase(card):
    """Phase 12: the two-stage pipeline through the CLIs on DeiT-Small at
    full width and depth: ``joint_train`` (stage 1 + the inline stage 2,
    a profiled window), a resume, ``post_train --compact_train`` and
    ``export_compact --export_stablehlo`` served through ``apply_compact``
    and through the ``torch.export`` artifact it writes.  Returns the
    launches of the CLI runs and of the serving."""
    import re
    import tempfile

    import numpy as np

    from uvc_tpu_torch.cli import export_compact, joint_train, post_train
    from uvc_tpu_torch.compress.state import MinimaxHParams
    from uvc_tpu_torch.configs import get_config
    from uvc_tpu_torch.data.pipeline import (ProceduralLoader,
                                             device_prefetch,
                                             normalize_on_device)
    from uvc_tpu_torch.infer.compact import apply_compact
    from uvc_tpu_torch.infer.export import load_serving
    from uvc_tpu_torch.models import vit
    from uvc_tpu_torch.ops import (launch_counts, reset_launch_counts)
    from uvc_tpu_torch.train.step import eval_step
    from uvc_tpu_torch.utils.checkpoint import load_checkpoint

    cfg = get_config(PIPE_MODEL).replace(num_classes=PIPE_CLASSES)
    ln = cfg.depth
    name = cfg.name
    total = {}
    with tempfile.TemporaryDirectory(prefix="uvc_pipeline_") as tmp:
        common = ["--model_type", PIPE_MODEL, "--dataset", "procedural",
                  "--img_size", str(cfg.img_size), "--train_batch_size",
                  str(BATCH), "--eval_batch_size", str(BATCH),
                  "--synthetic_steps", str(PIPE_STEPS),
                  "--distillation-type", "soft", "--dp", "1",
                  "--output_dir", tmp]
        trace_dir = os.path.join(tmp, "trace")

        # -- 1. stage 1 + the inline stage 2 through joint_train ----------
        t0 = time.perf_counter()
        with _HeldTrees() as held:
            out, counts = _run_cli(joint_train.main, common + [
                "--num_epochs", "2", "--warmup_epochs", "1",
                "--post_num_epochs", "1", "--name", "run",
                "--profile_dir", trace_dir, "--profile_start", "3",
                "--profile_steps", "5"])
        wall = time.perf_counter() - t0
        # stage 1: 2 epochs of 12 steps and a validation each; stage 2: 1
        # epoch of 12 steps and the final validation
        want = _want(counts, train=(PIPE_TRAIN_STEP, 3 * PIPE_STEPS),
                     eval=(PIPE_EVAL_BATCH, 3 * PIPE_EVAL_BATCHES))
        print(f"launches joint_train     {counts} (expected {want})")
        check(counts == want, "joint_train launch counts differ")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        run_dir = os.path.join(tmp, "run")
        files = [f"{name}_1.ckpt", f"{name}_2.ckpt", f"{name}_post_0.ckpt"]
        for f in files:
            path = os.path.join(run_dir, f)
            check(os.path.exists(path) and f in held.trees,
                  f"checkpoint {f} was not written")
            n, bad = _held_mismatches(load_checkpoint(path), held.trees[f])
            print(f"checkpoint {f}: {os.path.getsize(path) / 2 ** 20:.1f} "
                  f"MiB, {n} leaves read back, {bad} differ from the "
                  f"driver's state")
            check(bad == 0, f"checkpoint {f} does not read back as saved")
        with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
            recs = [json.loads(line) for line in fh]
        keys = set().union(*recs)
        need = {"train/flops_expectation", "train/flops_real",
                "train/flops_real_argmax", "train/param_size",
                "test/accuracy"}
        check(need <= keys, f"metrics.jsonl lacks {need - keys}")
        for r in recs:
            if "train/flops_real" in r:
                print(f"  epoch report @ step {r['step']}: "
                      + ", ".join(f"{k}={r[k]:.4f}" for k in sorted(need)
                                  if k in r))
        epochs = re.findall(r"\[Epoch (\d+)\] ([\d.]+)s \(([\d.]+) img/s\)",
                            out)
        check(len(epochs) == 2, f"epoch lines {epochs}")
        busy, span, n_dev, mb = _trace_busy(trace_dir)
        print(f"joint_train (DeiT-Small, batch {BATCH}, 2 + 1 epochs of "
              f"{PIPE_STEPS} steps, {3 * PIPE_EVAL_BATCHES} eval batches): "
              f"{wall:.2f} s wall in all [{card}]")
        PIPE_RATES.update({ep: float(rate) for ep, _, rate in epochs})
        for ep, secs, rate in epochs:
            print(f"  stage-1 epoch {ep} as joint_train logs it: {rate} img/s "
                  f"({secs} s for {PIPE_STEPS} steps of {BATCH}"
                  f"{'; holds the profiled window' if ep == '1' else ''}) "
                  f"[{card}]")
        print(f"  stage-1 step alone (phase 5, the same settings on one "
              f"resident batch): {STEP_RATES.get('stage-1 step', 0.0):.1f} "
              f"img/s [{card}]")
        print(f"  profiled window (steps 3-7, torch.profiler): device busy "
              f"{busy / 1e3:.2f} ms of {span / 1e3:.2f} ms "
              f"({100 * busy / span:.1f}%), {n_dev} device events, trace "
              f"{mb:.1f} MiB [{card}]")

        # the loader alone, on the host
        loader = ProceduralLoader(BATCH, num_batches=PIPE_STEPS,
                                  img_size=cfg.img_size,
                                  num_classes=PIPE_CLASSES, train=True,
                                  seed=42)
        loader.set_epoch(1)
        t0 = time.perf_counter()
        ref = list(loader)
        host_ms = 1e3 * (time.perf_counter() - t0) / PIPE_STEPS
        px = cfg.img_size
        print(f"  procedural loader ({px} px, batch {BATCH}: {BATCH} x {px} "
              f"x {px} x 3 uniform draws on the host): {host_ms:.1f} ms a "
              f"batch on the host, synchronous with the steps [{card}]")
        # device_prefetch: the batches on the card are the loader's
        got = [(x.cpu(), y.cpu()) for x, y in
               list(device_prefetch(iter(ref), depth=2))]
        check(len(got) == len(ref) and all(
            np.array_equal(x.numpy(), rx) and np.array_equal(y.numpy(), ry)
            for (x, y), (rx, ry) in zip(got, ref)),
            "device_prefetch changed a batch")
        print(f"device_prefetch: {len(ref)} batches on the card bit for bit "
              f"the loader's")

        # -- 2. resume from the epoch-1 checkpoint -------------------------
        ck1 = os.path.join(run_dir, f"{name}_1.ckpt")
        out, counts = _run_cli(joint_train.main, common + [
            "--num_epochs", "2", "--warmup_epochs", "1",
            "--post_num_epochs", "0", "--resume", ck1, "--name",
            "resumed"])
        want = _want(counts, train=(PIPE_TRAIN_STEP, PIPE_STEPS),
                     eval=(PIPE_EVAL_BATCH, 2 * PIPE_EVAL_BATCHES))
        print(f"launches resumed run     {counts} (expected {want})")
        check(counts == want, "resumed run launch counts differ")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        a = load_checkpoint(os.path.join(tmp, "resumed", f"{name}_2.ckpt"))
        b = load_checkpoint(os.path.join(run_dir, f"{name}_2.ckpt"))
        for k in ("step", "epoch", "global_step", "key_seed"):
            check(int(a[k]) == int(b[k]), f"resumed {k} {a[k]} != {b[k]}")
        errs = _ckpt_rel_errs(a, b)
        worst = max(errs, key=lambda e: e[1])
        exact = sum(e[2] for e in errs)
        print(f"resume: epoch-2 checkpoint against the first run's: "
              f"{len(errs)} tensor leaves, {exact} bit for bit, worst "
              f"{worst[0]} rel_fro={worst[1]:.2e} (tol {RESUME_REL_TOL}); "
              f"step, epoch, global_step, key_seed equal "
              f"({int(a['global_step'])}, {int(a['epoch'])}, "
              f"{int(a['global_step'])}, {int(a['key_seed'])})")
        check(worst[1] <= RESUME_REL_TOL, "the resumed run drifted")

        # -- 3. compact stage 2 through post_train -------------------------
        ck2 = os.path.join(run_dir, f"{name}_2.ckpt")
        g = b["params"]["block_gating"]
        keep = (g[:, 1] > g[:, 0]).tolist()
        kept = sum(keep)
        out, counts = _run_cli(post_train.main, common + [
            "--checkpoint_dir", ck2, "--compact_train", "--num_epochs", "1",
            "--name", "compact"])
        compact_step = {"layer_attention_ln": ln + kept, "mlp_ln": ln + kept,
                        "layer_attention_ln_bwd": kept, "mlp_ln_bwd": kept}
        want = _want(counts, train=(compact_step, PIPE_STEPS),
                     eval=(PIPE_EVAL_BATCH, PIPE_EVAL_BATCHES))
        print(f"launches post_train --compact_train ({kept} of {ln} blocks "
              f"kept) {counts} (expected {want})")
        check(counts == want, "compact post_train launch counts differ")
        check(counts["mlp_ln_bwd"] > 0, "A6 did not launch")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        post = load_checkpoint(os.path.join(tmp, "compact",
                                            f"{name}_post_0.ckpt"))
        check(bool(post["compact"]), "the checkpoint is not a compact run's")
        for k in ("attn", "mlp"):
            check(torch.equal(post["masks"][k], b["masks"][k]),
                  "post_train's masks are not stage 1's")
        pruned, moved, kept_c, moved_kept = _pruned_coordinates(
            b["params"], post["params"], post["masks"], keep)
        print(f"compact stage-2 checkpoint (dense layout): {pruned} pruned "
              f"coordinates, {moved} changed from stage 1 (they keep "
              f"stage 1's values, as scatter_to_dense writes them, and the "
              f"masks multiply them by 0); {moved_kept} of {kept_c} kept "
              f"coordinates trained")
        check(pruned > 0 and moved == 0, "a pruned coordinate moved")
        check(moved_kept > 0, "compact stage 2 trained nothing")

        # -- 4. export and serve -------------------------------------------
        post_ck = os.path.join(tmp, "compact", f"{name}_post_0.ckpt")
        export_file = os.path.join(tmp, "compact_serving.ckpt")
        artifact = os.path.join(tmp, "compact_serving.npz")
        t0 = time.perf_counter()
        out, export_counts = _run_cli(export_compact.main, [
            "--model_type", PIPE_MODEL, "--checkpoint", post_ck,
            "--save_file", export_file, "--token_ratio",
            str(PIPE_TOKEN_RATIO), "--num_classes", str(PIPE_CLASSES),
            "--img_size", str(cfg.img_size), "--export_stablehlo", artifact,
            "--serve_batches", str(BATCH)])
        export_s = time.perf_counter() - t0
        # tracing runs the operators' fake implementations: no launch
        check(not any(export_counts.values()),
              f"export_compact launched {export_counts}")
        ex = load_checkpoint(export_file)
        check(ex["model_type"] == PIPE_MODEL
              and float(ex["token_ratio"]) == PIPE_TOKEN_RATIO,
              "the export's fields")
        layers = [_tree_to(ex["layers"][str(i)], "cuda")
                  for i in range(len(ex["layers"]))]
        for blk in layers:
            blk["num_heads"] = int(blk["num_heads"])
        top = _tree_to(ex["top"], "cuda")
        check(len(layers) == kept, f"the export holds {len(layers)} layers")
        dense = _tree_to(post["params"], "cuda")
        masks = _tree_to(post["masks"], "cuda")
        gd = dense["block_gating"]
        k1 = (gd[:, 1] > gd[:, 0]).float()
        gating = torch.stack([1.0 - k1, k1], dim=-1)
        hp = MinimaxHParams(patch_ratio=PIPE_TOKEN_RATIO)
        ev = ProceduralLoader(BATCH, num_batches=PIPE_EVAL_BATCHES,
                              img_size=cfg.img_size,
                              num_classes=PIPE_CLASSES, train=False, seed=42)
        model = load_serving(artifact)
        check(model.batch_sizes == [BATCH],
              f"the artifact's batch sizes {model.batch_sizes}")
        served, ref_logits, labels, correct, count = [], [], [], 0, 0
        from_artifact = []
        serve_counts, artifact_counts = {}, {}
        with torch.no_grad():
            for x, y in device_prefetch(iter(ev)):
                xb, y = normalize_on_device(x), y.long()
                labels.append(y)
                reset_launch_counts()
                served.append(apply_compact(
                    layers, top, xb, cfg,
                    token_ratio=PIPE_TOKEN_RATIO).logits.float())
                for k, v in launch_counts().items():
                    serve_counts[k] = serve_counts.get(k, 0) + v
                reset_launch_counts()
                from_artifact.append(model(xb).float())
                for k, v in launch_counts().items():
                    artifact_counts[k] = artifact_counts.get(k, 0) + v
                # eval_step's forward (hard gating, masks, the physical
                # deterministic top-k at the export's ratio), its logits
                out_d = vit.apply(dense, xb, cfg, gating_distrib=gating,
                                  masks=masks, tau=1.0,
                                  patch_ratio=PIPE_TOKEN_RATIO,
                                  patch_gate_mode=2, patch_hard=True,
                                  patch_physical=True, rng=None, train=False,
                                  dtype=torch.bfloat16)
                ref_logits.append(vit.eval_logits(out_d, cfg).float())
                m = eval_step(dense, masks, xb, y, cfg, hp)
                correct += int(m["correct"])
                count += int(m["count"])
        want_serve = {name_: 0 for name_ in serve_counts}
        want_serve.update(layer_attention_ln=kept * PIPE_EVAL_BATCHES,
                          mlp_ln=kept * PIPE_EVAL_BATCHES)
        print(f"launches served export   {serve_counts} (expected "
              f"{want_serve})")
        check(serve_counts == want_serve, "served export launch counts")
        print(f"launches served artifact {artifact_counts} (expected "
              f"{want_serve})")
        check(artifact_counts == want_serve, "the artifact's launch counts")
        for counts in (serve_counts, artifact_counts):
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
        a_all = torch.cat(from_artifact)
        same = torch.equal(a_all, torch.cat(served))
        rel_a, mx_a = rel_err(a_all, torch.cat(served))
        print(f"export_compact --export_stablehlo (batch {BATCH}, "
              f"{os.path.getsize(artifact) / 2 ** 20:.1f} MiB, the CLI "
              f"{export_s:.1f} s with the .ckpt): the artifact served "
              f"{PIPE_EVAL_BATCHES} batches "
              + ("bit for bit apply_compact's" if same else
                 f"against apply_compact: rel_fro={rel_a:.2e} "
                 f"max_abs={mx_a:.2e} (tol {MODEL_REL_TOL})"))
        check(same or rel_a <= MODEL_REL_TOL,
              "the artifact and apply_compact disagree")
        s_all, r_all = torch.cat(served), torch.cat(ref_logits)
        check(torch.isfinite(s_all).all().item()
              and s_all.shape == (PIPE_EVAL_BATCHES * BATCH, PIPE_CLASSES),
              "served logits not finite or of the wrong shape")
        rel, mx = rel_err(s_all, r_all)
        served_acc = float((s_all.argmax(-1) == torch.cat(labels))
                           .float().mean())
        print(f"export (token ratio {PIPE_TOKEN_RATIO}, "
              f"{float(ex['flops_fraction']) * 100:.2f}% of dense FLOPs, "
              f"{os.path.getsize(export_file) / 2 ** 20:.1f} MiB) served "
              f"{PIPE_EVAL_BATCHES} batches of {BATCH} through apply_compact "
              f"vs eval_step's forward on the dense-layout params: "
              f"rel_fro={rel:.2e} max_abs={mx:.2e} (tol {MODEL_REL_TOL}); "
              f"accuracy served {served_acc:.4f}, eval_step "
              f"{correct / max(1, count):.4f}")
        check(rel <= MODEL_REL_TOL, "served export and eval_step disagree")
    return total


# ---------------------------------------------------------------------------
# phase 13: the baseline-pruning suite through its CLIs
# ---------------------------------------------------------------------------

SUITE_MODEL = "deit_small_patch16_224"
SUITE_DENSITY = 0.5          # generate_mask's --sparsity (the density kept)
SUITE_STEPS = 12             # baseline_train's steps an epoch
TAYLOR_BATCHES = 4           # Taylor's --num_batches at the CLI's batch 128
SYNFLOW_ROUNDS = 100
HOLD_BATCH = 8               # the scorers held against the plain versions
# kernel vs plain (both bf16 on the card): a scorer's scores per leaf
# (relative Frobenius) and the kept sets of its masks (Jaccard); SP's
# masks equal in every layer whose cut the score differences cannot move
SCORE_REL_TOL = 2e-2
JACCARD_MIN = 0.99
# SynFlow's objective sums the logits of the |w| network on an all-ones
# image: its bf16 residual stream carries a large component common to all
# features, which the LayerNorms subtract, so one rounding of the stream
# moves the scores by several percent (kernel vs plain 2-10% a round,
# either vs f32 ~14% at round 0; PERF.md, PR 16).  Its kernels are held
# to be no further from the f32 plain path than the plain bf16 versions
# are, within this factor, at the first, middle and last round
SYNFLOW_F32_RATIO = 1.25
# the CPU f32 SynFlow runs at depth 4 when its 100 rounds at full depth
# would take longer than this
CPU_SYNFLOW_BUDGET_S = 60.0
# a scoring pass (forward and backward through the LN-fused sublayers on
# DeiT-Small's 12 blocks), a baseline_train step (drop-path: A7 forward
# and backward, the MLP composed) and an eval batch (K1 and K2)
SCORE_PASS = {"layer_attention_ln": 12, "mlp_ln": 12,
              "layer_attention_ln_bwd": 12, "mlp_ln_bwd": 12}
BASE_TRAIN_STEP = {"layer_attention": 12, "layer_attention_bwd": 12}
BASE_EVAL_BATCH = {"layer_attention_ln": 12, "mlp_ln": 12}


class _PlainSublayers:
    """The LN-fused sublayers' kernel wrappers (K1, A2, K2, A6) swapped for
    their plain PyTorch versions, which then run on the card's tensors in
    the same dtype: the yardstick a scorer's kernel run is held to.  The
    launch counters see none of these calls."""

    def __enter__(self):
        from uvc_tpu_torch.ops import attention, mlp
        self.saved = []
        for mod, name in ((attention, "layer_attention_ln"),
                          (attention, "layer_attention_ln_bwd"),
                          (mlp, "mlp_ln"), (mlp, "mlp_ln_bwd")):
            self.saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, getattr(mod, name + "_plain"))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _masked_leaves(tree):
    from uvc_tpu_torch.utils.tree import tree_leaves_with_path
    return {".".join(p): t for p, t in tree_leaves_with_path(tree)}


def _jaccard(a, b):
    """The kept sets' Jaccard index of two mask trees (on their device)."""
    fa, fb = _masked_leaves(a), _masked_leaves(b)
    both = sum(float((fa[k] * fb[k]).sum()) for k in fa)
    either = sum(float((fa[k] + fb[k] > 0).sum()) for k in fa)
    return both / max(either, 1.0)


def _global_rel(a, b):
    """The relative Frobenius error of score tree ``a`` against ``b`` over
    all their leaves together."""
    fa, fb = _masked_leaves(a), _masked_leaves(b)
    num = sum(((fa[k].double() - ref.double()) ** 2).sum().item()
              for k, ref in fb.items())
    den = sum((ref.double() ** 2).sum().item() for ref in fb.values())
    return (num / den) ** 0.5


def _worst_rel(a, b):
    """(the worst per-leaf relative Frobenius error of score tree ``a``
    against ``b``, its leaf)."""
    fa, fb = _masked_leaves(a), _masked_leaves(b)
    errs = []
    for k, ref in fb.items():
        ref = ref.double()
        den = ref.norm().item()
        err = (fa[k].double() - ref).norm().item()
        errs.append((err / den if den else err, k))
    return max(errs)


def _sp_scores(params, grads, cfg):
    """SP's head and unit scores (the quantities its masks rank)."""
    l, h, hs, d = cfg.depth, cfg.num_heads, cfg.head_size, cfg.embed_dim
    w = params["blocks"]["qkv"]["kernel"][:, :, 2 * d:].reshape(l, d, h, hs)
    g = grads["blocks"]["qkv"]["kernel"][:, :, 2 * d:].reshape(l, d, h, hs)
    heads = (w * g).sum(dim=(1, 3)).abs()
    units = (grads["blocks"]["fc1"]["kernel"].abs().sum(dim=1)
             + grads["blocks"]["fc2"]["kernel"].abs().sum(dim=2))
    return {"attn": heads, "mlp": units}


def _sp_disagreement(mk, mp, sk, sp, density):
    """(the worst relative Frobenius error of the kernels' head / unit
    scores ``sk`` against the plain versions' ``sp``, rows, rows whose cut
    lies within twice the row's largest score difference, entries that
    differ outside such rows).  A row's masks can differ only where the
    score differences can move its cut: every other row must agree."""
    worst = 0.0
    rows = close = bad = 0
    for kind in ("attn", "mlp"):
        a, b = sk[kind].double().cpu(), sp[kind].double().cpu()
        worst = max(worst, ((a - b).norm() / b.norm()).item())
        n = b.shape[1]
        keep = max(int(density * n), 1)
        srt = b.sort(dim=1, descending=True).values
        for r in range(b.shape[0]):
            rows += 1
            delta = (a[r] - b[r]).abs().max().item()
            lo = srt[r, keep - 1].item()
            hi = srt[r, keep].item() if keep < n else float("-inf")
            if lo - hi <= 2 * delta:
                close += 1
                continue
            bad += int((mk[kind][r].cpu() != mp[kind][r].cpu()).sum())
    return worst, rows, close, bad


def _suite_weights(cfg, seed):
    """DeiT-Small's tree from the seeded init, its zero-initialised head
    drawn too (a zero head makes every gradient score zero)."""
    from uvc_tpu_torch.models import get_model
    gen = torch.Generator().manual_seed(seed)
    params = get_model(cfg).init_params(gen, cfg, device="cpu")
    params["head"]["kernel"] = 0.02 * torch.randn(
        params["head"]["kernel"].shape, generator=gen)
    return params


def _scoring_fns(cfg, dtype):
    """The loss and the SynFlow objective as ``cli/generate_mask.py``
    builds them."""
    from uvc_tpu_torch.models import get_model
    model = get_model(cfg)

    def loss_fn(p, x, y):
        out = model.apply(p, x, cfg, train=True, dtype=dtype)
        return -torch.log_softmax(out.logits, dim=-1).gather(
            -1, y[:, None]).mean()

    def forward_sum(p):
        ones = torch.ones(1, cfg.img_size, cfg.img_size, cfg.in_chans,
                          device=p["cls_token"].device)
        return model.apply(p, ones, cfg, train=False,
                           dtype=dtype).logits.sum()

    return loss_fn, forward_sum


def _cut_depth(params, cfg, depth):
    """The first ``depth`` blocks of a tree (parameters or weight masks,
    whose None leaves stay None) and its config."""
    from uvc_tpu_torch.utils.tree import tree_map

    out = dict(params)
    out["blocks"] = tree_map(lambda v: v[:depth], params["blocks"])
    for k in ("block_gating", "attn_gating", "mlp_gating"):
        if out.get(k) is not None:
            out[k] = params[k][:depth]
    return out, cfg.replace(depth=depth)


def _remain(out):
    import re
    return float(re.search(r"remain weight = ([\d.]+) %", out).group(1))


def _hold_scorers(card, params, cfg, files):
    """Phase 13's scorers held at batch 8 (SynFlow at its batch 1): the
    kernels against the plain versions on the card in bf16 (gated), and
    against the f32 plain path on the CPU (recorded: the evidence for
    scoring in bf16 on the card)."""
    import numpy as np

    from uvc_tpu_torch.baselines import pruning
    from uvc_tpu_torch.data.pipeline import (SyntheticLoader,
                                             normalize_on_device)
    from uvc_tpu_torch.utils.checkpoint import load_checkpoint
    from uvc_tpu_torch.utils.tree import tree_map

    gp = _tree_to(params, "cuda")
    cp = _tree_to(params, "cpu")
    loss_k, fsum_k = _scoring_fns(cfg, torch.bfloat16)
    loss_c, fsum_c = _scoring_fns(cfg, torch.float32)
    x, y = next(iter(SyntheticLoader(HOLD_BATCH, num_batches=1,
                                     img_size=cfg.img_size,
                                     num_classes=cfg.num_classes, seed=0)))
    xc = normalize_on_device(torch.from_numpy(x))
    yc = torch.from_numpy(y).long()
    gb = [(xc.to("cuda"), yc.to("cuda"))] * 2   # two batches: accumulation
    cb = [(xc, yc)] * 2

    # magnitude: no kernel; the CLI's file, the card and the CPU agree bit
    # for bit
    mag = pruning.global_threshold_mask(pruning.magnitude_scores(gp),
                                        SUITE_DENSITY)
    mag_cpu = pruning.global_threshold_mask(pruning.magnitude_scores(cp),
                                            SUITE_DENSITY)
    ref = load_checkpoint(files["mag_global"])
    flat, flat_cpu = pruning.masks_to_flat(mag), pruning.masks_to_flat(
        mag_cpu)
    same = all(np.array_equal(flat[k], ref[k].numpy())
               and np.array_equal(flat_cpu[k], flat[k]) for k in ref)
    print(f"hold mag: the CLI's mask, the card's and the CPU's f32 bit for "
          f"bit: {same}")
    check(same, "magnitude masks differ")

    # Taylor over two batches of 8
    tk = pruning.taylor_scores(gp, loss_k, gb)
    with _PlainSublayers():
        tp = pruning.taylor_scores(gp, loss_k, gb)
    tc = pruning.taylor_scores(cp, loss_c, cb)
    mk, mp, mc = (pruning.global_threshold_mask(t, SUITE_DENSITY)
                  for t in (tk, tp, tc))
    rel, leaf = _worst_rel(tk, tp)
    jac = _jaccard(mk, mp)
    jac_cpu = _jaccard(_tree_to(mk, "cpu"), mc)
    rel_cpu, _ = _worst_rel(_tree_to(tk, "cpu"), tc)
    rel_plain_cpu, _ = _worst_rel(_tree_to(tp, "cpu"), tc)
    print(f"hold taylor (batch {HOLD_BATCH} x 2, density {SUITE_DENSITY}): "
          f"kernel vs plain on the card (bf16): worst leaf {leaf} "
          f"rel_fro={rel:.2e} (tol {SCORE_REL_TOL}), kept sets' Jaccard "
          f"{jac:.5f} (min {JACCARD_MIN}); vs the CPU f32 plain path "
          f"(recorded): the kernels' worst rel_fro={rel_cpu:.2e} (the plain "
          f"versions' {rel_plain_cpu:.2e}), Jaccard {jac_cpu:.5f}")
    check(rel <= SCORE_REL_TOL and jac >= JACCARD_MIN,
          "Taylor: the kernels and the plain versions disagree")

    # SP on one batch of 8
    g_k = pruning.tree_grad(loss_k, gp, *gb[0])
    with _PlainSublayers():
        g_p = pruning.tree_grad(loss_k, gp, *gb[0])
    g_c = pruning.tree_grad(loss_c, cp, *cb[0])
    sk, sp_, sc = (pruning.sp_structured_masks(p_, g, cfg, SUITE_DENSITY,
                                               SUITE_DENSITY)
                   for p_, g in ((gp, g_k), (gp, g_p), (cp, g_c)))
    rel, rows, close, bad = _sp_disagreement(
        sk, sp_, _sp_scores(gp, g_k, cfg), _sp_scores(gp, g_p, cfg),
        SUITE_DENSITY)
    differ = sum(int((sk[k] != sp_[k]).sum()) for k in ("attn", "mlp"))
    agree_cpu = sum(float((sk[k].cpu() == sc[k]).float().mean())
                    for k in ("attn", "mlp")) / 2
    print(f"hold sp (batch {HOLD_BATCH}): kernel vs plain on the card: head "
          f"and unit scores rel_fro={rel:.2e} (tol {SCORE_REL_TOL}); {rows} "
          f"rows, {close} whose cut lies within twice the row's largest "
          f"score difference, {differ} entries differ, {bad} of them "
          f"elsewhere; vs the CPU f32 plain path (recorded): "
          f"{agree_cpu:.4f} of the entries equal")
    check(rel <= SCORE_REL_TOL and bad == 0,
          "SP: the kernels and the plain versions disagree")

    # SynFlow: each round of the plain versions' trajectory scored again
    # by the kernels on the same masks; at the first, middle and last
    # round by the f32 CPU plain path too; then the kernels' whole run
    # (the CLI's file) against the plain one (recorded)
    abs_p = tree_map(torch.abs, gp)
    abs_c = tree_map(torch.abs, cp)
    masks = pruning.identity_masks(abs_p)
    f32_rounds = (0, SYNFLOW_ROUNDS // 2 - 1, SYNFLOW_ROUNDS - 1)
    worst, worst_jac = (0.0, -1), (2.0, -1)
    t0 = time.perf_counter()
    for e in range(SYNFLOW_ROUNDS):
        with _PlainSublayers():
            sp_round = pruning.synflow_round(abs_p, masks, fsum_k)
        sk_round = pruning.synflow_round(abs_p, masks, fsum_k)
        d = SUITE_DENSITY ** ((e + 1) / SYNFLOW_ROUNDS)
        new_p = pruning.global_threshold_mask(sp_round, d)
        new_k = pruning.global_threshold_mask(sk_round, d)
        worst = max(worst, (_global_rel(sk_round, sp_round), e))
        worst_jac = min(worst_jac, (_jaccard(new_k, new_p), e))
        if e in f32_rounds:
            sc_round = _tree_to(pruning.synflow_round(
                abs_c, _tree_to(masks, "cpu"), fsum_c), "cuda")
            rk = _global_rel(sk_round, sc_round)
            rp = _global_rel(sp_round, sc_round)
            print(f"hold synflow round {e}: against the f32 CPU plain path "
                  f"the kernels' scores rel_fro={rk:.3e}, the plain "
                  f"versions' {rp:.3e} (the kernels within "
                  f"{SYNFLOW_F32_RATIO} x the plain versions'); kernel vs "
                  f"plain {_global_rel(sk_round, sp_round):.3e}")
            check(rk <= SYNFLOW_F32_RATIO * rp,
                  f"SynFlow round {e}: the kernels are further from f32 "
                  f"than the plain versions")
        masks = new_p
    torch.cuda.synchronize()
    rounds_s = time.perf_counter() - t0
    cli = pruning.masks_from_flat(load_checkpoint(files["synflow"]), gp)
    whole = _jaccard(cli, masks)
    print(f"hold synflow ({SYNFLOW_ROUNDS} rounds, batch 1), each round of "
          f"the plain trajectory scored by the kernels on its masks "
          f"(recorded): worst round {worst[1]} rel_fro={worst[0]:.3e}, "
          f"lowest kept sets' Jaccard {worst_jac[0]:.5f} (round "
          f"{worst_jac[1]}); the kernels' whole run (the CLI's file) vs the "
          f"plain versions' whole run (recorded): Jaccard {whole:.5f}; "
          f"{rounds_s:.2f} s for the 2 x {SYNFLOW_ROUNDS} rounds [{card}]")

    # the CPU f32 SynFlow (recorded): at full depth if its 100 rounds fit
    # the budget, else at depth 4 against the card's kernels at depth 4
    t0 = time.perf_counter()
    pruning.global_threshold_mask(pruning.synflow_round(
        abs_c, pruning.identity_masks(abs_c), fsum_c), 0.9)
    per_round = time.perf_counter() - t0
    depth = cfg.depth
    if per_round * SYNFLOW_ROUNDS > CPU_SYNFLOW_BUDGET_S:
        depth = 4
    if depth == cfg.depth:
        kern_masks, ccfg, cparams = _tree_to(cli, "cpu"), cfg, cp
    else:
        gcut, ccfg = _cut_depth(gp, cfg, depth)
        cparams, _ = _cut_depth(cp, cfg, depth)
        _, fsum_kd = _scoring_fns(ccfg, torch.bfloat16)
        _, kern_masks = pruning.synflow_scores(gcut, fsum_kd, SUITE_DENSITY,
                                               SYNFLOW_ROUNDS)
        kern_masks = _tree_to(kern_masks, "cpu")
    _, fsum_cd = _scoring_fns(ccfg, torch.float32)
    t0 = time.perf_counter()
    _, cpu_masks = pruning.synflow_scores(cparams, fsum_cd, SUITE_DENSITY,
                                          SYNFLOW_ROUNDS)
    cpu_s = time.perf_counter() - t0
    print(f"hold synflow vs the CPU f32 plain path (recorded"
          + ("" if depth == cfg.depth else
             f"; at depth {depth}: {SYNFLOW_ROUNDS} rounds at full depth "
             f"would take {per_round * SYNFLOW_ROUNDS:.0f} s on the CPU, "
             f"over the {CPU_SYNFLOW_BUDGET_S:.0f} s budget")
          + f"): kept sets' Jaccard {_jaccard(kern_masks, cpu_masks):.5f} "
          f"({cpu_s:.1f} s on the CPU)")


def baseline_suite_phase(card):
    """Phase 13: the baseline-pruning suite through its CLIs on DeiT-Small
    at full width and depth with seeded random weights written as a timm
    ``.pth``: ``generate_mask`` (each type), the scorers held at batch 8,
    ``baseline_train`` (a one-shot mask run with EMA, its resume, GMP,
    ``--eval``) and ``show_gradient_sparsity``.  Returns the launches of
    the CLI runs."""
    import argparse
    import re
    import tempfile

    from uvc_tpu_torch.baselines.gmp import cubic_sparsity
    from uvc_tpu_torch.cli import (baseline_train, generate_mask,
                                   joint_train, show_gradient_sparsity)
    from uvc_tpu_torch.configs import get_config
    from uvc_tpu_torch.data.pipeline import ProceduralLoader
    from uvc_tpu_torch.models import convert
    from uvc_tpu_torch.utils.checkpoint import load_checkpoint
    from uvc_tpu_torch.utils.tree import leaf_at, tree_leaves_with_path

    # the synthetic data's 1000 classes, as an ImageNet checkpoint has
    cfg = get_config(SUITE_MODEL).replace(num_classes=1000)
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    with tempfile.TemporaryDirectory(prefix="uvc_baselines_") as tmp:
        # -- 1. the weights as a timm .pth, read back -----------------------
        params = _suite_weights(cfg, seed=60)
        pth = os.path.join(tmp, "deit_small.pth")
        torch.save({"model": convert.to_torch_state_dict(params, cfg)}, pth)
        via_cli = joint_train.load_params(argparse.Namespace(
            pretrained=1, model_path=pth, seed=0, device="cuda"), cfg)
        n = bad = 0
        for loaded in (convert.load_torch_checkpoint(pth, cfg), via_cli):
            for path, leaf in tree_leaves_with_path(params):
                n += 1
                bad += int(not torch.equal(leaf_at(loaded, path), leaf))
        print(f"weights: {os.path.getsize(pth) / 2 ** 20:.1f} MiB .pth "
              f"(to_torch_state_dict), read back through "
              f"load_torch_checkpoint and joint_train's load_params: {n} "
              f"leaves, {bad} differ")
        check(bad == 0, "the .pth does not read back bit for bit")

        # -- 2. generate_mask, each type -----------------------------------
        gen = ["--model_type", SUITE_MODEL, "--pretrained", pth,
               "--dataset", "synthetic", "--sparsity", str(SUITE_DENSITY)]
        runs = {"mag_global": (["--type", "mag"], {}),
                "mag_local": (["--type", "mag", "--scope", "local"], {}),
                "synflow": (["--type", "synflow"],
                            dict(score=(SCORE_PASS, SYNFLOW_ROUNDS))),
                "taylor": (["--type", "taylor", "--num_batches",
                            str(TAYLOR_BATCHES)],
                           dict(score=(SCORE_PASS, TAYLOR_BATCHES))),
                "sp": (["--type", "sp"], dict(score=(SCORE_PASS, 1)))}
        files = {}
        for kind, (extra, per) in runs.items():
            files[kind] = os.path.join(tmp, f"{kind}.ckpt")
            t0 = time.perf_counter()
            out, counts = _run_cli(generate_mask.main,
                                   gen + extra + ["--save_file",
                                                  files[kind]])
            wall = time.perf_counter() - t0
            want = _want(counts, **per)
            print(f"launches generate_mask {kind:10s} {counts} (expected "
                  f"{want})")
            check(counts == want, f"generate_mask {kind} launch counts")
            add(counts)
            remain = _remain(out) / 100
            if kind == "sp":
                st = load_checkpoint(files[kind] + ".structural")
                heads = st["attn"].sum(dim=1)
                units = st["mlp"].sum(dim=1)
                print(f"generate_mask sp: {wall:.2f} s wall, heads kept "
                      f"per layer {heads.tolist()}, units kept per layer "
                      f"{units.tolist()}, remaining weight density "
                      f"{remain:.6f} (identity outside qkv / fc1 / fc2) "
                      f"[{card}]")
                check(bool((heads == max(int(SUITE_DENSITY
                                             * cfg.num_heads), 1)).all())
                      and bool((units == max(int(SUITE_DENSITY
                                                 * cfg.mlp_hidden), 1))
                               .all()),
                      "SP kept the wrong number of heads / units")
                continue
            print(f"generate_mask {kind}: {wall:.2f} s wall, remaining "
                  f"density {remain:.6f} against --sparsity "
                  f"{SUITE_DENSITY} [{card}]")
            check(abs(remain - SUITE_DENSITY) <= 5e-3,
                  f"generate_mask {kind} missed its density")
        # the mask baseline_train reads: the 10 classes of its procedural
        # data, so the .pth's 1000-class head is re-initialised
        files["bt_mask"] = os.path.join(tmp, "bt_mask.ckpt")
        _run_cli(generate_mask.main, [
            "--model_type", SUITE_MODEL, "--pretrained", pth, "--dataset",
            "cifar10", "--type", "mag", "--sparsity", str(SUITE_DENSITY),
            "--save_file", files["bt_mask"]])

        # -- 3. the scorers against the plain versions ---------------------
        _hold_scorers(card, params, cfg, files)

        # -- 4. baseline_train ---------------------------------------------
        base = ["--model_type", SUITE_MODEL, "--dataset", "procedural",
                "--train_batch_size", str(BATCH), "--eval_batch_size",
                str(BATCH), "--synthetic_steps", str(SUITE_STEPS),
                "--init_weight", pth, "--output_dir", tmp, "--dp", "1"]
        name = cfg.name

        def ckpt(run, epoch):
            return os.path.join(tmp, run, f"{name}_baseline_{epoch}.ckpt")

        def train(run, extra, steps, evals):
            t0 = time.perf_counter()
            out, counts = _run_cli(baseline_train.main,
                                   base + extra + ["--name", run])
            wall = time.perf_counter() - t0
            want = _want(counts, train=(BASE_TRAIN_STEP, steps),
                         eval=(BASE_EVAL_BATCH, evals * 8))
            print(f"launches baseline_train {run:8s} {counts} (expected "
                  f"{want}); {wall:.2f} s wall")
            check(counts == want, f"baseline_train {run} launch counts")
            add(counts)
            return out

        mask_args = ["--init_mask", files["bt_mask"], "--model_ema", "1"]
        out = train("full", mask_args + ["--epochs", "2"], 2 * SUITE_STEPS,
                    2)
        epochs = re.findall(r"\[Baseline Epoch (\d+)\] ([\d.]+)s "
                            r"\(([\d.]+) img/s\)", out)
        accs = re.findall(r"\[Baseline Eval\|Epoch (\d+)\] acc ([\d.]+)%",
                          out)
        check(len(epochs) == 2 and len(accs) == 2, f"epoch lines {epochs}")
        loader = ProceduralLoader(BATCH, num_batches=SUITE_STEPS,
                                  img_size=cfg.img_size, num_classes=10,
                                  train=True, seed=42)
        loader.set_epoch(1)
        t0 = time.perf_counter()
        for _ in loader:
            pass
        host_ms = 1e3 * (time.perf_counter() - t0) / SUITE_STEPS
        for ep, secs, rate in epochs:
            print(f"baseline_train epoch {ep} as it logs it (DeiT-Small, "
                  f"batch {BATCH}, {SUITE_STEPS} procedural steps, mask "
                  f"density {SUITE_DENSITY}, EMA, drop-path 0.1, reprob "
                  f"0.25, mixup / cutmix): {rate} img/s ({secs} s) [{card}]")
        print(f"  the baseline step alone (phase 6, one resident batch): "
              f"{STEP_RATES.get('baseline step', 0.0):.1f} img/s; the "
              f"procedural loader: {host_ms:.1f} ms a batch of {BATCH} on "
              f"the host [{card}]")

        ck1 = load_checkpoint(ckpt("full", 1))
        masked = leaked = 0
        for k, m in ck1["masks"].items():
            off = m == 0
            node = ck1["opt_state"]["0"]
            for mom in ("mu", "nu"):
                leaf = node[mom]
                for part in k.split("."):
                    leaf = leaf[part]
                leaked += int((leaf[off] != 0).sum())
            masked += int(off.sum())
        print(f"baseline_train epoch-1 checkpoint: {masked} masked "
              f"coordinates, {leaked} AdamW moments (mu, nu) nonzero there")
        check(masked > 0 and leaked == 0, "a masked coordinate has a moment")

        train("resumed", mask_args + ["--epochs", "2", "--resume",
                                      ckpt("full", 0)], SUITE_STEPS, 1)
        with open(ckpt("full", 1), "rb") as a, \
                open(ckpt("resumed", 1), "rb") as b:
            same = a.read() == b.read()
        print(f"baseline_train resumed from epoch 0: epoch-1 checkpoint "
              f"({os.path.getsize(ckpt('full', 1)) / 2 ** 20:.1f} MiB) bit "
              f"for bit the first run's: {same}")
        check(same, "the resumed baseline run differs")

        t_start, delta_t, times = 2, 4, 2
        out = train("gmp", ["--gmp", "1", "--sparsity", str(SUITE_DENSITY),
                            "--t_start", str(t_start), "--delta_t",
                            str(delta_t), "--pruning_times", str(times),
                            "--epochs", "1"], SUITE_STEPS, 1)
        events = re.findall(r"\[GMP\] step (\d+): pruning event (\d+), "
                            r"remaining ([\d.]+)%", out)
        check(len(events) == times, f"GMP events {events}")
        for st, ev, rem in events:
            want_d = 1.0 - cubic_sparsity(0.0, SUITE_DENSITY, int(st),
                                          t_start, times, delta_t)
            print(f"baseline_train --gmp 1: event {ev} at step {st}, "
                  f"remaining {rem}% (cubic_sparsity: "
                  f"{want_d * 100:.2f}%)")
            check(abs(float(rem) / 100 - want_d) <= 1e-4,
                  "GMP's density does not follow cubic_sparsity")

        out = train("eval", ["--eval", "--resume", ckpt("full", 1)], 0, 1)
        acc = re.findall(r"Eval accuracy ([\d.]+)%", out)
        print(f"baseline_train --eval --resume (epoch 1): {acc[0]}%, the "
              f"run's own epoch-1 eval {accs[1][1]}%")
        check(acc == [accs[1][1]], "--eval disagrees with the run's eval")

        # -- 5. show_gradient_sparsity -------------------------------------
        out, counts = _run_cli(show_gradient_sparsity.main, [
            "--model_type", SUITE_MODEL, "--dataset", "synthetic",
            "--train_batch_size", str(BATCH), "--num_batches", "4",
            "--model_path", pth, "--output_dir", tmp, "--top", "5"])
        want = _want(counts, score=(SCORE_PASS, 4))
        print(f"launches show_gradient_sparsity {counts} (expected {want})")
        check(counts == want, "show_gradient_sparsity launch counts")
        check("overall zero-gradient fraction" in out, "no report")
        add(counts)
    return total


# ---------------------------------------------------------------------------
# phase 14: the other backbones, and stage 2 from a torch checkpoint
# ---------------------------------------------------------------------------

R50_MODEL = "R50-ViT-B_16"
# card vs CPU: the full stem at 224 px, depth cut to 2, batch 2
R50_CPU_DEPTH, R50_CPU_BATCH = 2, 2
# serving and eval: passes of this many request batches of 64
R50_SERVE_BATCHES = 4
# stage 2 and compact_ft: untimed + timed steps (img/s), then one step of
# each from one state
R50_S2_WARM, R50_S2_TIMED = 1, 3
# the flagship stage-1 step's launches on a 12-block ViT: the student's
# and the teacher's K1, the teacher's K2, the gated student's K3, A2, A4
FLAGSHIP_STEP = PIPE_TRAIN_STEP
CAIT_MODEL = "cait_S24_224"
CAIT_CPU_DEPTH = 2
TORCH_CKPT_STEPS = 4


def _zero_launches(counts):
    return {name: 0 for name in counts}


def _stage1_runner(step, cfg, hp, thp, teacher, x, labels, ngen):
    """``run(state, n, b)``: n stage-1 steps on the first b images, each
    with a fresh draw from ``ngen``; returns (state, losses, metrics)."""
    from uvc_tpu_torch.train.step import draw_stage1_noise

    def run(st, n, b=BATCH):
        losses = []
        for _ in range(n):
            noise = draw_stage1_noise(ngen, cfg, hp, thp, b, "cuda")
            st, m = step(st, teacher, x[:b], labels[:b], noise, TRAIN_TAU)
            losses.append(m["loss"])
        return st, losses, m
    return run


def _timed_window(label, run, state, warm, timed, per_step, card, what):
    """``warm`` untimed steps, then ``timed`` steps as one window with their
    launches held to ``per_step`` each (0 of every other kernel); prints
    img/s and peak memory.  Returns (state, counts, img/s)."""
    t0 = time.perf_counter()
    state, _, _ = run(state, warm)
    torch.cuda.synchronize()
    print(f"{label}: {warm} untimed steps in {time.perf_counter() - t0:.2f} "
          f"s", flush=True)
    state, losses, m, counts, secs, issued, peak = _count_window(
        run, state, timed)
    want = _want(counts, step=(per_step, timed))
    print(f"launches {label} {counts} (expected {want})")
    check(counts == want, f"{label} launch counts differ")
    check(torch.isfinite(losses).all().item(),
          f"non-finite {label} losses {losses.tolist()}")
    rate = timed * BATCH / secs
    print(f"{label} ({what}, batch {BATCH}, bf16): {rate:.1f} img/s "
          f"({timed} steps in {secs:.4f} s, {1e3 * secs / timed:.2f} "
          f"ms/step; the host had issued them after {issued:.4f} s) [{card}]")
    print(f"  losses {[round(v, 4) for v in losses.tolist()]}; last step "
          f"grad_norm={float(m['grad_norm']):.4f}")
    print(f"{label} max_memory_allocated={peak} bytes "
          f"({peak / 2**20:.1f} MiB) [{card}]")
    return state, counts, rate


def _npz_round_trip(params, cfg, tmp):
    """Write ``params`` as an upstream R50+ViT ``.npz`` and read it back
    through ``load_npz_checkpoint``: every leaf the file carries equal to
    what was written.  Returns the loaded tree on the card."""
    import numpy as np

    from uvc_tpu_torch.models.convert import load_npz_checkpoint, to_npz_dict
    from uvc_tpu_torch.utils.tree import leaf_at, tree_leaves_with_path

    path = os.path.join(tmp, "r50_vit_b16.npz")
    t0 = time.perf_counter()
    np.savez(path, **to_npz_dict(params, cfg))
    loaded = load_npz_checkpoint(path, cfg)
    secs = time.perf_counter() - t0
    carried = [(p, leaf) for p, leaf in tree_leaves_with_path(loaded)
               if p[0] not in ("block_gating", "attn_gating", "mlp_gating",
                               "token_scorer")]
    bad = [".".join(p) for p, leaf in carried
           if not torch.equal(leaf, leaf_at(params, p).float().cpu())]
    units = [len(loaded["resnet"][f"block{i}"]) for i in (1, 2, 3)]
    print(f"R50-ViT-B/16 upstream .npz: {os.path.getsize(path) / 2**20:.1f} "
          f"MiB written and read back in {secs:.2f} s; stem units {units} "
          f"({sum(units)}), {len(carried)} leaves, {len(bad)} differ from "
          f"what was written")
    check(units == [3, 4, 9], f"the stem's units {units}")
    check(not bad, f"leaves read back unequal: {bad[:5]}")
    return _tree_to(loaded, "cuda")


def r50_phase(card):
    """Phase 14 (a): R50-ViT-B/16 at full width and depth through stage 1,
    eval, compact serving, stage 2 and compact_ft.  Returns the launches
    of its windows."""
    import tempfile

    from uvc_tpu_torch.compress.masks import build_masks
    from uvc_tpu_torch.compress.minimax import init_compression_state
    from uvc_tpu_torch.compress.resource import build_macs_table
    from uvc_tpu_torch.compress.state import MinimaxHParams
    from uvc_tpu_torch.configs import get_config
    from uvc_tpu_torch.infer.compact import apply_compact, compact_model
    from uvc_tpu_torch.models import vit
    from uvc_tpu_torch.ops import (launch_counts, reset_launch_counts)
    from uvc_tpu_torch.train.compact_ft import (build_compact_stage2_step,
                                                compact_train_tree)
    from uvc_tpu_torch.train.state import TrainHParams, create_train_state
    from uvc_tpu_torch.train.step import (build_stage1_step,
                                          build_stage2_step,
                                          draw_stage1_noise, eval_step)
    from uvc_tpu_torch.utils.tree import tree_map

    cfg = get_config(R50_MODEL)
    ln = cfg.depth
    check((cfg.embed_dim, cfg.num_heads, cfg.mlp_hidden, cfg.seq_len,
           cfg.resnet_layers) == (768, 12, 3072, 197, (3, 4, 9)),
          "R50-ViT-B/16's widths")
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    grown = _grown_vit(cfg, 70)
    with tempfile.TemporaryDirectory(prefix="uvc_r50_") as tmp:
        params = _npz_round_trip(grown, cfg, tmp)
    del grown
    # the teacher: the same upstream weights, dense
    teacher = tree_map(torch.clone, params)

    # -- stage 1 ------------------------------------------------------------
    hp = MinimaxHParams(enable_patch_gating=2, gating_interval=100)
    thp = TrainHParams()
    table = build_macs_table(cfg)
    step = build_stage1_step(cfg, table, hp, thp, warmup=False)
    igen = torch.Generator(device="cuda").manual_seed(71)
    x = torch.randn(BATCH, cfg.img_size, cfg.img_size, cfg.in_chans,
                    generator=igen, device="cuda")
    labels = torch.randint(0, cfg.num_classes, (BATCH,), generator=igen,
                           device="cuda")
    ngen = torch.Generator().manual_seed(72)
    run = _stage1_runner(step, cfg, hp, thp, teacher, x, labels, ngen)
    state = create_train_state(params, thp,
                               init_compression_state(cfg, hp, "cuda"))
    state, counts, _ = _timed_window(
        "R50 stage-1 train step", run, state, TRAIN_WARM, TRAIN_TIMED,
        FLAGSHIP_STEP, card, "R50-ViT-B/16")
    add(counts)
    profile_phase(card, {"R50 stage-1 train step": lambda: run(state, 1)},
                  top=14)

    # the card against the CPU plain path: the full stem at 224 px, the
    # first blocks, from one state with one set of draws
    small, cut_cfg = R50_CPU_BATCH, cfg.replace(depth=R50_CPU_DEPTH)
    cut, _ = _cut_depth(params, cfg, R50_CPU_DEPTH)
    cut_teacher, _ = _cut_depth(teacher, cfg, R50_CPU_DEPTH)
    c_state = create_train_state(cut, thp, init_compression_state(
        cut_cfg, hp, "cuda"))
    c_step = build_stage1_step(cut_cfg, build_macs_table(cut_cfg), hp, thp,
                               warmup=False)
    noise = draw_stage1_noise(ngen, cut_cfg, hp, thp, small, "cpu")
    _, gm = c_step(c_state, cut_teacher, x[:small], labels[:small],
                   _noise_to(noise, "cuda"), TRAIN_TAU)
    t0 = time.perf_counter()
    _, cm = c_step(_state_to(c_state, "cpu"), _tree_to(cut_teacher, "cpu"),
                   x[:small].cpu(), labels[:small].cpu(), noise, TRAIN_TAU)
    print(f"R50 stage-1 step on the CPU plain path (depth {R50_CPU_DEPTH}, "
          f"batch {small}): {time.perf_counter() - t0:.2f} s")
    card_vs_cpu(f"R50 stage-1 step (depth {R50_CPU_DEPTH})", small, gm, cm,
                ("loss", "grad_norm", "resource"))

    # -- a discovered architecture: eval and compact serving ----------------
    trained = tree_map(lambda t: t.detach().clone(), state.params)
    gen = torch.Generator().manual_seed(73)
    s = torch.tensor([[3.0, cfg.mlp_hidden / 2]] * ln)
    r = torch.randint(0, cfg.head_size // 4 + 1, (ln, cfg.num_heads),
                      generator=gen).float()
    masks = build_masks(trained, s.cuda(), r.cuda(), cfg)
    gating = torch.tensor([[-1.0, 1.0]] * ln)
    for i in SKIPPED_BLOCKS:
        gating[i] = torch.tensor([1.0, -1.0])
    trained["block_gating"] = gating.cuda()
    kept = ln - len(SKIPPED_BLOCKS)
    layers, top = compact_model(trained, masks, cfg)
    check(len(layers) == kept and "resnet" in top
          and all(b["num_heads"] == 9
                  and b["fc1"]["kernel"].shape[1] == cfg.mlp_hidden // 2
                  for b in layers),
          "R50 compact layers are not 10 of 9 heads / F 1536 with the stem")
    images = [torch.randn(BATCH, cfg.img_size, cfg.img_size, cfg.in_chans,
                          generator=igen, device="cuda")
              for _ in range(R50_SERVE_BATCHES)]
    ehp = MinimaxHParams(enable_block_gating=True, enable_patch_gating=2,
                         patch_ratio=TOKEN_RATIO)
    n_img = R50_SERVE_BATCHES * BATCH

    def serve():
        return [apply_compact(layers, top, xb, cfg, token_ratio=TOKEN_RATIO)
                .logits for xb in images]

    def evaluate():
        tot = 0
        for xb in images:
            tot = tot + eval_step(trained, masks, xb, labels, cfg,
                                  ehp)["correct"]
        return tot.item()

    with torch.no_grad():
        serve()
        evaluate()
        reset_launch_counts()
        w_serve, _, logits = passes(serve)
        serve_counts = launch_counts()
        reset_launch_counts()
        w_eval, _, _ = passes(evaluate)
        eval_counts = launch_counts()
    runs = N_PASSES * R50_SERVE_BATCHES
    want_serve = _want(serve_counts, b=({"layer_attention_ln": kept,
                                         "mlp_ln": kept}, runs))
    want_eval = _want(eval_counts, b=(PIPE_EVAL_BATCH, runs))
    print(f"launches R50 compact serving {serve_counts} (expected "
          f"{want_serve})")
    print(f"launches R50 eval_step       {eval_counts} (expected "
          f"{want_eval})")
    check(serve_counts == want_serve, "R50 serving launch counts differ")
    check(eval_counts == want_eval, "R50 eval launch counts differ")
    add(serve_counts)
    add(eval_counts)
    for lab, window in (("compact serving (token ratio 0.7)", w_serve),
                        ("eval_step (masked dense)", w_eval)):
        print(f"R50-ViT-B/16 {lab}: {N_PASSES * n_img / window:.1f} img/s "
              f"({N_PASSES} passes of {R50_SERVE_BATCHES} batches of "
              f"{BATCH} in {window:.4f} s) [{card}]")
    keep = (trained["block_gating"][:, 1] > trained["block_gating"][:, 0])
    hard = torch.stack([1.0 - keep.float(), keep.float()], dim=-1)
    with torch.no_grad():
        for ratio, mode in ((None, 0), (TOKEN_RATIO, 2)):
            dense = vit.apply(trained, images[0], cfg, gating_distrib=hard,
                              masks=masks, patch_gate_mode=mode,
                              patch_ratio=TOKEN_RATIO, patch_physical=True,
                              dtype=torch.bfloat16).logits
            comp = apply_compact(layers, top, images[0], cfg,
                                 token_ratio=ratio).logits
            rel, mx = rel_err(comp, dense)
            check(torch.isfinite(comp).all().item()
                  and comp.shape == (BATCH, cfg.num_classes),
                  "R50 compact logits")
            print(f"R50 compact vs masked dense (token ratio {ratio}): "
                  f"rel_fro={rel:.2e} max_abs={mx:.2e} "
                  f"(tol {MODEL_REL_TOL})")
            check(rel <= MODEL_REL_TOL, "R50 compact and masked dense "
                  "disagree")

    # -- stage 2 and compact_ft -------------------------------------------
    s2_hp = MinimaxHParams(enable_patch_gating=2, patch_ratio=TOKEN_RATIO)
    s2_step = build_stage2_step(cfg, s2_hp, thp)
    s2_run = _stage2_runner(s2_step, cfg, thp, teacher, masks, x, labels,
                            ngen)
    s2_state, counts, _ = _timed_window(
        "R50 stage-2 train step", s2_run, create_train_state(trained, thp),
        R50_S2_WARM, R50_S2_TIMED, FLAGSHIP_STEP, card, "R50-ViT-B/16")
    add(counts)
    ctree, meta = compact_train_tree(trained, masks, cfg)
    check(len(meta.plans) == kept, "R50 compact_ft layers")
    c2_step = build_compact_stage2_step(cfg, s2_hp, thp, meta)
    c2_run = _stage2_runner(c2_step, cfg, thp, teacher, masks, x, labels,
                            ngen)
    c2_state, counts, _ = _timed_window(
        "R50 compact stage-2 train step", c2_run,
        create_train_state(ctree, thp), R50_S2_WARM, R50_S2_TIMED,
        {"layer_attention_ln": ln + kept, "mlp_ln": ln + kept,
         "layer_attention_ln_bwd": kept, "mlp_ln_bwd": kept}, card,
        "R50-ViT-B/16")
    add(counts)
    n_pad, leaked = _compact_leaks(c2_state, meta)
    print(f"R50 compact_ft padding and v-masked coordinates: {n_pad}, "
          f"nonzero: {leaked}")
    check(leaked == 0, "an R50 compact padding slot or v-masked row moved")
    _one_step_each("R50", cfg, s2_step, c2_step, s2_state, meta, masks,
                   teacher, thp, x, labels, ngen)
    return total


def cait_phase(card):
    """Phase 14 (b): CaiT-S24-224 through the baseline fine-tune under a
    half-density magnitude mask from ``generate_mask --type mag``, and its
    eval.  Returns the launches (none: CaiT is a composition)."""
    import tempfile

    from uvc_tpu_torch.baselines.finetune import build_baseline_eval_step
    from uvc_tpu_torch.baselines.pruning import masks_from_flat
    from uvc_tpu_torch.cli import generate_mask
    from uvc_tpu_torch.configs import get_config
    from uvc_tpu_torch.models import cait
    from uvc_tpu_torch.ops import launch_counts, reset_launch_counts
    from uvc_tpu_torch.train.state import TrainHParams
    from uvc_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    cfg = get_config(CAIT_MODEL)
    check((cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.cls_attn_layers,
           cfg.img_size) == (384, 24, 8, 2, 224), "CaiT-S24-224's widths")
    gen = torch.Generator().manual_seed(80)
    params = cait.init_params(gen, cfg)
    params["head"]["kernel"] = 0.05 * torch.randn(
        params["head"]["kernel"].shape, generator=gen).cuda()
    with tempfile.TemporaryDirectory(prefix="uvc_cait_") as tmp:
        weights = os.path.join(tmp, "cait.ckpt")
        save_checkpoint(weights, {"params": params})
        mask_file = os.path.join(tmp, "mag.ckpt")
        t0 = time.perf_counter()
        out, counts = _run_cli(generate_mask.main, [
            "--type", "mag", "--model_type", CAIT_MODEL, "--sparsity",
            str(BASE_DENSITY), "--pretrained", weights, "--save_file",
            mask_file])
        print(f"generate_mask --type mag (CaiT-S24-224): "
              f"{time.perf_counter() - t0:.2f} s, launches {counts}")
        check(counts == _zero_launches(counts), "generate_mask mag launched")
        wmasks = masks_from_flat(load_checkpoint(mask_file), params)
    total = {}
    counts, state, _ = baseline_phase(card, {}, CAIT_MODEL, "CaiT-S24-224",
                                      init=(params, wmasks),
                                      cpu_depth=CAIT_CPU_DEPTH)
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    print(f"baseline CaiT-S24-224 kernel launches: {sum(counts.values())} "
          f"(talking heads and class attention are a composition)")

    thp = TrainHParams()
    estep = build_baseline_eval_step(cfg, thp)
    igen = torch.Generator(device="cuda").manual_seed(81)
    images = [torch.randn(BATCH, cfg.img_size, cfg.img_size, cfg.in_chans,
                          generator=igen, device="cuda")
              for _ in range(R50_SERVE_BATCHES)]
    labels = torch.randint(0, cfg.num_classes, (BATCH,), generator=igen,
                           device="cuda")

    def evaluate():
        tot = 0
        for xb in images:
            tot = tot + estep(state.params, wmasks, xb, labels)["count"]
        return tot.item()

    evaluate()
    reset_launch_counts()
    window, _, n = passes(evaluate)
    counts = launch_counts()
    check(n == R50_SERVE_BATCHES * BATCH, f"CaiT eval count {n}")
    check(counts == _zero_launches(counts), "CaiT eval launched a kernel")
    print(f"CaiT-S24-224 baseline eval step: "
          f"{N_PASSES * R50_SERVE_BATCHES * BATCH / window:.1f} img/s "
          f"({N_PASSES} passes of {R50_SERVE_BATCHES} batches of {BATCH} in "
          f"{window:.4f} s) [{card}]")
    return total


def _reference_state_dict(params, masks, cfg):
    """A reference-layout stage-1 state dict: the timm weights of
    ``to_torch_state_dict`` and a binary ``mask`` buffer on every weighted
    module, zero at ``attn.proj``'s pruned columns and ``mlp.fc1`` /
    ``mlp.fc2``'s pruned units, one elsewhere."""
    from uvc_tpu_torch.models.convert import to_torch_state_dict

    sd = to_torch_state_dict(params, cfg)
    for key in [k for k in sd if k.endswith(".weight")]:
        sd[key[:-len("weight")] + "mask"] = torch.ones_like(sd[key])
    attn, mlp = masks["attn"].cpu(), masks["mlp"].cpu()
    for i in range(cfg.depth):
        sd[f"blocks.{i}.attn.proj.mask"] *= attn[i][None]
        sd[f"blocks.{i}.mlp.fc2.mask"] *= mlp[i][None]
        sd[f"blocks.{i}.mlp.fc1.mask"] *= mlp[i][:, None]
    return sd


def torch_ckpt_phase(card):
    """Phase 14 (c): ``post_train`` from a reference-layout torch stage-1
    ``.pth.tar`` on DeiT-Small with phase 11's seeded architecture: the
    masks read bit for bit, every masked, pruned and skipped coordinate's
    gradient exactly 0, exact launches.  Returns the launches."""
    import tempfile

    from uvc_tpu_torch.cli import post_train
    from uvc_tpu_torch.configs import get_config
    from uvc_tpu_torch.utils.checkpoint import load_checkpoint

    cfg = get_config(PIPE_MODEL).replace(num_classes=PIPE_CLASSES)
    params, _, masks = _stage2_model(cfg, 60, SKIPPED_BLOCKS, S2_KEPT_UNITS)
    with tempfile.TemporaryDirectory(prefix="uvc_torch_ckpt_") as tmp:
        path = os.path.join(tmp, "stage1.pth.tar")
        torch.save({"model": _reference_state_dict(params, masks, cfg),
                    "epoch": 29}, path)
        _, read = post_train.stage1_params_and_masks(path, cfg)
        same = all(torch.equal(read[k], masks[k].cpu()) for k in masks)
        print(f"post_train's masks from the .pth.tar's *.mask buffers: "
              f"{'equal' if same else 'UNEQUAL'} bit for bit to the masks "
              f"written ({int(read['attn'].sum())} of {read['attn'].numel()} "
              f"context dims, {int(read['mlp'].sum())} of "
              f"{read['mlp'].numel()} units kept)")
        check(same, "the masks read are not the masks written")
        t0 = time.perf_counter()
        out, counts = _run_cli(post_train.main, [
            "--model_type", PIPE_MODEL, "--dataset", "procedural",
            "--img_size", str(cfg.img_size), "--train_batch_size",
            str(BATCH), "--eval_batch_size", str(BATCH), "--synthetic_steps",
            str(TORCH_CKPT_STEPS), "--num_epochs", "1", "--dp", "1",
            "--distillation-type", "soft", "--patch_ratio", str(TOKEN_RATIO),
            "--checkpoint_dir", path, "--output_dir", tmp, "--name", "s2"])
        print(f"post_train from the .pth.tar: 1 epoch of "
              f"{TORCH_CKPT_STEPS} steps in {time.perf_counter() - t0:.2f} s")
        want = _want(counts, train=(FLAGSHIP_STEP, TORCH_CKPT_STEPS),
                     eval=(PIPE_EVAL_BATCH, PIPE_EVAL_BATCHES))
        print(f"launches post_train (.pth.tar) {counts} (expected {want})")
        check(counts == want, "post_train (.pth.tar) launch counts differ")
        ck = load_checkpoint(os.path.join(tmp, "s2",
                                          f"{cfg.name}_post_0.ckpt"))
    check(int(ck["global_step"]) == TORCH_CKPT_STEPS, "post_train's steps")
    check(all(torch.equal(ck["masks"][k], masks[k].cpu()) for k in masks),
          "the stage-2 checkpoint's masks are not the buffers'")
    mu = _tree_to(ck["opt_state"]["0"]["mu"], "cuda")
    n_zero, leaked = _frozen_moment_leaks(mu, _tree_to(masks, "cuda"), cfg,
                                          SKIPPED_BLOCKS)
    print(f"post_train (.pth.tar): coordinates whose gradient must be "
          f"exactly 0: {n_zero}, with a nonzero AdamW first moment after "
          f"{TORCH_CKPT_STEPS} steps: {leaked}")
    check(n_zero > 0 and leaked == 0,
          "a masked coordinate of the torch checkpoint received a gradient")
    return counts


# ---------------------------------------------------------------------------
# phase 15: data parallelism
# ---------------------------------------------------------------------------

DDP_WORLD = 2
DDP_WARM, DDP_UVC = 1, 4
# each rank's step against the single-process step on the concatenated
# batch: the same bf16 kernels, the loss and gradient summed as two
# half-batch means (TRAIN_REL_TOL's reasoning, over a few steps)
DDP_REL_TOL = 2e-2
DDP_KEYS = ("loss", "grad_norm", "resource")
# phase 11's compact step: 12 teacher and 10 student blocks' K1 and K2,
# the 10 students' A2 and A6
COMPACT_STEP = {"layer_attention_ln": 22, "mlp_ln": 22,
                "layer_attention_ln_bwd": 10, "mlp_ln_bwd": 10}
DDP_ALONE_STEPS = 8
# phase 12's epoch rates, which phase 15 prints beside its own
PIPE_RATES = {}


def _ddp_specs(tmp, only=None, ema_decay=0.0, states=False):
    """Phase 15 (a)'s spec files (``parallel/dryrun.py``): DeiT-Small at
    full width, a global batch of 64 drawn from a seed, and each spec's
    kernel launches a step; ``only`` keeps the specs named, ``ema_decay``
    turns the baseline's EMA on and ``states`` records the whole params
    after every step (phase 17)."""
    from uvc_tpu_torch.configs import get_config
    from uvc_tpu_torch.parallel import dryrun

    cfg = get_config(PIPE_MODEL)
    flagship = dict(enable_patch_gating=2, gating_interval=100)
    plain = dict(mixup=0.0, cutmix=0.0)
    base = dict(model=PIPE_MODEL, tau=TRAIN_TAU, head_std=0.05)
    params, teacher, masks = _stage2_model(cfg, 60, SKIPPED_BLOCKS,
                                           S2_KEPT_UNITS)
    s2_arrays = dict(params=params, teacher=teacher, masks=masks)
    s2_hp = dict(enable_patch_gating=2, patch_ratio=TOKEN_RATIO)
    specs = [
        ("stage1", dict(base, kind="stage1", hp=flagship, thp=plain,
                        warmup=DDP_WARM, data=[DDP_WARM + DDP_UVC, BATCH, 11],
                        noise_seed=12, seed=13), {}, FLAGSHIP_STEP),
        ("stage1 mixup", dict(base, kind="stage1", hp=flagship,
                              data=[1, BATCH, 14], noise_seed=15, seed=13),
         {}, FLAGSHIP_STEP),
        ("stage2", dict(base, kind="stage2", hp=s2_hp, data=[1, BATCH, 16],
                        noise_seed=17), s2_arrays, PIPE_TRAIN_STEP),
        ("compact_ft", dict(base, kind="compact_ft", hp=s2_hp,
                            data=[1, BATCH, 18], noise_seed=19), s2_arrays,
         COMPACT_STEP),
        ("baseline", dict(base, kind="baseline", data=[1, BATCH, 20],
                          noise_seed=21, seed=22,
                          baseline=dict(drop_path_rate=0.1, re_prob=0.25,
                                        ema_decay=ema_decay)),
         {}, BASE_TRAIN_STEP),
    ]
    out = []
    for name, settings, arrays, per_step in specs:
        if only is not None and name not in only:
            continue
        if states:
            settings = dict(settings, step_states=True)
        path = os.path.join(tmp, name.replace(" ", "_") + ".npz")
        dryrun.write_spec(path, settings, **arrays)
        out.append((name, path, per_step))
    return out


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-6)


def ddp_ranks_phase(card):
    """Phase 15 (a): two ranks on the one card over gloo (NCCL takes one
    rank a GPU), each a ``python -m uvc_tpu_torch.parallel.dryrun`` rank:
    DeiT-Small stage 1 (1 warmup and 4 UVC steps, mixup off), one stage-1
    step with mixup (the partners across the ranks), one step each of
    stage 2, compact_ft and the baseline fine-tune.  After every step the
    ranks hold the same bytes; each step's metrics are within DDP_REL_TOL
    of this process's single-process run on the concatenated batch; each
    rank's launches are exact.  Returns the launches (the ranks' and the
    references')."""
    import tempfile

    from uvc_tpu_torch.ops import (backward_launch_counts, launch_counts,
                                   reset_launch_counts)
    from uvc_tpu_torch.parallel import dryrun

    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    with tempfile.TemporaryDirectory(prefix="uvc_ddp_") as tmp:
        specs = _ddp_specs(tmp)
        t0 = time.perf_counter()
        dryrun.launch_ranks(DDP_WORLD, device="cuda", backend="gloo",
                            tasks=[p for _, p, _ in specs], threads=2,
                            timeout=900)
        wall = time.perf_counter() - t0
        print(f"phase 15 (a): {DDP_WORLD} ranks over gloo on one card, "
              f"{len(specs)} specs in {wall:.1f} s wall (each rank's CUDA "
              f"start and kernel load included) [{card}]", flush=True)
        for name, path, per_step in specs:
            ranks = dryrun.read_rank_results(path, DDP_WORLD)
            settings, arrays = dryrun.read_npz(path)
            torch.cuda.synchronize()
            reset_launch_counts()
            ref, _ = dryrun.run_spec(settings, arrays, device="cuda")
            torch.cuda.synchronize()
            add({**launch_counts(), **backward_launch_counts()})
            (r0, _), (r1, _) = ranks
            check(r0["digests"] == r1["digests"],
                  f"{name}: the ranks' states differ after a step")
            worst = 0.0
            for got, want in zip(r0["metrics"], ref["metrics"]):
                for k in DDP_KEYS:
                    if k in want:
                        worst = max(worst, _rel(got[k], want[k]))
            check(worst <= DDP_REL_TOL,
                  f"{name}: two ranks vs one process differ by {worst:.2e}")
            for r, (res, _) in enumerate(ranks):
                for step, counts in enumerate(res["launches"]):
                    check(counts == per_step,
                          f"{name}: rank {r} step {step} launched {counts} "
                          f"(expected {per_step})")
                    add(counts)
            clock = r0["reduce"]
            n = max(1, clock["calls"])
            steps = len(r0["step_ms"])
            step_ms = sorted(r0["step_ms"])[steps // 2]
            print(f"phase 15 [{name}]: {steps} step(s), ranks bit for bit "
                  f"equal after each; loss "
                  f"{r0['metrics'][-1]['loss']:.5f} (one process "
                  f"{ref['metrics'][-1]['loss']:.5f}), worst of "
                  f"{'/'.join(k for k in DDP_KEYS if k in ref['metrics'][0])}"
                  f" {worst:.2e} (tol {DDP_REL_TOL}); launches a step "
                  f"{per_step} on each rank; rank step {step_ms:.1f} ms "
                  f"(median; one process {sorted(ref['step_ms'])[steps // 2]:.1f}"
                  f" ms); gloo all-reduce {clock['host_ms'] / n:.1f} ms a "
                  f"step on the host, {(clock['device_ms'] or 0) / n:.1f} ms "
                  f"between its events on the card [{card}]", flush=True)
    return total


def _step_with_and_without_mesh(card, mesh):
    """Phase 5's stage-1 step (DeiT-Small, batch 64, the flagship
    settings) built without a mesh and with ``mesh`` (NCCL at world size
    1): windows of DDP_ALONE_STEPS steps in turns (plain, mesh, mesh,
    plain), each window from an idle card to its last synchronise, then
    one profiled step of each."""
    from uvc_tpu_torch.compress.minimax import init_compression_state
    from uvc_tpu_torch.compress.resource import build_macs_table
    from uvc_tpu_torch.compress.state import MinimaxHParams
    from uvc_tpu_torch.configs import get_config
    from uvc_tpu_torch.models import vit
    from uvc_tpu_torch.parallel import mesh as pmesh
    from uvc_tpu_torch.train.state import TrainHParams, create_train_state
    from uvc_tpu_torch.train.step import build_stage1_step, draw_stage1_noise

    cfg = get_config(PIPE_MODEL)
    hp = MinimaxHParams(enable_patch_gating=2, gating_interval=100)
    thp = TrainHParams()
    gen = torch.Generator().manual_seed(5)
    params, teacher = (vit.init_params(gen, cfg) for _ in range(2))
    for tree in (params, teacher):
        tree["head"]["kernel"] = 0.05 * torch.randn(
            tree["head"]["kernel"].shape, generator=gen).cuda()
    table = build_macs_table(cfg)
    state = create_train_state(params, thp,
                               init_compression_state(cfg, hp, "cuda"))
    igen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(BATCH, cfg.img_size, cfg.img_size, cfg.in_chans,
                    generator=igen, device="cuda")
    labels = torch.randint(0, cfg.num_classes, (BATCH,), generator=igen,
                           device="cuda")
    ngen = torch.Generator().manual_seed(7)
    steps = {"no mesh": build_stage1_step(cfg, table, hp, thp,
                                          warmup=False),
             "NCCL mesh (world 1)": build_stage1_step(
                 cfg, table, hp, thp, warmup=False, mesh=mesh)}

    def window(fn, n):
        st = state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            noise = draw_stage1_noise(ngen, cfg, hp, thp, BATCH, "cuda")
            st, _ = fn(st, teacher, x, labels, noise, TRAIN_TAU)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    for fn in steps.values():
        window(fn, 2)
    times = {k: [] for k in steps}
    labels_ = list(steps)
    pmesh.reset_reduce_clock(events=False)
    for k in (labels_[0], labels_[1], labels_[1], labels_[0]):
        times[k].append(window(steps[k], DDP_ALONE_STEPS))
    clock = pmesh.reduce_clock()
    check(clock["calls"] == 2 * DDP_ALONE_STEPS,
          "the mesh's steps did not all-reduce once each")
    # the host's pace moves between windows by more than the mesh costs:
    # the best window of each side is the one least disturbed
    plain, with_mesh = (min(times[k]) for k in labels_)
    phase5 = STEP_RATES.get("stage-1 step")
    print(f"  stage-1 step alone (DeiT-Small, batch {BATCH}, the flagship "
          f"settings, windows of {DDP_ALONE_STEPS} steps in turns plain / "
          f"mesh / mesh / plain): no mesh "
          f"{' / '.join(f'{t:.2f}' for t in times[labels_[0]])} ms a step "
          f"(best {BATCH / plain * 1e3:.1f} img/s), NCCL mesh at world 1 "
          f"{' / '.join(f'{t:.2f}' for t in times[labels_[1]])} ms (best "
          f"{BATCH / with_mesh * 1e3:.1f} img/s), best against best "
          f"{100 * (with_mesh / plain - 1):+.2f}%; the all-reduce "
          f"{clock['host_ms'] / clock['calls']:.3f} ms a step on the host; "
          f"phase 5's step "
          f"{'not run' if phase5 is None else f'{phase5:.1f} img/s'} "
          f"[{card}]")
    noise = draw_stage1_noise(ngen, cfg, hp, thp, BATCH, "cuda")
    profile_phase(card, {
        f"stage-1 step, {k}": (lambda fn=fn: fn(state, teacher, x, labels,
                                                  noise, TRAIN_TAU))
        for k, fn in steps.items()},
        watch={"NCCL kernels": "nccl", "the flatten (torch.cat)":
               "CatArrayBatchedCopy"}, host_top=12)


def ddp_nccl_phase(card):
    """Phase 15 (b): ``joint_train`` at world size 1 under NCCL, started
    as torchrun starts a rank (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``): phase 12's run (DeiT-Small,
    procedural data, 12 steps an epoch, 2 + 1 epochs) with its
    checkpoints, exact launches and the all-reduce's time a step; then the
    stage-1 step alone with and without the mesh, in turns, and one
    profiled step of each.  Returns the launches."""
    import re
    import tempfile

    import torch.distributed as dist

    from uvc_tpu_torch.cli import joint_train
    from uvc_tpu_torch.parallel import dryrun
    from uvc_tpu_torch.parallel import mesh as pmesh

    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(dryrun.free_port()))
    with tempfile.TemporaryDirectory(prefix="uvc_nccl_") as tmp:
        common = ["--model_type", PIPE_MODEL, "--dataset", "procedural",
                  "--img_size", "224", "--train_batch_size", str(BATCH),
                  "--eval_batch_size", str(BATCH), "--synthetic_steps",
                  str(PIPE_STEPS), "--distillation-type", "soft",
                  "--output_dir", tmp]
        os.environ.update(env)
        try:
            pmesh.reset_reduce_clock(events=True)
            t0 = time.perf_counter()
            out, counts = _run_cli(joint_train.main, common + [
                "--num_epochs", "2", "--warmup_epochs", "1",
                "--post_num_epochs", "1", "--name", "run"])
            wall = time.perf_counter() - t0
            clock = pmesh.reduce_clock()
        finally:
            for k in env:
                os.environ.pop(k, None)
        check(not dist.is_initialized(), "joint_train left its group up")
        check("Mesh: {'data': 1, 'model': 1}" in out,
              "joint_train formed no mesh under torchrun's environment")
        want = _want(counts, train=(PIPE_TRAIN_STEP, 3 * PIPE_STEPS),
                     eval=(PIPE_EVAL_BATCH, 3 * PIPE_EVAL_BATCHES))
        print(f"launches joint_train (NCCL, world 1) {counts} "
              f"(expected {want})")
        check(counts == want, "joint_train (NCCL) launch counts differ")
        name = "deit_small_patch16_224"
        files = [f"{name}_1.ckpt", f"{name}_2.ckpt", f"{name}_post_0.ckpt"]
        for f in files:
            check(os.path.exists(os.path.join(tmp, "run", f)),
                  f"joint_train (NCCL) wrote no {f}")
        check(clock["calls"] == 3 * PIPE_STEPS,
              f"{clock['calls']} all-reduces for {3 * PIPE_STEPS} steps")
    n = clock["calls"]
    epochs = re.findall(r"\[Epoch (\d+)\] ([\d.]+)s \(([\d.]+) img/s\)",
                        out)
    check(len(epochs) == 2, f"epoch lines {epochs}")
    print(f"joint_train under NCCL at world size 1 (DeiT-Small, batch "
          f"{BATCH}, 2 + 1 epochs of {PIPE_STEPS} steps): {wall:.2f} s wall, "
          f"checkpoints {', '.join(files)} [{card}]")
    for ep, secs, rate in epochs:
        ref = PIPE_RATES.get(ep)
        print(f"  stage-1 epoch {ep}: {rate} img/s (phase 12, no mesh: "
              f"{'not run' if ref is None else f'{ref} img/s'}) [{card}]")
    print(f"  gradient all-reduce (NCCL, world 1, {n} calls): "
          f"{clock['host_ms'] / n:.3f} ms a step on the host, "
          f"{clock['device_ms'] / n:.3f} ms a step on the card between its "
          f"events (flatten, all_reduce, divide, unflatten) [{card}]")

    # the step alone, with and without the mesh, in turns, then profiled
    os.environ.update(env, MASTER_PORT=str(dryrun.free_port()))
    try:
        pmesh.initialize_multihost()
        _step_with_and_without_mesh(card, pmesh.make_mesh())
    finally:
        for k in env:
            os.environ.pop(k, None)
        if dist.is_initialized():
            dist.destroy_process_group()
    return counts


# ---------------------------------------------------------------------------
# phase 16: the serving export (infer/export.py)
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
EXPORT_BATCHES = (8, 64)
EXPORT_PARTIAL = 5
# a fresh interpreter that imports the export's load side alone: argv is
# the artifact, the inputs (.npz by batch key) and the logits' file; it
# serves each batch once to warm and once counted, and prints its
# launches and what it imported beside the export
_LOAD_SIDE = """
import json, sys
import numpy as np, torch
from uvc_tpu_torch.infer.export import load_serving
from uvc_tpu_torch.ops import launch_counts, reset_launch_counts
art, inputs, out = sys.argv[1:4]
model = load_serving(art)
res = {"batch_sizes": model.batch_sizes, "launches": {}}
logits = {}
with np.load(inputs) as z:
    for key in z.files:
        x = torch.from_numpy(z[key]).cuda()
        model(x)
        torch.cuda.synchronize()
        reset_launch_counts()
        y = model(x)
        torch.cuda.synchronize()
        res["launches"][key] = {k: v for k, v in launch_counts().items()
                                if v}
        logits[key] = y.float().cpu().numpy()
np.savez(out, **logits)
res["imported"] = sorted(
    n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "uvc_tpu")
    or n.startswith(("uvc_tpu_torch.models", "uvc_tpu_torch.infer.compact",
                     "uvc_tpu_torch.train")))
print(json.dumps(res))
"""


def export_phase(card):
    """Phase 16: phase 4's DeiT-Small and phase 7's T2T-ViT-14 compact
    models (bf16) exported at batches 8 and 64 (``export_serving``), saved,
    then loaded and served in a fresh interpreter that imports
    ``uvc_tpu_torch.infer.export`` alone (no model code, no JAX imported):
    its logits against ``apply_compact``'s at the same batch (bit for bit,
    else within MODEL_REL_TOL), a batch of 5 padded to 8, its launches a
    batch equal to ``apply_compact``'s; then the artifact's img/s beside
    ``apply_compact``'s over the same windows, in turns.  Returns the
    launches of the windows and references in this process."""
    import subprocess
    import tempfile

    import numpy as np

    from uvc_tpu_torch.infer.compact import apply_compact
    from uvc_tpu_torch.infer.export import (ServingModel, export_serving,
                                            save_serving)
    from uvc_tpu_torch.ops import launch_counts, reset_launch_counts

    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    models = (("DeiT-Small", "deit_small_patch16_224", 0, SKIPPED_BLOCKS,
               TOKEN_RATIO, 0),
              ("T2T-ViT-14", "t2t_vit_14", 15, T2T_SKIPPED_BLOCKS, None, 2))
    with tempfile.TemporaryDirectory(prefix="uvc_export_") as tmp:
        for label, name, seed, skipped, ratio, stems in models:
            cfg, _, _, layers, top = _served_model(name, seed, skipped)
            kept = cfg.depth - len(skipped)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            arts = export_serving(layers, top, cfg,
                                  batch_sizes=EXPORT_BATCHES,
                                  token_ratio=ratio)
            export_s = time.perf_counter() - t0
            path = os.path.join(tmp, f"{name}.npz")
            save_serving(path, arts)
            mib = os.path.getsize(path) / 2 ** 20
            igen = torch.Generator(device="cuda").manual_seed(seed + 100)
            x = torch.randn(max(EXPORT_BATCHES), cfg.img_size, cfg.img_size,
                            cfg.in_chans, generator=igen, device="cuda")
            inputs = {f"b{b}": x[:b] for b in (*EXPORT_BATCHES,
                                                 EXPORT_PARTIAL)}
            in_path = os.path.join(tmp, f"{name}_x.npz")
            np.savez(in_path, **{k: v.cpu().numpy()
                                 for k, v in inputs.items()})
            # apply_compact at the program's batch: a partial batch padded
            # with zero images to the smallest exported batch, as the
            # artifact pads it
            refs, ref_counts = {}, {}
            with torch.no_grad():
                for key, xb in inputs.items():
                    fit = min(b for b in EXPORT_BATCHES if b >= len(xb))
                    xp = torch.cat([xb, xb.new_zeros(
                        (fit - len(xb),) + tuple(xb.shape[1:]))])
                    apply_compact(layers, top, xp, cfg, token_ratio=ratio)
                    torch.cuda.synchronize()
                    reset_launch_counts()
                    y = apply_compact(layers, top, xp, cfg,
                                      token_ratio=ratio).logits
                    torch.cuda.synchronize()
                    ref_counts[key] = {k: v for k, v in
                                       launch_counts().items() if v}
                    add(ref_counts[key])
                    refs[key] = y[:len(xb)].float().cpu()
            want = {"layer_attention_ln": kept, "mlp_ln": kept}
            if stems:
                want["performer"] = stems
            for key, counts in ref_counts.items():
                check(counts == want, f"{label} apply_compact [{key}] "
                      f"launched {counts} (expected {want})")
            out_path = os.path.join(tmp, f"{name}_y.npz")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", _LOAD_SIDE, path, in_path, out_path],
                cwd=REPO, capture_output=True, text=True, timeout=900,
                env=dict(os.environ, PYTHONPATH=REPO))
            load_s = time.perf_counter() - t0
            check(proc.returncode == 0,
                  f"{label}: the load side failed:\n{proc.stderr[-4000:]}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            check(res["imported"] == [],
                  f"{label}: the load side imported {res['imported']}")
            check(res["batch_sizes"] == list(EXPORT_BATCHES),
                  f"{label}: the artifact's batches {res['batch_sizes']}")
            served = dict(np.load(out_path))
            parts = []
            for key in inputs:
                check(res["launches"][key] == ref_counts[key],
                      f"{label} [{key}]: the artifact launched "
                      f"{res['launches'][key]}, apply_compact "
                      f"{ref_counts[key]}")
                got = torch.from_numpy(served[key])
                check(got.shape == refs[key].shape
                      and torch.isfinite(got).all().item(),
                      f"{label} [{key}]: served logits {tuple(got.shape)}")
                if torch.equal(got, refs[key]):
                    parts.append(f"{key} bit for bit")
                else:
                    rel, mx = rel_err(got, refs[key])
                    parts.append(f"{key} rel_fro={rel:.2e} max_abs={mx:.2e}")
                    check(rel <= MODEL_REL_TOL,
                          f"{label} [{key}]: the artifact and apply_compact "
                          f"disagree")
            print(f"phase 16 [{label}, {kept} kept blocks, token ratio "
                  f"{ratio}]: export {export_s:.2f} s for batches "
                  f"{EXPORT_BATCHES}, artifact {mib:.1f} MiB; loaded and "
                  f"served in a fresh interpreter ({load_s:.1f} s, kernels' "
                  f"load included) that imported no model code; against "
                  f"apply_compact: {', '.join(parts)} (b{EXPORT_PARTIAL} "
                  f"padded to b{min(EXPORT_BATCHES)}); launches a batch "
                  f"{ref_counts['b64']} both ways [{card}]", flush=True)

            # the artifact and apply_compact over the same windows, in turns
            model = ServingModel(arts)
            images = [torch.randn(BATCH, cfg.img_size, cfg.img_size,
                                  cfg.in_chans, generator=igen,
                                  device="cuda") for _ in range(N_BATCHES)]

            def artifact():
                return [model(xb) for xb in images]

            def eager():
                with torch.no_grad():
                    return [apply_compact(layers, top, xb, cfg,
                                          token_ratio=ratio).logits
                            for xb in images]

            artifact()
            eager()
            windows = {"artifact": [], "apply_compact": []}
            torch.cuda.synchronize()
            reset_launch_counts()
            for way, fn in (("artifact", artifact), ("apply_compact", eager),
                            ("apply_compact", eager),
                            ("artifact", artifact)):
                windows[way].append(passes(fn)[0])
            torch.cuda.synchronize()
            counts = {k: v for k, v in launch_counts().items() if v}
            runs = 4 * N_PASSES * N_BATCHES
            check(counts == {k: v * runs for k, v in want.items()},
                  f"{label}: the windows launched {counts}")
            add(counts)
            n_img = N_PASSES * N_BATCHES * BATCH
            rates = {k: [n_img / w for w in v] for k, v in windows.items()}
            print(f"phase 16 [{label}] serving {N_PASSES} passes of "
                  f"{N_BATCHES} batches of {BATCH}, in turns (artifact, "
                  f"apply_compact, apply_compact, artifact): " + "; ".join(
                      f"{k} {' / '.join(f'{r:.1f}' for r in v)} img/s "
                      f"(best {max(v):.1f})" for k, v in rates.items())
                  + f" [{card}]", flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 17: tensor parallelism (the model axis of parallel/mesh.py)
# ---------------------------------------------------------------------------

TP_WORLD, TP_MP = 4, 2
TP_SPECS = ("stage1", "stage2", "baseline")
TP_EMA = 0.99
# AdamW's largest step of a leaf's coordinate, a step: the learning rate
# (TrainHParams' default, every spec's), so that a leaf whose gradient is
# rounding noise (the qkv biases' key thirds, the token scorer's bias)
# moves at most this much further on one path than on the other
TP_NOISE_LR = 1e-4


def _noise_leaf(key):
    return key.endswith("token_scorer/bias") or key.endswith("qkv/bias")


def _tp_state_gaps(got, want, steps):
    """The gaps of a whole params tree (``got``, from the ranks) from the
    one-process run's (``want``) after ``steps`` steps: by leaf, (relative
    Frobenius gap, max abs gap, coordinates further apart than TP_NOISE_LR
    x ``steps``, coordinates), with the rounding-noise leaves (the qkv
    biases' key thirds, the token scorer's bias) split off and held to
    TP_NOISE_LR x ``steps`` absolute.  Returns (the gaps by leaf, the worst
    noise gap)."""
    import numpy as np

    gaps, noise = {}, 0.0
    for key, w in want.items():
        g = torch.from_numpy(np.asarray(got[key], np.float64))
        w = torch.from_numpy(np.asarray(w, np.float64))
        if _noise_leaf(key):
            if key.endswith("qkv/bias"):
                third = w.shape[-1] // 3
                mid = slice(third, 2 * third)
                noise = max(noise, float((g[..., mid] - w[..., mid]).abs()
                                         .max()))
                g, w = (torch.cat([a[..., :third], a[..., 2 * third:]], -1)
                        for a in (g, w))
            else:
                noise = max(noise, float((g - w).abs().max()))
                continue
        d = (g - w).abs()
        gaps[key] = (float(d.norm() / max(float(w.norm()), 1e-12)),
                     float(d.max()), int((d > TP_NOISE_LR * steps).sum()),
                     d.numel())
    check(noise <= TP_NOISE_LR * steps, f"a noise leaf moved {noise:.2e}")
    return gaps, noise


def tp_phase(card):
    """Phase 17: four ranks on the one card over gloo at 2 dp x 2 mp, each
    a ``python -m uvc_tpu_torch.parallel.dryrun`` rank holding its shard of
    the blocks' qkv / proj / fc1 / fc2 leaves: DeiT-Small at full width, a
    global batch of 64 (32 a data shard), stage 1 (1 warmup and 4 UVC
    steps), dense stage 2 and the baseline fine-tune with EMA, one step
    each.  Held: after every step the four ranks' whole (gathered) states
    bit for bit equal; each step's metrics and the whole params after it
    within DDP_REL_TOL of this process's single-process run on the global
    batch (the noise leaves within TP_NOISE_LR a step); each rank's
    tensor-parallel leaves half their whole bytes; each rank's launches a
    step exactly one process's at batch 32; compact stage 2 at mp 2
    raising JAX's ValueError; and the same specs run by two ranks at 2 dp
    x 1 mp (the same data split, no model axis) bit for bit the four
    ranks' states after every step.  A leaf of the whole params past
    DDP_REL_TOL passes only if every coordinate is within TP_NOISE_LR a
    step of one process's: a zero-initialised bias, whose value is
    AdamW's normalised steps alone, flips a step's sign where its
    gradient is bf16 rounding noise of the data split.  Recorded: the
    steps' all-gather and all-reduce ms.  Returns the launches."""
    import tempfile

    from uvc_tpu_torch.compress.state import MinimaxHParams
    from uvc_tpu_torch.configs import get_config
    from uvc_tpu_torch.ops import (backward_launch_counts, launch_counts,
                                   reset_launch_counts)
    from uvc_tpu_torch.parallel import dryrun
    from uvc_tpu_torch.parallel import mesh as pmesh
    from uvc_tpu_torch.train.stage2 import run_stage2
    from uvc_tpu_torch.train.state import TrainHParams

    try:
        run_stage2(get_config(PIPE_MODEL), MinimaxHParams(), TrainHParams(),
                   params={}, masks={}, train_loader=[], test_loader=None,
                   mesh=pmesh.Mesh(size=TP_WORLD, rank=0, mp=TP_MP),
                   mp=TP_MP, compact=True, device="cuda")
        refused = None
    except ValueError as err:
        refused = str(err)
    check(refused is not None and "data-parallel meshes only" in refused,
          f"compact stage 2 at mp {TP_MP} did not raise ({refused})")
    print(f"phase 17: compact stage 2 at mp {TP_MP} raises ValueError: "
          f"{refused}")

    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    import shutil

    failures = []
    with tempfile.TemporaryDirectory(prefix="uvc_tp_") as tmp:
        specs = _ddp_specs(tmp, only=TP_SPECS, ema_decay=TP_EMA,
                           states=True)
        t0 = time.perf_counter()
        dryrun.launch_ranks(TP_WORLD, device="cuda", backend="gloo",
                            tasks=[p for _, p, _ in specs], threads=2,
                            timeout=900, mp=TP_MP)
        wall = time.perf_counter() - t0
        print(f"phase 17: {TP_WORLD} ranks at {TP_WORLD // TP_MP} dp x "
              f"{TP_MP} mp over gloo on one card, {len(specs)} specs in "
              f"{wall:.1f} s wall (each rank's CUDA start and kernel load "
              f"included) [{card}]", flush=True)
        # the same specs at the same data split without the model axis
        dp_paths = []
        for _, path, _ in specs:
            dp_paths.append(path.replace(".npz", "_dp.npz"))
            shutil.copy(path, dp_paths[-1])
        dryrun.launch_ranks(TP_WORLD // TP_MP, device="cuda",
                            backend="gloo", tasks=dp_paths, threads=2,
                            timeout=900)
        for (name, path, per_step), dp_path in zip(specs, dp_paths):
            ranks = dryrun.read_rank_results(path, TP_WORLD)
            dp_ranks = dryrun.read_rank_results(dp_path,
                                                TP_WORLD // TP_MP)
            settings, arrays = dryrun.read_npz(path)
            torch.cuda.synchronize()
            reset_launch_counts()
            ref, ref_arrays = dryrun.run_spec(settings, arrays,
                                              device="cuda")
            torch.cuda.synchronize()
            add({**launch_counts(), **backward_launch_counts()})
            results = [res for res, _ in ranks]
            for r, res in enumerate(results[1:], 1):
                check(res["digests"] == results[0]["digests"],
                      f"{name}: rank {r}'s whole state differs from rank "
                      f"0's after a step")
            same_as_dp = all(res["digests"] == results[0]["digests"]
                             for res, _ in dp_ranks)
            worst = 0.0
            for got, want in zip(results[0]["metrics"], ref["metrics"]):
                for k in DDP_KEYS:
                    if k in want:
                        worst = max(worst, _rel(got[k], want[k]))
            check(worst <= DDP_REL_TOL,
                  f"{name}: 2 dp x 2 mp vs one process differ by "
                  f"{worst:.2e}")
            noise_gap, worst_leaves = 0.0, []
            steps = len(ref["metrics"])
            for i in range(steps):
                head = f"step{i}/params/"
                want = {k[len(head):]: v for k, v in ref_arrays.items()
                        if k.startswith(head)}
                got = {k[len(head):]: v for k, v in ranks[0][1].items()
                       if k.startswith(head)}
                check(want and sorted(got) == sorted(want),
                      f"{name}: step {i}'s whole params missing")
                gaps, ngap = _tp_state_gaps(got, want, i + 1)
                noise_gap = max(noise_gap, ngap)
                worst_leaves += [(g, i, k) for k, g in gaps.items()]
            worst_leaves.sort(key=lambda t: -t[0][0])
            state_gap = worst_leaves[0][0][0]
            # a leaf past the gate must be one that started at zero and
            # moved by AdamW's normalised steps alone (a bias), each of its
            # coordinates within those steps of one process's
            beyond = [(k, i, g) for g, i, k in worst_leaves
                      if g[0] > DDP_REL_TOL and g[2] > 0]
            print(f"phase 17 [{name}]: whole params against one process, "
                  f"the worst leaves (relative Frobenius, max abs, "
                  f"coordinates apart by more than {TP_NOISE_LR:g} a step "
                  f"of all): " + "; ".join(
                      f"{k} after step {i + 1} {g[0]:.2e} {g[1]:.2e} "
                      f"{g[2]}/{g[3]}" for g, i, k in worst_leaves[:4]),
                  flush=True)
            if beyond:
                failures.append(f"{name}: the whole params after a step "
                                f"differ: {beyond[:3]}")
            for r, res in enumerate(results):
                local, whole = res["tp_bytes"]
                check(whole > 0 and 2 * local == whole,
                      f"{name}: rank {r} holds {local} of {whole} bytes of "
                      f"the tensor-parallel leaves")
                for step, counts in enumerate(res["launches"]):
                    check(counts == per_step,
                          f"{name}: rank {r} step {step} launched {counts} "
                          f"(expected {per_step})")
                    add(counts)
            r0 = results[0]
            gather, reduce_ = r0["gather"], r0["reduce"]
            step_ms = sorted(r0["step_ms"])[steps // 2]
            print(f"phase 17 [{name}]: {steps} step(s), the 4 ranks' whole "
                  f"states bit for bit equal after each and "
                  f"{'bit for bit' if same_as_dp else 'NOT bit for bit'} "
                  f"the 2 dp x 1 mp run's at the same data split; loss "
                  f"{r0['metrics'][-1]['loss']:.5f} (one process "
                  f"{ref['metrics'][-1]['loss']:.5f}), worst of "
                  f"{'/'.join(k for k in DDP_KEYS if k in ref['metrics'][0])}"
                  f" {worst:.2e}, whole params {state_gap:.2e} (tol "
                  f"{DDP_REL_TOL}, or every coordinate within "
                  f"{TP_NOISE_LR:g} a step; noise leaves {noise_gap:.2e}); "
                  f"tensor-parallel leaves "
                  f"{r0['tp_bytes'][0]} of {r0['tp_bytes'][1]} bytes a rank; "
                  f"launches a step {per_step} on each rank; rank step "
                  f"{step_ms:.1f} ms (median; one process "
                  f"{sorted(ref['step_ms'])[steps // 2]:.1f} ms); all-gather "
                  f"{gather['calls'] / steps:.0f} calls "
                  f"{gather['host_ms'] / steps:.1f} ms a step on the host, "
                  f"{(gather['device_ms'] or 0) / steps:.1f} ms between its "
                  f"events on the card; all-reduce "
                  f"{reduce_['host_ms'] / steps:.1f} ms host, "
                  f"{(reduce_['device_ms'] or 0) / steps:.1f} ms card a step "
                  f"[{card}]", flush=True)
            if not same_as_dp:
                failures.append(f"{name}: the tensor-parallel run differs "
                                f"from the data-parallel one")
    check(not failures, "; ".join(failures))
    return total


# ---------------------------------------------------------------------------
# phase 18: the evidence harnesses
# ---------------------------------------------------------------------------

# the cut horizon of the e2e harness (its widths, depth, batch, task and
# recipe untouched): 8 batches an epoch, a 1-epoch pretrain extended once
# (2 epochs) while below its target, stage 1 of 2 epochs (1 warmup),
# stage 2 of 1 epoch, 2 eval batches
ACC_E2E_SIZES = dict(STEPS=8, PRETRAIN_EPOCHS=1, DENSE_EPOCHS_MAX=3,
                     EPOCHS=2, WARMUP=1, STAGE2_EPOCHS=1, EVAL_BATCHES=2)
# each step's launches on DeiT-Tiny's 12 blocks: a distilling step (stage
# 1, stage 2) as phase 12's; the pretrain (no distillation) runs no
# teacher, so the student's K1 and K3 and its A2 and A4
ACC_STEP = {"pretrain": {"layer_attention_ln": 12, "mlp_ln_blend": 12,
                         "layer_attention_ln_bwd": 12,
                         "mlp_ln_blend_bwd": 12},
            "stage1": PIPE_TRAIN_STEP, "stage2": PIPE_TRAIN_STEP}


class _Sizes:
    """Module constants set for a block and restored after it."""

    def __init__(self, module, sizes):
        self.module, self.sizes = module, sizes

    def __enter__(self):
        self.saved = {k: getattr(self.module, k) for k in self.sizes}
        for k, v in self.sizes.items():
            setattr(self.module, k, v)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.module, k, v)


class _StepLaunches:
    """Within the block, every step that ``train/step.py``'s builders
    return (looked up by the drivers at call time) records its own
    launches and host seconds: ``steps`` holds (kind, counts, seconds) a
    step, the kind "pretrain" (stage 1 without distillation), "stage1" or
    "stage2"."""

    def __enter__(self):
        from uvc_tpu_torch.train import step as step_mod

        self.mod, self.steps = step_mod, []
        self.saved = (step_mod.build_stage1_step, step_mod.build_stage2_step)
        b1, b2 = self.saved

        def stage1(cfg, table, hp, thp, **kw):
            kind = ("pretrain" if thp.distillation_type in (None, "none")
                    else "stage1")
            return self._counted(kind, b1(cfg, table, hp, thp, **kw))

        def stage2(cfg, hp, thp, **kw):
            return self._counted("stage2", b2(cfg, hp, thp, **kw))
        step_mod.build_stage1_step, step_mod.build_stage2_step = (stage1,
                                                                  stage2)
        return self

    def _counted(self, kind, fn):
        def step(*args):
            before = _all_counts()
            t = time.perf_counter()
            out = fn(*args)
            secs = time.perf_counter() - t
            after = _all_counts()
            self.steps.append((kind, {k: after[k] - before[k]
                                      for k in after}, secs))
            return out
        return step

    def __exit__(self, *exc):
        (self.mod.build_stage1_step,
         self.mod.build_stage2_step) = self.saved


def _all_counts():
    from uvc_tpu_torch.ops import (backward_launch_counts, composed_counts,
                                   launch_counts)
    return {**launch_counts(), **backward_launch_counts(),
            **composed_counts()}


def _check_steps(label, steps, want_kinds):
    """Every recorded step's launches exactly ACC_STEP's for its kind;
    prints each kind's median host ms a step (the step's call alone, the
    loader not included; the card is not waited for)."""
    kinds = {}
    for i, (kind, counts, secs) in enumerate(steps):
        want = _want(counts, step=(ACC_STEP[kind], 1))
        check(counts == want, f"{label} step {i} ({kind}) launches {counts} "
              f"(expected {want})")
        kinds.setdefault(kind, []).append(secs)
    check(set(kinds) == set(want_kinds),
          f"{label}: steps of kinds {sorted(kinds)}, expected {want_kinds}")
    print(f"{label}: launches exact in each of {len(steps)} steps "
          f"({', '.join(f'{k} {len(v)}' for k, v in kinds.items())}; per "
          f"step {', '.join(f'{k}: {ACC_STEP[k]}' for k in kinds)}); "
          f"median host ms a step's call: " + ", ".join(
              f"{k} {1e3 * sorted(v)[len(v) // 2]:.1f}"
              for k, v in kinds.items()), flush=True)


def _loader_ms(loader, n):
    """Host ms a batch of ``loader`` after its first."""
    it = iter(loader)
    next(it)
    t = time.perf_counter()
    for _ in range(n):
        next(it)
    return 1e3 * (time.perf_counter() - t) / n


def _metrics_finite(label, out):
    """Every number in every ``metrics.jsonl`` under ``out`` finite;
    returns the count."""
    import math

    n = 0
    for root, _, files in os.walk(out):
        if "metrics.jsonl" not in files:
            continue
        with open(os.path.join(root, "metrics.jsonl")) as fh:
            for line in fh:
                for k, v in json.loads(line).items():
                    if isinstance(v, float):
                        check(math.isfinite(v), f"{label}: {root} {k} = {v}")
                        n += 1
    check(n > 0, f"{label}: no metrics written")
    return n


def _record_keys(label, path, keys):
    with open(path) as fh:
        got = json.load(fh)
    check(set(got) == set(keys), f"{label}: the record's keys "
          f"{sorted(got)} are not {sorted(keys)}")
    return got


def card_vs_cpu_stage1(e2e, fid, art, card):
    """The e2e harness's stage 1 at the cut horizon again, on the CPU plain
    path in f32 from the same pretrained weights with the same batches and
    draws (the drivers draw from a CPU generator whatever the device):
    each epoch's FLOPs report and the minimax state against the card's run
    (bf16 through the kernels).  Printed, not gated: how far the card's
    trajectory is from the plain computation's over the first gating
    update."""
    import tempfile

    from uvc_tpu_torch.compress.state import MinimaxHParams
    from uvc_tpu_torch.train.stage1 import run_stage1
    from uvc_tpu_torch.train.state import TrainHParams
    from uvc_tpu_torch.utils.logging import MetricLogger
    from uvc_tpu_torch.utils.tree import tree_leaves_with_path

    with _Sizes(e2e, ACC_E2E_SIZES), \
            tempfile.TemporaryDirectory(prefix="uvc_acc_cpu_") as out:
        hp_kw, thp_kw = e2e.recipe()["stage1"]
        dense = _tree_to(art["dense"], "cpu")
        t0 = time.perf_counter()
        cpu = run_stage1(
            art["cfg"], MinimaxHParams(**hp_kw),
            TrainHParams(**thp_kw, compute_dtype=torch.float32),
            train_loader=art["train"], test_loader=art["test"],
            params=dense, teacher_params=dense, seed=0, output_dir=out,
            name="stage1", eval_each_epoch=True, save_checkpoints=False,
            logger=MetricLogger(out, "stage1"), device="cpu")
        secs = time.perf_counter() - t0
        ser = fid._read_series(out, "stage1")
    card_cs, cpu_cs = art["stage1"].state.cstate, cpu.state.cstate
    gaps = {f: rel_err(getattr(card_cs, f).cpu(), getattr(cpu_cs, f))[1]
            for f in ("s", "r", "y", "p", "z", "gating_accum")}
    params, _ = rel_err(*(torch.cat([
        v.detach().float().cpu().flatten()
        for _, v in tree_leaves_with_path(state.params)])
        for state in (art["stage1"].state, cpu.state)))
    print(f"e2e stage 1 at the cut horizon, card (bf16) vs CPU plain path "
          f"(f32, {secs:.1f} s) from the same weights and draws: Real "
          f"{[round(v, 4) for v in art['real_flops']]} vs "
          f"{[round(v, 4) for v in ser['real']]}; minimax state max abs "
          f"gap " + ", ".join(f"{f} {v:.3e}" for f, v in gaps.items())
          + f"; all params rel_fro {params:.3e}; accuracy "
          f"{art['stage1'].best_acc:.4f} vs {cpu.best_acc:.4f} (not gated) "
          f"[{card}]", flush=True)


def accuracy_phase(card):
    """Phase 18: both evidence harnesses through their entry points in this
    process, on DeiT-Tiny (distilled) at 64 px at full width and depth (12
    blocks of 192, 3 heads of 64, F 768), at a cut horizon:
    ``uvc_tpu_torch/scripts/e2e_accuracy.py`` at ACC_E2E_SIZES (batch 128:
    dense pretrain with its extension, stage 1 with token selection, stage
    2, compaction and slimmed serving) and
    ``scripts/trajectory_fidelity.py`` at its UVC_FID_SMOKE sizes (2
    batches of 8 an epoch, both scenarios).  Held: each training step's
    launches exact (ACC_STEP); every logged metric finite; each FLOPs
    series one entry an epoch; the compact model's full-token logits within
    MODEL_REL_TOL of the masked-dense forward at the same frozen decision
    (the oracle of gate A4); z, y, p, s >= 0 at the end (T5, B5); each
    record written with the JAX harness's keys.  Printed: each gate's
    value at the cut horizon, each stage's wall seconds, the steps' and
    loaders' host ms, and ``card_vs_cpu_stage1``.  Returns the phase's
    launches."""
    import math
    import tempfile

    from uvc_tpu_torch.data.pipeline import (ProceduralLoader,
                                             normalize_on_device)
    from uvc_tpu_torch.ops import reset_launch_counts
    from uvc_tpu_torch.scripts import e2e_accuracy as e2e
    from uvc_tpu_torch.scripts import trajectory_fidelity as fid

    with tempfile.TemporaryDirectory(prefix="uvc_acc_") as tmp:
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        reset_launch_counts()
        e2e_out = os.path.join(tmp, "e2e")
        with _Sizes(e2e, ACC_E2E_SIZES), _StepLaunches() as e2e_steps:
            record, art = e2e.run(0, e2e_out, "cuda")
            e2e.write_record(record, os.path.join(tmp, "e2e.json"))
            # each series one entry an epoch
            check(len(art["real_flops"]) == e2e.EPOCHS,
                  f"e2e stage-1 series {art['real_flops']}")
        fid_out = os.path.join(tmp, "fid")
        with _Sizes(fid, fid.SMOKE), _StepLaunches() as fid_steps:
            frecord, fsecs = fid.run(fid_out, device="cuda")
            fid.write_record(frecord, os.path.join(tmp, "fid.json"))
        torch.cuda.synchronize()
        counts = _all_counts()
        secs = time.perf_counter() - t0
        n_e2e = _metrics_finite("e2e", e2e_out)
        n_fid = _metrics_finite("fidelity", fid_out)
        _check_steps("e2e", e2e_steps.steps, ("pretrain", "stage1",
                                              "stage2"))
        _check_steps("fidelity", fid_steps.steps, ("pretrain",
                                                   "stage1"))
        fid_epochs = (fid.EPOCHS, fid.EPOCHS_BELOW)
        tiny, below = frecord["tiny"], frecord["below"]
        for name, series, n in (
                ("tiny real", tiny["real_flops_series"], fid_epochs[0]),
                ("tiny exp", tiny["exp_flops_series"], fid_epochs[0]),
                ("tiny argmax", tiny["argmax_flops_series"],
                 fid_epochs[0]),
                ("below real", below["real_flops_series"],
                 fid_epochs[1]),
                ("below argmax", below["argmax_flops_series"],
                 fid_epochs[1]),
                ("below z", below["z_series"], fid_epochs[1])):
            check(len(series) == n, f"fidelity {name} series has "
                  f"{len(series)} entries, {n} epochs ran")
        for key in ("T5 dual/primal invariants",
                    "B5 dual/primal invariants"):
            check(frecord["gates"][key], f"fidelity: {key} fails")
        # the oracle of A4: compact full-token logits against the
        # masked-dense forward at the same frozen decision
        x = normalize_on_device(torch.from_numpy(
            next(iter(art["test"]))[0]).cuda())
        compact = e2e.serving_logits(art["layers"], art["top"],
                                     art["cfg"], x, dtype=art["dtype"])
        masked = e2e.masked_dense_logits(
            art["params"], art["masks"], art["cfg"], x,
            gating_distrib=art["gating_distrib"], dtype=art["dtype"])
        rel, mx = rel_err(compact, masked)
        check(torch.isfinite(compact).all().item()
              and rel <= MODEL_REL_TOL,
              f"e2e compact vs masked dense logits rel_fro {rel:.3e} "
              f"(tol {MODEL_REL_TOL})")
        got = _record_keys("e2e", os.path.join(tmp, "e2e.json"),
                           e2e.RECORD_KEYS)
        check(got["backend"] == "cuda" and got["device"] == card,
              f"e2e record names {got['backend']} {got['device']}")
        _record_keys("fidelity", os.path.join(tmp, "fid.json"),
                     fid.RECORD_KEYS)
    card_vs_cpu_stage1(e2e, fid, art, card)
    numbers = ("dense_acc", "stage1_acc", "stage2_acc", "compact_acc",
               "slim_acc", "masked_dense_full_acc", "masked_dense_slim_acc",
               "real_flops_final", "compact_flops_fraction")
    check(all(math.isfinite(record[k]) for k in numbers),
          f"e2e record {[record[k] for k in numbers]}")
    print(f"e2e (DeiT-Tiny 64 px, {record['blocks_kept']}/12 blocks kept "
          f"after stage 2, {art['cfg'].num_patches} patches): compact vs "
          f"masked dense logits rel_fro={rel:.2e} max_abs={mx:.2e} (tol "
          f"{MODEL_REL_TOL}); {n_e2e} + {n_fid} metrics finite", flush=True)
    print("e2e at the cut horizon (not gated): " + ", ".join(
        f"{k} {record[k]}" for k in numbers + ("dense_epochs",)))
    for name, passed in {**record["gates"], **frecord["gates"]}.items():
        print(f"  {name}: {'PASS' if passed else 'FAIL'} at the cut "
              f"horizon (not gated)")
    e2e.print_stage_times(art, card)
    # the records' loaders at their full batch, on the host
    proc = _loader_ms(ProceduralLoader(
        e2e.BATCH, num_batches=9, img_size=e2e.IMG,
        num_classes=e2e.CLASSES, train=True, seed=0, **e2e.HARD), 8)
    tex = _loader_ms(fid.TextureLoader(fid.BATCH, 9, seed=0), 8)
    print(f"host loaders at batch {e2e.BATCH}: ProceduralLoader (e2e, "
          f"lowpass) {proc:.1f} ms a batch, TextureLoader (fidelity) "
          f"{tex:.1f} ms a batch")
    print("fidelity stages: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in fsecs.items()) + f" [{card}]")
    print(f"phase 18: {secs:.1f} s; launches {counts}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 19: the real-image input path, with PIL unimportable
# ---------------------------------------------------------------------------

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
IMG_FIXTURES = os.path.join(REPO_ROOT, "tests", "fixtures", "images")
# joint_train and baseline_train: 12 steps of 64 at 224 px over the
# photo-sized JPEG fixtures (symlinks) in 4 class folders, 2 eval batches
# of 64 a validation (every fixture); the CIFAR-layout run: 4 steps,
# resized 32 -> 224
IMG_STEPS, IMG_VAL, IMG_CLASSES = 12, 2 * BATCH, 4
IMG_CIFAR_STEPS = 4
# the first line of every phase-19 child: any import of PIL then fails
NO_PIL = 'import sys; sys.modules["PIL"] = None\n'


def _image_folder(root, n_train, n_val, photo_prefix="imagenet_"):
    """``n_train`` symlinks to the photo-sized fixtures whose names start
    with ``photo_prefix`` (the JPEGs, or ``webp_photo_`` for the lossy
    WebPs) in ``train/`` and ``n_val`` to every fixture (JPEG of each
    kind, PNG, BMP, WebP) in ``val/``, 4 classes.  Returns the train
    sources."""
    files = sorted(f for f in os.listdir(IMG_FIXTURES) if f != "digests.json")
    photos = [f for f in files if f.startswith(photo_prefix)]
    for split, n, srcs in (("train", n_train, photos), ("val", n_val, files)):
        for i in range(n):
            d = os.path.join(root, split, f"class_{i % IMG_CLASSES}")
            os.makedirs(d, exist_ok=True)
            src = srcs[i % len(srcs)]
            os.symlink(os.path.join(IMG_FIXTURES, src),
                       os.path.join(d, f"{i:05d}_{src}"))
    return photos


def _cifar_pickles(root, n_train, n_test, seed=0):
    """CIFAR-10's python-pickle layout (``cifar-10-batches-py``) of random
    images: five train batches and the test batch."""
    import pickle

    import numpy as np

    rng = np.random.default_rng(seed)
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    per = -(-n_train // 5)
    for name, n in [(f"data_batch_{i}", per) for i in range(1, 6)] + \
            [("test_batch", n_test)]:
        with open(os.path.join(base, name), "wb") as fh:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072),
                                               dtype=np.uint8),
                         b"labels": rng.integers(0, 10, n).tolist()}, fh)


def _epoch_lines(out, pattern, label):
    import re
    found = re.findall(pattern, out)
    check(found, f"{label}: no epoch line")
    return found


def _accuracies(out, pattern, label):
    import math
    import re
    accs = [float(a) for a in re.findall(pattern, out)]
    check(accs and all(math.isfinite(a) for a in accs),
          f"{label}: eval accuracies {accs}")
    return accs


def images_part(part, tmp):
    """One part of phase 19, in a child process whose first line made PIL
    unimportable; prints ``PHASE19 <json>`` with its launches."""
    import numpy as np

    from uvc_tpu_torch.data import native_loader
    from uvc_tpu_torch.data.pipeline import ArrayLoader, FolderLoader

    check(sys.modules.get("PIL", 0) is None, "PIL is importable here")
    card = card_line()
    folder = os.path.join(tmp, "folder")
    counts_all = {}

    def add(counts):
        for k, v in counts.items():
            counts_all[k] = counts_all.get(k, 0) + v

    common = ["--model_type", PIPE_MODEL, "--img_size", "224",
              "--train_batch_size", str(BATCH), "--eval_batch_size",
              str(BATCH), "--num_workers", "16", "--dp", "1",
              "--output_dir", os.path.join(tmp, "runs")]
    if part == "check":
        sys.path.insert(0, os.path.join(REPO_ROOT, "tests"))
        import image_check
        t0 = time.perf_counter()
        rep = image_check.check()
        for m in rep["mismatches"]:
            print(f"  MISMATCH {json.dumps(m)}")
        for kind, n in rep["per_kind"].items():
            print(f"  {kind:12s} {n['records']:4d} records, "
                  f"{n['mismatches']} differ from PIL / the JAX package")
        print(f"image fixtures: {rep['records']} records recomputed without "
              f"PIL in {time.perf_counter() - t0:.1f} s on the card's host "
              f"[{card}]", flush=True)
        check(not rep["mismatches"], f"{len(rep['mismatches'])} image "
              f"records differ from their digests")
    elif part == "joint":
        from uvc_tpu_torch.cli import joint_train
        real = native_loader.available
        rates, loader_ms = {}, {}
        # in turns, so that the first run's start-up in this process (CUDA
        # and the libraries' first calls) falls on each JPEG path once; the
        # WebP folder's run in the middle, warm, on the default loader (its
        # native path hands every WebP to the PIL path)
        for i, path in enumerate(("native", "pil", "webp", "pil", "native")):
            native_loader.available = real if path != "pil" else \
                (lambda: False)
            data_dir = os.path.join(tmp, "folder_webp") if path == "webp" \
                else folder
            t0 = time.perf_counter()
            out, counts = _run_cli(joint_train.main, common + [
                "--dataset", "imagenet", "--data_dir", data_dir,
                "--distillation-type", "soft", "--num_epochs", "1",
                "--warmup_epochs", "1", "--post_num_epochs", "0",
                "--name", f"joint_{i}_{path}"])
            wall = time.perf_counter() - t0
            # stage 1's validation after its epoch, stage 2's final one
            want = _want(counts, train=(PIPE_TRAIN_STEP, IMG_STEPS),
                         eval=(PIPE_EVAL_BATCH, 2 * IMG_VAL // BATCH))
            print(f"launches joint_train (run {i}, {path} path) {counts} "
                  f"(expected {want}); {wall:.1f} s wall")
            check(counts == want, f"joint_train on images ({path}) "
                  "launch counts")
            add(counts)
            (ep, secs, rate), = _epoch_lines(
                out, r"\[Epoch (\d+)\] ([\d.]+)s \(([\d.]+) img/s\)",
                "joint_train")
            accs = _accuracies(out, r"Validation @ step \d+: loss "
                               r"[\d.naninf]+ acc ([\d.naninf]+)%",
                               "joint_train")
            ms = _loader_ms(FolderLoader(
                os.path.join(data_dir, "train"), BATCH, train=True,
                img_size=224, num_workers=16), 4)
            rates.setdefault(path, []).append(float(rate))
            loader_ms.setdefault(path, []).append(round(ms, 1))
            what = ("lossy WebPs (the same photos at quality 80)"
                    if path == "webp" else "JPEGs")
            print(f"joint_train --dataset imagenet, run {i}, "
                  f"{'WebP folder' if path == 'webp' else path + ' path'} "
                  f"(DeiT-Small, 224 px, batch {BATCH}, {IMG_STEPS} steps, "
                  f"{IMG_CLASSES} class folders of fixture symlinks): "
                  f"stage-1 epoch {rate} img/s ({secs} s) on the photo-sized "
                  f"{what}; the folder loader's host ms a batch {ms:.1f}; "
                  f"eval accuracy "
                  f"{accs} % [{card}]", flush=True)
        native_loader.available = real
        print("joint_train epochs in turns (run 0 holds the process's "
              "start-up): " + ", ".join(
                  f"{p} {v} img/s" for p, v in rates.items())
              + f" [{card}]", flush=True)
        print(f"WebP folder against the JPEG folder, the same run: epoch "
              f"{rates['webp'][0]} img/s against the JPEG PIL path's "
              f"{rates['pil']} and native path's {rates['native']}; the "
              f"folder loader's host ms a batch {loader_ms['webp'][0]} "
              f"against {loader_ms['pil']} and {loader_ms['native']} "
              f"[{card}]", flush=True)
    elif part == "baseline":
        from uvc_tpu_torch.cli import baseline_train
        from uvc_tpu_torch.data.augment import make_train_augment
        t0 = time.perf_counter()
        out, counts = _run_cli(baseline_train.main, common + [
            "--dataset", "imagenet", "--data_dir", folder, "--epochs", "1",
            "--aa", "rand-m9-mstd0.5-inc1", "--train-interpolation",
            "bicubic", "--name", "baseline"])
        wall = time.perf_counter() - t0
        want = _want(counts, train=(BASE_TRAIN_STEP, IMG_STEPS),
                     eval=(BASE_EVAL_BATCH, IMG_VAL // BATCH))
        print(f"launches baseline_train (RandAugment) {counts} (expected "
              f"{want}); {wall:.1f} s wall")
        check(counts == want, "baseline_train on images launch counts")
        add(counts)
        (ep, secs, rate), = _epoch_lines(
            out, r"\[Baseline Epoch (\d+)\] ([\d.]+)s \(([\d.]+) img/s\)",
            "baseline_train")
        accs = _accuracies(out, r"\[Baseline Eval\|Epoch \d+\] acc "
                           r"([\d.naninf]+)%", "baseline_train")
        aug = make_train_augment("rand-m9-mstd0.5-inc1", 0.0, "bicubic")
        loader = FolderLoader(os.path.join(folder, "train"), BATCH,
                              train=True, img_size=224, num_workers=16,
                              interpolation="bicubic")
        plain = _loader_ms(loader, 4)
        loader.aug = aug
        with_aug = _loader_ms(loader, 4)
        crops, _ = next(iter(loader))
        t1 = time.perf_counter()
        for i, img in enumerate(crops):
            aug(img, np.random.default_rng(i))
        one = 1e3 * (time.perf_counter() - t1)
        print(f"baseline_train --aa rand-m9-mstd0.5-inc1 "
              f"--train-interpolation bicubic (DeiT-Small, batch {BATCH}, "
              f"{IMG_STEPS} steps): epoch {rate} img/s ({secs} s); eval "
              f"accuracy {accs} %; the loader's host ms a batch "
              f"{with_aug:.1f} with RandAugment, {plain:.1f} without; "
              f"RandAugment alone {one:.1f} ms for {BATCH} crops on one "
              f"thread [{card}]", flush=True)
    elif part == "cifar":
        from uvc_tpu_torch.cli import joint_train
        t0 = time.perf_counter()
        out, counts = _run_cli(joint_train.main, common + [
            "--dataset", "cifar10", "--data_dir", os.path.join(tmp, "cifar"),
            "--distillation-type", "soft", "--num_epochs", "1",
            "--warmup_epochs", "1", "--post_num_epochs", "0",
            "--name", "cifar"])
        wall = time.perf_counter() - t0
        want = _want(counts, train=(PIPE_TRAIN_STEP, IMG_CIFAR_STEPS),
                     eval=(PIPE_EVAL_BATCH, 2 * IMG_VAL // BATCH))
        print(f"launches joint_train --dataset cifar10 {counts} (expected "
              f"{want}); {wall:.1f} s wall")
        check(counts == want, "joint_train on CIFAR launch counts")
        add(counts)
        (ep, secs, rate), = _epoch_lines(
            out, r"\[Epoch (\d+)\] ([\d.]+)s \(([\d.]+) img/s\)",
            "joint_train cifar")
        accs = _accuracies(out, r"Validation @ step \d+: loss "
                           r"[\d.naninf]+ acc ([\d.naninf]+)%", "cifar")
        from uvc_tpu_torch.data.pipeline import cifar_arrays
        x, y = cifar_arrays(os.path.join(tmp, "cifar"), "cifar10")
        ms = _loader_ms(ArrayLoader(x, y, BATCH, train=True, img_size=224),
                        2)
        print(f"joint_train --dataset cifar10 --img_size 224 (CIFAR's "
              f"pickles, 32 -> 224 px through Pillow's bilinear resample, "
              f"{IMG_CIFAR_STEPS} steps of {BATCH}): epoch {rate} img/s; the "
              f"array loader's host ms a batch {ms:.1f}; eval accuracy "
              f"{accs} % [{card}]", flush=True)
    elif part == "bench":
        from uvc_tpu_torch.scripts import data_bench
        rep = data_bench.main(["--batches", "2", "--repeats", "1",
                               "--fixtures", IMG_FIXTURES])
        print(f"data_bench (batch {rep['batch']}, {rep['workers']} workers, "
              f"{rep['cores']} cores, {rep['interpolation']}): img/s train "
              f"{rep['train']}, train_randaug {rep['train_randaug']}, eval "
              f"{rep['eval']} [{card}]", flush=True)
    else:
        raise ValueError(part)
    print("PHASE19 " + json.dumps({"counts": counts_all}), flush=True)


def images_phase(card):
    """Phase 19: the real-image input path on the card's machine, each part
    in a child process that first makes PIL unimportable
    (``sys.modules["PIL"] = None``): (a) the committed fixtures' decodes,
    the PIL-path and native-path crops and RandAugment's ops held to the
    digests of PIL and the JAX package (WebP, 16-bit and Adam7 PNG and
    palette, 16-bit and RLE BMP among them); (b) ``joint_train --dataset
    imagenet`` on a folder of fixture symlinks (4 classes; train the
    photo-sized JPEGs, val every fixture) at 224 px,
    batch 64, one stage-1 epoch of 12 steps and its validation, in turns
    on the native path and on the PIL path (native, PIL, WebP, PIL,
    native), the third run on a folder of the photo-sized lossy WebPs,
    launches exact; (c) ``baseline_train``
    with RandAugment (12 steps, A7 12 forward and 12 backward a step); (d)
    ``--dataset cifar10 --img_size 224`` on CIFAR-layout pickles written
    here (4 steps); (e) ``scripts/data_bench.py`` once, at 2 batches of
    256 on the photo-sized JPEGs.  Returns the launches."""
    import tempfile

    t_all = time.perf_counter()
    total = {}
    with tempfile.TemporaryDirectory(prefix="uvc_images_") as tmp:
        for sub, prefix, what in (("folder", "imagenet_", "JPEGs"),
                                  ("folder_webp", "webp_photo_",
                                   "lossy WebPs")):
            photos = _image_folder(os.path.join(tmp, sub),
                                   IMG_STEPS * BATCH, IMG_VAL, prefix)
            sizes = [os.path.getsize(os.path.join(IMG_FIXTURES, f))
                     for f in photos]
            print(f"phase 19 train folder {sub}: {IMG_STEPS * BATCH} "
                  f"symlinks to {len(photos)} photo-sized {what} "
                  f"({', '.join(photos)}; "
                  f"{sum(sizes) / len(sizes) / 1e3:.1f} KB a file on "
                  "average)", flush=True)
        _cifar_pickles(os.path.join(tmp, "cifar"), IMG_CIFAR_STEPS * BATCH,
                       IMG_VAL)
        for part in ("check", "joint", "baseline", "cifar", "bench"):
            t0 = time.perf_counter()
            code = NO_PIL + (f"import chip_smoke\n"
                             f"chip_smoke.images_part({part!r}, {tmp!r})\n")
            proc = subprocess.run([sys.executable, "-c", code],
                                  cwd=REPO_ROOT, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  timeout=600)
            lines = proc.stdout.splitlines()
            for line in lines:
                if not line.startswith("PHASE19 "):
                    print(f"  | {line}")
            check(proc.returncode == 0, f"phase 19 ({part}) failed with "
                  f"exit {proc.returncode}")
            res = json.loads([x for x in lines
                              if x.startswith("PHASE19 ")][-1][8:])
            for k, v in res["counts"].items():
                total[k] = total.get(k, 0) + v
            print(f"phase 19 ({part}): {time.perf_counter() - t0:.1f} s in "
                  f"a process without PIL", flush=True)
    print(f"phase 19: {time.perf_counter() - t_all:.1f} s; launches "
          f"{total} [{card}]", flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 20: --config and --enable_writer 1 without yaml or tensorboard
# ---------------------------------------------------------------------------

# the first lines of the phase-20 child: yaml, tensorboard and protobuf
# then cannot be imported
NO_CONFIG_DEPS = (
    'import sys\n'
    'for _m in ("yaml", "tensorboard", "torch.utils.tensorboard",\n'
    '           "google.protobuf"):\n'
    '    sys.modules[_m] = None\n')
CONFIG_BASE_STEPS = 4
# timm's args.yaml for joint_train, as text: a block sequence, null, a
# bool, a quoted numeric string (budget has no type: it stays a string,
# as from the command line), 1.0e-04 (a float) and 1e-4 (a string that
# the flag's type makes a float); the command line's --train_batch_size
# beats the file's
CONFIG_JOINT = f"""\
# args.yaml, as timm writes it (yaml.safe_dump(vars(args),
# default_flow_style=False)), cut to the flags this run sets
model_type: {PIPE_MODEL}
dataset: procedural
img_size: 224
train_batch_size: 32
eval_batch_size: {BATCH}
synthetic_steps: {PIPE_STEPS}
num_epochs: 2
warmup_epochs: 1
post_num_epochs: 0
distillation_type: soft
teacher_path: null
model_path: null
fp16: false
budget: '0.5'
learning_rate: 1.0e-04
ylr: 1e-4
cutmix_minmax:
- 0.2
- 0.8
log_interval: 4
dp: 1
name: config_run
"""
CONFIG_JOINT_SEEN = (
    f"model_type='{PIPE_MODEL}'", "dataset='procedural'",
    f"train_batch_size={BATCH}", f"synthetic_steps={PIPE_STEPS}",
    "num_epochs=2", "post_num_epochs=0", "distillation_type='soft'",
    "teacher_path=None", "fp16=False", "budget='0.5'",
    "learning_rate=0.0001", "ylr=0.0001", "cutmix_minmax=[0.2, 0.8]",
    "log_interval=4", "enable_writer=1", "name='config_run'")
CONFIG_BASELINE = f"""\
model_type: {PIPE_MODEL}
dataset: procedural
train_batch_size: {BATCH}
eval_batch_size: {BATCH}
synthetic_steps: {CONFIG_BASE_STEPS}
epochs: 1
dp: 1
name: config_baseline
"""


def config_part(tmp):
    """Phase 20, in a child process whose first lines made yaml,
    tensorboard and protobuf unimportable; prints ``PHASE20 <json>`` with
    its launches and rates."""
    import re

    from uvc_tpu_torch.cli import baseline_train, joint_train

    for m in ("yaml", "tensorboard", "torch.utils.tensorboard",
              "google.protobuf"):
        try:
            __import__(m)
        except ImportError:
            continue
        check(False, f"{m} is importable here")
    sys.path.insert(0, os.path.join(REPO_ROOT, "tests"))
    import event_check

    card = card_line()
    runs = os.path.join(tmp, "runs")
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    def event_file(name):
        d = os.path.join(runs, name, "tb")
        files = os.listdir(d) if os.path.isdir(d) else []
        check(len(files) == 1, f"{name}: event files {files}")
        return os.path.join(d, files[0])

    # -- joint_train -c args.yaml --enable_writer 1 ------------------------
    cfg = os.path.join(tmp, "args.yaml")
    with open(cfg, "w") as f:
        f.write(CONFIG_JOINT)
    t0 = time.perf_counter()
    out, counts = _run_cli(joint_train.main, [
        "-c", cfg, "--train_batch_size", str(BATCH), "--enable_writer", "1",
        "--output_dir", runs])
    wall = time.perf_counter() - t0
    # 2 stage-1 epochs (1 warmup) and their validations, stage 2's final
    want = _want(counts, train=(PIPE_TRAIN_STEP, 2 * PIPE_STEPS),
                 eval=(PIPE_EVAL_BATCH, 3 * PIPE_EVAL_BATCHES))
    print(f"launches joint_train -c args.yaml {counts} (expected {want}); "
          f"{wall:.1f} s wall")
    check(counts == want, "joint_train -c launch counts")
    add(counts)
    found = re.search(r"Training parameters Namespace\((.*)\)", out)
    check(found is not None, "joint_train printed no parameters")
    missing = [s for s in CONFIG_JOINT_SEEN if s not in found.group(1)]
    check(not missing, f"the config's values did not take effect: {missing}")
    print(f"the config's values took effect ({len(CONFIG_JOINT_SEEN)} read "
          f"back, --train_batch_size {BATCH} from the command line over the "
          "file's 32)")
    epochs = re.findall(r"\[Epoch (\d+)\] ([\d.]+)s \(([\d.]+) img/s\)",
                        out)
    check(len(epochs) == 2, f"epoch lines {epochs}")
    path = event_file("config_run")
    try:
        n = event_check.match_jsonl(
            path, os.path.join(runs, "config_run", "metrics.jsonl"))
    except ValueError as e:
        check(False, f"joint_train's event file: {e}")
    n_rec = len(event_check.read_events(path))
    print(f"event file {os.path.basename(path)}: {n_rec} records, both CRCs "
          f"of each held; {n} float scalars of metrics.jsonl in order at "
          f"their steps, equal to their float32 [{card}]")
    rates = {ep: float(rate) for ep, _, rate in epochs}
    for ep, secs, rate in epochs:
        print(f"  joint_train -c epoch {ep}: {rate} img/s ({secs} s for "
              f"{PIPE_STEPS} steps of {BATCH}"
              f"{'; holds the process start-up' if ep == '1' else ''}) "
              f"[{card}]")

    # -- baseline_train -c ... --enable_writer 1 ---------------------------
    cfg = os.path.join(tmp, "baseline.yaml")
    with open(cfg, "w") as f:
        f.write(CONFIG_BASELINE)
    t0 = time.perf_counter()
    out, counts = _run_cli(baseline_train.main, [
        "-c", cfg, "--enable_writer", "1", "--output_dir", runs])
    wall = time.perf_counter() - t0
    want = _want(counts, train=(BASE_TRAIN_STEP, CONFIG_BASE_STEPS),
                 eval=(BASE_EVAL_BATCH, PIPE_EVAL_BATCHES))
    print(f"launches baseline_train -c {counts} (expected {want}); "
          f"{wall:.1f} s wall")
    check(counts == want, "baseline_train -c launch counts")
    add(counts)
    events = event_check.read_events(event_file("config_baseline"))
    check(len(events) == 1 and events[0].get("file_version")
          == "brain.Event:2", f"baseline_train's event file: {events}")
    print("baseline_train's event file: the header record alone (the "
          "baseline driver logs no scalars), its CRCs held")
    print("PHASE20 " + json.dumps({"counts": total, "rates": rates,
                                   "scalars": n}), flush=True)


def config_phase(card):
    """Phase 20: ``--config`` and ``--enable_writer 1`` on the card's
    machine, in a child process that first makes yaml, tensorboard and
    protobuf unimportable: ``joint_train -c args.yaml --enable_writer 1``
    (a timm-style file; DeiT-Small at 224 px, batch 64, procedural data,
    one warmup and one stage-1 epoch of 12 steps, the validations;
    launches exact; the file's values read back from the printed
    parameters, the command line beating the file; every float scalar of
    metrics.jsonl read back from the event file, both CRCs of every
    record held), then ``baseline_train -c ... --enable_writer 1`` (4
    steps, A7 12 + 12 a step; its event file the header alone).  Returns
    the launches."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="uvc_config_") as tmp:
        code = NO_CONFIG_DEPS + (f"import chip_smoke\n"
                                 f"chip_smoke.config_part({tmp!r})\n")
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              timeout=600)
        lines = proc.stdout.splitlines()
        for line in lines:
            if not line.startswith("PHASE20 "):
                print(f"  | {line}")
        check(proc.returncode == 0, f"phase 20 failed with exit "
              f"{proc.returncode}")
        res = json.loads([x for x in lines if x.startswith("PHASE20 ")][-1]
                         [8:])
    secs = time.perf_counter() - t0
    phase12 = ", ".join(f"epoch {ep} {r}" for ep, r in sorted(
        PIPE_RATES.items())) or "not run"
    print(f"phase 20: {secs:.1f} s in a process without yaml, tensorboard "
          f"or protobuf; joint_train -c img/s " + ", ".join(
              f"epoch {ep} {r}" for ep, r in sorted(res["rates"].items()))
          + f" beside phase 12's {phase12}; {res['scalars']} scalars read "
          f"back; launches {res['counts']} [{card}]", flush=True)
    return res["counts"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 3 (the kernels) and phase 7's "
                    "kernel rows")
    ap.add_argument("--refused-ok", action="store_true",
                    help="print a phase-3 row (or launch breakdown) whose "
                    "kernel refuses the shape instead of failing: for "
                    "running this script in a checkout whose kernels "
                    "predate the shape")
    ap.add_argument("--backbones-only", action="store_true",
                    help="phase 3 at R50-ViT-B/16's block shape ('vit_b') and "
                    "phase 14 (R50-ViT-B/16, CaiT-S24-224, post_train from a "
                    "torch checkpoint), then the card line")
    ap.add_argument("--ddp-only", action="store_true",
                    help="phase 15 alone (data parallelism: two ranks over "
                    "gloo on the card, joint_train under NCCL at world size "
                    "1), then the card line")
    ap.add_argument("--export-only", action="store_true",
                    help="phase 16 alone (the serving export: DeiT-Small "
                    "and T2T-ViT-14 served from torch.export artifacts in a "
                    "fresh interpreter), then the card line")
    ap.add_argument("--tp-only", action="store_true",
                    help="phase 17 alone (tensor parallelism: four ranks "
                    "at 2 dp x 2 mp over gloo on the card), then the card "
                    "line")
    ap.add_argument("--accuracy-only", action="store_true",
                    help="phase 18 alone (the evidence harnesses at a cut "
                    "horizon on DeiT-Tiny), then the card line")
    ap.add_argument("--images-only", action="store_true",
                    help="phase 19 alone (the real-image input path without "
                    "PIL: the fixtures' digests, joint_train and "
                    "baseline_train on an image folder, CIFAR at 224 px, "
                    "data_bench), then the card line")
    ap.add_argument("--config-only", action="store_true",
                    help="phase 20 alone (--config and --enable_writer 1 "
                    "through joint_train and baseline_train in a process "
                    "without yaml or tensorboard), then the card line")
    ap.add_argument("--digests", action="store_true",
                    help="phase 3 at the shapes the parent commit's kernels "
                    "take and phase 7's performer kernels, digests only (no "
                    "timing), then stop; run it in a checkout of the parent "
                    "and here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from uvc_tpu_torch.configs import get_config
    from uvc_tpu_torch.ops import _cuda

    # the wall seconds of the run, where each phase begins
    clock = time.perf_counter()

    def elapsed(phase):
        print(f"[{phase} starts at {time.perf_counter() - clock:.1f} s]",
              flush=True)

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} x{torch.cuda.device_count()} [{card}] "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from uvc_tpu_torch.data import imagelib
    t0 = time.perf_counter()
    lib = imagelib.build()
    print(f"build: the host image library (c++) {time.perf_counter() - t0:.1f}"
          f" s -> {lib}")
    secs = _cuda.build()
    print(f"build: {secs:.1f} s -> {_cuda.build_dir()}")
    for name, log in _cuda.build_logs().items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    eps = get_config("deit_small_patch16_224").layer_norm_eps
    if args.ddp_only:
        elapsed("phase 15")
        ddp_ranks_phase(card)
        ddp_nccl_phase(card)
        print(card_line())
        return 0
    if args.export_only:
        elapsed("phase 16")
        export_phase(card)
        print(card_line())
        return 0
    if args.tp_only:
        elapsed("phase 17")
        tp_phase(card)
        print(card_line())
        return 0
    if args.accuracy_only:
        elapsed("phase 18")
        accuracy_phase(card)
        print(card_line())
        return 0
    if args.images_only:
        elapsed("phase 19")
        images_phase(card)
        print(card_line())
        return 0
    if args.config_only:
        elapsed("phase 20")
        config_phase(card)
        print(card_line())
        return 0
    elapsed("phase 3")
    if args.backbones_only:
        kernel_phase(eps, only=("vit_b",))
        backward_kernel_phase(eps, only=("vit_b",))
        r50_phase(card)
        cait_phase(card)
        torch_ckpt_phase(card)
        print(card_line())
        return 0
    res = kernel_phase(eps, args.digests, args.refused_ok)
    if not args.digests:
        forward_breakdowns(eps, card)
    res.update(backward_kernel_phase(eps, args.digests, args.refused_ok))
    if args.kernels_only:
        # not in the whole run: profiling A7's backward at "vit_h" here
        # left phase 9's timed window 8-12% slower on the H100
        sublayer_bwd_breakdown(eps, card, args.refused_ok)
    res.update(core_kernel_phase(args.digests))
    if args.kernels_only:
        core_bwd_breakdown(card)
        res.update(performer_kernel_phase(refused_ok=args.refused_ok))
        performer_breakdown(card, args.refused_ok)
    if args.digests:
        performer_kernel_phase(digests_only=True)
    if args.kernels_only or args.digests:
        print(card_line())
        return 0
    elapsed("phase 4")
    launches = serving_phase(card)
    elapsed("phase 5")
    train_counts, off_counts, part_counts = training_phase(card)
    # DeiT-Small's 12 blocks run A7 forward and backward
    base_counts, _, _ = baseline_phase(
        card, dict(layer_attention=12, layer_attention_bwd=12))
    elapsed("phase 7")
    res.update(performer_kernel_phase())
    t2t_train_counts = t2t_training_phase(card)
    t2t_serve_counts = t2t_serving_phase(card)
    elapsed("phase 8")
    ablation_counts = ablation_phase(card)
    elapsed("phase 9")
    vit_h_counts = vit_h_phase(card)
    # phase 10: the resnext structure ablation, 32 heads of 12 (K1, A2)
    resnext_counts = t2t_training_phase(
        card, "t2t_vit_14_resnext", "T2T-ViT-14-resnext", seed=50, warm=1,
        timed=5)
    # phase 11: stage 2 and compact stage 2 (DeiT-Small, T2T-ViT-14)
    elapsed("phase 11")
    stage2_counts, compact_counts = stage2_phase(card)
    t2t_stage2_counts = t2t_stage2_phase(card)
    # phase 12: the two-stage pipeline through its CLIs (DeiT-Small)
    elapsed("phase 12")
    pipeline_counts = pipeline_phase(card)
    # phase 13: the baseline-pruning suite through its CLIs (DeiT-Small)
    elapsed("phase 13")
    suite_counts = baseline_suite_phase(card)
    # phase 14: R50-ViT-B/16 (stage 1, serving, stage 2), CaiT-S24-224
    # (the baseline fine-tune) and post_train from a torch checkpoint
    elapsed("phase 14")
    r50_counts = r50_phase(card)
    cait_counts = cait_phase(card)
    torch_ckpt_counts = torch_ckpt_phase(card)
    # phase 15: data parallelism (two ranks over gloo on the card, then
    # joint_train under NCCL at world size 1)
    elapsed("phase 15")
    ddp_counts = ddp_ranks_phase(card)
    nccl_counts = ddp_nccl_phase(card)
    # phase 16: the serving export (DeiT-Small, T2T-ViT-14)
    elapsed("phase 16")
    export_counts = export_phase(card)
    # phase 17: tensor parallelism (four ranks at 2 dp x 2 mp over gloo)
    elapsed("phase 17")
    tp_counts = tp_phase(card)
    # phase 18: the evidence harnesses (DeiT-Tiny at 64 px)
    elapsed("phase 18")
    accuracy_counts = accuracy_phase(card)
    # phase 19: the real-image input path without PIL (DeiT-Small)
    elapsed("phase 19")
    image_counts = images_phase(card)
    # phase 20: --config and --enable_writer 1 without yaml or tensorboard
    elapsed("phase 20")
    config_counts = config_phase(card)
    elapsed("the summary")
    # launches on the main paths: serving and eval, the timed stage-1
    # window, the gating-off steps (the only path of A6), the part-gated
    # steps and the timed baseline window (the paths of A7), the timed
    # T2T-ViT-14 stage-1 window and its serving (A10 / A11), the ablations'
    # fine-tune and the SE eval (A9), the timed ViT-H/14 window (A2 and A4
    # at dm 1280; A8 only on the composed route, past it) and the resnext
    # window, phase 11's stage-2 windows (A6 at a compact layer's
    # padded width, A2 below dm), phase 12's CLI runs and served export,
    # and phase 13's (the scorers' passes at batch 1 and 128, the baseline
    # runs, the gradient report), phase 14's (R50-ViT-B/16's windows,
    # CaiT's, which launch none, and post_train from the .pth.tar) and
    # phase 15's (both ranks' steps, the single-process references, the
    # NCCL joint_train), phase 16's (the artifacts' and apply_compact's
    # serving windows and references in this process), phase 17's (the
    # four ranks' steps and the single-process references), phase 18's
    # (the harnesses' trainings, evaluations and serving), phase 19's
    # (joint_train, baseline_train and the CIFAR run on real images) and
    # phase 20's (joint_train and baseline_train from config files)
    for counts in (train_counts, off_counts, part_counts, base_counts,
                   t2t_train_counts, t2t_serve_counts, ablation_counts,
                   vit_h_counts, resnext_counts, stage2_counts,
                   compact_counts, t2t_stage2_counts, pipeline_counts,
                   suite_counts, r50_counts, cait_counts,
                   torch_ckpt_counts, ddp_counts, nccl_counts,
                   export_counts, tp_counts, accuracy_counts,
                   image_counts, config_counts):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    # each kernel's headline shape is that of the path that launches it
    # most: K1 runs in both (12 blocks at "eval", 10 at "compact")
    meta = {
        "layer_attention_ln": ("uvc_tpu_torch/csrc/attention.cu",
                               "uvc_tpu/ops/attention.py:741", "eval"),
        "mlp_ln": ("uvc_tpu_torch/csrc/mlp.cu", "uvc_tpu/ops/mlp.py:71",
                   "compact"),
        "mlp_ln_blend": ("uvc_tpu_torch/csrc/mlp.cu",
                         "uvc_tpu/ops/mlp.py:147", "eval"),
        "layer_attention_ln_bwd": ("uvc_tpu_torch/csrc/attention.cu",
                                   "uvc_tpu/ops/attention.py:790", "train"),
        "mlp_ln_blend_bwd": ("uvc_tpu_torch/csrc/mlp.cu",
                             "uvc_tpu/ops/mlp.py:179", "train"),
        "mlp_ln_bwd": ("uvc_tpu_torch/csrc/mlp.cu", "uvc_tpu/ops/mlp.py:90",
                       "train"),
        "layer_attention": ("uvc_tpu_torch/csrc/attention.cu",
                            "uvc_tpu/ops/attention.py:349", "dense"),
        "layer_attention_bwd": ("uvc_tpu_torch/csrc/attention.cu",
                                "uvc_tpu/ops/attention.py:446", "train"),
        "performer": ("uvc_tpu_torch/csrc/performer.cu",
                      "uvc_tpu/ops/performer.py:603", "t2t_stage1"),
        "performer_bwd": ("uvc_tpu_torch/csrc/performer.cu",
                          "uvc_tpu/ops/performer.py:670", "t2t_stage1"),
        "attention": ("uvc_tpu_torch/csrc/attention_core.cu",
                      "uvc_tpu/ops/attention.py:100", "se"),
        "attention_bwd": ("uvc_tpu_torch/csrc/attention_core.cu",
                          "uvc_tpu/ops/attention.py:124", "se"),
        "attention_bwd_ctx": ("uvc_tpu_torch/csrc/attention_core.cu",
                              "uvc_tpu/ops/attention.py:161", "vit_h"),
    }
    # A11, the split form of the same function, ports into the same kernels
    also = {"performer": ["uvc_tpu/ops/performer.py:153",
                          "uvc_tpu/ops/performer.py:175"],
            "performer_bwd": ["uvc_tpu/ops/performer.py:214",
                              "uvc_tpu/ops/performer.py:330"]}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = []
    for name, (source, replaces, shape) in meta.items():
        r = res[(name, shape)]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            **{k: r[k] for k in keys}, "shape": shape,
            **({"also_replaces": also[name]} if name in also else {}),
            **({"library": r["library"]} if "library" in r else {}),
            "other_shapes": {s: {k: o[k] for k in keys}
                             for (n, s), o in res.items()
                             if n == name and s != shape}})
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
