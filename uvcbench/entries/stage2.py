"""Stage 2, the mask-frozen distillation fine-tune of ``post_train``'s
default route: ``train/step.py::build_stage2_step`` with the
configuration's architecture as frozen masks, the block gating frozen to
its hard decision (the skipped blocks' logits set to skip), and the
physical top-k token drop by the frozen scorer at the configuration's
token ratio; each step's mixup from ``draw_stage2_noise``, which the
reference draws again itself from the seed (``reference/draws.py``).

Its model FLOPs: the student's forward three times at the kept tokens and
full widths (the masks multiply and a skipped block is blended away, so
every block's dense products are computed), and the teacher's at every
token.
"""

from __future__ import annotations

from uvcbench import flops
from uvcbench.reference import draws
from uvcbench.reference import train as ref
from uvcbench.training import CHECK_STEPS, TrainUnit
from uvcbench.weights import gate_blocks, make_masks


class Stage2(TrainUnit):

    def build(self, gen) -> None:
        from uvc_tpu_torch.compress.state import MinimaxHParams
        from uvc_tpu_torch.train.state import TrainHParams, create_train_state
        from uvc_tpu_torch.train.step import (build_stage2_step,
                                              draw_stage2_noise)

        w, s, dev = self.cell.workload, self.cell.sizes, self.cell.device
        self.arch = self.cell.config["architecture"]
        self.masks = make_masks(s, self.arch, gen, dev)
        self.params = gate_blocks(self.params, s, self.arch)
        self.hp = MinimaxHParams(**w["minimax"])
        self.thp = TrainHParams(**w["train"])
        self.state = create_train_state(self.params, self.thp)
        self.step_fn = build_stage2_step(self.cfg, self.hp, self.thp)
        self.drawer = draw_stage2_noise

    def draw(self):
        return self.drawer(self.noise_gen, self.cfg, self.thp, self.batch,
                           self.cell.device)

    def call(self, x, y, noise):
        return self.step_fn(self.state, self.teacher, self.masks, x, y,
                            noise)

    def draws(self) -> tuple:
        return ([{"mixup": tuple(n.mixup)} for n in self.noises],
                draws.stage2(self.cell.seed, CHECK_STEPS, self.cell.sizes,
                             self.cell.workload["train"], self.cell.device))

    def init_cstate(self) -> dict:
        return {}

    def reference(self, num):
        w = self.cell.workload
        noises = self.draws()[1]
        batches = [(self.x[i], self.y[i]) for i in range(len(noises))]
        return ref.stage2(self.init, self.teacher, self.masks, batches,
                          noises, self.cell.sizes, w["minimax"], w["train"],
                          num, w["check"]["chunk"])

    @property
    def flops_per_unit(self) -> float:
        s = self.cell.sizes
        blocks = flops.dense_blocks(s)
        student = flops.forward_flops(s, s.tokens(self.hp.patch_ratio),
                                      blocks, scorer=True)
        return self.batch * (3 * student + flops.forward_flops(
            s, s.seq_len, blocks))

    def work(self) -> dict:
        s, b = self.cell.sizes, self.batch
        n = s.tokens(self.hp.patch_ratio)
        dm, h, f, dh = s.embed_dim, s.num_heads, s.mlp_hidden, s.head_size
        # K1 runs in the student at the kept tokens and in the teacher at
        # every token, equally often: the mean of the two
        k1 = [flops.attention_fwd(b, n, dm, h, dh),
              flops.attention_fwd(b, s.seq_len, dm, h, dh)]
        return {"layer_attention_ln": flops.Work(
                    *(sum(v) / 2 for v in zip(*k1))),
                "mlp_ln": flops.mlp_fwd(b, s.seq_len, dm, f),
                "mlp_ln_blend": flops.mlp_fwd(b, n, dm, f, blend=True),
                "mlp_ln_bwd": flops.mlp_bwd(b, n, dm, f),
                "layer_attention_ln_bwd": flops.attention_bwd(b, n, dm, h,
                                                              dh),
                "mlp_ln_blend_bwd": flops.mlp_bwd(b, n, dm, f, blend=True)}


Unit = Stage2
