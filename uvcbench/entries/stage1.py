"""Stage 1, the joint search: ``train/step.py::build_stage1_step`` (not the
warmup phase), each step's noise from ``draw_stage1_noise`` on a host
generator seeded from ``--seed``, as the CLI draws it, and the workload
file's hyperparameters.

The reference draws the same stream itself from the seed
(``reference/draws.py``); the check holds the program's draws to it.

One step: mixup, the student forward with the Gumbel block gating and
(DeiT) the Gumbel token top-k, the dense teacher forward, soft
distillation, the backward, the clip, AdamW, and the minimax
architecture update.  Its model FLOPs: the student's forward three times
(forward and backward) and the teacher's, at full widths and every token
(the masks multiply: the dense products are the work).
"""

from __future__ import annotations

from uvcbench import flops
from uvcbench.reference import draws
from uvcbench.reference import train as ref
from uvcbench.training import CHECK_STEPS, TrainUnit


class Stage1(TrainUnit):

    def build(self, gen) -> None:
        from uvc_tpu_torch.compress.minimax import init_compression_state
        from uvc_tpu_torch.compress.resource import build_macs_table
        from uvc_tpu_torch.compress.state import MinimaxHParams
        from uvc_tpu_torch.train.state import TrainHParams, create_train_state
        from uvc_tpu_torch.train.step import (build_stage1_step,
                                              draw_stage1_noise)

        w = self.cell.workload
        mm = dict(w["minimax"])
        mm["zlr_schedule"] = tuple(mm["zlr_schedule"])
        self.hp = MinimaxHParams(**mm)
        self.thp = TrainHParams(**w["train"])
        self.tau = float(w["tau"])
        dev = self.cell.device
        self.state = create_train_state(
            self.params, self.thp,
            init_compression_state(self.cfg, self.hp, dev))
        self.cstate0 = {k: getattr(self.state.cstate, k).clone()
                        for k in ("s", "r", "y", "p", "z", "gating_accum")}
        self.step_fn = build_stage1_step(self.cfg, build_macs_table(self.cfg),
                                         self.hp, self.thp, warmup=False)
        self.drawer = draw_stage1_noise

    def draw(self):
        return self.drawer(self.noise_gen, self.cfg, self.hp, self.thp,
                           self.batch, self.cell.device)

    def call(self, x, y, noise):
        return self.step_fn(self.state, self.teacher, x, y, noise, self.tau)

    def draws(self) -> tuple:
        program = [{"mixup": tuple(n.mixup), "gate": n.gate,
                    "token": n.token, "res1": n.res1, "res2": n.res2}
                   for n in self.noises]
        return program, draws.stage1(
            self.cell.seed, CHECK_STEPS, self.cell.sizes, self.batch,
            self.tau, self.cell.workload["train"], self.cell.device)

    def init_cstate(self) -> dict:
        return self.cstate0

    def reference(self, num):
        w = self.cell.workload
        hp = dict(w["minimax"], zlr=w["minimax"]["zlr_schedule"][0])
        noises = self.draws()[1]
        batches = [(self.x[i], self.y[i]) for i in range(len(noises))]
        return ref.stage1(self.init, self.teacher, batches, noises,
                          self.cell.sizes, hp, w["train"], num,
                          w["check"]["chunk"])

    @property
    def flops_per_unit(self) -> float:
        s = self.cell.sizes
        one = flops.forward_flops(s, s.seq_len, flops.dense_blocks(s),
                                  scorer=s.tokens_type == "none")
        return self.batch * 4 * one

    def work(self) -> dict:
        """Each kernel wrapper's work a call, at this cell's shapes."""
        s, b = self.cell.sizes, self.batch
        n, dm, h, f = s.seq_len, s.embed_dim, s.num_heads, s.mlp_hidden
        out = {"layer_attention_ln": flops.attention_fwd(b, n, dm, h,
                                                         s.head_size),
               "mlp_ln": flops.mlp_fwd(b, n, dm, f),
               "mlp_ln_blend": flops.mlp_fwd(b, n, dm, f, blend=True),
               "layer_attention_ln_bwd": flops.attention_bwd(
                   b, n, dm, h, s.head_size),
               "mlp_ln_blend_bwd": flops.mlp_bwd(b, n, dm, f, blend=True)}
        if s.tokens_type != "none":
            out.update(performer_work(s, b))
        return out


def performer_work(s, b: int) -> dict:
    """The performer wrappers' work a call: the mean of the stem's two
    stages (147 needed input features of 3 x 7 x 7 pixels at 56 x 56
    tokens, no input gradient; 576 at 28 x 28), each launched equally
    often."""
    g0, td = s.img_size // 4, s.token_dim
    one = (b, g0 * g0, s.in_chans * 49, td, td // 2)
    two = (b, (g0 // 2) ** 2, td * 9, td, td // 2)
    pairs = {"performer": (flops.performer_fwd(*one),
                           flops.performer_fwd(*two)),
             "performer_bwd": (flops.performer_bwd(*one, dx=False),
                               flops.performer_bwd(*two))}
    return {name: flops.Work(*(sum(v) / 2 for v in zip(*works)))
            for name, works in pairs.items()}


Unit = Stage1
