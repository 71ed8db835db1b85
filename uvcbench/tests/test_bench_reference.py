"""The plain reference against the port's CPU path (its plain versions in
bfloat16) at a tiny size, for each entry, through the entries' own
set-up, window and check; and the weights' layout against the port's."""

import pytest
import torch

from uvcbench.tests.tiny import tiny_cell

# the port's CPU path computes in bfloat16, the reference in float32:
# bounds at a tiny size, well below what the float8 control reads there
CPU_TOL = {"draw_gap": 0.0, "loss_gap": 2e-3, "grad_gap": 5e-2, "grad_err": 2e-1, "change_gap": 3e-2,
           "logit_err": 2e-2, "id_gap": 0.05}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_sample(monkeypatch):
    import uvcbench.entries.serve as serve
    monkeypatch.setattr(serve, "SAMPLE_FROM", 4)
    monkeypatch.setattr(serve, "SAMPLES", 2)


@pytest.mark.parametrize("name", ["deit_small.stage1", "t2t_vit_14.stage1",
                                  "deit_small.stage2", "deit_small.serve"])
def test_reference_follows_the_port(name, small_sample):
    c = tiny_cell(name, seed=5)
    unit = c.entry().Unit(c)
    unit.run(lambda: False, units=5)
    for key, got in unit.check().items():
        assert got["value"] <= CPU_TOL[key], (key, got["value"])


@pytest.mark.parametrize("config", ["deit_small", "t2t_vit_14"])
def test_weights_layout_is_the_ports(config):
    from uvc_tpu_torch.models import get_model
    from uvcbench.reference.train import leaves
    from uvcbench.weights import make_params

    c = tiny_cell(f"{config}.stage1")
    cfg = c.program_cfg()
    port = get_model(cfg).init_tree(torch.Generator().manual_seed(0), cfg)
    ours = make_params(c.sizes, torch.Generator().manual_seed(0), "cpu")
    assert [(p, tuple(t.shape)) for p, t in leaves(port)] == \
        [(p, tuple(t.shape)) for p, t in leaves(ours)]


def test_same_seed_same_inputs():
    from uvcbench.reference.train import leaves
    from uvcbench.weights import make_params
    c = tiny_cell("deit_small.stage1")
    a, b = (make_params(c.sizes, torch.Generator().manual_seed(2**31 + 7),
                        "cpu") for _ in range(2))
    assert all(torch.equal(x, y) for (_, x), (_, y) in
               zip(leaves(a), leaves(b)))
