"""The frozen counts against the program's own: `bbx_torch.models.flops`
and `chip_smoke.py`'s K8 counts, at run9's and run8's widths."""
import json
import os
import sys

import pytest
import torch

from perfbench import flops, harness

ROOT = harness.ROOT


def _net(name):
    with open(os.path.join(ROOT, "perfbench", "configs", name + ".json")) as f:
        return json.load(f)["network"]


def _program_net(net):
    from bbx_torch.models import network_from_config

    return network_from_config(net, generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("name", ["run9", "run8"])
@pytest.mark.parametrize("batch", [1, 512, 2048])
def test_forward_equals_the_programs_count(name, batch):
    from bbx_torch.models.flops import network_flops

    net = _net(name)
    assert flops.forward_flops(net, batch) == network_flops(_program_net(net), batch)


@pytest.mark.parametrize("name", ["run9", "run8"])
def test_gradient_step_leaves_out_only_the_recompute(name):
    from bbx_torch.models.flops import network_flops

    net = _net(name)
    program = _program_net(net)
    recompute = sum(f for f, _, again in program.flop_layers(2048) if again)
    assert network_flops(program, 2048, grad=True) - recompute == flops.grad_step_flops(net, 2048)


def test_iteration_adds_the_last_value_and_leaves_out_the_recompute():
    from bbx_torch.agent.trainer import iteration_flops, ppo_config_from

    with open(os.path.join(ROOT, "perfbench", "configs", "run9.json")) as f:
        config = json.load(f)
    net, cfg = config["network"], ppo_config_from(config)
    program = _program_net(net)
    recompute = sum(f for f, _, again in program.flop_layers(cfg.minibatch_size) if again)
    ours = flops.train_iteration_flops(net, cfg.num_envs, cfg.rollout_steps, cfg.num_epochs,
                                       cfg.minibatch_size)
    assert ours == (iteration_flops(cfg, program) + flops.forward_flops(net, cfg.num_envs)
                    - recompute * cfg.num_epochs * cfg.num_minibatches)


@pytest.mark.parametrize("lanes", [1, 512, 2048])
def test_evaluator_counts_against_the_kernels(lanes):
    from bbx_torch.models import flops as program

    sys.path.insert(0, ROOT)
    import chip_smoke

    widths = flops.evaluator_widths(_net("run9"))
    ops, nbytes = flops.evaluator_forward(lanes, widths, 2)
    assert ops == program.k8_flops(lanes, widths) == chip_smoke.k8_flops(lanes, widths)
    assert nbytes == chip_smoke.k8_bytes(lanes, widths, 2)
    # The backward without the recompute: the kernels' counts take K8's
    # forward again, dW0's context columns once an afterstate (the work
    # needs them once a lane and slot) and one of dense1's two products.
    (c1, c2), h, d = widths
    m = lanes * 192
    ops, nbytes = flops.evaluator_backward(lanes, widths, 2)
    assert ops == (program.k8b_flops(lanes, widths) + program.k8w_flops(lanes, widths)
                   - program.k8_flops(lanes, widths) - flops.dense(m, d, h)
                   + 2 * flops.dense(3 * lanes, d, h) + flops.dense(m, h, 1))
    params = sum(p.numel() for p in _program_net(_net("run9")).evaluator.parameters())
    assert nbytes == chip_smoke.k8_bytes(lanes, widths, 2) + 3 * lanes * d * 2 + 4 * params


def test_bound_is_the_larger_of_operations_and_bytes():
    dev = "NVIDIA H100 80GB HBM3"
    assert flops.bound_s(989.4e12, 0, dev, "bfloat16") == pytest.approx(1.0)
    assert flops.bound_s(0, 3.35e12, dev, "bfloat16") == pytest.approx(1.0)
