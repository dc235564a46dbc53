"""The plain reference against the program's plain (CPU) path at a small
size: the game bit for bit, the networks in float32."""
import copy
import json
import os

import pytest
import torch

from perfbench import harness, weights
from perfbench.reference import engine as E
from perfbench.reference import networks as N


def test_game_bit_for_bit_over_random_play():
    from bbx_torch.engine.state import make_generator, reset
    from bbx_torch.engine.step import RewardConfig, observe, step

    n = 32
    state = reset(n, make_generator(5, "cpu"), "cpu")
    gen = torch.Generator().manual_seed(5)
    game = E.reset(n, gen, "cpu")
    obs, ref_obs = observe(state), E.observe(game)
    pick = torch.Generator().manual_seed(1)
    for t in range(60):
        assert torch.equal(obs["action_mask"], ref_obs["action_mask"])
        assert torch.equal(obs["pieces"], ref_obs["pieces"])
        u = torch.rand(obs["action_mask"].shape, generator=pick)
        action = torch.where(obs["action_mask"], u, -1.0).argmax(1).int()
        if t % 7 == 0:
            action[0] = 5  # now and then an invalid move
        out = step(state, action, RewardConfig(), auto_reset=True)
        game, ref_obs, reward, done, info = E.step(game, action, E.Rewards(), gen, True)
        assert torch.equal(out.reward, reward) and torch.equal(out.done, done)
        assert torch.equal(out.state.board.reshape(n, 64).bool(), game.board)
        assert torch.equal(out.state.piece_ids, game.ids)
        assert torch.equal(out.state.score, game.score)
        assert torch.equal(out.info["final_length"], info["final_length"])
        state, obs = out.state, out.obs


def _config(name):
    with open(os.path.join(harness.ROOT, "perfbench", "configs", name + ".json")) as f:
        net = json.load(f)["network"]
    return dict(net, compute_dtype="float32")


def _observations(n, seed):
    from bbx_torch.engine.state import make_generator, reset
    from bbx_torch.engine.step import RewardConfig, observe, step

    state = reset(n, make_generator(seed, "cpu"), "cpu")
    obs = observe(state)
    for _ in range(5):
        action = torch.where(obs["action_mask"], torch.rand(obs["action_mask"].shape),
                             -1.0).argmax(1).int()
        out = step(state, action, RewardConfig())
        state, obs = out.state, out.obs
    return obs


@pytest.mark.parametrize("name", ["run9", "run8"])
@pytest.mark.parametrize("train", [False, True])
def test_networks_against_the_program(name, train):
    from bbx_torch.models import network_from_config

    net = network_from_config(_config(name), generator=torch.Generator().manual_seed(0))
    w = weights.draw(net, 3)
    buffers = {k: v.clone() for k, v in net.named_buffers()}
    obs = _observations(6, 9)
    kind = "afterstate" if name == "run9" else "cnn"
    ref = N.Net(kind, w, buffers, torch.Generator().manual_seed(4), N.Precision())
    net.train(train)
    with torch.no_grad():
        logits, value = net(obs["board"], obs["pieces"], obs["action_mask"],
                            generator=torch.Generator().manual_seed(4))
        want_logits, want_value = ref.forward(obs["board"], obs["pieces"],
                                              obs["action_mask"], train)
    valid = obs["action_mask"]
    assert torch.allclose(logits[valid], want_logits[valid], atol=1e-4, rtol=1e-4)
    assert torch.allclose(value, want_value, atol=1e-4, rtol=1e-4)
    if kind == "cnn" and train:
        for k, v in net.named_buffers():
            assert torch.allclose(v, ref.state.stats[k], atol=1e-5, rtol=1e-5)
