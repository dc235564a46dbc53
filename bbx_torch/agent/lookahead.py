"""One-ply value lookahead: pick actions by simulating them.

Counterpart of `bbx/agent/lookahead.py`.  Every candidate action of every
lane is played on a tiled copy of the fleet in one batched `step` (place,
clear, score, regen; auto-reset off), and the action taken is
``argmax_a [ r(s, a) + gamma * V(s') * (1 - done) ]`` with the network's
value head.  On the card the simulated step is K6, K7, K6 over N x width
lanes, and V(s') is the network's value alone (`value`): for the
AfterstateNetwork that is its value head, so the simulated afterstates are
never expanded (no K4, no K8).

This is not the checkpoint's raw policy: results from it are search
results (``policy+1-ply search``), never raw-policy numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..engine.state import EnvState
from ..engine.step import RewardConfig, observe, step
from ..engine.tables import NUM_ACTIONS
from ..utils.profiling import span


def tile_state(state: EnvState, width: int, generator: torch.Generator) -> EnvState:
    """Each lane repeated `width` times in a row ([N * width] lanes), drawing
    from `generator`: the simulated fleet's regen draws never touch the real
    fleet's generator, and `regen_draw` hashes the tiled lane index, so each
    simulated lane draws its own pieces.  A shard of a fleet tiles into the
    same shard of the tiled fleet (lane i, candidate j of a fleet whose first
    lane is `lane_base` is tiled lane (lane_base + i) * width + j), so each
    rank's simulated lanes draw what the whole fleet's tiling draws there."""
    tiled = EnvState(**{f.name: getattr(state, f.name).repeat_interleave(width, dim=0)
                        for f in dataclasses.fields(EnvState) if f.name != "rng"},
                     rng=generator)
    return tiled.sharded(state.lane_base * width, state.global_lanes * width)


def search_width(topk: int) -> int:
    """Candidates the search simulates a lane: `topk` if 0 < topk < 192,
    else all 192 actions."""
    return topk if 0 < topk < NUM_ACTIONS else NUM_ACTIONS


def lookahead_actions(network: torch.nn.Module, state: EnvState,
                      generator: torch.Generator,
                      reward_config: Optional[RewardConfig] = None,
                      gamma: float = 0.99, topk: int = 0,
                      policy_logits: Optional[torch.Tensor] = None,
                      return_q: bool = False,
                      obs: Optional[Dict[str, torch.Tensor]] = None):
    """Pick actions by one simulated step and a value bootstrap.

    Args:
      network: the policy/value network; it runs in eval mode here (running
        BatchNorm statistics, no dropout), as bbx's ``train=False``, and
        its earlier mode is restored afterwards.
      state: [N] EnvState.
      generator: draws the simulated fleet's regen seed (on the state's
        device): a one-sample estimate of E[V(s')] over the piece draws.
      reward_config: the shaped reward r(s, a).
      gamma: the bootstrap's discount.
      topk: if 0 < topk < 192, simulate only the top-k actions by masked
        policy logit (ties in the lower action first, as ``lax.top_k``);
        else all 192.
      policy_logits: optional masked logits [N, 192] for the top-k choice
        (a rollout has them); computed by the network when needed and None.
      return_q: also return the candidates and their Q estimates.
      obs: optional ``observe(state)``, which a caller stepping the fleet
        already holds; computed here when None.
    Returns:
      [N] int32 actions, the first maximum of Q over the valid candidates
      (action 0 on a lane with no valid candidate at full width; the first
      candidate at top-k); with `return_q`, (actions, cand [N, width]
      int32, q [N, width] float32 with -inf on invalid candidates).
    """
    rc = reward_config or RewardConfig()
    n, dev = state.num_envs, state.device
    width = search_width(topk)
    was_training = network.training
    network.eval()
    try:
        with torch.no_grad(), span("search.lookahead", lanes=n * width):
            if obs is None:
                obs = observe(state)
            mask = obs["action_mask"]
            if width < NUM_ACTIONS:
                if policy_logits is None:
                    policy_logits, _ = network(obs["board"], obs["pieces"], mask)
                order = torch.sort(policy_logits, dim=1, descending=True, stable=True)
                cand = order.indices[:, :width].to(torch.int32)
                actions = cand.reshape(n * width)
                cand_mask = torch.gather(mask, 1, cand.long())
            else:
                cand = torch.arange(NUM_ACTIONS, dtype=torch.int32,
                                    device=dev).expand(n, NUM_ACTIONS)
                actions = cand.reshape(n * width)
                cand_mask = mask
            out = step(tile_state(state, width, generator), actions, rc,
                       auto_reset=False)
            v2 = network.value(out.obs["board"], out.obs["pieces"])
            q = out.reward + gamma * v2.to(torch.float32) * (
                1.0 - out.done.to(torch.float32))
            q = torch.where(cand_mask, q.reshape(n, width), -torch.inf)
            # The first maximum; 0 on a row with no valid candidate.
            best = torch.where(cand_mask.any(dim=1), q.argmax(dim=1), 0)
            action = torch.gather(cand, 1, best[:, None])[:, 0]
    finally:
        network.train(was_training)
    if return_q:
        return action, cand.contiguous(), q
    return action
