"""Object-style agent over a network: counterpart of
`bbx/agent/policy_agent.py`.

Gives host-side scripts (play, evaluate, the GUI) bbx's `PolicyAgent`
surface -- `select_action` / `select_actions` / `get_values` / `save` /
`load` / `from_checkpoint` -- while training itself goes through
`bbx_torch.agent.trainer`.  Observations are numpy arrays (or tensors);
the network runs in eval mode, with no gradient, on the agent's device
(the CUDA card unless ``device="cpu"``), and stochastic picks draw from
the agent's `torch.Generator` on that device.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import distributions as D
from ..models.network import BlockBlastNetwork
from .base import BaseAgent


class PolicyAgent(BaseAgent):
    """Inference-side agent: a network (with its weights) and a generator.

    `network` defaults to the flat `BlockBlastNetwork()`, initialised from
    `seed`; `state_dict` (bbx's `variables`), if given, is loaded into it.
    The sampler's generator is seeded ``seed + 1``, as bbx's key.
    """

    def __init__(self, network: Optional[torch.nn.Module] = None,
                 state_dict: Optional[dict] = None, seed: int = 0,
                 device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        if network is None:
            network = BlockBlastNetwork(generator=torch.Generator().manual_seed(seed))
        if state_dict is not None:
            network.load_state_dict(state_dict)
        self.network = network.to(self.device).eval()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed + 1)

    def _obs(self, observations) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One observation or a batch as (board [B,8,8], pieces [B,3,8,8]
        float32, mask [B,192] bool) on the device, in one host copy."""
        board = np.asarray(observations["board"], np.float32)
        lead = board.shape[:-2]
        flat = np.concatenate([
            board.reshape(*lead, 64),
            np.asarray(observations["pieces"], np.float32).reshape(*lead, 192),
            np.asarray(observations["action_mask"]).astype(np.float32).reshape(*lead, 192),
        ], axis=-1).reshape(-1, 448)
        t = torch.from_numpy(flat).to(self.device)
        return (t[:, :64].reshape(-1, 8, 8), t[:, 64:256].reshape(-1, 3, 8, 8),
                t[:, 256:] > 0)

    @torch.no_grad()
    def _act(self, board, pieces, mask, deterministic: bool):
        logits, value = self.network(board, pieces, mask)
        action = D.mode(logits) if deterministic else D.sample(self.generator, logits)
        return (action, D.log_prob(logits, action),
                D.masked_entropy(logits, mask), value)

    def select_action(self, observation: Dict[str, np.ndarray],
                      deterministic: bool = False) -> Tuple[int, Dict[str, Any]]:
        """Act on one observation: (action, {log_prob, entropy, value}),
        brought to the host in one copy."""
        a, logp, ent, v = self._act(*self._obs(observation), deterministic)
        host = torch.stack([a.double(), logp.double(), ent.double(), v.double()],
                           dim=1)[0].tolist()
        return int(host[0]), {"log_prob": host[1], "entropy": host[2], "value": host[3]}

    def select_actions(self, observations: Dict[str, np.ndarray],
                       deterministic: bool = False):
        """Act on a batch: (actions, log-probs, values) as numpy arrays."""
        a, logp, _, v = self._act(*self._obs(observations), deterministic)
        return a.cpu().numpy(), logp.cpu().numpy(), v.cpu().numpy()

    def get_values(self, observations: Dict[str, np.ndarray]) -> np.ndarray:
        """Bootstrap values of a batch, every action allowed."""
        board, pieces, mask = self._obs(observations)
        _, _, _, v = self._act(board, pieces, torch.ones_like(mask), True)
        return v.cpu().numpy()

    def save(self, path: str) -> None:
        """A checkpoint of the weights (`utils/checkpoints.py`, with its
        format marker) at `path`."""
        from ..utils.checkpoints import save_checkpoint

        save_checkpoint(os.path.dirname(path) or ".", os.path.basename(path),
                        {"params": self.network.state_dict()})

    def load(self, path: str) -> None:
        from ..utils.checkpoints import load_checkpoint

        self.network.load_state_dict(load_checkpoint(path)["params"])

    @classmethod
    def from_checkpoint(cls, path: str, config: Optional[dict] = None,
                        device="cuda", seed: int = 0):
        """The network a checkpoint's config names (`config`, else the
        eval CLI's lookup: the ``.config.json`` sidecar or the defaults),
        with the checkpoint's weights."""
        from ..cli.evaluate import config_for_checkpoint
        from ..models import network_from_config
        from ..utils.checkpoints import load_checkpoint

        cfg = config or config_for_checkpoint(path)
        net = network_from_config(cfg.get("network", {}))
        return cls(net, load_checkpoint(path)["params"], seed=seed, device=device)
