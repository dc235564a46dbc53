"""Model layer: PyTorch policy/value networks and masked distributions.

Counterpart of `bbx.models`: the AfterstateNetwork family and the flat
networks (`BlockBlastNetwork`, `ActorCritic`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from . import distributions
from .afterstate import AfterstateNetwork, afterstate_planes
from .network import ActorCritic, BlockBlastNetwork, ResidualBlock, count_parameters

__all__ = ["ActorCritic", "AfterstateNetwork", "BlockBlastNetwork",
           "ResidualBlock", "afterstate_planes", "count_parameters",
           "distributions", "network_from_config"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def network_from_config(net_cfg: Dict[str, Any],
                        generator: Optional[torch.Generator] = None):
    """Build the network a config's ``network:`` section names (the
    counterpart of `bbx/agent/trainer.py:_network_from_config`): the
    AfterstateNetwork for ``type: afterstate``, else the flat CNN."""
    dtype = _DTYPES[net_cfg.get("compute_dtype", "bfloat16")]
    if net_cfg.get("type", "cnn") == "afterstate":
        return AfterstateNetwork(
            eval_channels=tuple(net_cfg.get("eval_channels", (24, 24))),
            eval_hidden=net_cfg.get("eval_hidden", 96),
            ctx_dim=net_cfg.get("ctx_dim", 32),
            value_channels=tuple(net_cfg.get("value_channels", (48, 64))),
            value_hidden=net_cfg.get("value_hidden", 256),
            compute_dtype=dtype,
            generator=generator,
        )
    return BlockBlastNetwork(
        conv_channels=tuple(net_cfg.get("conv_channels", (64, 128, 128))),
        fc_hidden=tuple(net_cfg.get("fc_hidden", (512, 256))),
        use_residual=net_cfg.get("use_residual", True),
        norm="batch" if net_cfg.get("use_batch_norm", True) else "none",
        compute_dtype=dtype,
        generator=generator,
    )
