"""Flax parameters -> the port's state dicts.

The input is the nested dict of NumPy arrays that Flax's ``params`` (and,
for BatchNorm, ``batch_stats``) holds (no JAX objects).  Conv kernels go from HWIO to OIHW and Dense kernels are
transposed.  Flax flattens NHWC activations before a Dense; the port
flattens NCHW, so the rows of a Dense that follows a conv flatten are
permuted from (h, w, c) to (c, h, w) order here, once.  Adam's moments
(`adam_state_from_optax`) are permuted the same way, so a bbx train state
carries over whole.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

_HW = 8 * 8


def _conv(p: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    k = np.asarray(p["kernel"], np.float32)                # [kh, kw, in, out]
    return {"weight": torch.tensor(np.ascontiguousarray(k.transpose(3, 2, 0, 1))),
            "bias": torch.tensor(np.asarray(p["bias"], np.float32))}


def _dense(p: Dict[str, Any], flat_channels: int = 0) -> Dict[str, torch.Tensor]:
    """A Dense layer; its first ``64 * flat_channels`` input rows come from
    an NHWC flatten of [8, 8, flat_channels] and are reordered to NCHW."""
    k = np.asarray(p["kernel"], np.float32)                # [in, out]
    if flat_channels:
        n = _HW * flat_channels
        head = k[:n].reshape(8, 8, flat_channels, -1).transpose(2, 0, 1, 3)
        k = np.concatenate([head.reshape(n, -1), k[n:]], axis=0)
    return {"weight": torch.tensor(np.ascontiguousarray(k.T)),
            "bias": torch.tensor(np.asarray(p["bias"], np.float32))}


def afterstate_state_dict_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """`bbx.models.afterstate.AfterstateNetwork` params -> a state dict of
    `bbx_torch.models.afterstate.AfterstateNetwork`."""
    out: Dict[str, torch.Tensor] = {}

    def put(prefix, tensors):
        for name, t in tensors.items():
            out[f"{prefix}.{name}"] = t

    ev = params["Checkpoint_Evaluator_0"]
    n_eval = sum(1 for k in ev if k.startswith("Conv_"))
    for i in range(n_eval):
        put(f"evaluator.convs.{i}", _conv(ev[f"Conv_{i}"]))
    last_eval = np.asarray(ev[f"Conv_{n_eval - 1}"]["kernel"]).shape[-1]
    put("evaluator.dense0", _dense(ev["Dense_0"], flat_channels=last_eval))
    put("evaluator.dense1", _dense(ev["Dense_1"]))

    put("ctx", _dense(params["Dense_0"]))
    n_value = sum(1 for k in params if k.startswith("Conv_"))
    for i in range(n_value):
        put(f"value_convs.{i}", _conv(params[f"Conv_{i}"]))
    last_value = np.asarray(params[f"Conv_{n_value - 1}"]["kernel"]).shape[-1]
    put("value_dense0", _dense(params["Dense_1"], flat_channels=last_value))
    put("value_dense1", _dense(params["Dense_2"]))
    return out


def _norm(p: Dict[str, Any], stats: Optional[Dict[str, Any]]) -> Dict[str, torch.Tensor]:
    """A `_Norm`: Flax's ``BatchNorm_0``/``GroupNorm_0`` scale and bias, and
    BatchNorm's running ``mean``/``var`` from `stats` where given."""
    out: Dict[str, torch.Tensor] = {}
    for kind in ("BatchNorm_0", "GroupNorm_0"):
        if kind in p:
            out["weight"] = torch.tensor(np.asarray(p[kind]["scale"], np.float32))
            out["bias"] = torch.tensor(np.asarray(p[kind]["bias"], np.float32))
            if kind == "BatchNorm_0" and stats is not None:
                out["running_mean"] = torch.tensor(
                    np.asarray(stats[kind]["mean"], np.float32))
                out["running_var"] = torch.tensor(
                    np.asarray(stats[kind]["var"], np.float32))
    return out


def _n_layers(tree: Dict[str, Any], kind: str) -> int:
    return sum(1 for k in tree if k.startswith(kind + "_"))


def block_blast_state_dict_from_flax(
        params: Dict[str, Any],
        batch_stats: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
    """`bbx.models.network.BlockBlastNetwork` params (and, with BatchNorm,
    its ``batch_stats``) -> a state dict of
    `bbx_torch.models.network.BlockBlastNetwork`.  Without `batch_stats`
    the running statistics are left out (a `strict=False` load, or the
    moments of `adam_state_from_optax`)."""
    out: Dict[str, torch.Tensor] = {}

    def put(prefix, tensors):
        for name, t in tensors.items():
            out[f"{prefix}.{name}"] = t

    def norm_stats(*path):
        if batch_stats is None:
            return None
        node = batch_stats
        for key in path:
            node = node.get(key, {})
        return node

    n_conv = _n_layers(params, "Conv")
    for i in range(n_conv):
        put(f"convs.{i}", _conv(params[f"Conv_{i}"]))
        put(f"norms.{i}", _norm(params.get(f"_Norm_{i}", {}), norm_stats(f"_Norm_{i}")))
    for k in range(_n_layers(params, "ResidualBlock")):
        rb = params[f"ResidualBlock_{k}"]
        for j in range(2):
            put(f"blocks.{k}.conv{j}", _conv(rb[f"Conv_{j}"]))
            put(f"blocks.{k}.norm{j}", _norm(rb.get(f"_Norm_{j}", {}),
                                             norm_stats(f"ResidualBlock_{k}", f"_Norm_{j}")))
    last = np.asarray(params[f"Conv_{n_conv - 1}"]["kernel"]).shape[-1]
    n_fc = _n_layers(params, "Dense") - 4
    for i in range(n_fc):
        put(f"fc.{i}", _dense(params[f"Dense_{i}"], flat_channels=last if i == 0 else 0))
    for i, name in enumerate(("policy_hidden", "policy_out", "value_hidden",
                              "value_out")):
        put(name, _dense(params[f"Dense_{n_fc + i}"]))
    return out


def actor_critic_state_dict_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """`bbx.models.network.ActorCritic` params -> a state dict of
    `bbx_torch.models.network.ActorCritic`."""
    out: Dict[str, torch.Tensor] = {}

    def put(prefix, tensors):
        for name, t in tensors.items():
            out[f"{prefix}.{name}"] = t

    n_conv = _n_layers(params, "Conv")
    for i in range(n_conv):
        put(f"convs.{i}", _conv(params[f"Conv_{i}"]))
    last = np.asarray(params[f"Conv_{n_conv - 1}"]["kernel"]).shape[-1]
    for head, first in (("actor", 0), ("critic", 3)):
        put(f"{head}.0", _dense(params[f"Dense_{first}"], flat_channels=last))
        put(f"{head}.1", _dense(params[f"Dense_{first + 1}"]))
        put(f"{head}_out", _dense(params[f"Dense_{first + 2}"]))
    return out


def _adam_moments(opt_state):
    """The ``ScaleByAdamState(count, mu, nu)`` inside an optax chain state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state.count, opt_state.mu, opt_state.nu
    if isinstance(opt_state, tuple):
        for sub in opt_state:
            found = _adam_moments(sub)
            if found is not None:
                return found
    return None


def adam_state_from_optax(
        opt_state, params: Dict[str, Any],
        convert: Callable[[Dict[str, Any]], Dict[str, torch.Tensor]]
        = afterstate_state_dict_from_flax) -> Dict[str, Any]:
    """bbx's optimizer state -> the port's Adam state.

    Args:
      opt_state: the state of `bbx.agent.ppo.make_optimizer`'s chain
        (``clip_by_global_norm`` then ``adam``), with ``mu``/``nu`` as
        trees of NumPy arrays.
      params: the Flax params the state belongs to.
      convert: the network's params converter (the AfterstateNetwork's by
        default; `block_blast_state_dict_from_flax` for the flat CNN).
    Returns:
      ``{"step": count, "exp_avg": {name: tensor}, "exp_avg_sq": {name:
      tensor}}``, keyed by the port's parameter names, with the moments
      permuted as the weights are.
    """
    found = _adam_moments(opt_state)
    if found is None:
        raise ValueError("no ScaleByAdamState(count, mu, nu) in the optax state")
    count, mu, nu = found
    want = convert(params)
    out = {"step": int(np.asarray(count))}
    for key, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
        moments = convert(tree)
        for name, w in want.items():
            if moments[name].shape != w.shape:
                raise ValueError(f"{key} {name}: shape {tuple(moments[name].shape)}"
                                 f" != the parameter's {tuple(w.shape)}")
        out[key] = moments
    return out


def load_adam_state(optimizer: torch.optim.Optimizer, network: torch.nn.Module,
                    adam: Dict[str, Any]) -> None:
    """Put `adam_state_from_optax`'s state into a `torch.optim.Adam` over
    ``network.parameters()``."""
    state = {}
    for i, (name, p) in enumerate(network.named_parameters()):
        state[i] = {"step": torch.tensor(float(adam["step"])),
                    "exp_avg": adam["exp_avg"][name].to(p.device).clone(),
                    "exp_avg_sq": adam["exp_avg_sq"][name].to(p.device).clone()}
    sd = optimizer.state_dict()
    optimizer.load_state_dict({"state": state, "param_groups": sd["param_groups"]})
