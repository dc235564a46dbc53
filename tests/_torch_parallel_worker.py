"""One rank of the port's data-parallel runs in `tests/test_torch_parallel.py`.

Launched as N processes that form a gloo group on 127.0.0.1 and run
`bbx_torch` on the CPU.  Usage:

    python _torch_parallel_worker.py <mode> <rank> <world> <port> <out_dir>

Modes (rank 0 prints ``RESULT <json>`` where there is one):

  * ``train``: `mp_config.MP_CFG` (bbx's own multi-process recipe), seed 3:
    K_ITERS iterations, a collective save into <out_dir>, K_ITERS more
    ("cont"), then a fresh trainer (seed 999: the load must win) loaded
    from the save and K_ITERS more ("res"); after every update whether the
    parameters and buffers are bit for bit equal on every rank; then the
    refusals (a fleet the world size does not divide, ``num_model`` 2,
    ``num_data`` other than the world size);
  * ``zero_rows``: `ZERO_ROW_CFGS` (minibatches of 2 entries of a 4-lane
    fleet, so some minibatch falls wholly on one rank), each for 2
    iterations, with the same per-update check;
  * ``search``: `SEARCH_CFG` (config/run8.yaml's search and BC knobs on
    the tiny flat CNN, float32), seed 3, as ``train`` runs `MP_CFG`
    (K_ITERS, a collective save, K_ITERS more, a fresh trainer loaded from
    the save for K_ITERS more), with each rank's rows of the first
    rollout's search fields gathered to rank 0;
  * ``sigterm``: `train` on `SIGTERM_CFG` until the test signals one rank;
    every rank prints ``FINAL_STEP <step>`` and ``CLEAN_EXIT``;
  * ``bn``: the flat CNN of <out_dir>/bn_state.pt in train mode on its rows
    of `bn_inputs()`, through the cross-rank BatchNorm: outputs, input
    gradients and running statistics into <out_dir>/bn_out.npz.
"""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from bbx_torch.agent.trainer import PPOTrainer, train  # noqa: E402
from bbx_torch.models.network import BlockBlastNetwork  # noqa: E402
from bbx_torch.parallel import (  # noqa: E402
    BatchShard,
    gather_to_primary,
    initialize_multihost,
)
from mp_config import K_ITERS, MP_CFG  # noqa: E402

TINY_CNN = {"conv_channels": [4, 8], "fc_hidden": [16], "use_batch_norm": True,
            "use_residual": True, "compute_dtype": "float32"}
TINY_AFTERSTATE = {"type": "afterstate", "eval_channels": [4, 4], "eval_hidden": 8,
                   "ctx_dim": 6, "value_channels": [4, 4], "value_hidden": 16,
                   "compute_dtype": "float32"}
# config/run8.yaml's search and BC knobs (Q-soft, top-16).
RUN8_SEARCH = {"rollout_search_frac": 0.85, "final_rollout_search_frac": 0.0,
               "bc_coef": 1.2, "final_bc_coef": 0.0, "bc_target": "q_soft",
               "bc_q_temp": 0.25, "search_topk": 16, "search_anneal_frac": 0.55}
# BC against the search's action where it was taken with a positive
# advantage (a global weight sum every rank joins, rows or none).
ADV_POS_SEARCH = {"rollout_search_frac": 0.5, "bc_coef": 0.7, "bc_filter": "adv_pos",
                  "search_topk": 8}
# 4 lanes x 2 steps in minibatches of 2, 2 epochs: 8 minibatches an update.
ZERO_ROW_CFGS = {
    name: {"training": {"num_envs": 4, "rollout_steps": 2, "batch_size": 2,
                        "total_timesteps": 1 << 20},
           "ppo": {"num_epochs": 2, **ppo}, "network": net}
    for name, net, ppo in (("cnn", TINY_CNN, {}),
                           ("cnn_no_batch_norm", dict(TINY_CNN, use_batch_norm=False), {}),
                           ("afterstate", TINY_AFTERSTATE, {}),
                           ("afterstate_adv_pos_search", TINY_AFTERSTATE, ADV_POS_SEARCH))}
# 16 lanes x 4 steps in minibatches of 16, 2 epochs; the anneal's horizon
# (55% of 2**20 / 64 iterations) keeps every iteration searching.
SEARCH_CFG = {"training": {"num_envs": 16, "rollout_steps": 4, "batch_size": 16,
                           "total_timesteps": 1 << 20},
              "ppo": {"num_epochs": 2, **RUN8_SEARCH}, "network": TINY_CNN}
SEARCH_FIELDS = ("search_a", "search_used", "search_cand", "search_q")
ZERO_ROW_SEED = 5
SIGTERM_CFG = {
    "training": {"num_envs": 8, "rollout_steps": 4, "batch_size": 16,
                 "total_timesteps": 1 << 30},
    "ppo": {"num_epochs": 1},
    "network": TINY_CNN,
    "logging": {"log_interval": 1, "save_interval": 0, "eval_interval": 0},
}
BN_ROWS = 24
BN_WIDTHS = dict(conv_channels=(4, 8, 8), fc_hidden=(16, 8))


def bn_inputs():
    """The BatchNorm case's whole batch and the loss weights (numpy)."""
    rng = np.random.default_rng(2)
    board = (rng.random((BN_ROWS, 8, 8)) < 0.4).astype(np.float32)
    pieces = (rng.random((BN_ROWS, 3, 8, 8)) < 0.2).astype(np.float32)
    w_logits = rng.standard_normal((BN_ROWS, 192)).astype(np.float32)
    w_value = rng.standard_normal(BN_ROWS).astype(np.float32)
    return board, pieces, w_logits, w_value


def _floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


def _same_on_every_rank(module) -> bool:
    """Are `module`'s parameters and buffers bit for bit rank 0's?"""
    flat = torch.cat([v.detach().reshape(-1).to(torch.float64)
                      for v in module.state_dict().values()])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    same = torch.tensor([int(torch.equal(flat, ref))])
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    return bool(same.item())


def _iterate(trainer, n):
    series, same = [], []
    for _ in range(n):
        series.append(_floats(trainer.iterate()))
        same.append(_same_on_every_rank(trainer.network))
    return series, same


def _refusal(make):
    try:
        make()
    except ValueError as e:
        return str(e)
    return None


def _save_resume(cfg, out, name):
    """K_ITERS iterations of `cfg` (seed 3), a collective save, K_ITERS
    more, then a fresh trainer (seed 999: the load must win) loaded from
    the save for K_ITERS more: the series, the parameters' agreement after
    every update, the checkpoint and the first trainer."""
    trainer = PPOTrainer(cfg, seed=3, device="cpu")
    head, same_head = _iterate(trainer, K_ITERS)
    path = trainer.save(out, name)
    cont, same_cont = _iterate(trainer, K_ITERS)
    fresh = PPOTrainer(cfg, seed=999, device="cpu")
    fresh.load(path)
    loaded_step = fresh.global_step
    res, same_res = _iterate(fresh, K_ITERS)
    return {"head": head, "cont": cont, "res": res, "path": path,
            "lanes": list(trainer.lanes), "same": same_head + same_cont + same_res,
            "loaded_step": loaded_step}, trainer


def run_train(out):
    result, trainer = _save_resume(MP_CFG, out, "mp_resume")
    refusals = {
        "num_envs": _refusal(lambda: PPOTrainer(
            {**MP_CFG, "training": {**MP_CFG["training"], "num_envs": 255}}, device="cpu")),
        "num_model": _refusal(lambda: PPOTrainer(
            {**MP_CFG, "mesh": {"num_model": 2}}, device="cpu")),
        "num_data": _refusal(lambda: PPOTrainer(
            {**MP_CFG, "mesh": {"num_data": 4}}, device="cpu")),
    }
    return result | {"refusals": refusals, "num_devices": trainer.mesh.num_devices()}


def run_search(out):
    """`SEARCH_CFG` as ``train`` runs `MP_CFG`; each rank's rows of the
    first rollout's search fields, gathered to rank 0 in rank order."""
    from bbx_torch.agent import ppo as P

    rollout0, fields = P.rollout, []

    def rollout(*args, **kwargs):
        out = rollout0(*args, **kwargs)
        if not fields:
            # [T, N_local, ...] -> lanes first, so the gather concatenates lanes.
            fields.append({k: out[1][k].transpose(0, 1).float() for k in SEARCH_FIELDS})
        return out

    P.rollout = rollout
    try:
        result, _ = _save_resume(SEARCH_CFG, out, "search_resume")
    finally:
        P.rollout = rollout0
    got = gather_to_primary(fields[0])
    if got is not None:
        result["first_rollout"] = {k: v.tolist() for k, v in got.items()}
    return result


def run_zero_rows(out):
    result = {}
    for name, cfg in ZERO_ROW_CFGS.items():
        trainer = PPOTrainer(cfg, seed=ZERO_ROW_SEED, device="cpu")
        series, same = _iterate(trainer, 2)
        result[name] = {"series": series, "same": same}
    return result


def run_sigterm(out):
    cfg = json.loads(json.dumps(SIGTERM_CFG))
    cfg["paths"] = {"checkpoint_dir": os.path.join(out, "ckpt"),
                    "log_dir": os.path.join(out, "logs")}
    stats = train(cfg, seed=11, device="cpu")
    print(f"FINAL_STEP {stats['global_step']}", flush=True)
    print("CLEAN_EXIT", flush=True)


def run_bn(out):
    rank, world = dist.get_rank(), dist.get_world_size()
    net = BlockBlastNetwork(**BN_WIDTHS, norm="batch", dropout_rate=0.0,
                            compute_dtype=torch.float32)
    net.load_state_dict(torch.load(os.path.join(out, "bn_state.pt")))
    net.train()
    board, pieces, w_logits, w_value = bn_inputs()
    per = BN_ROWS // world
    rows = slice(rank * per, (rank + 1) * per)
    b = torch.from_numpy(board[rows]).requires_grad_()
    p = torch.from_numpy(pieces[rows]).requires_grad_()
    logits, value = net(b, p, None, shard=BatchShard(BN_ROWS, rows))
    loss = ((logits * torch.from_numpy(w_logits[rows])).sum()
            + (value * torch.from_numpy(w_value[rows])).sum())
    loss.backward()
    got = gather_to_primary({"logits": logits, "value": value, "dboard": b.grad,
                             "dpieces": p.grad})
    same = _same_on_every_rank(net)
    if got is not None:
        stats = {f"stat:{k}": v.numpy() for k, v in net.state_dict().items()
                 if "running" in k}
        np.savez(os.path.join(out, "bn_out.npz"), same=same,
                 **{k: v.detach().numpy() for k, v in got.items()}, **stats)


def main():
    mode, rank, world, port, out = sys.argv[1:6]
    torch.set_num_threads(1)
    assert initialize_multihost(f"127.0.0.1:{port}", int(world), int(rank),
                                backend="gloo", device="cpu", timeout_s=300)
    try:
        result = {"train": run_train, "zero_rows": run_zero_rows, "search": run_search,
                  "sigterm": run_sigterm, "bn": run_bn}[mode](out)
        if result is not None and dist.get_rank() == 0:
            print("RESULT " + json.dumps(result), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
