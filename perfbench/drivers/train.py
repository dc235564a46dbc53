"""Traffic driver ``train``: PPO training as a training job runs it.

Set-up builds the program's `PPOTrainer` for the configuration, loads the
weights drawn from the seed, sets the trainer's update step where the mix
says (``start``: 0, the job's first iteration; ``search_end``: the first
iteration at which the program's own schedule has taken the search
fraction and the cloning coefficient to 0), and runs the first iteration
through `PPOTrainer.iterate`, the window's own call.  That iteration is
the warm-up, and what it produced is captured for the comparison.  The
window then calls `iterate` back to back until the host clock passes the
run's seconds, and ends with the iteration that crossed them and a
synchronise.  `train_env_steps_per_s` is every env-step of the window's
iterations over the window's seconds.

The same trainer then runs one more iteration, captured alike, so that
what the window's path does after its first iteration (a buffer reused,
a path switched on after warm-up) is compared too.  The reference follows
it from the program's state just before it (`program_state`); its
numbers are compared under their names with ``.later`` appended, each
against a limit of its own.
"""
from __future__ import annotations

import gc
import sys
import time


def start_update(ppo_mod, cfg, where: str) -> int:
    if where == "start":
        return 0
    if where == "search_end":
        def off(u):
            return ppo_mod.search_frac_at(cfg, u) == 0.0 and ppo_mod.bc_coef_at(cfg, u) == 0.0

        lo, hi = 0, cfg.schedule_updates + 1
        if not off(hi):
            raise ValueError("the configuration's search never anneals to 0")
        while lo < hi:  # the schedules fall linearly and stay at 0
            mid = (lo + hi) // 2
            lo, hi = (lo, mid) if off(mid) else (mid + 1, hi)
        return lo
    raise ValueError(f"traffic 'start': {where!r}; 'start' or 'search_end'")


def capture_iteration(trainer, hooks_cls) -> dict:
    """Run one iteration through `iterate` and keep what the comparison
    reads: the rollout's buffer, the first three minibatch losses (the
    first with its policy and value terms), the first step's gradient as
    Adam holds it (the change of its first moment over 1 - beta1) and the
    parameters' change over the first three steps.  The optimizer is
    watched through its own step hooks."""
    import torch

    net = trainer.network
    opt = trainer.train_state.optimizer
    beta1 = opt.param_groups[0]["betas"][0]
    before = {n: p.detach().clone() for n, p in net.named_parameters()}

    def moment(p):
        return opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p)).float().clone()

    got = {"losses": [], "update": trainer.train_state.update_step}
    hooks = hooks_cls(cuda=False)

    def on_rollout(fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            got["traj"] = out[1]
            return out
        return wrapped

    def on_loss(fn):
        def wrapped(*args, **kwargs):
            total, aux = fn(*args, **kwargs)
            got["losses"].append(total.detach().clone())
            if "terms1" not in got:
                got["terms1"] = {"policy": aux["policy_loss"].detach().clone(),
                                 "value": aux["value_loss"].detach().clone()}
            return total, aux
        return wrapped

    calls, m0 = [0], {}

    def before_step(optimizer, args, kwargs):
        if calls[0] == 0:
            m0.update({n: moment(p) for n, p in net.named_parameters()})

    def after_step(optimizer, args, kwargs):
        calls[0] += 1
        if calls[0] == 1:
            got["grad1"] = {n: (moment(p) - beta1 * m0[n]) / (1 - beta1)
                            for n, p in net.named_parameters()}
        elif calls[0] == 3:
            got["change3"] = {n: p.detach() - before[n] for n, p in net.named_parameters()}

    hooks.wrap("bbx_torch.agent.ppo:rollout", on_rollout)
    hooks.wrap("bbx_torch.agent.ppo:ppo_loss", on_loss)
    handles = [opt.register_step_pre_hook(before_step),
               opt.register_step_post_hook(after_step)]
    try:
        trainer.iterate()
    finally:
        for h in handles:
            h.remove()
        hooks.remove()
    if calls[0] < 3:
        raise RuntimeError(f"the optimizer's step hooks ran {calls[0]} times in an "
                           "iteration, not once a minibatch step")
    got["losses"] = [float(x) for x in got["losses"][:3]]
    got["terms1"] = {k: float(v) for k, v in got["terms1"].items()}
    return got


def program_state(trainer) -> dict:
    """The program's state before an iteration, as the reference reads it
    to follow that iteration: weights, buffers, Adam's moments and step
    count, the fleet's games (the reference's names and layout) and the
    generators' states.  Moments the optimizer does not hold yet are
    nought, as Adam starts them."""
    import torch

    from bbx_torch.agent import ppo

    net, opt = trainer.network, trainer.train_state.optimizer
    env = trainer.env_state
    n = env.board.shape[0]
    game = {"board": env.board.reshape(n, -1).bool(), "ids": env.piece_ids}
    for name in ("used", "score", "streak", "moves", "lines_total", "max_streak",
                 "blocks_total", "done", "prev_holes", "prev_center", "ep_return", "ep_len"):
        game[name] = getattr(env, name)
    return {
        "weights": {k: p.detach().clone() for k, p in net.named_parameters()},
        "buffers": {k: v.detach().clone() for k, v in net.named_buffers()},
        "adam": {k: tuple(opt.state.get(p, {}).get(m, torch.zeros_like(p)).clone()
                          for m in ("exp_avg", "exp_avg_sq"))
                 for k, p in net.named_parameters()},
        "adam_steps": ppo.optimizer_steps(opt),
        "game": {k: v.clone() for k, v in game.items()},
        "rngs": {k: g.get_state() for k, g in trainer.rngs.items()},
    }


def capture_later_iteration(trainer) -> tuple:
    """(the program's state, what one more iteration produced)."""
    from ..instrument import Hooks

    start = program_state(trainer)
    return start, capture_iteration(trainer, Hooks)


def judge_both(config: dict, seed: int, first: tuple, later: tuple, device) -> dict:
    """The program's numbers of the first iteration (`first`: weights,
    buffers, capture) and, with ``.later`` appended to their names, of a
    later one (`later`: start, capture)."""
    from ..reference.judge import judge_train

    w, buffers, got = first
    start, got2 = later
    a = judge_train(config, seed, w, buffers, got, device)["program"]
    b = judge_train(config, seed, start["weights"], start["buffers"], got2, device,
                    start=start)["program"]
    print(f"judged: the first iteration and iteration {got2['update']}", file=sys.stderr)
    return {**a, **{k + ".later": v for k, v in b.items()}}


def prepare(config: dict, traffic: dict, seed: int, device: str, mark=lambda what: None):
    """Set-up up to the window: (trainer, weights, buffers, captured
    first iteration)."""
    from bbx_torch.agent import ppo
    from bbx_torch.agent.trainer import PPOTrainer

    from .. import weights
    from ..instrument import Hooks

    mark("imported")
    trainer = PPOTrainer(config, seed=seed, device=device)
    mark("trainer built")
    w = weights.draw(trainer.network, seed)
    buffers = {k: v.detach().clone() for k, v in trainer.network.named_buffers()}
    trainer.train_state.update_step = start_update(ppo, trainer.ppo, traffic["start"])
    mark("weights drawn")
    got = capture_iteration(trainer, Hooks)
    mark("first iteration run")
    return trainer, w, buffers, got


def run(r) -> None:
    import torch

    from bbx_torch.agent import ppo

    trainer, w, buffers, got = prepare(r.config, r.traffic, r.seed, r.device, r.mark)
    cfg = trainer.ppo
    u = trainer.train_state.update_step
    searching = cfg.uses_search and (ppo.search_frac_at(cfg, u) > 0 or ppo.bc_coef_at(cfg, u) > 0)
    r.search_width = ((cfg.search_topk if 0 < cfg.search_topk < 192 else 192)
                      if searching else 0)

    sync = torch.cuda.synchronize if r.cuda else (lambda: None)
    sync()
    t0 = r.start_window()
    iters = 0
    while True:
        trainer.iterate()
        iters += 1
        if time.perf_counter() - t0 >= r.seconds:
            break
    sync()
    r.end_window(t0)
    r.units = r.attempted = iters
    print(f"window: {iters} iterations in {r.window_s:.3f} s", file=sys.stderr)
    r.values["train_env_steps_per_s"] = iters * cfg.batch_size / r.window_s
    later = capture_later_iteration(trainer)
    r.profile_unit(trainer.iterate)
    if r.cuda:
        r.memory_peak_bytes = torch.cuda.max_memory_allocated()
    del trainer
    gc.collect()
    if r.cuda:
        torch.cuda.empty_cache()
    r.checks = judge_both(r.config, r.seed, (w, buffers, got), later, r.device)
