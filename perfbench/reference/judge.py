"""The comparisons that decide `correct`.

Training: the harness captures what the timed path produced in an
iteration (the rollout buffer, the first three minibatch losses, the
first gradient as the optimizer gets it, the parameters' change over
three steps).  The reference replays the game over the program's actions
from the seed's draws, runs its own network over every observation,
computes GAE, and follows the first three minibatch steps from the
seeded weights.  Where the run searches, it simulates the program's
candidates at a few rollout steps drawn from the seed.  For an iteration
after the window it starts instead from `start`: the program's state
just before that iteration (weights, buffers, Adam's moments and step
count, the fleet's games and the generators' states), which it cannot
work out again without following every iteration of the window.

Evaluation: the program's actions, rewards and game-over flags of one
job drawn from the seed, and the job's statistics.  The reference replays
the job and reads, at every live lane and step, how far the program's
greedy action lies below its own best logit.

The control (the reference itself in fp8, in the program's place) runs
through the same code: `nets` may hold a "control" network beside "want".
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

from . import engine as E
from . import ppo as P
from .networks import Net, Precision

STEPS_FOLLOWED = 3
SEARCH_STEPS_CHECKED = 8
FLEET, SHUFFLE, DROPOUT, SEARCH = 0, 2, 3, 4  # generator offsets from the seed


@contextlib.contextmanager
def float32_exact():
    """Float32 products in full float32 on the card (no TF32)."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def gen(seed: int, device, state: Optional[torch.Tensor] = None) -> torch.Generator:
    """A generator seeded `seed`, or set to `state` where one is given."""
    g = torch.Generator(device=torch.device(device)).manual_seed(seed)
    if state is not None:
        g.set_state(state)
    return g


def _state(start: Optional[dict], name: str) -> Optional[torch.Tensor]:
    return None if start is None else start["rngs"][name]


def make_nets(kind: str, weights: dict, buffers: dict, seed: int, device,
              control: bool = False, start: Optional[dict] = None) -> Dict[str, Net]:
    drop = _state(start, "dropout")
    nets = {"want": Net(kind, weights, buffers, gen(seed + DROPOUT, device, drop),
                        Precision())}
    if control:
        nets["control"] = Net(kind, weights, buffers, gen(seed + DROPOUT, device, drop),
                              Precision(low=True))
    return nets


def _top(logits: torch.Tensor, k: int) -> torch.Tensor:
    return torch.sort(logits, dim=1, descending=True, stable=True).indices[:, :k]


def _cand_gap(cand, logits, mask) -> float:
    """How far a valid action left out of `cand` lies above the lowest
    valid candidate, by the judge's logits (0 for a true top-k)."""
    inside = torch.zeros_like(mask).scatter_(1, cand.long(), True)
    low = torch.where(mask & inside, logits, torch.inf).amin(1)
    high = torch.where(mask & ~inside, logits, -torch.inf).amax(1)
    gap = torch.where(torch.isfinite(low) & torch.isfinite(high), high - low, 0.0)
    return float(gap.clamp(min=0).max())


class _Max:
    """Running maxima of the compared quantities, and sums for their scales."""

    def __init__(self):
        self.v: Dict[str, float] = {}

    def max(self, key, x):
        self.v[key] = max(self.v.get(key, 0.0), float(x))

    def add(self, key, x):
        self.v[key] = self.v.get(key, 0.0) + float(x)


def follow_rollout(h: P.Hyper, nets: Dict[str, Net], seed: int, traj: dict,
                   update: int, rc: E.Rewards, device, start: Optional[dict] = None):
    """Replay the program's rollout, from the fleet's reset or from
    `start`; returns (replay, per-net outputs, per-side search readings,
    engine mismatches)."""
    t_len, n = traj["action"].shape
    fleet = gen(seed + FLEET, device, _state(start, "fleet"))
    search = gen(seed + SEARCH, device, _state(start, "search"))
    frac = h.search_frac_at(update)
    searching = h.uses_search and (frac > 0 or h.bc_at(update) > 0)
    width = h.search_topk if 0 < h.search_topk < 192 else 192
    checked = set(torch.randperm(t_len, generator=gen(seed, "cpu"))[
        :SEARCH_STEPS_CHECKED].tolist()) if searching else set()
    game = E.Game(**start["game"]) if start is not None else E.reset(n, fleet, device)
    obs = E.observe(game)
    replay = {k: [] for k in ("board", "pieces", "mask", "reward", "done")}
    outs = {k: {"logp": [], "value": []} for k in nets}
    side = {k: _Max() for k in ("program", *[k for k in nets if k != "want"])}
    bad = torch.zeros(n, dtype=torch.int64, device=device)
    with torch.no_grad():
        for t in range(t_len):
            a = traj["action"][t].long()
            bad += (traj["board"][t].reshape(n, -1).bool() != game.board).any(1)
            bad += (traj["piece_ids"][t].int() != game.ids).any(1)
            bad += (traj["used"][t] != game.used).any(1)
            bad += (traj["mask"][t] != obs["action_mask"]).any(1)
            bad += ~obs["action_mask"].gather(1, a[:, None])[:, 0]
            for k in ("board", "pieces"):
                replay[k].append(obs[k])
            replay["mask"].append(obs["action_mask"])
            logits = {}
            for k, net in nets.items():
                logits[k], value = net.forward(obs["board"], obs["pieces"],
                                               obs["action_mask"], train=True)
                lp = P.log_prob(logits[k], a)
                outs[k]["logp"].append(lp.clamp(min=P.LOGP_FLOOR) if h.uses_search else lp)
                outs[k]["value"].append(value)
            if searching:
                if t in checked:
                    _check_search(h, nets, side, traj, t, game, obs, logits, width,
                                  search, rc)
                else:
                    torch.randint(0, 2**32, (), generator=search, device=device,
                                  dtype=torch.int64)
                use = torch.rand(n, generator=search, device=device) < frac
                bad += use != traj["search_used"][t]
                bad += use & (a != traj["search_a"][t].long())
            game, obs, reward, done, _ = E.step(game, a, rc, fleet, auto_reset=True)
            bad += reward != traj["reward"][t]
            bad += done != traj["done"][t]
            replay["reward"].append(reward)
            replay["done"].append(done)
        last = {k: net.forward(obs["board"], obs["pieces"], obs["action_mask"],
                               train=False)[1] for k, net in nets.items()}
    replay = {k: torch.stack(v) for k, v in replay.items()}
    outs = {k: {"logp": torch.stack(v["logp"]), "value": torch.stack(v["value"]),
                "last_value": last[k]} for k, v in outs.items()}
    return replay, outs, side, int((bad > 0).sum())


def _check_search(h, nets, side, traj, t, game, obs, logits, width, search, rc):
    """One rollout step's search: the program's candidates simulated by
    the reference, their Q by each network, and the choices."""
    n = game.board.shape[0]
    mask = obs["action_mask"]
    cand = traj["search_cand"][t].long()
    sim, sim_obs, reward, done, _ = E.step(game.repeat(width), cand.reshape(-1), rc, search,
                                           auto_reset=False)
    valid = mask.gather(1, cand)
    q = {}
    for k, net in nets.items():
        v2 = net.value(sim_obs["board"], sim_obs["pieces"])
        q[k] = (reward + h.gamma * v2 * (1.0 - done.float())).reshape(n, width)
    want = q["want"]
    scale_keys = torch.where(valid, want, 0.0)
    got = {"program": (cand, traj["search_q"][t].float(), traj["search_a"][t].long())}
    for k in nets:
        if k != "want":
            choice = torch.where(valid, q[k], -torch.inf).argmax(1)
            got[k] = (_top(logits[k], width), q[k], cand.gather(1, choice[:, None])[:, 0])
    for k, (c, qk, act) in got.items():
        s = side[k]
        s.max("search_cand_gap", _cand_gap(c, logits["want"], mask))
        s.add("search_q_err_sq", torch.where(valid, (qk - want) ** 2, 0.0).sum())
        pos = (cand == act[:, None]).float().argmax(1)
        best = torch.where(valid, want, -torch.inf).amax(1)
        chosen = want.gather(1, pos[:, None])[:, 0]
        has = valid.any(1)
        s.max("search_choice_abs", torch.where(has, best - chosen, 0.0).max())
        s.add("search_q_sq", (scale_keys ** 2).sum())
        s.add("search_q_count", valid.sum())


def follow_update(h: P.Hyper, net: Net, weights: dict, seed: int, traj: dict,
                  replay: dict, out: dict, update: int, device,
                  start: Optional[dict] = None):
    """The first three minibatch steps from `weights` (with Adam's state
    from `start`, or fresh).  Returns their losses, the first step's
    policy and value terms, the first clipped gradient and the parameters'
    change after three."""
    adv, ret = P.gae(h, replay["reward"], replay["done"], out["value"], out["last_value"])
    adv = P.normalize(adv).float().reshape(-1)
    ret = ret.float().reshape(-1)
    perm = torch.randperm(h.batch, generator=gen(seed + SHUFFLE, device, _state(start, "shuffle")),
                          device=device)
    flat = {"board": replay["board"].flatten(0, 1), "pieces": replay["pieces"].flatten(0, 1),
            "mask": replay["mask"].flatten(0, 1), "action": traj["action"].reshape(-1),
            "logp": out["logp"].reshape(-1), "adv": adv, "ret": ret}
    if "search_q" in traj:
        flat["search_q"] = traj["search_q"].flatten(0, 1)
        flat["search_cand"] = traj["search_cand"].flatten(0, 1)
    params = {k: v.detach().clone().requires_grad_() for k, v in weights.items()}
    adam = (P.Adam(params) if start is None
            else P.Adam(params, start["adam"], start["adam_steps"]))
    ent, bc = h.ent_at(update), h.bc_at(update)
    losses, terms1, grad1 = [], None, None
    for i in range(STEPS_FOLLOWED):
        rows = {k: v[perm[i * h.minibatch:(i + 1) * h.minibatch]] for k, v in flat.items()}
        net.p = params
        logits, value = net.forward(rows["board"], rows["pieces"], rows["mask"], train=True)
        total, terms = P.loss(h, logits, value, rows, ent, bc)
        grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
        grads = P.Adam.clip(grads, h.max_grad_norm)
        losses.append(float(total.detach()))
        if grad1 is None:
            grad1 = {k: g.detach() for k, g in grads.items()}
            terms1 = {k: float(v.detach()) for k, v in terms.items()}
        with torch.no_grad():
            params = adam.step(params, grads, h.lr_at(adam.t))
        params = {k: v.detach().requires_grad_() for k, v in params.items()}
    change = {k: (params[k] - weights[k]).detach() for k in weights}
    return losses, terms1, grad1, change


def _leaves(want: dict) -> Dict[str, float]:
    """The reference's leaf norms, without the leaves whose norm is under a
    thousandth of the median leaf's (nought to rounding), and that median."""
    norms = {k: float(w.norm()) for k, w in want.items()}
    median = float(np.median(list(norms.values())))
    return {k: w for k, w in norms.items() if w >= 1e-3 * median}, median


def leaf_gap(got: dict, want: dict) -> float:
    """The worst leaf's gap of norms, against the larger of that leaf's
    reference norm and the median leaf's."""
    norms, median = _leaves(want)
    return max(abs(float(got[k].norm()) - w) / max(w, median) for k, w in norms.items())


def direction_gap(got: dict, want: dict) -> float:
    """1 - the cosine between the program's and the reference's whole
    gradient over the leaves `leaf_gap` compares (1 where the program's is
    nought).  A gradient taken over part of the rows points elsewhere even
    where its norm comes out close."""
    keys = sorted(_leaves(want)[0])
    a = torch.cat([got[k].double().flatten() for k in keys])
    b = torch.cat([want[k].double().flatten() for k in keys])
    na, nb = float(a.norm()), float(b.norm())
    return 1.0 - float(a @ b) / (na * nb) if na > 0 else 1.0


def train_numbers(h: P.Hyper, out_want: dict, got: dict, side: _Max,
                  losses_want, terms_want, grad_want, change_want, mismatches: int) -> dict:
    """The numbers of one side (the program's or the control's).  The first
    step's terms are read at the seeded weights on the same rows, so no
    drift enters them: the policy term's gap is absolute (its scale is the
    normalised advantage's, 1), the value term's relative."""
    v = out_want["value"]
    nums = {
        "engine_mismatch": mismatches,
        "logp_gap": float((got["logp"] - out_want["logp"]).abs().max()),
        "value_gap": float((got["value"] - v).pow(2).mean().sqrt() / v.pow(2).mean().sqrt()),
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], losses_want)),
        "policy_loss1_gap": abs(got["terms1"]["policy"] - terms_want["policy"]),
        "value_loss1_gap": abs(got["terms1"]["value"] - terms_want["value"]) / terms_want["value"],
        "update_gap": leaf_gap(got["change3"], change_want),
        "grad_gap": leaf_gap(got["grad1"], grad_want),
        "grad_dir_gap": direction_gap(got["grad1"], grad_want),
    }
    s = side.v
    if "search_q_count" in s:
        rms = (s["search_q_sq"] / max(s["search_q_count"], 1.0)) ** 0.5
        nums["search_cand_gap"] = s["search_cand_gap"]
        nums["search_q_gap"] = (s["search_q_err_sq"] / max(s["search_q_count"], 1.0)) ** 0.5 / rms
        nums["search_choice_gap"] = s["search_choice_abs"] / rms
    return nums


def judge_train(config: dict, seed: int, weights: dict, buffers: dict, got: dict,
                device, control: bool = False, start: Optional[dict] = None
                ) -> Dict[str, dict]:
    """{"program": numbers[, "control": numbers]} of a captured iteration:
    the first, from the seeded `weights` and `buffers`, or, with `start`,
    a later one from the program's state (`weights` and `buffers` are then
    the program's too).  `got` holds the program's `traj`, its first three
    `losses`, `grad1`, `change3` and the iteration's `update` step."""
    with float32_exact():
        return _judge_train(config, seed, weights, buffers, got, device, control, start)


def _judge_train(config, seed, weights, buffers, got, device, control, start):
    h = P.Hyper.of(config)
    kind = "afterstate" if config["network"].get("type") == "afterstate" else "cnn"
    rc = E.Rewards(**config.get("rewards", {}))
    nets = make_nets(kind, weights, buffers, seed, device, control, start)
    traj, update = got["traj"], got["update"]
    replay, outs, side, bad = follow_rollout(h, nets, seed, traj, update, rc, device, start)
    followed = {k: follow_update(h, net, weights, seed, traj, replay, outs[k], update, device,
                                 start)
                for k, net in nets.items()}
    losses_w, terms_w, grad_w, change_w = followed["want"]
    result = {"program": train_numbers(
        h, outs["want"], {"logp": traj["logp"], "value": traj["value"], **got},
        side["program"], losses_w, terms_w, grad_w, change_w, bad)}
    result["losses"] = {"program": got["losses"], "want": losses_w}
    if control:
        losses_c, terms_c, grad_c, change_c = followed["control"]
        result["losses"]["control"] = losses_c
        result["control"] = train_numbers(
            h, outs["want"], {**outs["control"], "losses": losses_c, "terms1": terms_c,
                              "grad1": grad_c, "change3": change_c},
            side["control"], losses_w, terms_w, grad_w, change_w, bad)
    return result


# ---------------------------------------------------------------------------
# Evaluation.
# ---------------------------------------------------------------------------

def eval_stats(game: E.Game) -> dict:
    """The job's statistics over its completed episodes, as the eval
    reports them."""
    done = game.done.cpu().numpy()
    sel = done if done.any() else np.ones_like(done)

    def col(x):
        return x.cpu().numpy().astype(np.float64)[sel]

    scores, lengths = col(game.score), col(game.moves)
    return {"completed": int(done.sum()), "truncated": int((~done).sum()),
            "score_mean": float(scores.mean()), "score_max": float(scores.max()),
            "score_min": float(scores.min()), "score_median": float(np.median(scores)),
            "length_mean": float(lengths.mean()),
            "lines_mean": float(col(game.lines_total).mean()),
            "max_combo_mean": float(col(game.max_streak).mean())}


def play_control(network: dict, weights: dict, seed: int, episodes: int, steps: int,
                 device) -> dict:
    """The reference in fp8 playing the job greedily in the program's
    place: its actions, rewards, game-over flags and statistics."""
    kind = "afterstate" if network.get("type") == "afterstate" else "cnn"
    net = Net(kind, weights, {}, None, Precision(low=True))
    fleet = gen(seed, device)
    game = E.reset(episodes, fleet, device)
    obs = E.observe(game)
    rec = {"actions": [], "reward": [], "done": []}
    with torch.no_grad():
        for _ in range(steps):
            logits, _ = net.forward(obs["board"], obs["pieces"], obs["action_mask"], False)
            a = logits.argmax(1).int()
            game, obs, reward, done, _ = E.step(game, a, E.Rewards(), fleet, auto_reset=False)
            for k, x in zip(rec, (a, reward, done)):
                rec[k].append(x)
    return {**rec, "stats": eval_stats(game)}


def judge_eval(network: dict, weights: dict, seed: int, episodes: int, got: dict,
               device) -> dict:
    """The numbers of one recorded eval job (`got`: its per-step
    `actions`, `reward`, `done` and its `stats`)."""
    with float32_exact():
        return _judge_eval(network, weights, seed, episodes, got, device)


def _judge_eval(network, weights, seed, episodes, got, device):
    kind = "afterstate" if network.get("type") == "afterstate" else "cnn"
    net = Net(kind, weights, {}, None, Precision())
    fleet = gen(seed, device)
    game = E.reset(episodes, fleet, device)
    obs = E.observe(game)
    gap = 0.0
    bad = torch.zeros(episodes, dtype=torch.int64, device=device)
    with torch.no_grad():
        for a, r, d in zip(got["actions"], got["reward"], got["done"]):
            live = (~game.done).nonzero().squeeze(1)
            if live.numel():
                logits, _ = net.forward(obs["board"][live], obs["pieces"][live],
                                        obs["action_mask"][live], False)
                chosen = logits.gather(1, a[live].long()[:, None])[:, 0]
                gap = max(gap, float((logits.amax(1) - chosen).max()))
            game, obs, reward, done, _ = E.step(game, a.long(), E.Rewards(), fleet,
                                                auto_reset=False)
            bad += (reward != r) | (done != d)
    want = eval_stats(game)
    stats_bad = sum(1 for k, v in want.items() if got["stats"].get(k) != v)
    return {"engine_mismatch": int((bad > 0).sum()) + stats_bad, "greedy_gap": gap}
