"""Interactive play CLI: counterpart of `bbx/cli/play.py`.

Modes: `watch` (a trained agent plays with ASCII rendering), `manual` (a
human enters `piece row col`), `random` (random-policy statistics).  The
game runs on the CUDA card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..device import resolve_device
from ..env.single import BlockBlastEnv
from ..render import render_board_with_placement, render_game_state


def watch(checkpoint: str, config_path=None, games: int = 1,
          delay: float = 0.3, deterministic: bool = True, seed: int = 42,
          device="cuda") -> dict:
    """The checkpoint's agent plays `games` games with live rendering.
    Returns each game's score and moves."""
    from ..agent.policy_agent import PolicyAgent
    from .evaluate import config_for_checkpoint

    dev = resolve_device(device)
    agent = PolicyAgent.from_checkpoint(
        checkpoint, config_for_checkpoint(checkpoint, config_path), device=dev,
        seed=seed)
    scores, moves = [], []
    for g in range(games):
        env = BlockBlastEnv(render_mode="human", seed=seed + g, device=dev)
        obs, info = env.reset(seed=seed + g)
        done, steps = False, 0
        while not done and steps < 10_000:
            action, act_info = agent.select_action(obs, deterministic=deterministic)
            obs, reward, done, _, info = env.step(action)
            print(f"move {info['moves']} | score {info['score']} | "
                  f"value {act_info['value']:.2f} | reward {reward:+.3f}")
            steps += 1
            time.sleep(delay)
        print(f"\ngame {g + 1}: score={info['score']} moves={info['moves']} "
              f"lines={info['lines_cleared']} max_combo={info['max_combo']}")
        scores.append(info["score"])
        moves.append(info["moves"])
    return {"scores": scores, "moves": moves}


def manual(seed: int = 42, device="cuda"):
    """Human play in the terminal."""
    env = BlockBlastEnv(render_mode=None, seed=seed, device=device)
    obs, info = env.reset(seed=seed)
    print("Enter moves as: <piece 0-2> <row 0-7> <col 0-7>;"
          " 'p <piece> <row> <col>' to preview, 'q' to quit.\n")
    done = False
    while not done:
        print(env.render() or render_game_state(
            obs["board"], env.state.piece_ids[0].tolist(),
            env.state.used[0].tolist(), score=info["score"], moves=info["moves"]))
        try:
            raw = input("> ").strip()
        except EOFError:
            break
        if not raw:
            continue
        if raw.lower() in ("q", "quit", "exit"):
            break
        parts = raw.split()
        if parts[0] == "p" and len(parts) == 4:
            p, r, c = (int(x) for x in parts[1:])
            pid = int(env.state.piece_ids[0, p])
            print(render_board_with_placement(obs["board"], pid, r, c))
            continue
        if len(parts) != 3:
            print("need: piece row col")
            continue
        p, r, c = (int(x) for x in parts)
        action = p * 64 + r * 8 + c
        obs, reward, done, _, info = env.step(action)
        if info.get("invalid_action"):
            print("invalid move (-10)")
        else:
            lm = info.get("last_move", {})
            print(f"+{lm.get('score_gained', 0)} points"
                  + (f", cleared {lm['lines_cleared']} lines!"
                     if lm.get("lines_cleared") else ""))
    print(f"\nfinal score: {info['score']} in {info['moves']} moves")


def random_games(games: int = 10, seed: int = 42, verbose: bool = True,
                 device="cuda"):
    """Random-policy statistics (each move `sample_valid_action`)."""
    scores, moves, lines = [], [], []
    for g in range(games):
        env = BlockBlastEnv(seed=seed + g, device=device)
        obs, info = env.reset(seed=seed + g)
        done, steps = False, 0
        while not done and steps < 10_000:
            obs, _, done, _, info = env.step(env.sample_valid_action())
            steps += 1
        scores.append(info["score"])
        moves.append(info["moves"])
        lines.append(info["lines_cleared"])
        if verbose:
            print(f"game {g + 1}: score={info['score']} moves={info['moves']}")
    print(f"\n{games} random games: "
          f"score mean {np.mean(scores):.1f} ± {np.std(scores):.1f} "
          f"(max {max(scores)}), moves mean {np.mean(moves):.1f}, "
          f"lines mean {np.mean(lines):.1f}")
    return {"scores": scores, "moves": moves, "lines": lines}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Play Block Blast")
    ap.add_argument("--mode", choices=["watch", "manual", "random"],
                    default="manual")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--config", default=None)
    ap.add_argument("--games", type=int, default=None,
                    help="number of games (default: 1 for watch, 10 for random)")
    ap.add_argument("--delay", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--stochastic", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.mode == "watch":
        if not args.checkpoint:
            ap.error("--checkpoint required for watch mode")
        watch(args.checkpoint, args.config, games=args.games or 1,
              delay=args.delay, deterministic=not args.stochastic,
              seed=args.seed, device=device)
    elif args.mode == "manual":
        manual(seed=args.seed, device=device)
    else:
        random_games(games=args.games or 10, seed=args.seed, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
