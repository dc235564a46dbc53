"""The GUI's thread bodies, without tkinter.

`bbx_torch.gui.app` runs these in worker threads and polls their events;
they import no tkinter, so they run where there is no display (a test, a
machine with the card).

  * `TrainingRunner`: `train` with a progress callback that posts each log
    row to a queue and returns False once `stop` is called, so the loop
    saves `final` and returns;
  * `watch_frames`: one game of a `PolicyAgent` on `BlockBlastEnv`, a frame
    a move;
  * `OutputRedirector`: a stream that posts what is written to a queue.
"""
from __future__ import annotations

import contextlib
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np

from ..agent.policy_agent import PolicyAgent
from ..agent.trainer import train
from ..env.single import BlockBlastEnv


class OutputRedirector:
    """Route stdout/stderr into the UI queue as ``(tag, text)`` events."""

    def __init__(self, q: queue.Queue, tag: str):
        self.q = q
        self.tag = tag

    def write(self, text: str):
        if text.strip():
            self.q.put((self.tag, text))

    def flush(self):
        pass

    def close(self):
        """A library that kept this stream (a logging handler) may close
        it at exit: nothing to release."""


class TrainingRunner:
    """`train(config, progress_callback=...)` on `device`, reporting to
    `events`: ``("training_update", row)`` at each log row, then
    ``("training_done", stats)`` (global_step, elapsed_sec,
    steps_per_sec, best_score, best_eval) or ``("error", message)``; the
    console output goes there as ``("train_log", text)`` while it runs.
    `stop()` (from any thread) ends the run at the next log row, as the
    callback's False does."""

    def __init__(self, config: Dict[str, Any], events: queue.Queue, device="cuda",
                 seed: Optional[int] = None):
        self.config = config
        self.events = events
        self.device = device
        self.seed = seed
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()

    def callback(self, row: Dict[str, Any]) -> bool:
        self.events.put(("training_update", row))
        return not self._stop.is_set()

    def run(self) -> Optional[Dict[str, Any]]:
        """Train until the run ends or is stopped; the stats, or None after
        an error (which is posted, not raised: this is a thread's body)."""
        out = OutputRedirector(self.events, "train_log")
        try:
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
                stats = train(self.config, seed=self.seed, device=self.device,
                              progress_callback=self.callback)
        except Exception as e:  # surfaced in the UI
            self.events.put(("error", f"training failed: {e!r}"))
            return None
        stats = {k: stats[k] for k in ("global_step", "elapsed_sec", "steps_per_sec",
                                        "best_score", "best_eval")}
        self.events.put(("training_done", stats))
        return stats


def watch_frames(agent: PolicyAgent, seed: int, game: int = 1,
                 max_moves: int = 10_000, device="cuda") -> Iterator[Dict[str, Any]]:
    """Play one greedy game of `agent` on a `BlockBlastEnv` seeded `seed`,
    as `bbx_torch.cli.play.watch` plays it, yielding after each move the
    frame the watch page draws: the board (numpy), score, moves, lines,
    the move's action and `game`."""
    env = BlockBlastEnv(seed=seed, device=device)
    obs, _ = env.reset(seed=seed)
    done, moves = False, 0
    while not done and moves < max_moves:
        action, _ = agent.select_action(obs, deterministic=True)
        obs, _, done, _, info = env.step(action)
        moves += 1
        yield {"board": np.asarray(obs["board"]).copy(), "score": info["score"],
               "moves": info["moves"], "lines": info["lines_cleared"],
               "action": action, "game": game}
