"""The port's GUI (`bbx_torch.gui`) without a display, and the trainer's
`progress_callback` that its training page stops through.

  * `bbx_torch.gui.app` imports headless, and its `OutputRedirector` posts
    what is written as `tests/test_cli_and_utils.py` checks bbx's does;
  * the port's `train(progress_callback=...)` returning False after 2 rows
    stops the run with `final` written, and its rows carry the keys of
    bbx's rows from bbx's `train` under the same callback (the tiny
    config of `tests/test_torch_trainer.py`); `TrainingRunner` stops the
    same way from another thread's `stop()`;
  * the watch worker's seeded moves equal `PolicyAgent`'s on
    `BlockBlastEnv`, move for move.
"""
import json
import queue
import threading

import pytest
import torch

from bbx.agent.trainer import train as j_train
from bbx_torch.agent.policy_agent import PolicyAgent
from bbx_torch.agent.trainer import PPOTrainer, train
from bbx_torch.env.single import BlockBlastEnv
from bbx_torch.gui import workers
from bbx_torch.utils.checkpoints import checkpoint_exists

torch.set_num_threads(1)

TINY_NET = {"type": "afterstate", "eval_channels": [4, 4], "eval_hidden": 8,
            "ctx_dim": 6, "value_channels": [4, 4], "value_hidden": 16,
            "compute_dtype": "float32"}
CFG = {
    "training": {"num_envs": 8, "rollout_steps": 8, "batch_size": 32,
                 "total_timesteps": 64 * 20},
    "ppo": {"num_epochs": 2},
    "network": TINY_NET,
}


def _cfg(tmp_path, name):
    cfg = json.loads(json.dumps(CFG))
    cfg["paths"] = {"checkpoint_dir": str(tmp_path / name / "ckpt"),
                    "log_dir": str(tmp_path / name / "logs")}
    cfg["logging"] = {"log_interval": 1, "save_interval": 0, "eval_interval": 0}
    return cfg


def _stop_after(n, rows):
    def callback(row):
        rows.append(row)
        return len(rows) < n
    return callback


def test_gui_module_imports_headless():
    import bbx_torch.gui.app as app

    q = queue.Queue()
    red = app.OutputRedirector(q, "log")
    red.write("hello\n")
    red.write("   \n")
    red.flush()
    assert q.get_nowait() == ("log", "hello\n")
    assert q.empty()


def test_progress_callback_stops_training_with_bbx_keys(tmp_path):
    rows, j_rows = [], []
    cfg = _cfg(tmp_path, "port")
    stats = train(cfg, seed=3, device="cpu", progress_callback=_stop_after(2, rows))
    j_stats = j_train(_cfg(tmp_path, "bbx"), seed=3,
                      progress_callback=_stop_after(2, j_rows))
    assert len(rows) == len(j_rows) == 2
    step = 8 * 8
    assert [r["step"] for r in rows] == [r["step"] for r in j_rows] == [step, 2 * step]
    assert stats["global_step"] == j_stats["global_step"] == 2 * step
    for row, j_row in zip(rows, j_rows):
        assert set(row) == set(j_row)
        assert all(isinstance(v, (int, float)) for v in row.values())
    assert checkpoint_exists(cfg["paths"]["checkpoint_dir"] + "/final")


def test_training_runner_stops_from_another_thread(tmp_path):
    events = queue.Queue()
    cfg = _cfg(tmp_path, "runner")
    runner = workers.TrainingRunner(cfg, events, device="cpu", seed=3)

    def stop_on_first_row():
        tag, _ = events.get(timeout=120)
        while tag != "training_update":
            tag, _ = events.get(timeout=120)
        runner.stop()

    watcher = threading.Thread(target=stop_on_first_row, daemon=True)
    watcher.start()
    stats = runner.run()
    watcher.join(timeout=10)
    assert not watcher.is_alive()
    assert stats is not None and 0 < stats["global_step"] < 64 * 20
    tags = []
    while not events.empty():
        tags.append(events.get_nowait()[0])
    assert tags[-1] == "training_done" and "train_log" in tags
    assert checkpoint_exists(cfg["paths"]["checkpoint_dir"] + "/final")


class _StopAfterRows(workers.TrainingRunner):
    """A runner that stops itself from its callback after `rows` rows."""

    def __init__(self, *args, rows: int, **kwargs):
        super().__init__(*args, **kwargs)
        self.rows, self.seen = rows, 0

    def callback(self, row):
        self.seen += 1
        if self.seen >= self.rows:
            self.stop()
        return super().callback(row)


def test_training_runner_stopped_by_its_callback(tmp_path):
    events = queue.Queue()
    runner = _StopAfterRows(_cfg(tmp_path, "rows"), events, device="cpu", seed=3, rows=2)
    stats = runner.run()
    assert runner.seen == 2 and stats["global_step"] == 2 * 64


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A seeded, freshly initialised tiny AfterstateNetwork, saved with its
    sidecar by the trainer."""
    trainer = PPOTrainer(CFG, seed=7, device="cpu")
    return trainer.save(str(tmp_path_factory.mktemp("watch")), "final")


def test_watch_frames_equal_policy_agent_on_the_env(checkpoint):
    agent = PolicyAgent.from_checkpoint(checkpoint, device="cpu")
    frames = list(workers.watch_frames(agent, seed=11, game=2, max_moves=50,
                                       device="cpu"))
    ref_agent = PolicyAgent.from_checkpoint(checkpoint, device="cpu")
    env = BlockBlastEnv(seed=11, device="cpu")
    obs, _ = env.reset(seed=11)
    done = False
    for i, frame in enumerate(frames):
        assert not done
        action, _ = ref_agent.select_action(obs, deterministic=True)
        obs, _, done, _, info = env.step(action)
        assert frame["action"] == action, i
        assert (frame["board"] == obs["board"]).all(), i
        assert (frame["score"], frame["moves"], frame["lines"], frame["game"]) == \
            (info["score"], info["moves"], info["lines_cleared"], 2), i
    assert len(frames) == 50 or done
