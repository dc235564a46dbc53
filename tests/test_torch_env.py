"""The port's single env (`bbx_torch.env.single`) held against
`bbx.env.single`, on the CPU (``device="cpu"``: the engine's plain
versions).

The first tests mirror `tests/test_env.py` for the port.  The piece
streams of the two packages differ (a `torch.Generator` against
`jax.random` keys), so no seeded game of one can be held against the
other; instead both envs are put into the same state (`from_components`)
and stepped with the same action, over every transition of a game the
port plays under `sample_valid_action`, plus an invalid action and the
terminal state stepped again.  Observations, masks, info (with `holes`
and `last_move`) and `render("ansi")` must be equal exactly, the reward
within 1e-6 (bbx's XLA contracts the reward's products and sums into
fused multiply-adds on the CPU; ROADMAP.md Queue 3).  Where a move uses up
the triple, regen draws the next one from each package's own stream: the
pieces, the mask, the game-over test and the reward then depend on the
draws, and everything else is compared.
"""
import jax
import numpy as np
import pytest
import torch

from bbx.engine.state import from_components as j_from_components
from bbx.env import single as JS
from bbx_torch.engine import state as TState
from bbx_torch.engine.step import observe
from bbx_torch.env import (
    BlockBlastEnv,
    BlockBlastEnvFlat,
    NormalizedRewardWrapper,
    make_env,
    register_gym_envs,
)

torch.set_num_threads(1)

STATE_FIELDS = ("board", "piece_ids", "used", "score", "streak", "moves",
                "lines_total", "max_streak", "blocks_total", "done",
                "prev_holes", "prev_center")
REWARD_ATOL = 1e-6


@pytest.fixture(scope="module")
def env():
    return BlockBlastEnv(seed=42, device="cpu")


def test_spaces(env):
    obs, info = env.reset(seed=42)
    assert obs["board"].shape == (8, 8) and obs["board"].dtype == np.float32
    assert obs["pieces"].shape == (3, 8, 8) and obs["pieces"].dtype == np.float32
    assert obs["action_mask"].shape == (192,) and obs["action_mask"].dtype == np.int8
    assert env.action_space.n == 192
    assert env.observation_space.contains(obs)


def test_seeded_reset_reproducible(env):
    obs1, info1 = env.reset(seed=7)
    obs2, info2 = env.reset(seed=7)
    for k in obs1:
        np.testing.assert_array_equal(obs1[k], obs2[k])
    assert info1 == info2


def test_unseeded_resets_differ(env):
    env.reset(seed=3)
    assert env._episode_seed == 3
    obs1, _ = env.reset()
    obs2, _ = env.reset()
    assert env._episode_seed == 3 + 2 * 1_000_003
    assert not np.array_equal(obs1["pieces"], obs2["pieces"])


def test_invalid_action_penalty(env):
    obs, _ = env.reset(seed=42)
    invalid = np.nonzero(obs["action_mask"] == 0)[0]
    obs2, reward, term, trunc, info = env.step(int(invalid[0]))
    assert reward == -10.0
    assert not term and not trunc
    assert info["invalid_action"]
    for k in obs:
        np.testing.assert_array_equal(obs2[k], obs[k])


def test_mask_matches_valid_actions(env):
    obs, _ = env.reset(seed=42)
    mask = env.get_action_mask()
    valid = env.get_valid_actions()
    assert mask.dtype == bool and mask.sum() == len(valid)
    assert all(mask[a] for a in valid)
    np.testing.assert_array_equal(mask, obs["action_mask"] > 0)
    assert mask[env.sample_valid_action()]


def test_episode_terminates_under_random_play_and_replays(env):
    """A game under `sample_valid_action` ends; the same env seed and
    `np.random.seed` replay it move for move."""
    def play():
        np.random.seed(0)
        env.reset(seed=1)
        trail = []
        for _ in range(5000):
            a = env.sample_valid_action()
            _, r, done, _, info = env.step(a)
            trail.append((a, r, info["score"]))
            if done:
                return trail, info
        raise AssertionError("no game over in 5000 moves")

    trail, info = play()
    assert info["score"] > 0 and env.get_valid_actions() == []
    assert play()[0] == trail


def test_action_codec(env):
    assert env._action_to_move(0) == (0, 0, 0)
    assert env._action_to_move(64) == (1, 0, 0)
    assert env._action_to_move(63) == (0, 7, 7)
    assert env._move_to_action(2, 7, 7) == 191


def test_flat_env_obs_size():
    env = BlockBlastEnvFlat(seed=0, device="cpu")
    obs, _ = env.reset(seed=0)
    assert obs["obs"].shape == (178,) and obs["obs"].dtype == np.float32
    assert obs["action_mask"].shape == (192,)
    used_pieces = obs["obs"][64:64 + 111].reshape(3, 37)
    assert (used_pieces.sum(axis=1) == 1).all()


def test_ansi_render():
    env = BlockBlastEnv(render_mode="ansi", seed=0, device="cpu")
    env.reset(seed=0)
    text = env.render()
    assert "Score: 0" in text
    assert "Available pieces" in text


def test_gym_registration_under_the_ports_ids():
    """The port's ids leave bbx's `BlockBlast-v0` to bbx, and
    ``gym.make(..., device="cpu")`` reaches the port's constructor."""
    import gymnasium as gym

    assert register_gym_envs()
    JS.register_gym_envs()
    assert gym.registry["BlockBlastTorch-v0"].entry_point == "bbx_torch.env.single:BlockBlastEnv"
    assert gym.registry["BlockBlast-v0"].entry_point == "bbx.env.single:BlockBlastEnv"
    genv = gym.make("BlockBlastTorch-v0", device="cpu")
    assert genv.unwrapped.device == torch.device("cpu")
    obs, info = genv.reset(seed=5)
    assert obs["board"].shape == (8, 8)
    obs, reward, term, trunc, info = genv.step(genv.unwrapped.sample_valid_action())
    assert np.isfinite(reward)
    flat = gym.make("BlockBlastTorch-Flat-v0", device="cpu")
    assert flat.reset(seed=5)[0]["obs"].shape == (178,)


def test_make_env_factory_with_wrappers():
    env = make_env(seed=5, normalize_reward=True, frame_stack=3, device="cpu")
    obs, info = env.reset()
    assert obs["board_stack"].shape == (3, 8, 8)
    for f in obs["board_stack"]:
        np.testing.assert_array_equal(f, obs["board"])
    a = int(np.nonzero(obs["action_mask"])[0][0])
    obs2, r, term, trunc, info2 = env.step(a)
    assert obs2["board_stack"].shape == (3, 8, 8)
    np.testing.assert_array_equal(obs2["board_stack"][-1], obs2["board"])
    np.testing.assert_array_equal(obs2["board_stack"][-2], obs["board"])
    assert np.isfinite(r)


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        BlockBlastEnv(seed=0)


# ---------------------------------------------------------------------------
# Against bbx, from the same states.
# ---------------------------------------------------------------------------

class _Rewards:
    """A stand-in env that returns a fixed reward sequence."""

    def __init__(self, rewards, ends):
        self.rewards, self.ends, self.t = rewards, ends, 0

    def reset(self, *args, **kwargs):
        return {}, {}

    def step(self, action):
        r, end = self.rewards[self.t], self.ends[self.t]
        self.t += 1
        return {}, r, end, False, {}


def test_normalized_reward_wrapper_matches_bbx():
    rng = np.random.default_rng(3)
    rewards = rng.normal(0.0, 2.0, 60).tolist()
    ends = (rng.random(60) < 0.1).tolist()
    got = NormalizedRewardWrapper(_Rewards(rewards, ends))
    want = JS.NormalizedRewardWrapper(_Rewards(rewards, ends))
    got.reset()
    want.reset()
    for _ in range(60):
        assert got.step(0)[1:3] == want.step(0)[1:3]


def _transitions():
    """Every transition of a game the port plays on the CPU under
    `sample_valid_action` (state before, action), then an invalid action
    from the first state and the terminal state stepped again."""
    env = BlockBlastEnv(seed=11, device="cpu")
    np.random.seed(5)
    env.reset(seed=11)
    first = env.state
    out, done = [], False
    while not done:
        a = env.sample_valid_action()
        out.append((env.state, a))
        done = env.step(a)[2]
    out.append((first, int(np.nonzero(~_mask(first))[0][0])))
    out.append((env.state, 0))
    return out


def _mask(state):
    return observe(state)["action_mask"][0].numpy()


def _board(obs):
    return obs["board"] if "board" in obs else obs["obs"][:64].reshape(8, 8)


def _fields(state):
    return {f: getattr(state, f).numpy() for f in STATE_FIELDS}


@pytest.fixture(scope="module")
def env_pair():
    """bbx's and the port's env (ansi rendering), and the flat pair."""
    return (JS.BlockBlastEnv(render_mode="ansi", seed=0),
            BlockBlastEnv(render_mode="ansi", seed=0, device="cpu"),
            JS.BlockBlastEnvFlat(seed=0),
            BlockBlastEnvFlat(seed=0, device="cpu"))


def _put(jenv, tenv, fields):
    jenv.state = j_from_components(**fields, rng=jax.random.split(jax.random.key(0), 1))
    tenv.state = TState.from_components(**fields, rng=TState.make_generator(0, "cpu"),
                                        device="cpu")


def test_transitions_equal_bbx(env_pair):
    jenv, tenv, jflat, tflat = env_pair
    cases = _transitions()
    regens = ended = 0
    for i, (state, action) in enumerate(cases):
        fields = _fields(state)
        # A valid move with two slots used takes the last piece: regen.
        regen = bool(fields["used"].sum() == 2 and _mask(state)[action])
        regens += regen
        for je, te in ((jenv, tenv), (jflat, tflat)):
            _put(je, te, fields)
            jo, jr, jt, jtr, ji = je.step(action)
            to, tr, tt, ttr, ti = te.step(action)
            assert ti == ji, (i, ti, ji)
            assert ttr is jtr is False
            if regen:
                np.testing.assert_array_equal(_board(to), _board(jo))
                continue
            assert tt == jt, i
            ended += tt
            assert abs(tr - jr) <= REWARD_ATOL, (i, tr, jr)
            assert set(to) == set(jo)
            for k in jo:
                np.testing.assert_array_equal(to[k], jo[k], err_msg=f"case {i}: {k}")
                assert to[k].dtype == jo[k].dtype, k
        if not regen:
            assert tenv.render() == jenv.render(), i
    assert len(cases) >= 10 and regens >= 1, (len(cases), regens)
    # The game's last move ended it (in both envs); the terminal state
    # stepped again took the invalid-action path.
    assert ended == 2 and ji["invalid_action"] and tt is False


def test_reset_info_and_render_equal_bbx(env_pair):
    """After a reset the info and the frame depend on the drawn triple only
    through the pieces: with the port's triple put into bbx's env, both
    equal."""
    jenv, tenv, _, _ = env_pair
    tobs, tinfo = tenv.reset(seed=3)
    jenv.state = j_from_components(**_fields(tenv.state),
                                   rng=jax.random.split(jax.random.key(0), 1))
    jobs, jinfo = jenv._get_observation(), jenv._get_info()
    assert tinfo == jinfo
    for k in jobs:
        np.testing.assert_array_equal(tobs[k], jobs[k])
    assert tenv.render() == jenv.render()
