"""The port's engine (`bbx_torch.engine`) held against `bbx.engine`.

The same inputs, made from numpy seeds, go through the JAX function (jitted
once per module, on the CPU) and its PyTorch counterpart (device "cpu", so
every dispatching wrapper takes its plain version).  Engine outputs are
integers and booleans, and the comparisons are exact unless a docstring
says otherwise.  The CUDA kernels are held against these plain versions on
the card by `tests/test_torch_kernels.py`.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from bbx.engine import kernel as JK
from bbx.engine import pieces as JP
from bbx.engine import solvability as JS
from bbx.engine import tables as JT
from bbx.engine.parity import ParityEngine as JParityEngine
from bbx.engine.state import _verdict_flat
from bbx.engine.state import from_components as j_from_components
from bbx.engine.step import RewardConfig as JRewardConfig
from bbx.engine.step import _move_core as j_move_core
from bbx.engine.step import observe as j_observe
from bbx.engine.step import step as j_step
from bbx_torch.engine import kernel as TK
from bbx_torch.engine import pieces as TP
from bbx_torch.engine import solvability as TS
from bbx_torch.engine import state as TState
from bbx_torch.engine.parity import ParityEngine as TParityEngine
from bbx_torch.engine.step import _move_core as t_move_core
from bbx_torch.engine.step import observe as t_observe
from bbx_torch.engine.step import step as t_step
from bbx_torch.engine.tables import tables as t_tables

torch.set_num_threads(1)

# JAX oracles, jitted once for the whole module.
_j_clear = jax.jit(JK.clear_lines)
_j_holes = jax.jit(JK.count_holes)
_j_center = jax.jit(JK.center_openness)
_j_total = jax.jit(JK.total_blocks)
_j_valid3 = jax.jit(JS.valid3_bits)
_j_disjoint = jax.jit(JS.solvable_disjoint_bits)
_j_exact = jax.jit(JS.solvable_exact_bits)
_j_clear_bits = jax.jit(JS.clear_lines_bits)
_j_move = jax.jit(j_move_core)
_j_observe = jax.jit(j_observe)
_j_step = jax.jit(lambda s, a: j_step(s, a, JRewardConfig(), auto_reset=False))


_j_verdict_flat = jax.jit(partial(_verdict_flat, ke=16))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _random_boards(seed, n):
    """Random boards at fills 10-90%, with their full lines cleared."""
    rng = np.random.default_rng(seed)
    fills = rng.uniform(0.1, 0.9, n)
    raw = (rng.random((n, 8, 8)) < fills[:, None, None]).astype(np.uint8)
    return raw, np.asarray(_j_clear(jnp.asarray(raw))[0])


def _play(n, moves, seed):
    """Reachable mid-game states: the port's fleet under random valid moves
    (numpy-chosen, auto-reset on)."""
    rng = np.random.default_rng(seed)
    state = TState.reset(n, TState.make_generator(seed, "cpu"), "cpu")
    obs = t_observe(state)
    for _ in range(moves):
        mask = obs["action_mask"].numpy()
        acts = [rng.choice(np.flatnonzero(m)) for m in mask]
        out = t_step(state, torch.tensor(acts), auto_reset=True)
        state, obs = out.state, out.obs
    return state


@pytest.fixture(scope="module")
def reachable():
    """64 reachable boards with one random triple each."""
    state = _play(64, 14, seed=5)
    ids = np.random.default_rng(6).integers(0, 37, (64, 3)).astype(np.int32)
    return state, state.board.numpy(), ids


def _boards_and_ids(reachable, which):
    if which == "reachable":
        _, board, ids = reachable
        return board, ids
    _, board = _random_boards(1, 96)
    return board, np.random.default_rng(2).integers(0, 37, (96, 3)).astype(np.int32)


# ---------------------------------------------------------------------------
# Tables.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "PIECE_NAMES", "PIECE_OFFSETS", "PIECE_HEIGHTS", "PIECE_WIDTHS",
    "PIECE_NBLOCKS", "PIECE_MASKS", "ANCHOR_OK", "PLACEMENT", "PAIR_CONFLICT",
    "PLACE_BITS", "NO_CONFLICT_BITS", "PIECE_SHIFTS", "ANCHOR_OK_BITS",
])
def test_pieces_table_equal(name):
    want, got = getattr(JP, name), getattr(TP, name)
    if isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
        assert got.shape == want.shape
    else:
        assert got == want


@pytest.mark.parametrize("name", [
    "PIECE_MASKS", "PIECE_NBLOCKS", "ANCHOR_OK", "PLACEMENT", "PLACE_BITS",
    "NO_CONFLICT_BITS", "PIECE_SHIFTS", "ANCHOR_OK_BITS",
])
def test_device_table_equal(name):
    got = getattr(t_tables("cpu"), name).numpy()
    want = np.asarray(getattr(JT, name))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(got.dtype))


def test_u64_tables_combine_the_words():
    tb = t_tables("cpu")
    for u64, words in ((tb.PLACE_U64, JP.PLACE_BITS),
                       (tb.NO_CONFLICT_U64, JP.NO_CONFLICT_BITS),
                       (tb.ANCHOR_OK_U64, JP.ANCHOR_OK_BITS)):
        u = u64.numpy().view(np.uint64)
        np.testing.assert_array_equal(u & np.uint64(0xFFFFFFFF), words[..., 0])
        np.testing.assert_array_equal(u >> np.uint64(32), words[..., 1])
    np.testing.assert_array_equal(tb.PIECE_SHIFTS_I32.numpy(), JP.PIECE_SHIFTS)


# ---------------------------------------------------------------------------
# Board ops and the action codec.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["random", "reachable", "raw"])
def test_board_ops_equal(reachable, which):
    if which == "raw":
        board, _ = _random_boards(3, 96)  # with full lines still on the board
    else:
        board, _ = _boards_and_ids(reachable, which)
    jb, tb = jnp.asarray(board), torch.from_numpy(board.copy())
    for got, want in zip(TK.clear_lines(tb), _j_clear(jb)):
        np.testing.assert_array_equal(_np(got), _np(want))
        assert _np(got).dtype == _np(want).dtype
    np.testing.assert_array_equal(_np(TK.count_holes(tb)), _np(_j_holes(jb)))
    np.testing.assert_array_equal(_np(TK.center_openness(tb)), _np(_j_center(jb)))
    np.testing.assert_array_equal(_np(TK.total_blocks(tb)), _np(_j_total(jb)))


def test_action_codec_equal():
    a = np.arange(192, dtype=np.int32)
    for got, want in zip(TK.decode_action(torch.from_numpy(a)),
                         JK.decode_action(jnp.asarray(a))):
        np.testing.assert_array_equal(_np(got), _np(want))
    s, r, c = np.meshgrid(np.arange(3), np.arange(8), np.arange(8), indexing="ij")
    np.testing.assert_array_equal(
        _np(TK.encode_action(torch.from_numpy(s), torch.from_numpy(r),
                             torch.from_numpy(c))),
        _np(JK.encode_action(jnp.asarray(s), jnp.asarray(r), jnp.asarray(c))))
    assert TK.empty_boards(3, "cpu").shape == (3, 8, 8)


# ---------------------------------------------------------------------------
# Bitboards and the plain versions of K1-K3.
# ---------------------------------------------------------------------------

def test_bitboard_pack_unpack_clear_equal():
    raw, board = _random_boards(4, 128)
    for b in (raw, board):
        flat = b.reshape(-1, 64)
        jbits = JS.pack_cells(jnp.asarray(flat))
        tbits = TS.pack_cells(torch.from_numpy(flat.copy()))
        np.testing.assert_array_equal(_np(tbits), np.asarray(jbits).astype(np.int64))
        np.testing.assert_array_equal(_np(TS.unpack_cells(tbits)), flat > 0)
        np.testing.assert_array_equal(
            _np(TS.clear_lines_bits(tbits)),
            np.asarray(_j_clear_bits(jbits)).astype(np.int64))
        np.testing.assert_array_equal(
            _np(TS.board_bits(torch.from_numpy(b.copy()))),
            np.asarray(JS.board_bits(jnp.asarray(b))).astype(np.int64))


@pytest.mark.parametrize("which", ["random", "reachable"])
def test_verdict_plain_versions_equal(reachable, which):
    """K1-K3's plain versions == `valid3_bits`, `solvable_disjoint_bits`,
    `solvable_exact_bits` on >= 64 boards x draws (exact)."""
    board, ids = _boards_and_ids(reachable, which)
    jbits = JS.board_bits(jnp.asarray(board))
    tbits = TS.board_bits(torch.from_numpy(board.copy()))
    jids, tids = jnp.asarray(ids), torch.from_numpy(ids)
    jv3 = _j_valid3(jbits, jids)
    tv3 = TS.valid3_bits(tbits, tids)
    np.testing.assert_array_equal(_np(tv3), np.asarray(jv3))
    dj = np.asarray(_j_disjoint(jbits, jids, jv3))
    np.testing.assert_array_equal(_np(TS.solvable_disjoint_bits(tbits, tids, tv3)), dj)
    ej = np.asarray(_j_exact(jbits, jids, jv3))
    np.testing.assert_array_equal(_np(TS.solvable_exact_bits(tbits, tids, tv3)), ej)
    # Both tiers must say something on this data: some draws accepted by
    # each, and some rejected by the exact tier.
    assert dj.any() and (~dj).any() and ej.any() and (~ej).any()


def test_empty_board_lemma_exhaustive():
    """Every triple of the 37 pieces has 3 pairwise-disjoint placements on an
    empty board, so `fresh_pieces` may skip the retry loop.  The predicate is
    permutation-invariant: the 9,139 sorted triples cover all 37**3 draws."""
    triples = np.array(
        [(a, b, c) for a in range(37) for b in range(a, 37) for c in range(b, 37)],
        dtype=np.int32)
    ids = torch.from_numpy(triples)
    bits = torch.zeros((len(triples), 2), dtype=torch.int64)
    for start in range(0, len(triples), 2048):
        sl = slice(start, start + 2048)
        v3 = TS.valid3_bits(bits[sl], ids[sl])
        ok = TS.solvable_disjoint_bits(bits[sl], ids[sl], v3)
        assert bool(ok.all()), f"empty-board lemma violated in chunk {start}"


# ---------------------------------------------------------------------------
# Move core, observe, step.
# ---------------------------------------------------------------------------

def _states_pair(state, done=None):
    """The same batch as a bbx EnvState and a bbx_torch EnvState."""
    n = state.num_envs
    done = state.done.numpy() if done is None else done
    fields = dict(
        board=state.board.numpy(), piece_ids=state.piece_ids.numpy(),
        used=state.used.numpy(), score=state.score.numpy(),
        streak=state.streak.numpy(), moves=state.moves.numpy(),
        lines_total=state.lines_total.numpy(),
        max_streak=state.max_streak.numpy(),
        blocks_total=state.blocks_total.numpy(), done=done,
        prev_holes=state.prev_holes.numpy(),
        prev_center=state.prev_center.numpy(),
    )
    js = j_from_components(**fields, rng=jax.random.split(jax.random.key(0), n))
    ts = TState.from_components(**fields, rng=TState.make_generator(0, "cpu"),
                                device="cpu")
    return js, ts


def test_move_core_and_observe_equal(reachable):
    """Every output of `_move_core` and `observe`, invalid actions included
    (random actions over all 192, used slots, finished lanes)."""
    state, _, _ = reachable
    done = np.zeros(state.num_envs, bool)
    done[::7] = True
    js, ts = _states_pair(state, done)
    acts = np.random.default_rng(8).integers(0, 192, state.num_envs).astype(np.int32)
    jout = _j_move(js, jnp.asarray(acts))
    tout = t_move_core(ts, torch.from_numpy(acts))
    # The port's move core also returns the new board's holes, centre
    # openness, fill and bitboard (the port keeps bbx's u32 words as int64),
    # which bbx's step computes right after it, and regen's need flag.
    new_board, used_after, valid = jout[3], jout[11], jout[0]
    jout = (*jout, _j_holes(new_board), _j_center(new_board), _j_total(new_board),
            np.asarray(JS.board_bits(new_board)).astype(np.int64),
            used_after.all(axis=1) & valid)
    assert len(tout) == len(jout) == 17
    for i, (got, want) in enumerate(zip(tout, jout)):
        np.testing.assert_array_equal(_np(got), np.asarray(want), err_msg=f"output {i}")
        assert _np(got).dtype == np.asarray(want).dtype, f"output {i}"
    valid = np.asarray(jout[0])
    assert valid.any() and (~valid).any()
    jo, to = _j_observe(js), t_observe(ts)
    for k in ("board", "pieces", "action_mask"):
        np.testing.assert_array_equal(_np(to[k]), np.asarray(jo[k]), err_msg=k)


def test_step_without_regen_equal(reachable):
    """One batched step (auto_reset=False) on lanes that need no regen:
    every state field, the obs and every info key equal; the reward and the
    episode return built from it within atol 1e-6 (float32 sums of the same
    terms, which XLA may fuse into other roundings)."""
    state, _, _ = reachable
    # At most one slot used before the move: no lane uses up its triple.
    used = state.used.numpy().copy()
    used[:, 1:] = False
    state = state.replace(used=torch.from_numpy(used))
    js, ts = _states_pair(state)
    rng = np.random.default_rng(9)
    mask = t_observe(ts)["action_mask"].numpy()
    acts = np.array([rng.choice(np.flatnonzero(m)) if m.any() and i % 5 else
                     rng.integers(192) for i, m in enumerate(mask)], np.int32)
    jout = _j_step(js, jnp.asarray(acts))
    tout = t_step(ts, torch.from_numpy(acts), auto_reset=False)
    for f in ("board", "piece_ids", "used", "score", "streak", "moves",
              "lines_total", "max_streak", "blocks_total", "done",
              "prev_holes", "prev_center", "ep_len"):
        got, want = _np(getattr(tout.state, f)), np.asarray(getattr(jout.state, f))
        np.testing.assert_array_equal(got, want, err_msg=f)
        assert got.dtype == want.dtype, f
    for got, want in ((tout.reward, jout.reward),
                      (tout.state.ep_return, jout.state.ep_return),
                      (tout.info["final_return"], jout.info["final_return"])):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_np(tout.done), np.asarray(jout.done))
    assert set(tout.info) == set(jout.info)
    for k in set(jout.info) - {"final_return"}:
        np.testing.assert_array_equal(_np(tout.info[k]), np.asarray(jout.info[k]),
                                      err_msg=k)
    for k in jout.obs:
        np.testing.assert_array_equal(_np(tout.obs[k]), np.asarray(jout.obs[k]),
                                      err_msg=k)
    assert (acts != mask.argmax(1)).any()


def test_step_auto_reset_lanes():
    """Lanes that end a game under auto_reset start fresh: empty board,
    counters zero, done False, and an observation mask equal to ANCHOR_OK of
    their new pieces."""
    rng = np.random.default_rng(10)
    state = TState.reset(16, TState.make_generator(10, "cpu"), "cpu")
    obs = t_observe(state)
    ended = 0
    for _ in range(80):
        mask = obs["action_mask"].numpy()
        acts = torch.tensor([rng.choice(np.flatnonzero(m)) for m in mask])
        out = t_step(state, acts, auto_reset=True)
        d = out.done.numpy()
        if d.any():
            ended += int(d.sum())
            st = out.state
            assert (st.board[d] == 0).all() and not st.done[d].any()
            for f in ("score", "streak", "moves", "lines_total", "ep_len"):
                assert (getattr(st, f)[d] == 0).all(), f
            aok = t_tables("cpu").ANCHOR_OK[st.piece_ids[d].long()]
            np.testing.assert_array_equal(
                out.obs["action_mask"][d].numpy(), aok.reshape(-1, 192).numpy())
            assert (out.info["final_score"][d] > 0).all()
        state, obs = out.state, out.obs
    assert ended > 0


# ---------------------------------------------------------------------------
# Regen.
# ---------------------------------------------------------------------------

def test_regen_picks_first_accepted_draw(reachable):
    """On lanes that regen, the chosen triple is the first of the lane's
    draws ``regen_draw(seed, lane, j)``, j = 0, 1, ..., that bbx's verdict
    (`_verdict_flat`) accepts, and `attempts` counts the draws it took;
    other lanes keep their pieces with 0 attempts."""
    state, board, ids = reachable
    n = state.num_envs
    need = np.arange(n) % 4 != 0
    seed = torch.tensor(11, dtype=torch.int64)
    bits = TS.board_bits(torch.from_numpy(board))
    got, attempts = TState.regen_pieces(bits, torch.from_numpy(ids), seed,
                                        torch.from_numpy(need))
    got, attempts = got.numpy(), attempts.numpy()
    jbits = JS.board_bits(jnp.asarray(board))
    # Replay: each round draws attempt j for the lanes still open.
    todo = np.flatnonzero(need)
    want, want_att = ids.copy(), np.zeros(n, np.int32)
    for j in range(TState.MAX_REGEN_ATTEMPTS):
        if len(todo) == 0:
            break
        draws = TState.regen_draw(seed, torch.from_numpy(todo), j).numpy()
        # Padded to n rows so the oracle compiles once.
        pad = n - len(todo)
        ok = np.asarray(_j_verdict_flat(
            jbits[np.concatenate([todo, np.zeros(pad, int)])],
            jnp.asarray(np.concatenate([draws, np.zeros((pad, 3), np.int32)])),
            jnp.asarray(np.arange(n) < len(todo))))[:len(todo)]
        want[todo], want_att[todo] = draws, j + 1
        todo = todo[~ok]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(attempts, want_att)
    np.testing.assert_array_equal(got[~need], ids[~need])
    assert (attempts[~need] == 0).all() and (attempts[need] >= 1).all()
    assert attempts.max() > 1  # some lane needed a second draw


def test_step_reports_regen_attempts():
    """`step` returns regen's attempts: those of `regen_pieces` on the new
    board's bits with the step's seed (the generator's first draw of the
    step), 0 on lanes that keep their triple, and the ids it chose (on
    lanes whose game goes on)."""
    rng = np.random.default_rng(12)
    state = TState.reset(32, TState.make_generator(12, "cpu"), "cpu")
    obs = t_observe(state)
    seen = 0
    for _ in range(9):
        acts = torch.tensor([rng.choice(np.flatnonzero(m))
                             for m in obs["action_mask"].numpy()], dtype=torch.int32)
        rng_state = state.rng.get_state()
        moved = t_move_core(state, acts)
        need = moved[11].all(dim=1) & moved[0]
        seed = TState.regen_seed(state.rng, "cpu")
        ids, attempts = TState.regen_pieces(TS.board_bits(moved[3]), state.piece_ids,
                                            seed, need)
        state.rng.set_state(rng_state)
        out = t_step(state, acts, auto_reset=True)
        assert out.regen_attempts.dtype == torch.int32
        assert torch.equal(out.regen_attempts, attempts)
        kept = ~out.done  # lanes that ended a game draw fresh pieces
        assert torch.equal(out.state.piece_ids[kept], ids[kept])
        assert (attempts[~need] == 0).all() and (attempts[need] >= 1).all()
        seen += int(need.sum())
        state, obs = out.state, out.obs
    assert seen > 0


def test_regen_exhaustion_keeps_the_100th_draw():
    """On a full board no piece fits, so no triple is solvable: every lane
    in need spends all 100 attempts and keeps its 100th draw."""
    n = 5
    need = torch.tensor([True, False, True, True, False])
    ids = torch.full((n, 3), 4, dtype=torch.int32)
    seed = torch.tensor(2**32 - 3, dtype=torch.int64)
    bits = TS.board_bits(torch.ones((n, 8, 8), dtype=torch.uint8))
    got, attempts = TState.regen_pieces(bits, ids, seed, need)
    assert attempts.tolist() == [100, 0, 100, 100, 0]
    last = TState.regen_draw(seed, torch.arange(n), TState.MAX_REGEN_ATTEMPTS - 1)
    assert torch.equal(got[need], last[need])
    assert torch.equal(got[~need], ids[~need])
    jbits = JS.board_bits(jnp.ones((n, 8, 8), jnp.uint8))
    assert not np.asarray(_j_verdict_flat(jbits, jnp.asarray(last.numpy()),
                                          jnp.ones(n, bool))).any()


def test_regen_draws_uniform_chi_square():
    """Regen's draws are uniform over the 37 shapes: on empty boards every
    first draw is accepted, so regen returns ``regen_draw(seed, lane, 0)``;
    chi-square over its 9,000 ids below the 0.1% critical value of
    chi2(36) = 67.985."""
    n = 3000
    seed = torch.tensor(12, dtype=torch.int64)
    got, attempts = TState.regen_pieces(
        TS.board_bits(TK.empty_boards(n, "cpu")),
        torch.zeros((n, 3), dtype=torch.int32), seed, torch.ones(n, dtype=torch.bool))
    assert (attempts == 1).all()
    assert torch.equal(got, TState.regen_draw(seed, torch.arange(n), 0))
    draws = got.numpy().ravel()
    assert draws.min() >= 0 and draws.max() < 37
    counts = np.bincount(draws, minlength=37)
    expected = draws.size / 37
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 67.985, (chi2, counts)


@pytest.mark.parametrize("pair", ["attempts", "lanes", "slots"])
def test_regen_draw_pairs_chi_square(pair):
    """Neighbouring draws are independent: the 37 x 37 table of (shape,
    shape) pairs of consecutive attempts of a lane, of the same attempt of
    neighbouring lanes, and of two slots of one draw is uniform, chi-square
    over 74,000 pairs below the 0.1% critical value of chi2(1368)."""
    lanes, att = 1000, 75
    seed = torch.tensor(0xDEADBEEF, dtype=torch.int64)
    d = TState.regen_draw(seed, torch.arange(lanes)[:, None],
                          torch.arange(att)[None, :]).numpy()   # [lanes, att, 3]
    if pair == "attempts":
        a, b = d[:, :-1, 0], d[:, 1:, 0]
    elif pair == "lanes":
        a, b = d[:-1, :, 1], d[1:, :, 1]
    else:
        a, b = d[:, :, 0], d[:, :, 2]
    a, b = a.ravel()[:74_000], b.ravel()[:74_000]
    assert a.size == 74_000
    counts = np.bincount(a * 37 + b, minlength=37 * 37)
    expected = a.size / (37 * 37)
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < scipy.stats.chi2.ppf(0.999, 37 * 37 - 1), chi2


# ---------------------------------------------------------------------------
# ParityEngine, move for move.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2024])
def test_parity_engine_move_for_move(seed):
    """Both packages' ParityEngine on one seed and one shared stream of
    random valid moves: equal board, pieces, used flags, score, combo,
    counters and game-over point at every move."""
    je, te = JParityEngine(seed), TParityEngine(seed, device="cpu")
    moves_rng = np.random.default_rng(seed + 1)
    n = 0
    while True:
        np.testing.assert_array_equal(te.board, je.board)
        np.testing.assert_array_equal(te.piece_ids, je.piece_ids)
        np.testing.assert_array_equal(te.used, je.used)
        assert (te.score, te.combo_count, te.moves_made, te.total_lines_cleared,
                te.max_combo, te.total_blocks_placed, te.game_over) == (
                je.score, je.combo_count, je.moves_made, je.total_lines_cleared,
                je.max_combo, je.total_blocks_placed, je.game_over)
        if je.game_over:
            break
        vm = je.get_valid_moves()
        assert te.get_valid_moves() == vm
        mv = vm[moves_rng.integers(len(vm))]
        assert je.make_move(*mv) and te.make_move(*mv)
        n += 1
    assert n >= 5
    assert not te.make_move(0, 0, 0)
