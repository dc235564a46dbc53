"""The port's board helpers, dense tables and dense solvability oracles
held against `bbx`.

The same boards and piece ids, made from numpy seeds (or by the port's
engine under numpy-chosen moves), go through the JAX function (jitted once
per module, on the CPU) and its PyTorch counterpart on the CPU.  All
outputs are integers or booleans and must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbx.engine import kernel as JK
from bbx.engine import solvability as JS
from bbx.engine import tables as JT
from bbx_torch.engine import kernel as TK
from bbx_torch.engine import solvability as TS
from bbx_torch.engine import state as TState
from bbx_torch.engine.step import observe, step
from bbx_torch.engine.tables import dense_tables

torch.set_num_threads(1)

_j_all = jax.jit(JK.valid_anchors_all_pieces)
_j_for = jax.jit(JK.valid_anchors_for)
_j_place = jax.jit(JK.place)
_j_clear_flat = jax.jit(JK.clear_lines_flat)
_j_pholes = jax.jit(JK.count_potential_holes)
_j_height = jax.jit(JK.height_map)
_j_bump = jax.jit(JK.bumpiness)
_j_mask = jax.jit(JK.action_mask)
_j_disjoint = jax.jit(JS.solvable_disjoint)
_j_full = jax.jit(JS.solvable_full)


def _boards(which, n=48):
    """Boards [n, 8, 8] uint8 and a random triple for each."""
    rng = np.random.default_rng({"random": 1, "raw": 2, "reachable": 3}[which])
    ids = rng.integers(0, 37, (n, 3)).astype(np.int32)
    if which == "reachable":
        state = TState.reset(n, TState.make_generator(3, "cpu"), "cpu")
        obs = observe(state)
        for _ in range(14):
            acts = torch.tensor([rng.choice(np.flatnonzero(m))
                                 for m in obs["action_mask"].numpy()])
            out = step(state, acts, auto_reset=True)
            state, obs = out.state, out.obs
        return state.board.numpy(), ids
    fills = rng.uniform(0.1, 0.9, n)
    board = (rng.random((n, 8, 8)) < fills[:, None, None]).astype(np.uint8)
    if which == "random":  # full lines cleared, as on a reachable board
        board = np.asarray(JK.clear_lines(jnp.asarray(board))[0])
    return board, ids


@pytest.mark.parametrize("name", ["PAIR_CONFLICT", "OCC_T_BF16"])
def test_dense_table_equal(name):
    got = getattr(dense_tables("cpu"), name)
    want = np.asarray(getattr(JT, name))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


@pytest.mark.parametrize("which", ["random", "raw", "reachable"])
def test_board_helpers_equal(which):
    board, ids = _boards(which)
    n = board.shape[0]
    jb, tb = jnp.asarray(board), torch.from_numpy(board.copy())
    rng = np.random.default_rng(4)
    used = rng.random((n, 3)) < 0.3
    all_valid = TK.valid_anchors_all_pieces(tb)
    j_all = _j_all(jb)
    np.testing.assert_array_equal(all_valid.numpy(), np.asarray(j_all))
    assert all_valid.any() and (~all_valid).any()
    np.testing.assert_array_equal(
        TK.valid_anchors_for(tb, torch.from_numpy(ids)).numpy(),
        np.asarray(_j_for(jb, jnp.asarray(ids))))
    np.testing.assert_array_equal(
        TK.gather_piece_validity(all_valid, torch.from_numpy(ids)).numpy(),
        np.asarray(JK.gather_piece_validity(j_all, jnp.asarray(ids))))
    np.testing.assert_array_equal(
        TK.action_mask(all_valid, torch.from_numpy(ids), torch.from_numpy(used)).numpy(),
        np.asarray(_j_mask(j_all, jnp.asarray(ids), jnp.asarray(used))))
    anchor = rng.integers(0, 64, n).astype(np.int32)
    got = TK.place(tb, torch.from_numpy(ids[:, 0]), torch.from_numpy(anchor))
    want = np.asarray(_j_place(jb, jnp.asarray(ids[:, 0]), jnp.asarray(anchor)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.uint8
    # Clears on boards with lines completed by the placement, flat, with an
    # extra leading dimension.
    flat = want.reshape(n // 2, 2, 64)
    np.testing.assert_array_equal(TK.clear_lines_flat(torch.from_numpy(flat.copy())).numpy(),
                                  np.asarray(_j_clear_flat(jnp.asarray(flat))))
    for t_fn, j_fn in ((TK.count_potential_holes, _j_pholes),
                       (TK.height_map, _j_height), (TK.bumpiness, _j_bump)):
        got, want = t_fn(tb), np.asarray(j_fn(jb))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.numpy().dtype == want.dtype


@pytest.mark.parametrize("which", ["random", "reachable"])
def test_dense_oracles_equal(which):
    """`solvable_disjoint` and `solvable_full` equal bbx's, and the dense
    exact verdict equals the bitboard tiers' ``disjoint | exact``."""
    board, ids = _boards(which)
    tb, tids = torch.from_numpy(board.copy()), torch.from_numpy(ids)
    v3 = TS.valid3_bits(TS.board_bits(tb), tids)
    disjoint = TS.solvable_disjoint(v3, tids)
    np.testing.assert_array_equal(
        disjoint.numpy(), np.asarray(_j_disjoint(jnp.asarray(v3.numpy()), jnp.asarray(ids))))
    full = TS.solvable_full(tb, tids)
    np.testing.assert_array_equal(full.numpy(),
                                  np.asarray(_j_full(jnp.asarray(board), jnp.asarray(ids))))
    bits = TS.board_bits(tb)
    fast = TS.solvable_disjoint_bits(bits, tids, v3)
    np.testing.assert_array_equal(disjoint.numpy(), fast.numpy())
    np.testing.assert_array_equal(
        full.numpy(), (fast | TS.solvable_exact_bits(bits, tids, v3)).numpy())
    assert full.any() and (~full).any() and (full & ~disjoint).any()
