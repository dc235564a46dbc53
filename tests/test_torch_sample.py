"""K9, the engine path's uniform valid-action sampler
(`bbx_torch/csrc/sample.cu`), and its plain version.

The kernel is run on the CPU through the CUDA emulator (the fixtures of
`tests/test_torch_kernels_emulated.py`) and must equal the plain version
bit for bit; the plain version is held to a numpy reading of its contract
(`tests/test_torch_vector.py` holds the sampler to bbx's distribution:
chi-square, valid sets, all-false rows).
"""
import numpy as np
import pytest
import torch

from bbx_torch.engine.hashing import lane_keys, mix32
from bbx_torch.env import vector as V
from test_torch_kernels_emulated import emulated, kernels  # noqa: F401  (fixtures)

torch.set_num_threads(1)


def _masks(n, seed):
    """n masks of every density from numpy, with rows of no valid action,
    one (the first and the last action), and all 192."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n, 192)) < rng.random((n, 1))
    mask[0] = False
    mask[1] = False
    mask[1, 0] = True
    mask[2] = False
    mask[2, 191] = True
    mask[3] = True
    return torch.from_numpy(mask)


def _numpy_mix32(x):
    x ^= x >> 15
    x = (x * 0x2C1B3C6D) & 0xFFFFFFFF
    x ^= x >> 12
    x = (x * 0x297A2D39) & 0xFFFFFFFF
    return x ^ (x >> 15)


@pytest.mark.parametrize("n", [1, 37, 300])
def test_emulated_sample_kernel_matches_plain(kernels, n):
    """K9 (emulated: a warp reads 32 lanes' masks in 16-byte chunks) equals
    `sample_valid_actions_plain` bit for bit on one seed, with rows of
    none, one and 192 valid actions, and a lane count that leaves the last
    block's warps partly idle."""
    mask = _masks(max(n, 4), seed=n)[:n]
    seed = torch.tensor(2**32 - 5 - n, dtype=torch.int64)
    before = V.sample_valid_actions_device.launches
    got = V._sample_valid_actions_cuda(mask, seed)
    assert V.sample_valid_actions_device.launches == before + 1
    want = V.sample_valid_actions_plain(mask, seed)
    assert got.dtype == want.dtype == torch.int32 and torch.equal(got, want)
    assert got[0] == 0
    if n > 3:
        assert got[1] == 0 and got[2] == 191
    some = mask.any(dim=1)
    assert mask[torch.arange(n)[some], got[some].long()].all() and not got[~some].any()


def test_emulated_sample_kernel_finds_every_action(kernels):
    """K9 on rows of one valid action at each of the 192 places (every
    byte of every 16-byte chunk, every bit of every word it folds into),
    then rows of two and all 192, on several seeds: equal to the plain
    version bit for bit."""
    one = torch.eye(192, dtype=torch.bool)
    two = one | one.roll(97, dims=1)
    mask = torch.cat([one, two, torch.ones((40, 192), dtype=torch.bool)])
    assert torch.equal(V._sample_valid_actions_cuda(mask[:192], torch.tensor(9)),
                       torch.arange(192, dtype=torch.int32))
    for seed in (0, 1, 2**32 - 1):
        seed = torch.tensor(seed, dtype=torch.int64)
        assert torch.equal(V._sample_valid_actions_cuda(mask, seed),
                           V.sample_valid_actions_plain(mask, seed))


def test_emulated_sample_kernel_counts_any_nonzero_byte_as_valid(kernels):
    """A mask byte counts as valid when it is not 0 (the plain version's
    `mask > 0`), whatever its value: bytes 1, 2, 0x7F, 0x80 and 0xFF in
    a bool tensor's storage give the draws of the same mask of 0/1 bytes."""
    rng = np.random.default_rng(4)
    values = np.array([0, 0, 0, 1, 2, 0x7F, 0x80, 0xFF], dtype=np.uint8)
    raw = values[rng.integers(0, len(values), (70, 192))]
    seed = torch.tensor(123_456_789, dtype=torch.int64)
    got = V._sample_valid_actions_cuda(torch.from_numpy(raw).view(torch.bool), seed)
    assert torch.equal(got, V.sample_valid_actions_plain(torch.from_numpy(raw != 0), seed))


def test_emulated_sample_wrapper_refuses_a_misaligned_mask(kernels):
    """K9 reads the mask in 16-byte loads: a contiguous view that does not
    start on 16 bytes is refused before any launch; a whole-row slice of
    an aligned mask (192 = 12 x 16 bytes a row) is taken."""
    store = torch.zeros(50 * 192 + 16, dtype=torch.bool)
    assert store.data_ptr() % 16 == 0
    seed = torch.tensor(5, dtype=torch.int64)
    before = V.sample_valid_actions_device.launches
    for offset in (1, 8):
        with pytest.raises(ValueError, match="16-byte aligned"):
            V._sample_valid_actions_cuda(store[offset:offset + 50 * 192].view(50, 192), seed)
    assert V.sample_valid_actions_device.launches == before
    rows = store[:50 * 192].view(50, 192)[3:]
    assert torch.equal(V._sample_valid_actions_cuda(rows, seed),
                       V.sample_valid_actions_plain(rows, seed))
    assert V.sample_valid_actions_device.launches == before + 1


def test_emulated_sample_kernel_takes_an_empty_batch(kernels):
    before = V.sample_valid_actions_device.launches
    got = V._sample_valid_actions_cuda(torch.zeros((0, 192), dtype=torch.bool),
                                       torch.tensor(1, dtype=torch.int64))
    assert got.shape == (0,) and got.dtype == torch.int32
    assert V.sample_valid_actions_device.launches == before


def test_plain_sampler_takes_the_hashed_kth_valid_action():
    """The plain version against a numpy reading of the contract, with
    Python integers: u = mix32(mix32(seed) ^ lane), k = (u c) >> 32 for c
    valid actions, the lane's k-th valid action, 0 where c = 0."""
    mask = _masks(500, seed=7)
    seed = 3_000_000_019
    got = V.sample_valid_actions_plain(mask, torch.tensor(seed, dtype=torch.int64)).numpy()
    for lane, row in enumerate(mask.numpy()):
        valid = np.flatnonzero(row)
        u = _numpy_mix32(_numpy_mix32(seed) ^ lane)
        want = valid[(u * len(valid)) >> 32] if len(valid) else 0
        assert got[lane] == want, lane
    keys = lane_keys(torch.tensor(seed), torch.arange(4))
    assert keys.tolist() == [_numpy_mix32(_numpy_mix32(seed) ^ i) for i in range(4)]
    assert mix32(torch.tensor(12345)).item() == _numpy_mix32(12345)


def test_sampler_draws_one_seed_from_the_generator():
    """The dispatcher draws one int64 seed from the generator (the only
    draw: a generator advanced by one `randint` gives the same actions) and
    picks with the plain version on CPU tensors."""
    mask = _masks(64, seed=3)
    g = torch.Generator().manual_seed(11)
    got = V.sample_valid_actions_device(g, mask)
    ref = torch.Generator().manual_seed(11)
    seed = torch.randint(0, 2**32, (), generator=ref, dtype=torch.int64)
    assert torch.equal(got, V.sample_valid_actions_plain(mask, seed))
    assert torch.equal(g.get_state(), ref.get_state())
