"""PyTorch port, the threefry PRNG on the CPU: ``lightgbm_tpu_torch.ops.
threefry`` against ``jax.random`` (jax's default ``threefry2x32`` with
``jax_threefry_partitionable``). Keys, ``fold_in`` chains (with Python
ints and with 0-d tensors), raw bits and float32 uniforms are bit-equal
at every listed seed and shape, and a draw does not depend on the shape
it is made at."""

import jax
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import threefry

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the same results,
    and far less CPU time when several test workers share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEEDS = [0, 3, 2 ** 31 - 1]
SHAPES = [(1,), (7,), (4096,), (3, 1001), (7, 581)]


def _same_key(jk, tk) -> bool:
    """JAX's uint32 words against the port's int32-held words."""
    return np.array_equal(np.asarray(jk).view(np.int32), tk.numpy())


def _chain(seed, datas, as_tensor):
    jk, tk = jax.random.PRNGKey(seed), threefry.prng_key(seed)
    for d in datas:
        jk = jax.random.fold_in(jk, d)
        tk = threefry.fold_in(tk, torch.tensor(d) if as_tensor else d)
    return jk, tk


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_fold_in_chains(seed):
    jk, tk = jax.random.PRNGKey(seed), threefry.prng_key(seed)
    assert tk.dtype == torch.int32 and tk.shape == (2,)
    assert _same_key(jk, tk)
    for datas in ([0], [1, 2], [7, 0, 12345], [2 ** 31 - 1, 5]):
        for as_tensor in (False, True):
            jk2, tk2 = _chain(seed, datas, as_tensor)
            assert _same_key(jk2, tk2)
    # a 0-d int64 tensor, as the booster's iteration buffer holds it
    it = torch.zeros((), dtype=torch.int64).fill_(9)
    assert _same_key(jax.random.fold_in(jk, 9), threefry.fold_in(tk, it))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform(seed, shape):
    jk, tk = _chain(seed, [4, 1], as_tensor=True)
    jb = np.asarray(jax.random.bits(jk, shape))
    tb = threefry.random_bits(tk, shape)
    assert tuple(tb.shape) == shape
    assert np.array_equal(jb.view(np.int32), tb.numpy())
    ju = np.asarray(jax.random.uniform(jk, shape))
    tu = threefry.uniform(tk, shape)
    assert tu.dtype == torch.float32 and tuple(tu.shape) == shape
    assert np.array_equal(ju.view(np.int32), tu.numpy().view(np.int32))
    assert float(tu.min()) >= 0.0 and float(tu.max()) < 1.0


def test_draw_does_not_depend_on_shape():
    tk = threefry.fold_in(threefry.prng_key(3), 2)
    full = threefry.uniform(tk, (1000,))
    assert torch.equal(full[:777], threefry.uniform(tk, (777,)))
    assert torch.equal(threefry.uniform(tk, (2, 500)).reshape(-1), full)


def test_batched_keys_match_one_at_a_time():
    """Keys [K, 2]: fold_in with a [K] tensor of data and uniform draw
    each key's own values (the class-batched build's per-class keys)."""
    jk = jax.random.fold_in(jax.random.PRNGKey(11), 4)
    tk = threefry.fold_in(threefry.prng_key(11), 4)
    keys = threefry.fold_in(tk, torch.arange(5))
    assert keys.shape == (5, 2)
    u = threefry.uniform(threefry.fold_in(keys, 1), (6, 9))
    assert u.shape == (5, 6, 9)
    for k in range(5):
        jkk = jax.random.fold_in(jk, k)
        assert _same_key(jkk, keys[k])
        want = np.asarray(jax.random.uniform(jax.random.fold_in(jkk, 1),
                                             (6, 9)))
        assert np.array_equal(u[k].numpy().view(np.int32),
                              want.view(np.int32))
