"""The port's counter hash and draws are bit-equal to agarcl_tpu/prng.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agarcl_tpu import prng as JP
from agarcl_tpu_torch import prng as TP

SEEDS = np.array([0, 1, 7, 12345, 2**31 - 1, 2**31, 2**32 - 3, 2**32 - 1],
                 np.uint32)
TICKS = np.array([-1, 0, 1, 119, 120, 4001, 2**20, 2**31 - 1], np.int64)


def _grid():
    s, t, slot = np.meshgrid(SEEDS, TICKS, np.arange(0, 600, 37),
                             indexing="ij")
    return s, t, slot


def _both(fn_j, fn_t, *lead, stream=3):
    s, t, slot = _grid()
    outs = []
    for axis in (0, 1):
        j = np.asarray(fn_j(*lead, jnp.asarray(s), stream,
                            jnp.asarray(t.astype(np.int32)),
                            jnp.asarray(slot), axis))
        p = fn_t(*lead, torch.from_numpy(s.astype(np.int64)), stream,
                 torch.from_numpy(t), torch.from_numpy(slot), axis).numpy()
        outs.append((j, p))
    return outs


# (tick, slot) pairs of the Python-int counters, INIT_TICK among them
INT_TICK_SLOTS = [(-1, 0), (0, 1), (119, 37), (4001, 599),
                  (2**31 - 1, 2**31 - 1), (-(2**30), 2**32 - 1)]


def _int_forms(fn_j, fn_t, *lead):
    """(JAX, torch with tensor counters, torch with Python-int counters)
    over 64 random seeds, for every stream, each (tick, slot) of
    INT_TICK_SLOTS and both axes."""
    seeds = np.random.default_rng(15).integers(0, 2**32, 64,
                                               dtype=np.uint64)
    s = torch.from_numpy(seeds.astype(np.int64))
    for stream in range(1, 8):
        for tick, slot in INT_TICK_SLOTS:
            for axis in (0, 1):
                c = (stream, tick, slot, axis)
                j = np.asarray(fn_j(*lead, jnp.asarray(seeds.astype(
                    np.uint32)), *(np.uint32(v & 0xFFFFFFFF) for v in c)))
                t = fn_t(*lead, s, *map(torch.tensor, c)).numpy()
                p = fn_t(*lead, s, *c).numpy()
                yield j, t, p


@pytest.mark.parametrize("counters", ["tensor", "int"])
def test_hash_u32_bit_equal(counters):
    if counters == "int":
        for j, t, p in _int_forms(JP.hash_u32, TP.hash_u32):
            np.testing.assert_array_equal(t, p)
            np.testing.assert_array_equal(j.astype(np.int64), p)
        return
    for j, p in _both(JP.hash_u32, TP.hash_u32):
        assert p.dtype == np.int64 and p.min() >= 0 and p.max() < 2**32
        np.testing.assert_array_equal(j.astype(np.int64), p)


def test_uniform_bit_equal():
    for j, p in _both(JP.uniform, TP.uniform):
        assert p.dtype == np.float32
        np.testing.assert_array_equal(j, p)
    for j, t, p in _int_forms(JP.uniform, TP.uniform):
        assert p.dtype == np.float32
        np.testing.assert_array_equal(t, p)
        np.testing.assert_array_equal(j, p)


@pytest.mark.parametrize("lo,hi", [(0.0, 337.3577), (5.5, 94.2)])
def test_uniform_range_bit_equal(lo, hi):
    for j, p in _both(JP.uniform_range, TP.uniform_range,
                      np.float32(lo), np.float32(hi), stream=2):
        np.testing.assert_array_equal(j, p)


@pytest.mark.parametrize("nq", [1, 32700, 32768 - 2 * 19])
def test_uniform_q_bit_equal(nq):
    for j, p in _both(JP.uniform_q, TP.uniform_q, nq, stream=1):
        assert p.dtype == np.int32
        np.testing.assert_array_equal(j, p)
    for j, t, p in _int_forms(JP.uniform_q, TP.uniform_q, nq):
        np.testing.assert_array_equal(t, p)
        np.testing.assert_array_equal(j, p)


@pytest.mark.parametrize("n", [1, 13, 2**31 - 1])
def test_randint_mod_bit_equal(n):
    for j, p in _both(JP.randint_mod, TP.randint_mod, n, stream=4):
        np.testing.assert_array_equal(j, p)
