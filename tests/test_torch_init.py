"""The port's table initializers against the JAX package's.

The host initializers (numpy) must equal the JAX package's bit for bit for
the same generator, at every keyword default and override. The device
counterparts (``embedding.device_table_init``) draw from a torch generator,
so their values differ from any other stream; they are held to the JAX
package's device formulas by what those fix: bounds, means and standard
deviations (each slice scaled by its own width), and unit row norms. A
moment of n draws is held to 6 standard errors of its estimate (sigma/sqrt(n)
for a mean, about sigma/sqrt(2n) for a standard deviation), a margin no
correct formula misses at the fixed seeds here.
"""

import numpy as np
import pytest
import torch

from besskge_tpu import embedding as jax_emb
from besskge_tpu_torch import embedding as port_emb

#: (name, keyword overrides) of every host initializer the port shares.
HOST = [
    ("init_uniform", {}),
    ("init_zeros", {}),
    ("init_uniform_norm", {}),
    ("init_xavier_norm", {}),
    ("init_xavier_norm", {"gain": 2.5}),
    ("init_KGE_normal", {}),
    ("init_KGE_normal", {"std": 3.0}),
    ("init_KGE_normal", {"std": 0.5, "divide_by_embedding_size": False}),
    ("init_KGE_uniform", {}),
    ("init_KGE_uniform", {"b": 2.0, "divide_by_embedding_size": False}),
    ("init_uniform_rotation", {}),
]


@pytest.mark.parametrize("shape", [(7, 9), (3, 4, 16), (1, 1)])
@pytest.mark.parametrize("name,kw", HOST, ids=[f"{n}{'-' + '-'.join(kw) if kw else ''}"
                                                for n, kw in HOST])
def test_host_initializers_are_bit_equal(name, kw, shape):
    got = getattr(port_emb, name)(shape, np.random.default_rng(3), **kw)
    want = getattr(jax_emb, name)(shape, np.random.default_rng(3), **kw)
    assert got.dtype == want.dtype == np.float32 and got.shape == tuple(shape)
    np.testing.assert_array_equal(got, want)


def test_sliced_tables_are_bit_equal():
    """BoxE's relation spec: four uniform slices then two unit-norm ones."""
    from besskge_tpu import sharding as jax_sh
    from besskge_tpu_torch import sharding as port_sh

    inits = [4 * [f] + 2 * [g] for f, g in (
        (jax_emb.init_uniform, jax_emb.init_uniform_norm),
        (port_emb.init_uniform, port_emb.init_uniform_norm))]
    rows = [5, 5, 5, 5, 1, 1]
    want = jax_emb.initialize_relation_embedding(6, True, inits[0], rows, seed=4)
    got = port_emb.initialize_relation_embedding(6, True, inits[1], rows, seed=4)
    np.testing.assert_array_equal(got, want)
    assert want.shape == (12, 22)
    ent_j = jax_emb.initialize_entity_embedding(jax_sh.Sharding.create(50, 2, seed=1),
                                                [jax_emb.init_KGE_normal, jax_emb.init_zeros],
                                                [6, 1], seed=2)
    ent_p = port_emb.initialize_entity_embedding(port_sh.Sharding.create(50, 2, seed=1),
                                                 [port_emb.init_KGE_normal, port_emb.init_zeros],
                                                 [6, 1], seed=2)
    np.testing.assert_array_equal(ent_p, ent_j)


def _moments_ok(x: torch.Tensor, mean: float, std: float) -> None:
    n = x.numel()
    assert abs(float(x.mean()) - mean) <= 6 * std / np.sqrt(n)
    assert abs(float(x.std()) - std) <= 6 * std / np.sqrt(2 * n)


def _device(inits, sizes, rows=4000, seed=0):
    shape = (rows, sum(sizes))
    gen = torch.Generator("cpu").manual_seed(seed)
    return port_emb.device_table_init(inits, sizes, shape, seed, torch.float32, None, "cpu", gen)


@pytest.mark.parametrize("size", [8, 33])
def test_device_uniform_family(size):
    x = _device([port_emb.init_uniform], [size])
    assert ((x >= 0) & (x < 1)).all()
    _moments_ok(x, 0.5, np.sqrt(1 / 12))
    x = _device([port_emb.init_KGE_uniform], [size])
    assert (x.abs() <= 1 / size).all()
    _moments_ok(x, 0.0, (1 / size) / np.sqrt(3))
    x = _device([port_emb.init_uniform_rotation], [size])
    assert ((x >= 0) & (x < 2 * np.pi)).all()


@pytest.mark.parametrize("size", [8, 33])
def test_device_normal_family(size):
    """init_KGE_normal draws N(0, 1)/d and init_xavier_norm
    N(0, 1)·sqrt(2/(d + 1)), d the slice's width, as the JAX device path."""
    _moments_ok(_device([port_emb.init_KGE_normal], [size]), 0.0, 1 / size)
    _moments_ok(_device([port_emb.init_xavier_norm], [size]), 0.0, np.sqrt(2 / (size + 1)))


def test_device_unit_norm_and_zeros():
    x = _device([port_emb.init_uniform_norm], [12])
    assert (x >= 0).all()
    torch.testing.assert_close(torch.linalg.vector_norm(x, dim=-1), torch.ones(len(x)),
                               rtol=1e-6, atol=1e-6)
    assert (_device([port_emb.init_zeros], [5]) == 0).all()


def test_device_slices_scale_by_their_own_width():
    """A sliced row (BoxE's relation spec at d = 16, then ConvE's entity
    spec): each slice drawn by its own initializer at its own width."""
    sizes = [16, 16, 16, 16, 1, 1]
    x = _device(4 * [port_emb.init_uniform] + 2 * [port_emb.init_uniform_norm], sizes)
    assert x.shape == (4000, 66)
    assert ((x[:, :64] >= 0) & (x[:, :64] < 1)).all()
    assert (x[:, 64:] == 1).all()  # a one-wide unit-norm slice is 1
    x = _device([port_emb.init_KGE_normal, port_emb.init_zeros, port_emb.init_xavier_norm],
                [24, 1, 7])
    _moments_ok(x[:, :24], 0.0, 1 / 24)
    assert (x[:, 24] == 0).all()
    _moments_ok(x[:, 25:], 0.0, np.sqrt(2 / 8))


def test_device_init_is_seeded_and_rejects_unknowns():
    a = _device([port_emb.init_KGE_normal], [8], seed=1)
    b = _device([port_emb.init_KGE_normal], [8], seed=1)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="No device counterpart"):
        _device([lambda shape, rng: np.zeros(shape, np.float32)], [8])
