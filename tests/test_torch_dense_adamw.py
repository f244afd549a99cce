"""The port's dense AdamW against the JAX package's.

* The plain version of B10 (``adamw_kernels.dense_adamw_update``) against
  ``besskge_tpu.ops.pallas_adamw.dense_adamw_update`` in the Pallas
  interpreter, as ``tests/test_pallas_ops.py`` runs it: one tile, a ragged
  final tile, a bf16 param, and a three-step trajectory.
* ``optim.FusedDenseAdamW.apply_dense`` against the JAX package's
  ``FusedDenseAdamW`` off the TPU (its jnp path), with a float lr and with
  a schedule.
* ``optim.AdamW`` against ``optax.adamw``, with its default weight decay
  (1e-4, where ``torch.optim.AdamW`` has 1e-2) and with another.
* The same at steps 1 to 100000, which hold ``bias_corrections`` (whose
  operations the CUDA kernel repeats) against the Pallas wrapper's ``corr``.

Tolerances. Both sides compute the same fp32 operations on the same inputs,
but XLA on the CPU may contract a multiply and an add into one fused
operation where the port rounds both, and JAX's ``b^t`` may differ from
torch's in the last bit: a relative 2^-24 per term, a few terms per value.
The moments are held to rtol 1e-6. The param moves by ``lr`` times a ratio
that carries those relative errors, on top of its own fp32 rounding: rtol
1e-6 plus atol 1e-7 (the params are O(1), lr 1e-2). Against the jnp path of
``FusedDenseAdamW``, which divides by ``1 − b^t`` where the kernel and its
twin multiply by the reciprocal, the ratio differs by up to two more
roundings: the same tolerance covers it. A bf16 param is held to one bf16
ulp (2^-8 relative): the two fp32 results, each rounded to bf16, may land
on neighbouring values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from besskge_tpu import optim as jax_optim
from besskge_tpu.ops.pallas_adamw import dense_adamw_update as jax_dense_adamw
from besskge_tpu_torch import convert
from besskge_tpu_torch import optim as port_optim
from besskge_tpu_torch.ops import adamw_kernels

RTOL, ATOL = 1e-6, 1e-7


def _inputs(seed, m, d=128, moments=True):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(m, d)).astype(np.float32)
    if moments:
        mu = rng.normal(size=(m, d)).astype(np.float32) * 0.1
        nu = (rng.normal(size=(m, d)).astype(np.float32) * 0.1) ** 2
    else:
        mu = np.zeros((m, d), np.float32)
        nu = np.zeros((m, d), np.float32)
    g = rng.normal(size=(m, d)).astype(np.float32)
    return p, mu, nu, g


def _jax(p, mu, nu, g, t, **kw):
    out = jax_dense_adamw(jnp.asarray(p), jnp.asarray(mu), jnp.asarray(nu), jnp.asarray(g),
                          jnp.asarray(t, dtype=jnp.int32), interpret=True, **kw)
    return [np.asarray(x.astype(jnp.float32)) for x in out]


def _port(p, mu, nu, g, t, lr, b1=0.9, b2=0.999, eps=1e-8, wd=0.0):
    tensors = [convert.params_from_jax({"x": x}, "cpu")["x"] for x in (p, mu, nu)]
    out = adamw_kernels.dense_adamw_update(
        *tensors, torch.from_numpy(g), torch.tensor(t, dtype=torch.int32), lr, b1, b2, eps, wd)
    assert all(o is x for o, x in zip(out, tensors))  # in place
    return [x.float().numpy() for x in out]


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("m,t,wd,moments", [
    (512, 3, 0.01, True),  # exactly one 512-row tile of the Pallas kernel
    (700, 1, 0.0, False),  # a ragged final tile
])
def test_dense_adamw_twin_matches_pallas(m, t, wd, moments):
    p, mu, nu, g = _inputs(8 + m, m, moments=moments)
    kw = dict(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, wd=wd)
    _close(_port(p, mu, nu, g, t, **kw), _jax(p, mu, nu, g, t, **kw))


@pytest.mark.parametrize("t", [1, 2, 3, 10, 1000, 100000])
def test_dense_adamw_twin_matches_pallas_at_step(t):
    """The bias corrections from the first step to a late one, where ``b1^t``
    is below fp32's ulp of 1 and the correction is 1: the twin, through
    ``bias_corrections`` (whose operations the CUDA kernel repeats in each
    thread), against the Pallas kernel, through its wrapper's ``corr``."""
    p, mu, nu, g = _inputs(20 + t, 64)
    kw = dict(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    _close(_port(p, mu, nu, g, t, **kw), _jax(p, mu, nu, g, t, **kw))


def test_dense_adamw_twin_bf16_param_matches_pallas():
    p, mu, nu, g = _inputs(10, 512, moments=False)
    p16 = p.astype(jnp.bfloat16)
    kw = dict(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, wd=0.0)
    got = _port(p16, mu, nu, g, 2, **kw)
    want = _jax(p16, mu, nu, g, 2, **kw)
    np.testing.assert_allclose(got[0], want[0], rtol=2.0**-8, atol=0.0)
    _close(got[1:], want[1:])


def test_dense_adamw_twin_trajectory_matches_pallas():
    p, mu, nu, _ = _inputs(11, 600, moments=False)  # ragged
    rng = np.random.default_rng(11)
    kw = dict(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, wd=0.004)
    want, got = (p, mu, nu), (p, mu, nu)
    for t in range(1, 4):
        g = rng.normal(size=p.shape).astype(np.float32)
        want = _jax(*want, g, t, **kw)
        got = _port(*got, g, t, **kw)
    _close(got, want)


def test_dense_adamw_twin_takes_a_tensor_lr():
    p, mu, nu, g = _inputs(12, 64, d=8)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    a = _port(p, mu, nu, g, 5, 0.003, **kw)
    b = _port(p, mu, nu, g, 5, torch.tensor(0.003), **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_dense_adamw_validates():
    z = torch.zeros(4, 4)
    with pytest.raises(ValueError):
        adamw_kernels.dense_adamw_update(z, z.clone().double(), z.clone(), z, torch.tensor(1), 0.1)
    with pytest.raises(ValueError):
        adamw_kernels.dense_adamw_update(z, z.clone(), z.clone(), torch.zeros(4, 3),
                                         torch.tensor(1), 0.1)
    with pytest.raises(ValueError):
        adamw_kernels.dense_adamw_update(torch.zeros(4, 8)[:, ::2], z.clone(), z.clone(), z,
                                         torch.tensor(1), 0.1)


def _schedule(c):
    return 0.01 / (1.0 + c)


@pytest.mark.parametrize("schedule", [False, True])
def test_fused_dense_adamw_matches_jax(schedule):
    lr = _schedule if schedule else 0.01
    jopt = jax_optim.FusedDenseAdamW(lr, weight_decay=0.01)
    popt = port_optim.FusedDenseAdamW(lr, weight_decay=0.01)
    p, _, _, _ = _inputs(13, 96, d=16)
    rng = np.random.default_rng(13)
    jt, js = jnp.asarray(p), jopt.init(jnp.asarray(p))
    pt = torch.from_numpy(p.copy())
    ps = convert.opt_state_from_jax(
        {"entity": jax.tree.map(np.asarray, js), "other": ()}, "cpu")["entity"]
    for _ in range(3):
        g = rng.normal(size=p.shape).astype(np.float32)
        jt, js = jopt.apply_dense(jt, js, jnp.asarray(g))
        out, ps = popt.apply_dense(pt, ps, torch.from_numpy(g))
        assert out is pt
    assert int(ps["count"]) == int(js["count"]) == 3
    _close([pt.numpy(), ps["mu"].numpy(), ps["nu"].numpy()],
           [np.asarray(jt), np.asarray(js["mu"]), np.asarray(js["nu"])])


@pytest.mark.parametrize("weight_decay", [None, 0.05])
@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_matches_optax(weight_decay, schedule):
    lr = _schedule if schedule else 0.01
    kw = {} if weight_decay is None else {"weight_decay": weight_decay}
    opt, adamw = optax.adamw(lr, **kw), port_optim.AdamW(lr, **kw)
    rng = np.random.default_rng(14)
    params = {"relation_embedding": rng.normal(size=(5, 8)).astype(np.float32),
              "entity_embedding": rng.normal(size=(9, 8)).astype(np.float32)}
    jp, js = dict(params), opt.init(params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = convert.opt_state_from_jax(jax.tree.map(np.asarray, js), "cpu")
    assert set(ts) == {"count", "mu", "nu"}
    for _ in range(3):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        upd, js = opt.update({k: jnp.asarray(v) for k, v in grads.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = adamw.update_(convert.params_from_jax(grads, "cpu"), ts, tp)
    adam_state = js[0]
    assert int(ts["count"]) == int(adam_state.count) == 3
    for k in params:
        _close([tp[k].numpy(), ts["mu"][k].numpy(), ts["nu"][k].numpy()],
               [np.asarray(jp[k]), np.asarray(adam_state.mu[k]), np.asarray(adam_state.nu[k])])


def test_adamw_defaults_are_optax_defaults():
    import inspect

    optax_defaults = {k: v.default for k, v in inspect.signature(optax.adamw).parameters.items()}
    for field in ("b1", "b2", "eps", "weight_decay"):
        assert getattr(port_optim.AdamW(1e-3), field) == optax_defaults[field]
    assert port_optim.AdamW(1e-3).weight_decay == 1e-4
