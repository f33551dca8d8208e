"""The port's device grids (parallel/mesh) on grids of 8 CPU devices: the
grid's factoring, the shardings, and the batched ambi_bin render run
sharded over streams ('dp') and over input channels ('tp'), held against
the unsharded port and against the JAX package's sharded run on its
8-device CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from spatial_audio_framework_tpu.models import ambi_bin as jab
from spatial_audio_framework_tpu.parallel import mesh as jmesh
from spatial_audio_framework_tpu_torch.models import ambi_bin as tab
from spatial_audio_framework_tpu_torch.parallel import mesh as tmesh

RENDER_TOL = 1e-5   # the batched render, port vs JAX (test_torch_ambi_bin.py)
CPU8 = [torch.device("cpu")] * 8
_S, _ORDER = 8, 1


def test_make_mesh_dp_only_and_dp_tp():
    m = tmesh.make_mesh(8, devices=CPU8)
    assert m.axis_names == ("dp", "tp")
    assert m.shape == {"dp": 8, "tp": 1}
    assert tmesh.make_mesh(8, tp=2, devices=CPU8).shape == {"dp": 4, "tp": 2}
    assert tmesh.make_mesh(8, dp=2, tp=4, devices=CPU8).shape == {
        "dp": 2, "tp": 4}
    assert tmesh.make_mesh(devices=CPU8[:4]).shape == {"dp": 4, "tp": 1}


@pytest.mark.parametrize("dp,tp", [(3, 2), (8, 2), (0, 8)])
def test_make_mesh_rejects_nonfactoring(dp, tp):
    with pytest.raises(ValueError, match="does not factor"):
        tmesh.make_mesh(8, dp=dp, tp=tp, devices=CPU8)


def test_make_mesh_defaults_to_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()


def test_shardings_place_like_jax():
    m = tmesh.make_mesh(8, tp=2, devices=CPU8)
    assert tmesh.stream_sharding(m).spec == ("dp", None, None)
    assert tmesh.stream_sharding(m, True).spec == ("dp", "tp", None)
    assert tmesh.replicated(m).spec == ()
    x = torch.arange(8 * 6 * 5.0).reshape(8, 6, 5)
    g = tmesh.stream_sharding(m, True).place(x)
    assert g.shape == (4, 2) and tuple(g[1, 1].shape) == (2, 3, 5)
    assert torch.equal(g[1, 1], x[2:4, 3:])
    assert torch.equal(tmesh.replicated(m).place(x)[3, 1], x)
    tree = {"a": torch.zeros(8, 3), "b": (torch.ones(8, 2, 5),)}
    placed = tmesh.shard_leading(tree, m)
    assert tuple(placed[0, 1]["a"].shape) == (2, 3)
    assert tuple(placed[3, 0]["b"][0].shape) == (2, 2, 5)


def _weights():
    rng = np.random.default_rng(7)
    return (0.3 * rng.standard_normal((133, 2, 4)).astype(np.float32),
            0.3 * rng.standard_normal((133, 2, 4)).astype(np.float32))


def _x(seed, n_hops=3):
    return np.random.default_rng(seed).uniform(
        -1, 1, (_S, 4, n_hops * 128)).astype(np.float32)


def _port_proc(cfg):
    return lambda w, st, x: tab.process_ri_batched(cfg, w, st, x)


def _port_unsharded(cfg, w, xs):
    st = tab.init_state_batched(cfg, _S, device="cpu")
    ys = []
    for x in xs:
        y, st = tab.process_ri_batched(cfg, w, st, torch.from_numpy(x))
        ys.append(y.numpy())
    return ys, st


def _jax_sharded(xs, tp):
    cfg = jab.AmbiBinConfig(order=_ORDER)
    w = tuple(jnp.asarray(m) for m in _weights())
    mesh = jmesh.make_mesh(8, tp=tp)
    step = jax.jit(lambda w, s, xx: jab.process_ri_batched(
        cfg, w, s, xx, use_pallas=False))
    st = jab.init_state_batched(cfg, _S)
    if tp == 1:
        st = jmesh.shard_leading(st, mesh)
    else:
        w = jax.tree.map(lambda a: jax.device_put(
            a, NamedSharding(mesh, P(None, None, "tp"))), w)
        st = jax.tree.map(lambda a: jax.device_put(a, NamedSharding(
            mesh, P("dp", "tp", *([None] * (a.ndim - 2)))
            if a.shape[1] == cfg.nsh else
            P("dp", *([None] * (a.ndim - 1))))), st)
    ys = []
    for x in xs:
        xx = jax.device_put(jnp.asarray(x), jmesh.stream_sharding(
            mesh, shard_channels=tp > 1))
        y, st = step(w, st, xx)
        ys.append(np.asarray(y))
    return ys


@pytest.mark.parametrize("dp,tp", [(8, 1), (4, 2), (2, 4)])
def test_sharded_render_matches_unsharded_and_jax(dp, tp):
    cfg = tab.AmbiBinConfig(order=_ORDER)
    w = tab.weights_from_numpy(*_weights(), "cpu")
    xs = [_x(11), _x(12), _x(13, 1)]
    ref, st_ref = _port_unsharded(cfg, w, xs)
    mesh = tmesh.make_mesh(dp=dp, tp=tp, devices=CPU8)
    st = tab.init_state_batched(cfg, _S, device="cpu")
    got = []
    for x in xs:
        y, st = tmesh.run_sharded(_port_proc(cfg), w, st,
                                  torch.from_numpy(x), mesh,
                                  shard_channels=tp > 1)
        got.append(y.numpy())
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=RENDER_TOL, rtol=0)
    full = st.gather()
    assert torch.equal(full.in_tail, st_ref.in_tail)
    np.testing.assert_allclose(full.ola_tail.numpy(), st_ref.ola_tail.numpy(),
                               atol=RENDER_TOL, rtol=0)
    for a, b in zip(got, _jax_sharded(xs, tp)):
        np.testing.assert_allclose(a, b, atol=RENDER_TOL, rtol=0)


def test_sharded_render_without_channel_split_on_a_dp_tp_grid():
    """A (4, 2) grid without shard_channels: each row's first device does
    the row's work, the others would repeat it."""
    cfg = tab.AmbiBinConfig(order=_ORDER)
    w = tab.weights_from_numpy(*_weights(), "cpu")
    xs = [_x(21), _x(22)]
    ref, st_ref = _port_unsharded(cfg, w, xs)
    mesh = tmesh.make_mesh(8, tp=2, devices=CPU8)
    st = tab.init_state_batched(cfg, _S, device="cpu")
    for x, r in zip(xs, ref):
        y, st = tmesh.run_sharded(_port_proc(cfg), w, st,
                                  torch.from_numpy(x), mesh)
        np.testing.assert_array_equal(y.numpy(), r)
    assert torch.equal(st.gather().ola_tail, st_ref.ola_tail)
