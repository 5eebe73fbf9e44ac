"""The production-mesh train step held against the JAX reference.

The reference's ``tests/test_distributed.py`` ``compare()``: one step of
the port's ``make_train_step`` on ``small_topo`` (a ``MeshTopology`` over
the stacked cluster, ``launch.mesh.make_mesh_from_topo``), hier and naive,
against the reference's single-device step (``{"data": 1, "model": 1}``,
naive) from the same state and batch — loss rtol 2e-4, gnorm 5e-3, the
updated embedding rtol 2e-4 / atol 2e-5.  In hier on ``(2, 2, 2)`` the
whole updated state is also held to the reference's own
``make_train_step`` on that topology under ``PERF.md`` §2's rule
(``analysis.state_rule.state_close``).  This file: dense head_tp on
``(2, 2, 2)`` and ``(1, 2, 2)``, the vlm and audio frontends; the
context-parallel and MoE cases are
``tests/test_torch_mesh_steps_families.py``, the hybrid and xLSTM ones
``tests/test_torch_mesh_steps_recurrent.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.topology import MeshTopology as JTopology
from repro.launch.mesh import make_mesh_from_topo as jmesh
from repro.launch.mesh import small_topo as jsmall_topo
from repro.models import make_batch as jmake_batch
from repro.runtime.steps import make_train_step as jmake_train_step
from repro_torch import configs
from repro_torch.analysis.state_rule import state_close
from repro_torch.convert import (train_state_from_reference,
                                 train_state_to_reference)
from repro_torch.launch.mesh import make_mesh_from_topo, small_topo
from repro_torch.runtime.steps import make_train_step

RTOL, ATOL = 2e-4, 2e-5


def single_device_step(jcfg, batch, seed=0, lr=1e-3):
    """The reference's single-device step: (state, new state, metrics)."""
    topo = JTopology({"data": 1, "model": 1}, slow_axes=())
    b = jmake_train_step(jcfg, topo, jmesh(topo), mode="naive", lr=lr,
                         compute_dtype=jnp.float32)
    state = jax.device_get(b.init_state(seed))
    new, metrics = jax.jit(b.fn)(state, batch)
    return state, jax.device_get(new), metrics


def reshaped(state, shapes):
    """``state`` (nested dicts of arrays) with each leaf reshaped to the
    matching leaf of ``shapes``: a step at tp > 1 stores the MoE experts
    ``(tp, E/ep, ...)`` where the single-device step stores ``(1, E,
    ...)`` — the same elements in the same order, as the reference's test
    draws them for both from one seed."""
    if isinstance(state, dict):
        return {k: reshaped(v, shapes[k]) for k, v in state.items()}
    return np.asarray(state).reshape(tuple(shapes.shape))


def ref_dist_step(jcfg, batch, shape, state, lr=1e-3):
    """The reference's own hier step on ``small_topo(*shape)``."""
    topo = jsmall_topo(*shape)
    b = jmake_train_step(jcfg, topo, jmesh(topo), mode="hier", lr=lr,
                         compute_dtype=jnp.float32)
    state = reshaped(state, jax.eval_shape(b.init_state))
    new, metrics = jax.jit(b.fn)(state, batch)
    return jax.device_get(new), metrics


def port_step(cfg, batch, shape, mode, state0, lr=1e-3):
    """One step of the port's ``make_train_step`` from the reference's
    state: (global new state as numpy, metrics, bundle)."""
    topo = small_topo(*shape)
    vc = make_mesh_from_topo(topo, device="cpu")
    b = make_train_step(cfg, topo, vc, mode=mode, lr=lr,
                        compute_dtype=torch.float32)
    state = train_state_from_reference(
        reshaped(state0, b.abstract_state()), vc, b.state_specs)
    state, m = b.step(state, b.layout_batch(
        {k: np.array(v) for k, v in batch.items()}))
    return train_state_to_reference(state, vc, b.state_specs), m, b


def compare(name, red, seed, shape, *, dist=True, cfg_fn=None):
    """``compare()`` of the reference's test for the reduced ``name``
    (``red``: the reduce kwargs) on ``small_topo(*shape)``; ``dist``: also
    the reference's own hier step on that topology under §2's rule."""
    jcfg = jconfigs.get_config(name).reduced(**red)
    cfg = configs.get_config(name).reduced(**red)
    if cfg_fn is not None:
        jcfg, cfg = cfg_fn(jcfg, cfg)
    batch = jmake_batch(jcfg, B=4, T=32, seed=seed)
    state0, want, jm = single_device_step(jcfg, batch)
    got = {}
    for mode in ("hier", "naive"):
        st, m, b = port_step(cfg, batch, shape, mode, state0)
        np.testing.assert_allclose(float(m["loss"][0]), float(jm["loss"]),
                                   rtol=RTOL, err_msg=f"{mode} loss")
        np.testing.assert_allclose(float(m["gnorm"][0]),
                                   float(jm["gnorm"]), rtol=5e-3,
                                   err_msg=f"{mode} gnorm")
        st = reshaped(st, want)
        np.testing.assert_allclose(st["params"]["embed"],
                                   np.asarray(want["params"]["embed"]),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"{mode} embed update")
        got[mode] = (st, b)
    if dist:
        jnew, jdm = ref_dist_step(jcfg, batch, shape, state0)
        np.testing.assert_allclose(float(jdm["loss"]), float(jm["loss"]),
                                   rtol=RTOL)
        state_close(reshaped(got["hier"][0], jnew), jnew, 1,
                    f"{name} hier {shape}")
    return got, state0, want


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 2, 2)],
                         ids=["2x2x2", "1x2x2"])
def test_dense_head_tp(shape):
    got, _, _ = compare("qwen3-0.6b", dict(n_layers=2, d_model=64,
                                           n_heads=4), 1, shape,
                        dist=shape == (2, 2, 2))
    b = got["hier"][1]
    assert b.model.ctx.tp_axis == "model" and b.model.ctx.tp == 2
    assert b.model.ctx.fsdp_axes == ("data",)


@pytest.mark.parametrize("name,seed", [("internvl2-1b", 6),
                                       ("musicgen-medium", 7)])
def test_vlm_and_audio(name, seed):
    got, state0, _ = compare(name, dict(n_layers=2, d_model=64, n_heads=4),
                             seed, (2, 2, 2))
    b = got["hier"][1]
    # the frontend weight is carried and updated under its spec
    assert "frontend" in b.state_specs["params"]
    assert not np.array_equal(got["hier"][0]["params"]["frontend"],
                              np.asarray(state0["params"]["frontend"]))
    assert set(b.batch_spec) == ({"frames", "labels"}
                                 if name == "musicgen-medium"
                                 else {"tokens", "patches"})


def test_single_device_topology_is_the_reference_step():
    """``{"data": 1, "model": 1}`` (the examples' topology and
    ``compare()``'s reference): the port's step equals the reference's
    single-device step in every state group under §2's rule."""
    red = dict(n_layers=2, d_model=64, n_heads=4)
    jcfg = jconfigs.get_config("internvl2-1b").reduced(**red)
    cfg = configs.get_config("internvl2-1b").reduced(**red)
    batch = jmake_batch(jcfg, B=4, T=32, seed=6)
    state0, want, jm = single_device_step(jcfg, batch)
    st, m, b = port_step(cfg, batch, (1, 1, 1), "naive", state0)
    assert b.vc.num_devices == 1 and b.model.ctx.tp_axis == "model"
    np.testing.assert_allclose(float(m["loss"][0]), float(jm["loss"]),
                               rtol=RTOL)
    state_close(st, want, 1, "1x1")


@functools.lru_cache(maxsize=None)
def _lossy_case():
    red = dict(n_layers=2, d_model=64, n_heads=4)
    return (configs.get_config("qwen3-0.6b").reduced(**red),
            jmake_batch(jconfigs.get_config("qwen3-0.6b").reduced(**red),
                        B=4, T=32, seed=1))


def test_int8_bridge_and_compress_reach_the_bridge():
    """The ``int8_bridge`` opt routes the bridge through the lossy wire
    formats (the loss is the exact step's; the update differs), and an
    explicit ``compress`` hook is called per bridge-crossing leaf."""
    cfg, batch = _lossy_case()
    topo = small_topo(2, 2, 2)
    vc = make_mesh_from_topo(topo, device="cpu")
    out = {}
    calls = []

    def compress(g, axes):
        calls.append(axes)
        from repro_torch.comm import Communicator
        return Communicator(fast_axis=axes).allreduce(g, scheme="naive",
                                                      result="replicated")
    for name, kw in (("exact", {}), ("lossy", {"opts": ("int8_bridge",)}),
                     ("compress", {"compress": compress})):
        b = make_train_step(cfg, topo, vc, lr=1e-3,
                            compute_dtype=torch.float32, **kw)
        st = b.init_layout_state(0)
        st, m = b.step(st, b.layout_batch(
            {k: np.array(v) for k, v in batch.items()}))
        out[name] = (float(m["loss"][0]),
                     b.unlayout_state(st)["params"]["embed"])
    assert out["lossy"][0] == out["exact"][0]
    assert not torch.equal(out["lossy"][1], out["exact"][1])
    torch.testing.assert_close(out["lossy"][1], out["exact"][1], rtol=0,
                               atol=1e-2)
    assert calls and all("pod" in a for a in calls)
    assert torch.equal(out["compress"][1], out["exact"][1])
