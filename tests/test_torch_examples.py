"""The reference's three examples as the port's apps, on the CPU at a few
steps.

``repro_torch.apps.quickstart``: its losses over 4 steps equal the
reference's ``runtime.train_loop.train`` of the same bundle
(``examples/quickstart.py``'s config, topology and lr) from the same state
(the port's seed-0 draw, handed to the reference's bundle; rtol 2e-4,
``compare()``'s loss tolerance), and it generates 8 tokens for 2
prompts.  ``repro_torch.apps.train_100m`` at reduced width: 2 steps with
a checkpoint at step 2, then a run to 4 that resumes from it
(``resumed_from`` 2) with the uninterrupted run's losses for steps 3-4.
``repro_torch.apps.serve_lm``: every stream through the scheduler equals
its solo run, and the live tuner has an estimate.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np

from repro import configs as jconfigs
from repro.core.topology import MeshTopology as JTopology
from repro.data.synthetic import DataConfig as JDataConfig
from repro.launch.mesh import make_mesh_from_topo as jmesh
from repro.runtime.steps import make_train_step as jmake_train_step
from repro.runtime.train_loop import train as jtrain
from repro_torch.apps import quickstart, serve_lm, train_100m
from repro_torch.core import tree as T
from test_torch_models import as_reference


def test_quickstart_losses_equal_the_reference_train():
    cfg = quickstart.config()
    jcfg = jconfigs.get_config("qwen3-0.6b").reduced(
        n_layers=2, d_model=128, n_heads=4, vocab=512)
    assert as_reference(cfg) == dataclasses.asdict(jcfg)
    topo = JTopology({"data": 1, "model": 1}, slow_axes=())
    jb = jmake_train_step(jcfg, topo, jmesh(topo), mode="hier", lr=3e-3,
                          compute_dtype=jnp.float32)
    # the reference's train starts from the state the port's draws (seed
    # 0: the params of the port's init, zero moments)
    state = T.tree_map(lambda t: t.numpy(),
                       quickstart.make_bundle("cpu").init_state(0))
    object.__setattr__(jb, "init_state", lambda seed: state)
    jrep = jtrain(jb, steps=4, data_cfg=JDataConfig(
        vocab=jcfg.vocab, seq_len=128, global_batch=8), log_every=0)
    rep, gen = quickstart.run(steps=4, device="cpu", log_every=0)
    np.testing.assert_allclose(rep.losses, jrep.losses, rtol=2e-4)
    assert rep.losses[-1] < rep.losses[0]
    assert gen.tokens.shape == (2, 8)


def test_train_100m_resumes_from_its_checkpoint(tmp_path):
    small = ["--n-layers", "2", "--d-model", "64", "--vocab", "256",
             "--seq", "32", "--batch", "2", "--save-every", "2",
             "--device", "cpu"]
    whole = train_100m.main(small + ["--steps", "4", "--ckpt",
                                     str(tmp_path / "whole")])
    first = train_100m.main(small + ["--steps", "2", "--ckpt",
                                     str(tmp_path / "resumed")])
    second = train_100m.main(small + ["--steps", "4", "--ckpt",
                                      str(tmp_path / "resumed")])
    assert (whole.resumed_from, first.resumed_from,
            second.resumed_from) == (0, 0, 2)
    assert first.losses == whole.losses[:2]
    assert second.losses == whole.losses[2:]


def test_serve_lm_streams_equal_their_solo_runs():
    out, est = serve_lm.run("cpu")
    assert len(out) == 5
    for tokens, solo in out.values():
        assert np.array_equal(tokens, solo) and tokens.shape == (1, 6)
    assert est > 0
