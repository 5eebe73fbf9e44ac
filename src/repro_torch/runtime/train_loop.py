"""End-to-end training loop: data -> step -> metrics -> checkpoint/restart.

The reference's ``repro/runtime/train_loop.py`` over the port's cluster
train step: the state stays laid out on the cluster between steps and is
donated to ``bundle.step``; a checkpoint holds its logical (global) form
(``TrainStepBundle.host_state``) and a resume lays it out again, on any
cluster.  Fault tolerance is exercised by killing and re-entering
``train()``: it resumes from the newest intact checkpoint with the data
stream fast-forwarded (the stream is a pure function of step).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.runtime.fault_tolerance import (RestartManager,
                                                 StragglerPolicy)


@dataclasses.dataclass
class TrainReport:
    steps: int
    final_loss: float
    losses: list
    step_times: list
    resumed_from: int
    state: object = None


def _sync(bundle) -> None:
    if bundle.vc.device.type == "cuda":
        import torch
        torch.cuda.synchronize(bundle.vc.device)


def train(bundle, *, steps: int, data_cfg: DataConfig,
          ckpt_dir: Optional[str] = None, save_every: int = 50,
          log_every: int = 10, seed: int = 0,
          on_step: Optional[Callable] = None,
          stream: Optional[Callable] = None) -> TrainReport:
    """Train ``bundle`` (a ``TrainStepBundle``) to ``steps``, resuming from
    ``ckpt_dir``'s newest intact step when it has one.  ``on_step(step,
    metrics)`` sees each step's metrics, with ``"seconds"`` added: the
    step's wall time, ended by a device synchronize.  ``stream(data_cfg,
    start_step=...)`` makes the batch stream (``SyntheticLM`` by default;
    ``data.synthetic.FrontendLM`` for a frontend model).  Returns the
    laid-out state in the report."""
    start = 0
    if ckpt_dir:
        mgr = RestartManager(Checkpointer(ckpt_dir), save_every=save_every,
                             logical=bundle.host_state)
        state, start = mgr.resume_or_init(
            lambda: bundle.init_layout_state(seed),
            like=bundle.abstract_state(), layout=bundle.layout_state)
    else:
        mgr = None
        state = bundle.init_layout_state(seed)

    stream = (stream or SyntheticLM)(data_cfg, start_step=start)
    straggler = StragglerPolicy()
    losses, times = [], []
    t_total = time.time()
    for step in range(start, steps):
        batch = bundle.layout_batch(stream.next_batch())
        _sync(bundle)
        t0 = time.perf_counter()
        state, metrics = bundle.step(state, batch)
        loss = float(metrics["loss"][0])
        _sync(bundle)
        dt = time.perf_counter() - t0
        losses.append(loss)
        times.append(dt)
        straggler.observe({0: dt})
        if mgr:
            mgr.maybe_save(step + 1, state)
        if on_step:
            on_step(step, {**metrics, "seconds": dt})
        if log_every and (step % log_every == 0 or step == steps - 1):
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['gnorm'][0]):7.3f} "
                  f"{dt * 1e3:7.1f} ms", flush=True)
    if mgr:
        mgr.save(steps, state, blocking=True)
    print(f"trained {steps - start} steps in {time.time() - t_total:.1f}s")
    return TrainReport(steps=steps, final_loss=losses[-1] if losses else
                       float("nan"), losses=losses, step_times=times,
                       resumed_from=start, state=state)


def train_elastic(cfg, cluster, *, steps: int, ckpt_dir: str, plan=None,
                  **kw):
    """Supervised elastic training over a ``VirtualCluster``: the
    ``ElasticRuntime`` loop (fault injection, communicator rebuild, tuning
    re-resolution, checkpointed recovery) behind one call.  Returns an
    ``ElasticReport``; extra kwargs go to the runtime (``global_batch``,
    ``seq``, ``save_every``, ``opts``, ...)."""
    from repro_torch.runtime.elastic import ElasticRuntime
    rt = ElasticRuntime(cfg, cluster, ckpt_dir=ckpt_dir, plan=plan, **kw)
    return rt.run(steps)
