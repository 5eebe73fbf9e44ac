"""Training on the stacked cluster: ``repro_torch.runtime.steps.
make_cluster_train_step``.

Set-up builds the one train step the window drives, with its state laid out
on the cluster: the parameters from ``reference.qwen3.init_params`` (the
benchmark's own draw, on the card from the seed) through ``vc.layout``,
zero moments.  It drives that same step through the first ``check_steps``
batches of the seed's token stream, through the window's own call and feed
(``layout_batch`` then ``step``), and draws the stream's next
``window_batches`` batches, which the window takes in turn.  The check
steps warm every shape the window uses, and give the readings that the
reference follows: each step's loss, the first step's gradient as AdamW
received it (its first moment over 1 - b1, per leaf) and, per leaf, the
parameters' change over the check steps.  The window's unit is one more
step.  After the window the program's state is freed and the reference
(``reference.qwen3.train``) follows the check steps from the same
parameters and batches.
"""

from __future__ import annotations

import dataclasses
import gc

import torch

from portbench.check import Check
from portbench.reference import qwen3 as ref
from portbench.synthetic import DataConfig, SyntheticLM


def port_config(cfg: dict):
    """The port's ``ModelConfig`` at the configuration file's sizes."""
    from repro_torch.configs import get_config
    m = cfg["model"]
    return dataclasses.replace(
        get_config(cfg["port_config"]), n_layers=m["num_hidden_layers"],
        d_model=m["hidden_size"], n_heads=m["num_attention_heads"],
        n_kv=m["num_key_value_heads"], head_dim=m["head_dim"],
        d_ff=m["intermediate_size"], vocab=m["vocab_size"],
        qk_norm=m["qk_norm"], rope_theta=float(m["rope_theta"]),
        norm_eps=m["rms_norm_eps"],
        tie_embeddings=m["tie_word_embeddings"])


def _requested(device) -> int:
    from repro_torch.analysis.traffic import device_bytes
    return device_bytes(device) if device.type == "cuda" else 0


class Session:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from repro_torch.core import tree as T
        from repro_torch.kernels import flash_attention as kflash
        from repro_torch.kernels import flash_attention_bwd as kbwd
        from repro_torch.runtime.steps import make_cluster_train_step
        from repro_torch.substrate import VirtualCluster
        if cfg["tf32"]:
            raise ValueError("the train driver runs f32 with TF32 off")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.kflash, self.kbwd = kflash, kbwd
        self.model, self.opt, topo = cfg["model"], cfg["optimizer"], \
            cfg["topology"]
        self.batch, self.seq = traffic["global_batch"], traffic["seq_len"]
        self.vc = VirtualCluster(pods=topo["pods"], chips=topo["chips"],
                                 device=self.device)
        self.bundle = make_cluster_train_step(
            port_config(cfg), self.vc, mode=topo["mode"], lr=self.opt["lr"],
            weight_decay=self.opt["weight_decay"], clip=self.opt["clip"],
            global_batch=self.batch)
        specs = self.bundle.state_specs
        self.pspecs = T.leaves(specs["params"])
        want = T.leaves(self.bundle.abstract_state()["params"])

        p0 = ref.init_params(self.model, seed, self.device)
        named = ref.leaves(p0)
        got = [tuple(w.shape) for _, w in named]
        if got != [tuple(w.shape) for w in want]:
            raise ValueError(f"the benchmark's parameter tree {got} is not "
                             f"the step's {[tuple(w.shape) for w in want]}")
        self.names = [n for n, _ in named]
        base = _requested(self.device)
        state = {"params": self.vc.layout(p0, specs["params"])}
        state["m"] = _zeros_like(state["params"])
        state["v"] = _zeros_like(state["params"])
        state_bytes = _requested(self.device) - base if \
            self.device.type == "cuda" else sum(
                t.numel() * t.element_size()
                for g in ("params", "m", "v") for t in T.leaves(state[g]))
        del p0, named
        state["step"] = self.vc.layout(torch.zeros((), dtype=torch.int32),
                                       specs["step"])
        self.state = state
        stream = SyntheticLM(data_config(cfg, traffic, seed))
        check_batches = [stream.next_batch()
                       for _ in range(traffic["check_steps"])]
        self.pool = [stream.next_batch()
                     for _ in range(traffic["window_batches"])]
        self.prog = {"losses": []}
        b1 = self.opt["b1"]
        for i, batch in enumerate(check_batches):
            mt = self._step(batch)
            self.prog["losses"].append(float(mt["loss"][0]))
            if i == 0:
                self.prog["grad1"] = self._norms(
                    T.leaves(self.state["m"]), scale=1.0 / (1.0 - b1))
        p0 = ref.init_params(self.model, seed, self.device)
        self.prog["update"] = self._norms(
            T.leaves(self.state["params"]),
            base=[w for _, w in ref.leaves(p0)])
        del p0
        nodes = topo["pods"]
        self.stats = {"state_bytes_per_node":
                      (state_bytes + self.bundle.stats["grad_bytes"]) / nodes}
        self.units = 0

    def _norms(self, laid, *, scale: float = 1.0, base=None) -> dict:
        """Per leaf, the norm of the global tensor a laid-out leaf holds
        (member 0 of each replica), less ``base`` where given."""
        out = {}
        for i, (name, t, spec) in enumerate(zip(self.names, laid,
                                                self.pspecs)):
            g = self.vc.mesh.unlayout(t, spec)
            if base is not None:
                g = g - base[i]
            out[name] = float(g.norm()) * scale
        return out

    def _step(self, batch: dict) -> dict:
        laid = self.bundle.layout_batch(batch)
        self.state, mt = self.bundle.step(self.state, laid)
        return mt

    def step(self) -> None:
        self._step(self.pool[self.units % len(self.pool)])
        self.units += 1

    def counters(self) -> dict:
        return {"flash_fwd_launches": self.kflash.launches,
                "flash_bwd_launches": self.kbwd.launches,
                "steps": self.units}

    def end_to_end(self, window) -> dict:
        return {"train_tokens_per_s":
                window.units * self.batch * self.seq / window.seconds}

    def release(self) -> None:
        self.state = self.bundle = self.vc = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list[Check]:
        want = reference(self.cfg, self.traffic, self.seed, self.device)
        return checks(self.cfg, ref.gaps(self.prog, want))

    def failed_units(self, checks: list[Check]) -> int:
        return self.traffic["check_steps"]


def checks(cfg: dict, gaps: dict) -> list[Check]:
    """Each gap against the configuration's limit."""
    return [Check(k, v, cfg["limits"][k]) for k, v in gaps.items()]


#: Faults planted in the reference put in the program's place.  A step
#: that returns its state unchanged reads 1 on ``update_gap`` by the
#: measure itself and needs no run.
FAULTS = ("half_batch", "no_exchange")


def control_readings(cell, seed: int, device) -> dict[str, list[Check]]:
    """The control (the reference on TF32 operands) and each fault in
    ``FAULTS``, over the cell's check steps, judged as a run is."""
    cfg, tr = cell.config, cell.traffic
    want = reference(cfg, tr, seed, device)
    out = {"control": checks(cfg, ref.gaps(
        reference(cfg, tr, seed, device, precision="tf32"), want))}
    for f in FAULTS:
        out[f] = checks(cfg, ref.gaps(
            reference(cfg, tr, seed, device, fault=f), want))
    return out


def data_config(cfg: dict, traffic: dict, seed: int) -> DataConfig:
    """The cell's token stream from ``seed``."""
    return DataConfig(vocab=cfg["model"]["vocab_size"],
                      seq_len=traffic["seq_len"],
                      global_batch=traffic["global_batch"], seed=seed,
                      zipf_a=traffic["zipf_a"])


def reference(cfg: dict, traffic: dict, seed: int, device, **kw) -> dict:
    """The reference over the cell's check steps, from the parameters and
    batches the program received (``reference.qwen3.train``; ``kw`` picks
    a control precision or a planted fault)."""
    device = torch.device(device)
    p0 = ref.init_params(cfg["model"], seed, device)
    stream = SyntheticLM(data_config(cfg, traffic, seed))
    batches = [torch.as_tensor(stream.next_batch()["tokens"], device=device)
               for _ in range(traffic["check_steps"])]
    return ref.train(p0, batches, cfg["model"], cfg["optimizer"],
                     nodes=cfg["topology"]["pods"], **kw)


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def setup(cfg: dict, traffic: dict, seed: int, device) -> Session:
    return Session(cfg, traffic, seed, device)
