"""Training a sparse-expert decoder on the stacked cluster: ``repro_torch.
runtime.steps.make_cluster_train_step`` with the port's dropless MoE block.

As ``drivers/train.py`` (whose session this one extends): set-up builds the
one train step the window drives, the parameters from
``reference.granite_moe.init_params`` laid out on the cluster, drives it
through the check steps and draws the window's batches; the window's unit
is one more step; after it the program's state is freed and the reference
(``reference.granite_moe.train``) follows the check steps from the same
parameters and batches.  The check steps also record the program's routing
(``models.moe.routes()``), which the reference takes at its near-ties, and
what was dropped, which has to be nothing.  The configuration file's
published multipliers and dropless routing go into the port's config here.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.drivers import train as dense
from portbench.reference import granite_moe as ref
from portbench.synthetic import SyntheticLM

#: Faults planted in the reference put in the program's place.
FAULTS = ref.FAULTS


def port_config(cfg: dict):
    """The port's ``ModelConfig`` at the configuration file's sizes, with
    its multipliers, dropless top-k routing and the softmax over the
    published vocabulary (the embedding's pad rows out of it)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MoESpec
    m = cfg["model"]
    return dataclasses.replace(
        get_config(cfg["port_config"]), n_layers=m["num_hidden_layers"],
        d_model=m["hidden_size"], n_heads=m["num_attention_heads"],
        n_kv=m["num_key_value_heads"], head_dim=m["head_dim"],
        d_ff=m["intermediate_size"], vocab=m["vocab_size"],
        rope_theta=float(m["rope_theta"]), norm_eps=m["rms_norm_eps"],
        tie_embeddings=m["tie_word_embeddings"],
        moe=MoESpec(num_experts=m["num_local_experts"],
                    top_k=m["num_experts_per_tok"],
                    d_ff_expert=m["intermediate_size"],
                    capacity_factor=None),
        embed_scale=m["embedding_multiplier"],
        residual_scale=m["residual_multiplier"],
        attn_scale=m["attention_multiplier"],
        logit_scale=m["logits_scaling"], mask_vocab_pad=True)


class Session(dense.Session):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from repro_torch.core import tree as T
        from repro_torch.kernels import flash_attention as kflash
        from repro_torch.kernels import flash_attention_bwd as kbwd
        from repro_torch.kernels import matmul as kmm
        from repro_torch.models import moe
        from repro_torch.runtime.steps import make_cluster_train_step
        from repro_torch.substrate import VirtualCluster
        if cfg["tf32"]:
            raise ValueError("the train driver runs f32 with TF32 off")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.kflash, self.kbwd, self.kmm, self.moe = kflash, kbwd, kmm, moe
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
        base = dense._requested(self.device)
        state = {"params": self.vc.layout(p0, specs["params"])}
        state["m"] = dense._zeros_like(state["params"])
        state["v"] = dense._zeros_like(state["params"])
        state_bytes = dense._requested(self.device) - base if \
            self.device.type == "cuda" else sum(
                t.numel() * t.element_size()
                for g in ("params", "m", "v") for t in T.leaves(state[g]))
        del p0, named
        state["step"] = self.vc.layout(torch.zeros((), dtype=torch.int32),
                                       specs["step"])
        self.state = state
        stream = SyntheticLM(dense.data_config(cfg, traffic, seed))
        check_batches = [stream.next_batch()
                         for _ in range(traffic["check_steps"])]
        self.pool = [stream.next_batch()
                     for _ in range(traffic["window_batches"])]
        self.prog = {"losses": [], "routes": {}}
        b1 = self.opt["b1"]
        assigned = kept = 0
        for i, batch in enumerate(check_batches):
            with moe.routes() as rec:
                mt = self._step(batch)
            self.prog["routes"].update(self._program_routes(rec["idx"], i))
            a, k = moe.drops(rec)
            assigned, kept = assigned + a, kept + k
            self.prog["losses"].append(float(mt["loss"][0]))
            if i == 0:
                self.prog["grad1"] = self._norms(
                    T.leaves(self.state["m"]), scale=1.0 / (1.0 - b1))
        self.prog["dropped_share"] = (assigned - kept) / max(assigned, 1)
        p0 = ref.init_params(self.model, seed, self.device)
        self.prog["update"] = self._norms(
            T.leaves(self.state["params"]),
            base=[w for _, w in ref.leaves(p0)])
        del p0
        nodes = topo["pods"]
        self.stats = {"state_bytes_per_node":
                      (state_bytes + self.bundle.stats["grad_bytes"]) / nodes}
        self.units = 0

    def _program_routes(self, ids: list, step: int) -> dict:
        """A check step's recorded routing ids as ``{(step, row, layer):
        (T, k)}``: each memory domain (a node, its ranks' rows folded, a
        row a rank) records its layers' forwards in order, then their
        recompute in the backward."""
        layers = self.model["num_hidden_layers"]
        per_domain = len(ids) // self.cfg["topology"]["pods"]
        out = {}
        for dom in range(self.cfg["topology"]["pods"]):
            for layer in range(layers):
                got = ids[dom * per_domain + layer]
                got = got.reshape((-1,) + tuple(got.shape[-2:]))
                for j in range(got.shape[0]):
                    out[(step, dom * got.shape[0] + j, layer)] = got[j]
        return out

    def counters(self) -> dict:
        t = self.moe.tally.read()
        got = {f"grouped_{k}_launches": v for k, v in
               self.kmm.grouped_launches_by_layout.items()}
        return {**super().counters(), **got,
                "moe_forwards": t["forwards"],
                "moe_load_max_ratio_sum": t["load_max_ratio_sum"]}

    def check(self) -> list:
        want = reference(self.cfg, self.traffic, self.seed, self.device,
                         program_routes=self.prog["routes"])
        return readings(self.cfg, self.prog, want)


def readings(cfg: dict, prog: dict, want: dict) -> list:
    """The gaps of ``prog`` to the reference ``want``, the share of
    assignments the reference took from ``prog`` at its near-ties, and the
    share ``prog`` dropped, each against its limit."""
    return dense.checks(cfg, {**ref.gaps(prog, want),
                              "tie_share": want["tie_share"],
                              "dropped_share": prog["dropped_share"]})


def control_readings(cell, seed: int, device) -> dict:
    """The control (the reference on TF32 operands) and each fault in
    ``FAULTS``, over the cell's check steps, judged as a run is: the
    reference takes each stand-in's routing at its near-ties."""
    cfg, tr = cell.config, cell.traffic
    out = {}
    for name, kw in [("control", {"precision": "tf32"})] + [
            (f, {"fault": f}) for f in FAULTS]:
        stand = reference(cfg, tr, seed, device, **kw)
        want = reference(cfg, tr, seed, device,
                         program_routes=stand["routes"])
        out[name] = readings(cfg, stand, want)
    return out


def reference(cfg: dict, traffic: dict, seed: int, device, **kw) -> dict:
    """The reference over the cell's check steps, from the parameters and
    batches the program received (``reference.granite_moe.train``; ``kw``
    picks a control precision, a planted fault or the program's routes)."""
    device = torch.device(device)
    p0 = ref.init_params(cfg["model"], seed, device)
    stream = SyntheticLM(dense.data_config(cfg, traffic, seed))
    batches = [torch.as_tensor(stream.next_batch()["tokens"], device=device)
               for _ in range(traffic["check_steps"])]
    return ref.train(p0, batches, cfg["model"], cfg["optimizer"],
                     nodes=cfg["topology"]["pods"],
                     margin=cfg["route_margin"], **kw)


def setup(cfg: dict, traffic: dict, seed: int, device) -> Session:
    return Session(cfg, traffic, seed, device)
