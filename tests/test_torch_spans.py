"""``core.spans``: the port's phase spans as ``torch.profiler`` sees them.

A span is a host event (a function-scope range, never a user annotation,
so nothing of it lands on the device timeline) that holds the ops of its
phase; with no profiler recording it records nothing.  SUMMA's round
phases, the train step's phases and the model ranges that
``analysis.profile`` reads (``moe::``, ``xlstm::``, ``tp::``) each appear
as such events.  The device side (CUDA event pairs) is checked on the card.
"""

from __future__ import annotations

import functools

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.apps import summa
from repro_torch.configs import get_config
from repro_torch.core import spans
from repro_torch.models import ParallelCtx, build
from repro_torch.runtime.steps import make_cluster_train_step
from repro_torch.substrate import VirtualCluster


def _host_events(fn) -> list:
    """The CPU events of one profiled call of ``fn``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e for e in prof.events() if e.device_type == DeviceType.CPU]


def _named(events, name: str) -> list:
    return [e for e in events if e.name == name]


def _inside(e, outer) -> bool:
    return (outer.time_range.start <= e.time_range.start
            and e.time_range.end <= outer.time_range.end)


def test_span_records_nothing_without_a_profiler():
    spans.reset()
    x = torch.ones(4)
    with spans.span("test::outer"):
        with spans.span("test::inner") as sp:
            x = x + 1
    assert sp.name == "test::inner"
    assert spans._pending == []
    assert spans.totals() == {}
    assert float(x[0]) == 2.0


def test_span_raises_through_and_closes_its_range():
    with pytest.raises(ValueError):
        with profile(activities=[ProfilerActivity.CPU]):
            with spans.span("test::raises"):
                raise ValueError("inside")
    with spans.span("test::after"):
        pass


class _Event:
    """A stand-in for a recorded CUDA event: its time in ms."""

    def __init__(self, t: float):
        self.t = t

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, end: "_Event") -> float:
        return end.t - self.t


def test_totals_sums_each_name_and_reset_clears():
    spans.reset()
    spans._pending.extend([("a", _Event(0.0), _Event(1.5)),
                           ("b", _Event(2.0), _Event(2.25)),
                           ("a", _Event(3.0), _Event(3.5))])
    assert spans.totals() == {"a": {"calls": 2, "ms": 2.0},
                              "b": {"calls": 1, "ms": 0.25}}
    assert spans._pending == []
    spans._pending.append(("b", _Event(0.0), _Event(1.0)))
    assert spans.totals()["b"] == {"calls": 2, "ms": 1.25}
    spans.reset()
    assert spans.totals() == {}


@functools.lru_cache(maxsize=None)
def _summa_events() -> tuple:
    g = torch.Generator().manual_seed(0)
    a = torch.randn((64, 64), generator=g)
    b = torch.randn((64, 64), generator=g)
    box = {}
    events = _host_events(lambda: box.setdefault(
        "c", summa.summa(a, b, scheme="hybrid")))
    torch.testing.assert_close(box["c"], a @ b, rtol=1e-5, atol=1e-4)
    return tuple(events)


@pytest.mark.parametrize("name,calls", [
    ("summa::multiply", 1), ("summa::blocks", 2), ("summa::a_panel", 4),
    ("summa::b_panel", 4), ("summa::accumulate", 4)])
def test_summa_phase_spans_are_host_events(name, calls):
    events = _summa_events()
    got = _named(events, name)
    assert len(got) == calls
    (outer,) = _named(events, "summa::multiply")
    for e in got:
        assert not e.is_user_annotation
        assert _inside(e, outer)
    if name != "summa::multiply":
        # each phase holds ops of its own
        assert all(e.cpu_children for e in got)


@functools.lru_cache(maxsize=None)
def _train_events() -> tuple:
    cfg = get_config("qwen3-0.6b").reduced(n_layers=1)
    vc = VirtualCluster(pods=2, chips=2, device="cpu")
    bundle = make_cluster_train_step(cfg, vc, mode="hier", global_batch=4)
    state = bundle.init_layout_state(0)
    tokens = torch.randint(0, cfg.vocab, (4, 17), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))

    def run():
        bundle.step(state, bundle.layout_batch({"tokens": tokens}))

    return tuple(_host_events(run))


@pytest.mark.parametrize("name,calls", [
    ("train::step", 1), ("train::forward_backward", 2),
    ("train::bridge", 1), ("train::optimizer", 2),
    ("train::layout_batch", 1)])
def test_train_step_phase_spans_are_host_events(name, calls):
    """On a 2x2 cluster in hier: one forward and backward per node (2
    domains); the optimizer's two parts (the per-token mean, grad norm and
    clip; AdamW) are one name."""
    events = _train_events()
    got = _named(events, name)
    assert len(got) == calls
    assert all(not e.is_user_annotation and e.cpu_children for e in got)
    (outer,) = _named(events, "train::step")
    for e in got:
        assert _inside(e, outer) == (name != "train::layout_batch")


def _model_run(arch: str):
    cfg = get_config(arch).reduced()
    model = build(cfg, ParallelCtx.single(), device="cpu")
    params = model.init_params(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 17),
                                     dtype=torch.int32)}
    return lambda: model.loss_fn(params, batch)


def _tp_run():
    vc = VirtualCluster(pods=1, chips=2, fast_axis=("tp",), fast_shape=(2,),
                        device="cpu")
    ctx = ParallelCtx(tp_axis="tp", tp=2, compute_dtype=torch.float32)
    x = torch.randn(2, 3, 4, 5)

    def run():
        with vc.bind():
            ctx.psum_tp(x)
            ctx.ag_tokens(x)
            ctx.rs_tokens(x)
    return run


@pytest.mark.parametrize("names,make", [
    (("moe::route", "moe::dispatch", "moe::experts", "moe::combine"),
     lambda: _model_run("granite-moe-3b-a800m")),
    (("xlstm::mlstm_intra", "xlstm::mlstm_prefix", "xlstm::slstm_loop"),
     lambda: _model_run("xlstm-1.3b")),
    (("tp::psum_tp", "tp::ag_tokens", "tp::rs_tokens"), _tp_run),
], ids=["moe", "xlstm", "tp"])
def test_model_ranges_keep_their_names_as_host_events(names, make):
    """The names ``analysis.profile`` reads (``MOE_RANGES``,
    ``XLSTM_RANGES``, ``TP_RANGES``), now spans."""
    events = _host_events(make())
    for name in names:
        got = _named(events, name)
        assert got, name
        assert all(not e.is_user_annotation for e in got)
