"""The program's tracer (`bbx_torch.utils.profiling`): spans, counts, the
off path, the profiler's timeline, idle time by span, and the spans and
counts the training iteration and the eval job leave, on the CPU."""
import os
import re

import pytest
import torch

from bbx_torch.agent.trainer import PPOTrainer
from bbx_torch.cli import evaluate as EV
from bbx_torch.models import network_from_config
from bbx_torch.utils import profiling as P

TINY_NET = {"type": "afterstate", "eval_channels": [4, 4], "eval_hidden": 8,
            "ctx_dim": 6, "value_channels": [4, 4], "value_hidden": 16,
            "compute_dtype": "float32"}
CFG = {"training": {"num_envs": 4, "rollout_steps": 4, "batch_size": 8},
       "ppo": {"num_epochs": 2}, "network": TINY_NET}
SPAN_NAMES = ("train.iteration", "ppo.rollout", "ppo.rollout.step", "ppo.rollout.policy",
              "ppo.rollout.env", "ppo.rollout.record", "ppo.rollout.last_value", "ppo.gae",
              "ppo.update", "ppo.update.minibatch", "ppo.update.forward",
              "ppo.update.backward", "ppo.update.optimizer", "engine.step")


@pytest.fixture
def tracer():
    """The program's tracer, on, with nothing recorded; off and emptied
    afterwards."""
    P.snapshot(clear=True)
    P.enable()
    try:
        yield P.TRACER
    finally:
        P.disable()
        P.snapshot(clear=True)


def _children(spans, parent):
    return sorted(s["name"] for s in spans if s["parent"] == parent["id"])


def test_spans_nest_with_parent_and_root_on_the_host_clock(tracer, monkeypatch):
    ticks = iter(range(100, 200))
    monkeypatch.setattr(P.time, "perf_counter", lambda: float(next(ticks)))
    with P.span("job", lanes=3):
        with P.span("chunk"):
            with P.span("step", device=True):
                pass
        with P.span("poll"):
            P.count("lane_steps", 4)
    with P.span("job"):
        pass
    spans = {(s["name"], s["start"]): s for s in P.snapshot()["spans"]}
    job, chunk, step = spans["job", 100.0], spans["chunk", 101.0], spans["step", 102.0]
    poll, job2 = spans["poll", 105.0], spans["job", 108.0]
    assert (job["parent"], job["root"], job["end"], job["attrs"]) == (None, job["id"], 107.0,
                                                                     {"lanes": 3})
    assert (chunk["parent"], chunk["root"], chunk["end"]) == (job["id"], job["id"], 104.0)
    assert (step["parent"], step["root"], step["end"]) == (chunk["id"], job["id"], 103.0)
    assert (poll["parent"], poll["root"], poll["counts"]) == (job["id"], job["id"],
                                                              {"lane_steps": 4})
    assert job2["root"] == job2["id"] != job["id"] and job2["parent"] is None
    # A device span on the CPU keeps its host times only.
    assert step["device_ms"] is None
    assert len({s["id"] for s in spans.values()}) == 5


def test_counts_sum_ints_and_tensors_on_the_innermost_span(tracer):
    t = torch.tensor(2)
    with P.span("outer"):
        P.count("c", t)
        with P.span("inner"):
            P.count("c", 5)
        P.count("c", t)
    P.count("loose", 1)
    assert int(t) == 2
    snap = P.snapshot(clear=True)
    by_name = {s["name"]: s for s in snap["spans"]}
    assert by_name["outer"]["counts"] == {"c": 4} and by_name["inner"]["counts"] == {"c": 5}
    assert snap["counts"]["c"] == 9 and snap["counts"]["loose"] == 1
    assert P.snapshot()["spans"] == []


def test_off_keeps_nothing_and_adds_no_event_annotation_or_op(monkeypatch):
    """Off, a site gets the shared no-op back: no span object, no CUDA
    event, no `record_function`, no operation on a counted tensor, even
    under a profiler session, and nothing is kept."""
    def refuse(*args, **kwargs):
        raise AssertionError("the tracer is off")

    assert not P.TRACER.enabled
    P.snapshot(clear=True)
    for name in ("_Span", "_add"):
        monkeypatch.setattr(P, name, refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    t = torch.ones(())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with P.span("x", device=True, lanes=1) as a, P.span("y") as b:
            P.count("c", t)
    assert a is b is None and P.span("z") is P.span("w", device=True)
    assert not [e.name for e in prof.events() if e.name in ("x", "y") or "add" in e.name]
    assert int(t) == 1
    snap = P.snapshot()
    assert snap["spans"] == [] and "c" not in snap["counts"]


def test_an_iteration_off_opens_no_span(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the tracer is off")

    monkeypatch.setattr(P, "_Span", refuse)
    trainer = PPOTrainer(CFG, seed=3, device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trainer.iterate()
    assert not {e.name for e in prof.events()} & set(SPAN_NAMES)


def test_spans_are_record_functions_under_a_profiler(tracer):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with P.span("a.outer"):
            with P.span("a.inner", device=True):
                torch.ones(4) + 1
    names = [e.name for e in prof.events()]
    assert "a.outer" in names and "a.inner" in names
    with P.span("after"):
        pass
    assert "after" not in tracer._annotated and {"a.outer", "a.inner"} <= tracer._annotated


def test_idle_by_span_on_a_synthetic_timeline():
    """Each gap between device operations goes to the shortest span over
    its midpoint: (20, 30) to chunk, (40, 60) to poll, (70, 100) to job,
    (110, 200) to none."""
    device = [(0, 10), (5, 20), (30, 40), (60, 70), (100, 110), (200, 210)]
    spans = [(0, 120, "job"), (25, 65, "chunk"), (45, 58, "poll")]
    out = P.idle_by_span(device, spans)
    assert out["busy_s"] == pytest.approx(60e-6) and out["idle_s"] == pytest.approx(150e-6)
    got = {k: round(v * 1e6, 6) for k, v in out["by_span"]}
    assert got == {P.NO_SPAN: 90.0, "job": 30.0, "poll": 20.0, "chunk": 10.0}
    assert [k for k, _ in out["by_span"]] == [P.NO_SPAN, "job", "poll", "chunk"]


def test_trace_reports_idle_by_span(tmp_path, tracer):
    P.disable()
    with P.trace(str(tmp_path / "t")) as t:
        with P.span("inside"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        assert P.TRACER.enabled
    assert not P.TRACER.enabled and t.log_dir == str(tmp_path / "t")
    assert t.idle == {"busy_s": 0.0, "idle_s": 0.0, "by_span": []}  # no device here
    assert t.report().startswith("idle by span:")


def test_launch_counters_are_every_wrapper_that_counts(tracer):
    """`LAUNCH_COUNTERS` names each ``<wrapper>.launches = 0`` of the
    package, and the snapshot reads them as ``launches.<wrapper>``."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(P.__file__)))
    found = set()
    for folder, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(folder, name)
                module = os.path.relpath(path[:-3], os.path.dirname(root)).replace(os.sep, ".")
                with open(path) as f:
                    for fn in re.findall(r"^(\w+)\.launches = 0$", f.read(), re.M):
                        found.add(f"{module}:{fn}")
    assert found == set(P.LAUNCH_COUNTERS)
    from bbx_torch.agent import ppo

    ppo.compute_gae.launches += 2
    try:
        assert P.snapshot()["counts"]["launches.compute_gae"] == ppo.compute_gae.launches
    finally:
        ppo.compute_gae.launches -= 2


def test_a_training_iteration_leaves_its_spans(tracer):
    trainer = PPOTrainer(CFG, seed=3, device="cpu")
    trainer.iterate()
    spans = P.snapshot()["spans"]
    (it,) = [s for s in spans if s["name"] == "train.iteration"]
    assert all(s["root"] == it["id"] for s in spans)
    assert _children(spans, it) == ["ppo.gae", "ppo.rollout", "ppo.update"]
    (roll,) = [s for s in spans if s["name"] == "ppo.rollout"]
    steps = [s for s in spans if s["name"] == "ppo.rollout.step"]
    assert len(steps) == trainer.ppo.rollout_steps
    assert _children(spans, roll) == ["ppo.rollout.last_value"] + ["ppo.rollout.step"] * 4
    for s in steps:
        assert s["parent"] == roll["id"]
        assert _children(spans, s) == ["ppo.rollout.env", "ppo.rollout.policy",
                                       "ppo.rollout.record"]
    (env,) = [s for s in spans if s["name"] == "ppo.rollout.env"][:1]
    assert _children(spans, env) == ["engine.step"]
    mbs = [s for s in spans if s["name"] == "ppo.update.minibatch"]
    assert len(mbs) == trainer.ppo.num_epochs * trainer.ppo.num_minibatches == 4
    for s in mbs:
        assert _children(spans, s) == ["ppo.update.backward", "ppo.update.forward",
                                       "ppo.update.optimizer"]
    assert all(s["device_ms"] is None and s["end"] >= s["start"] for s in spans)


@pytest.mark.parametrize("mode", ["greedy", "sampled", "search"])
def test_an_eval_job_counts_its_live_lane_steps(tracer, monkeypatch, mode):
    """`eval.live_lane_steps` equals the lane-steps counted one by one on
    lanes whose game had not ended, and `eval.lane_steps` every lane-step."""
    net = network_from_config(TINY_NET, generator=torch.Generator().manual_seed(1))
    live, steps = [], []
    step = EV.step

    def counted(state, action, *args, **kwargs):
        live.append(int((~state.done).sum()))
        steps.append(state.num_envs)
        return step(state, action, *args, **kwargs)

    monkeypatch.setattr(EV, "step", counted)
    EV.evaluate_policy(net, num_episodes=6, deterministic=mode != "sampled", seed=5,
                       max_steps=96, chunk=8, lookahead=mode == "search", topk=3,
                       device="cpu")
    snap = P.snapshot()
    assert snap["counts"]["eval.live_lane_steps"] == sum(live) > 0
    assert snap["counts"]["eval.lane_steps"] == sum(steps) > sum(live)
    (job,) = [s for s in snap["spans"] if s["name"] == "eval.job"]
    assert job["attrs"] == {"lanes": 6}
    chunks = [s for s in snap["spans"] if s["name"] == "eval.chunk"]
    assert len(chunks) * 8 == len(steps)
    assert len([s for s in snap["spans"] if s["name"] == "eval.poll"]) == len(chunks)
    looks = [s for s in snap["spans"] if s["name"] == "search.lookahead"]
    assert len(looks) == (len(steps) if mode == "search" else 0)
    assert all(s["attrs"] == {"lanes": 6 * 3} for s in looks)
