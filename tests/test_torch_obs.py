"""The port's ``repro_torch.obs`` against the JAX package's ``repro.obs``.

  * Metrics ride beside the run: a metrics-on ``simulator.run`` equals a
    metrics-off one bit for bit in every other field (theta, bank and EF
    state included) and makes the same kernel launches, on both backends
    (``cuda`` over CPU tensors runs the kernels' plain versions; the card
    tests hold the launches on the card).
  * ``metric_names`` equals the JAX package's for every registry algorithm
    and transport; the bags of f64 runs (linreg m=5, n_per=30, d=20, 60
    iterations) against the JAX package's: counts, exact byte counters and
    the stage scalars (eps1, alpha, beta, tau, round) exact; the rates
    within 1e-7 absolute (f32 means of the mask: XLA's CPU code contracts
    ``1 - sum * (1/M)`` into one FMA and reads -1.5e-8 where every worker
    sent); the f32 norms (``*_sqnorm*``) within rtol 1e-6 wherever the
    value is above 1e-8 of its series' largest: both packages sum f64
    inputs that agree to about 1e-12 in f32, and below that share the
    inputs' cross-package differences outgrow the f32 rounding (the runs'
    last iterations reach the f64 noise floor).
  * ``run_edge(runlog=)`` writes the JAX package's events for a straggler
    deployment: equal keys, steps and cohort sizes; counts, bytes, energy,
    wall clock and staleness buckets exact; the f32 norms within rtol 1e-6.
  * ``compile_log`` (the ``kernels`` namespace is ``LAUNCHES``), the
    ``RunLog`` schema, ``bench`` artifacts (a port artifact passes the JAX
    package's validator, in-process and through its CLI) and the profiler
    hooks.
"""
import json
import os
import subprocess
import sys

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest
import torch

from repro import fed as j_fed
from repro import obs as j_obs
from repro import opt as j_opt
from repro.core import simulator as j_simulator
from repro.data import paper_tasks as j_paper
from repro_torch import fed, obs, opt, sweep
from repro_torch.core import simulator
from repro_torch.core.accounting import MIB, CommStats
from repro_torch.data import paper_tasks
from repro_torch.kernels import common
from repro_torch.obs import bench, compile_log
from repro_torch.tree import tree_leaves

M = 5
ITERS = 60
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = [("gd", {}), ("hb", {}), ("lag", {}), ("chb", {}),
         ("csgd", {"tau0": 0.05}),
         ("chb", {"quantize": "int8"}),
         ("chb", {"transport": "topk", "k": 8}),
         ("chb", {"transport": "lowrank", "rank": 2})]
IDS = ["gd", "hb", "lag", "chb", "csgd", "chb-int8", "chb-topk",
       "chb-lowrank"]


@pytest.fixture(scope="module")
def linreg():
    return paper_tasks.make_linear_regression(m=M, n_per=30, d=20, seed=0,
                                              device="cpu")


@pytest.fixture(scope="module")
def j_linreg():
    return j_paper.make_linear_regression(m=M, n_per=30, d=20, seed=0)


def _adaptive(pkg, alpha):
    return pkg.ComposedOptimizer(
        censor=pkg.AdaptiveCensor(adaptive=1.0),
        transport=pkg.DenseTransport(),
        server=pkg.HeavyBall(alpha, 0.4), num_workers=M)


# ===================================================== bits and launches
@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name,kw", [("chb", {}), ("chb", {"quantize":
                                                           "int8"}),
                                     ("csgd", {"tau0": 0.05})],
                         ids=["chb", "chb-int8", "csgd"])
def test_metrics_on_equals_metrics_off(linreg, name, kw, dtype, backend):
    task = simulator.task_to(linreg.task, dtype=dtype)
    o = opt.make(name, linreg.alpha_paper, M, backend=backend, **kw)
    common.reset_launches()
    h0 = simulator.run(o, task, 40, device="cpu")
    off = dict(common.LAUNCHES)
    common.reset_launches()
    h1 = simulator.run(o, task, 40, device="cpu", collect_metrics=True)
    assert dict(common.LAUNCHES) == off
    assert h0.metrics == ()
    for f in ("objective", "comm_cum", "mask", "agg_grad_sqnorm"):
        assert torch.equal(getattr(h0, f), getattr(h1, f)), f
    s0, s1 = h0.final_state, h1.final_state
    for a, b in zip(tree_leaves([h0.final_params, s0.ghat, s0.err,
                                 list(s0.comm), s0.censor]),
                    tree_leaves([h1.final_params, s1.ghat, s1.err,
                                 list(s1.comm), s1.censor])):
        assert torch.equal(a, b)
    assert all(v.shape == (40,) for v in h1.metrics.values())


def test_base_bag_contents(linreg):
    h = simulator.run(opt.make("chb", linreg.alpha_paper, M), linreg.task,
                      ITERS, device="cpu", collect_metrics=True)
    bag = h.metrics
    np.testing.assert_allclose(bag["censor_rate"].numpy(),
                               1.0 - h.mask.numpy().mean(axis=1), atol=1e-7)
    assert torch.equal(bag["comm/uplink_total"], h.comm_cum)
    assert float(bag["comm/uplink_bytes"][-1]) == \
        h.final_state.comm.uplink_bytes_exact()
    assert torch.equal(bag["comm/iterations"],
                       torch.arange(1, ITERS + 1, dtype=torch.int32))
    assert torch.equal(bag["agg_grad_sqnorm"], h.agg_grad_sqnorm)
    assert float(bag["bank_sqnorm"][-1]) == float(torch.sum(torch.square(
        h.final_state.ghat.to(torch.float32))))
    assert float(bag["censor/eq8/eps1"][0]) == np.float32(
        opt.make("chb", linreg.alpha_paper, M).eps1)


def test_stage_hooks(linreg):
    a = linreg.alpha_paper
    h = simulator.run(opt.make("csgd", a, M, tau0=5.0), linreg.task, 30,
                      device="cpu", collect_metrics=True)
    tau = h.metrics["censor/stochastic/tau"].numpy()
    assert tau.shape == (30,) and tau[0] > tau[-1] > 0
    assert torch.equal(h.metrics["censor/stochastic/round"],
                       torch.arange(1, 31, dtype=torch.int32))
    h = simulator.run(_adaptive(opt, a), linreg.task, 30, device="cpu",
                      collect_metrics=True)
    assert float(h.metrics["censor/adaptive/ema_max"][-1]) >= \
        float(h.metrics["censor/adaptive/ema_mean"][-1]) > 0


# ===================================================== against the JAX bags
@pytest.mark.parametrize("name,kw", CASES + [("adaptive", {})],
                         ids=IDS + ["adaptive"])
def test_metric_names_equal_jax(linreg, j_linreg, name, kw):
    a = linreg.alpha_paper
    if name == "adaptive":
        o, jo = _adaptive(opt, a), _adaptive(j_opt, a)
    else:
        o, jo = opt.make(name, a, M, **kw), j_opt.make(name, a, M, **kw)
    assert obs.metric_names(o, linreg.task.init_params) == \
        j_obs.metric_names(jo, j_linreg.task.init_params)


def _rate(k):
    return k.endswith("_rate")


def _norm(k):
    return "sqnorm" in k


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_bag_values_match_jax(linreg, j_linreg, name, kw):
    a = linreg.alpha_paper
    h = simulator.run(opt.make(name, a, M, **kw), linreg.task, ITERS,
                      device="cpu", collect_metrics=True)
    jh = j_simulator.run(j_opt.make(name, a, M, **kw), j_linreg.task,
                         ITERS, collect_metrics=True)
    assert sorted(h.metrics) == sorted(jh.metrics)
    for k, v in h.metrics.items():
        got, want = v.numpy(), np.asarray(jh.metrics[k])
        assert got.dtype == want.dtype, k
        if _rate(k):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-7,
                                       err_msg=k)
        elif _norm(k):
            live = np.abs(want) > 1e-8 * np.abs(want).max()
            np.testing.assert_allclose(got[live], want[live], rtol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


def test_commstats_exact_past_2pow24():
    stats = CommStats.init(4, "cpu")
    payload = 3 * MIB + 17          # odd size: exercises the carry
    mask = torch.ones((4,), dtype=torch.float32)
    for _ in range(2000):
        stats = stats.update(mask, payload)
    exact = stats.uplink_bytes_exact()
    assert exact == 4 * 2000 * payload > (1 << 24)
    bag = stats.metrics()
    assert float(bag["comm/uplink_bytes"]) == float(exact)
    assert set(bag) == {"comm/uplink_total", "comm/uplink_bytes",
                        "comm/downlink_count", "comm/iterations"}


def test_summarize_and_merge():
    series = {"a": torch.arange(5.0), "b": np.ones(5)}
    assert obs.summarize(series) == {"a": 4.0, "b": 1.0}
    assert obs.summarize(series, reducer=np.mean)["a"] == 2.0
    bags = [{"censor_rate": torch.tensor(0.5), "ema_max": torch.tensor(2.0),
             "ema_min": torch.tensor(1.0), "drops": torch.tensor(3.0)},
            {"censor_rate": torch.tensor(1.0), "ema_max": torch.tensor(5.0),
             "ema_min": torch.tensor(0.5), "drops": torch.tensor(4.0)}]
    out = obs.metrics.merge_shard_bags(bags, weights=[1.0, 3.0])
    want = j_obs.metrics.merge_shard_bags(
        [{k: np.float32(v) for k, v in b.items()} for b in bags],
        weights=[1.0, 3.0])
    for k, v in want.items():
        assert float(out[k]) == pytest.approx(float(v)), k
    assert obs.metrics.merge_shard_bags([]) == {}


# =============================================================== sweep
def test_sweep_metrics_add_no_launches_or_partitions(linreg):
    grid = sweep.ConfigGrid(alpha=[0.5 * linreg.alpha_paper,
                                   linreg.alpha_paper],
                            beta=[0.0, 0.4], eps1=[0.5, 2.0])
    base = opt.make("chb", linreg.alpha_paper, M, backend="cuda")
    with compile_log.track() as off:
        res0 = sweep.run_sweep(grid, linreg.task, num_iters=40,
                               base_cfg=base, device="cpu")
    with compile_log.track() as on:
        res1 = sweep.run_sweep(grid, linreg.task, num_iters=40,
                               base_cfg=base, collect_metrics=True,
                               device="cpu")
    assert res0.num_programs == res1.num_programs == 1
    assert on.counts == off.counts
    assert on.counts["sweep/partition"] == 1
    assert on.counts["simulator/trajectory"] == 8
    for i in range(len(res0)):
        assert torch.equal(res0.history(i).objective,
                           res1.history(i).objective)
        assert res0.metrics(i) == {}
        bag = res1.metrics(i)
        assert bag["censor_rate"].shape == (40,)
        assert float(bag["censor/eq8/eps1"][-1]) == pytest.approx(
            res1.points[i].eps1)
    summary = res1.metrics_summary()
    assert len(summary) == len(res1)
    json.dumps(summary)
    assert "metrics" in json.loads(res1.to_json(include_trajectories=False))
    assert "metrics" not in json.loads(
        res0.to_json(include_trajectories=False))


# ========================================================== compile_log
def test_compile_log_namespaces_and_track():
    compile_log.reset("t-ns")
    ns = compile_log.namespace("t-ns")
    compile_log.record("t-ns", "x")
    compile_log.record("t-ns", "x")
    assert ns == {"x": 2}               # the live dict
    with compile_log.track() as tc:
        compile_log.record("t-ns", "y")
    assert tc.counts == {"t-ns/y": 1}   # the delta only
    assert tc.total("t-ns") == 1
    assert compile_log.snapshot()["t-ns/x"] == 2
    compile_log.reset("t-ns")
    assert ns == {}


def test_kernels_namespace_is_launches():
    assert compile_log.namespace("kernels") is common.LAUNCHES
    common.count_launch("hb_update")
    assert compile_log.counts("kernels")["hb_update"] >= 1
    compile_log.reset("kernels")
    # reset keeps every kernel's key, at 0: readers compare whole dicts
    assert common.LAUNCHES == {k: 0 for k in common.KERNELS}
    with compile_log.track() as tc:
        common.count_launch("sqnorm_batched")
    assert tc.counts == {"kernels/sqnorm_batched": 1}
    common.reset_launches()


def test_fed_ticks_count_calls(linreg):
    o = opt.make("chb", linreg.alpha_paper, M)
    with compile_log.track() as t5:
        fed.run_edge(o, linreg.task, fed.sync_config(M), 5, device="cpu")
    assert t5.counts["fed/server_update"] == 5
    assert t5.counts["fed/client_eval"] == 5 * M
    with compile_log.track() as t:
        simulator.run(o, linreg.task, 3, device="cpu")
        simulator.run(o, linreg.task, 4, device="cpu")
    assert t.counts["simulator/trajectory"] == 2


# ================================================================ RunLog
def test_runlog_jsonl_roundtrip(tmp_path):
    path = str(tmp_path / "run.jsonl")
    spec = {"algo": "chb"}
    with obs.RunLog(path, run="t", backend="cuda", spec=spec) as log:
        log.write_round(0, {"censor_rate": torch.tensor(0.25),
                            "v": torch.arange(3)})
        log.write_point(3, {"final_err": 1e-6}, spec={"algo": "gd"},
                        note="tagged")
    events = obs.read_jsonl(path)
    assert [e["event"] for e in events] == ["round", "point"]
    for e in events:
        assert e["schema_version"] == obs.EVENT_SCHEMA_VERSION \
            == j_obs.EVENT_SCHEMA_VERSION
        assert e["run"] == "t" and e["backend"] == "cuda"
    assert events[0]["metrics"] == {"censor_rate": 0.25, "v": [0, 1, 2]}
    assert events[0]["spec"] == spec
    assert events[1]["spec"] == {"algo": "gd"}
    assert events[1]["note"] == "tagged"
    with obs.RunLog(path, run="t2") as log:
        log.write("done")
    assert len(obs.read_jsonl(path)) == 3
    mem = obs.RunLog(run="mem")
    mem.write_round(0, {"x": np.float64(1.5)})
    assert json.loads(mem.lines[0])["metrics"]["x"] == 1.5
    # the same event through both writers has the same layout
    jmem = j_obs.RunLog(run="mem")
    jmem.write_round(0, {"x": np.float64(1.5)})
    assert json.loads(mem.lines[0]) == json.loads(jmem.lines[0])


def _stragglers(pkg):
    return pkg.EdgeConfig(
        population=pkg.straggler_population(
            M, compute_mean_s=1.0, straggler_frac=0.4,
            straggler_slowdown=25.0, jitter="exp", seed=3),
        channel=pkg.ChannelConfig.lossy(0.15, uplink_rate_bps=1e6),
        quorum=3.0 / 5.0, seed=3)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_run_edge_runlog_matches_jax(linreg, j_linreg, backend):
    a = linreg.alpha_paper
    log, jlog = obs.RunLog(run="edge", backend=backend), \
        j_obs.RunLog(run="edge", backend=backend)
    h = fed.run_edge(opt.make("chb", a, M, backend=backend), linreg.task,
                     _stragglers(fed), 30, collect_metrics=True, runlog=log,
                     device="cpu")
    j_fed.run_edge(j_opt.make("chb", a, M), j_linreg.task,
                   _stragglers(j_fed), 30, runlog=jlog)
    events = [json.loads(x) for x in log.lines]
    jevents = [json.loads(x) for x in jlog.lines]
    assert len(events) == len(jevents) == 30
    late = 0
    for e, je in zip(events, jevents):
        assert set(e) == set(je) and set(e["metrics"]) == set(je["metrics"])
        for k in ("event", "step", "cohort_size", "run", "backend"):
            assert e[k] == je[k], k
        for k, v in e["metrics"].items():
            if _norm(k):
                assert v == pytest.approx(je["metrics"][k], rel=1e-6), k
            else:
                assert v == je["metrics"][k], k
        late += e["metrics"]["staleness/h1"] + e["metrics"][
            "staleness/h2_3"] + e["metrics"]["staleness/h4p"]
        # the event carries the round's collected bag
        assert e["metrics"]["folds"] == float(h.mask[e["step"]].sum())
    assert late > 0 and sum(e["metrics"]["drops"] for e in events) > 0


# ================================================================ bench
def _tiny_artifact(pkg, name="t"):
    return pkg.make_artifact(name, {
        "k": {"row": "k,10.0,d=1", "seconds": 0.1,
              "backend": ["reference", "cuda"],
              "specs": {"reference": {"algo": "chb"}},
              "measured_bytes": {"reference": 100.0},
              "analytic_bytes": {"reference": 90.0}}},
        registry=list(opt.names()))


def test_bench_artifact_passes_the_jax_validator(tmp_path):
    doc = _tiny_artifact(bench)
    assert doc["schema_version"] == bench.SCHEMA_VERSION \
        == j_obs.bench.SCHEMA_VERSION
    assert doc["kind"] == j_obs.bench.KIND
    env = doc["env"]
    assert env["jax_version"] is None and env["x64"] is True
    assert env["backend"] == ("gpu" if torch.cuda.is_available() else "cpu")
    assert env["torch_version"] == torch.__version__
    assert set(j_obs.bench.environment()) <= set(env)
    assert j_obs.bench.validate_artifact(doc) == []
    p = str(tmp_path / "BENCH_t.json")
    bench.write_artifact(doc, p)
    assert bench.load_artifact(p) == doc == j_obs.bench.load_artifact(p)
    with pytest.raises(ValueError, match="collides"):
        bench.make_artifact("t", {}, extra={"kind": "x"})


@pytest.mark.parametrize("mutate,msg", [
    (lambda d: d.pop("schema_version"), "schema_version"),
    (lambda d: d.update(schema_version=99), "newer"),
    (lambda d: d.update(kind="other"), "kind"),
    (lambda d: d.update(env=None), "env"),
    (lambda d: d["env"].pop("x64"), "x64"),
    (lambda d: d.update(failed=None), "failed"),
    (lambda d: d["benchmarks"]["k"].pop("row"), "row"),
    (lambda d: d["benchmarks"]["k"].update(seconds="1"), "seconds"),
    (lambda d: d["benchmarks"]["k"].update(specs=3), "specs"),
    (lambda d: d["benchmarks"]["k"].update(backend=3), "backend"),
    (lambda d: d["benchmarks"]["k"].update(measured_bytes=[1]),
     "measured_bytes"),
])
def test_bench_validation_catches(mutate, msg):
    doc = _tiny_artifact(bench)
    mutate(doc)
    errs = bench.validate_artifact(doc)
    assert errs and any(msg in e for e in errs), errs
    assert errs == j_obs.bench.validate_artifact(doc)


def test_bench_validate_clis(tmp_path):
    good = str(tmp_path / "good.json")
    bench.write_artifact(_tiny_artifact(bench), good)
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        json.dump({"schema_version": 1}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    ok = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.bench", "--validate", good],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert j_obs.bench._main(["--validate", good]) == 0
    assert bench._main(["--validate", bad]) == 1
    assert bench._main(["--validate", str(tmp_path / "missing.json")]) == 1
    assert bench.card_line() is None or "," in bench.card_line()


# ======================================================= profiler hooks
def test_annotate_and_named_scope_run():
    with obs.annotate("test/span"):
        x = torch.ones(3) + 1
    assert float(x.sum()) == 6.0

    @obs.annotate_fn()
    def f(v):
        return v * 2
    assert float(f(torch.tensor(2.0))) == 4.0
    with obs.named_scope("test/scope"):
        assert float(f(torch.tensor(1.0))) == 2.0


def test_profiler_trace_capture(tmp_path):
    with obs.trace(str(tmp_path / "prof")) as prof:
        with obs.annotate("traced/span"):
            torch.arange(8.0).sum()
    assert prof is not None
    assert (tmp_path / "prof" / "trace.json").exists()
    assert any(e.key == "traced/span" for e in prof.key_averages())
