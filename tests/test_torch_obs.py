"""The port's observability layer (``repro_torch.obs`` trace, log and report;
``repro_torch.core.retry``) against the JAX reference's: the same schema,
timing keys, span encoding, log lines, report text and retry schedule; and
on the port's own campaign runs (CPU), probes on and off byte-identical to
the reference's records, trace determinism, the cost and slot-budget fields
of dispatch spans, and the ``torch.profiler`` trace of ``profile_dir``."""
import json

import numpy as np
import pytest

from repro import obs as ref_obs
from repro import sweep as ref_sweep
from repro.core.retry import retry_call as ref_retry_call
from repro.obs import report as ref_report

from repro_torch import obs, sweep
from repro_torch.core.retry import retry_call
from repro_torch.obs import (TIMING_KEYS, TRACE_SCHEMA, SweepLogger,
                             TraceWriter, dispatch_line, load_trace,
                             render_report, strip_timing)
from repro_torch.obs import report, trace as trace_mod
from repro_torch.sweep import compile_cache

from _torch_compare import one_jax_device

SEEDS = (0, 1)


def _fast(pkg, **kw):
    base = dict(name="obs", schemes=("host_pkt", "simple_rr"),
                loads=(pkg.WorkloadSpec("permutation", 32,
                                        inter_pod_only=True),),
                trees=(4,), seeds=SEEDS)
    base.update(kw)
    return pkg.Campaign(**base)


def _loop(pkg, **kw):
    base = dict(name="obs_loop", schemes=("host_pkt",),
                loads=(pkg.WorkloadSpec("permutation", 16,
                                        inter_pod_only=True),),
                trees=(4,), seeds=SEEDS, engine="loop", max_slots=8000)
    base.update(kw)
    return pkg.Campaign(**base)


def _port_run(c, **kw):
    return sweep.run_campaign(c, compile_cache_dir=False, device="cpu", **kw)


@pytest.fixture(scope="module")
def probed():
    """Fast and loop campaigns with probes on: (reference records, port
    records) of each, the port's with its trace."""
    spec = ref_obs.ProbeSpec(stride=8, samples=64)
    out = {}
    for tag, make in (("fast", _fast), ("loop", _loop)):
        with one_jax_device():
            ref, _ = ref_sweep.run_campaign(make(ref_sweep, probes=spec),
                                            compile_cache_dir=False)
        tw = TraceWriter()
        port, _ = _port_run(make(sweep, probes=obs.ProbeSpec(8, 64)),
                            trace=tw)
        out[tag] = (ref, port, tw.spans)
    return out


# ---- the modules against the reference's ----------------------------------

def test_trace_schema_and_timing_keys_match_reference():
    assert TRACE_SCHEMA == ref_obs.TRACE_SCHEMA == 1
    assert TIMING_KEYS == ref_obs.TIMING_KEYS
    assert sorted(obs.__all__) == sorted(ref_obs.__all__)
    span = {"kind": "dispatch", "wall_s": np.float32(1.5), "n": np.int64(3),
            "key": "('fast', 4)", "a": np.arange(3), "b": [np.float64(2.0)]}
    assert trace_mod.encode_span(span) == \
        ref_obs.trace.encode_span(span)
    assert strip_timing(span) == ref_obs.strip_timing(span)


def test_dispatch_line_matches_reference():
    for span in ({"dispatch": 0, "engine": "fast", "schemes": ["host_pkt"],
                  "trees": [4, 8], "n_points": 6, "pkt_fill": 0.75,
                  "wall_s": 1.5, "cache": "hit"},
                 {"dispatch": 2, "engine": "loop", "schemes": ["ofan"],
                  "trees": [8], "n_points": 2, "pkt_fill": 1.0,
                  "impl": "cuda", "slots_run": 900, "wall_s": 3.25,
                  "compile_s": 0.5, "cache": "miss"}):
        assert dispatch_line(span, 3) == ref_obs.dispatch_line(span, 3)
    line = dispatch_line({"dispatch": 0, "engine": "fast",
                          "schemes": ["host_pkt"], "trees": [4, 8],
                          "n_points": 6, "pkt_fill": 0.75, "wall_s": 1.5,
                          "cache": "hit"}, 3)
    assert "[1/3]" in line and "k={4,8}" in line and "[cached]" in line


@pytest.mark.parametrize("level", ["quiet", "info", "debug"])
def test_sweep_logger_levels_match_reference(level):
    got, want = [], []
    for log, sink in ((SweepLogger(level, sink=got.append), got),
                      (ref_obs.SweepLogger(level, sink=want.append), want)):
        log.info("i")
        log.debug("d")
        assert log.verbose == (level == "debug")
    assert got == want
    with pytest.raises(ValueError):
        SweepLogger("loud")


def test_ratio_label_and_bench_lines_match_reference():
    for r in (0.0, -1.0, float("nan"), float("inf"), 0.5, 1.0, 2.0):
        assert report.ratio_label(r) == ref_report.ratio_label(r)
    assert report.ratio_label(0.5).startswith("0.50x -- SLOWDOWN")
    bench = {"speedup_vs_serial": 2.5,
             "sweep": {"impl": "cuda", "speedup_vs_warm": 0.49}}
    assert report._bench_ratio_lines(bench) == \
        ref_report._bench_ratio_lines(bench)
    assert report.sparkline([0, 1, 4, 2] * 40, 30) == \
        ref_report.sparkline([0, 1, 4, 2] * 40, 30)


def _retry_log(fn, n_fail, **kw):
    slept, seen, done = [], [], []
    calls = {"n": 0}

    def body():
        calls["n"] += 1
        if calls["n"] <= n_fail:
            raise RuntimeError(f"fail {calls['n']}")
        return calls["n"]

    try:
        out = fn(body, sleep=slept.append,
                 on_retry=lambda a, e, d: seen.append((a, str(e), d)),
                 on_exhausted=lambda e: done.append(str(e)), **kw)
    except RuntimeError as e:
        out = f"raised {e}"
    return out, slept, seen, done


@pytest.mark.parametrize("n_fail", [0, 2, 4])
def test_retry_call_matches_reference(n_fail):
    got = _retry_log(retry_call, n_fail, max_retries=3, backoff_s=0.5)
    assert got == _retry_log(ref_retry_call, n_fail, max_retries=3,
                             backoff_s=0.5)
    if n_fail == 4:
        assert got[1] == [0.5, 1.0, 2.0] and got[3] == ["fail 4"]


def test_report_renders_cost_plan_and_robustness_like_reference():
    spans = [
        {"schema": 1, "kind": "plan", "campaign": "c", "n_points": 6,
         "n_shapes": 2, "devices": 1, "policy": "k[4|8]",
         "predicted": {"pkt_fill": 0.5, "pkt_rows_real": 10,
                       "pkt_rows_padded": 20, "n_shapes": 2, "total": 30.0},
         "alternatives": [{"policy": f"p{i}", "cost": 40.0 + i,
                           "pkt_fill": 0.4} for i in range(6)]},
        {"schema": 1, "kind": "resume", "dispatches_kept": 1,
         "records_kept": 2},
        {"schema": 1, "kind": "retry", "dispatch": 1, "stage": "megabatch"},
        {"schema": 1, "kind": "degrade", "dispatch": 1, "stage": "serial",
         "scheme": "ofan", "failed": 1},
        {"schema": 1, "kind": "error", "dispatch": 1, "stage": "point",
         "scheme": "ofan", "seed": 1, "error": "boom"},
        {"schema": 1, "kind": "dispatch", "dispatch": 1, "engine": "loop",
         "n_points": 3, "row_fill": 1.0, "pkt_fill": 0.5, "wall_s": 2.0,
         "schemes": ["ofan"], "k_pad": 8, "impl": "cuda", "slots_run": 10,
         "slot_budget": 100, "slot_fill": 0.1, "pkt_rows_real": 5,
         "pkt_rows_padded": 10},
        {"schema": 1, "kind": "campaign", "campaign": "c", "wall_s": 3.0,
         "emit_s": 0.001, "pkt_rows_real": 5, "pkt_rows_padded": 10,
         "pkt_fill": 0.5},
    ]
    text = render_report(spans, [], bench={"speedup_vs_serial": 0.5})
    assert text == ref_report.render_report(spans, [],
                                            bench={"speedup_vs_serial": 0.5})
    for want in ("cost-modeled policy", "and 2 more alternatives",
                 "LOST point", "degraded to serial", "SLOWDOWN",
                 "slot budget", "impl=cuda"):
        assert want in text, want


# ---- the port's runs -------------------------------------------------------

@pytest.mark.parametrize("engine", ["fast", "loop"])
def test_probed_records_match_reference(probed, engine):
    ref, port, _ = probed[engine]
    assert [sweep.encode_record(r) for r in port] == \
        [ref_sweep.encode_record(r) for r in ref]
    for r in port:
        assert r["probe_stride"] == 8
        assert max(max(row) for row in r["probe_queue"]) == r["max_queue"]


def test_probes_off_records_byte_identical_with_observers(probed, tmp_path):
    """Probes off, with and without a trace and a logger, give the probed
    run's records minus their probe fields, byte for byte."""
    _, probed_recs, _ = probed["fast"]
    plain = [{k: v for k, v in r.items() if not k.startswith("probe_")}
             for r in probed_recs]
    store = sweep.ResultStore(tmp_path / "r.jsonl")
    lines = []
    _port_run(_fast(sweep), store=store, trace=TraceWriter(tmp_path / "t"),
              log=SweepLogger("debug", sink=lines.append))
    store.close()
    assert (tmp_path / "r.jsonl").read_text() == \
        "".join(sweep.encode_record(r) + "\n" for r in plain)
    assert any("[1/2]" in l for l in lines)
    bare, _ = _port_run(_fast(sweep))
    assert [sweep.encode_record(r) for r in bare] == \
        [sweep.encode_record(r) for r in plain]


def test_trace_deterministic_modulo_timing(tmp_path):
    traces = []
    for i in range(2):
        tw = TraceWriter(tmp_path / f"t{i}.jsonl")
        _port_run(_fast(sweep), trace=tw)
        tw.close()
        traces.append([strip_timing(s)
                       for s in load_trace(tmp_path / f"t{i}.jsonl")])
    assert traces[0] == traces[1]
    kinds = [s["kind"] for s in traces[0]]
    assert kinds[0] == "plan" and kinds[-1] == "campaign"
    assert kinds.count("dispatch") == sweep.plan(_fast(sweep)).n_dispatches
    for s in traces[0]:
        assert s["schema"] == 1 and not TIMING_KEYS & set(s)


def test_dispatch_spans_carry_cost_fields():
    tw = TraceWriter()
    _port_run(_fast(sweep), trace=tw, timing_split=True)
    disp = [s for s in tw.spans if s["kind"] == "dispatch"]
    assert disp
    for s in disp:
        assert 0 < s["pkt_fill"] <= 1.0
        assert s["pkt_rows_real"] <= s["pkt_rows_padded"]
        assert s["cache"] == "hit"          # nothing is built on the CPU
        assert s["wall_s"] > 0
        assert s["execute_s"] > 0 and s["compile_s"] >= 0
        assert s["devices"] == 1
    end = tw.spans[-1]
    assert end["kind"] == "campaign" and end["emit_s"] >= 0


def test_loop_dispatch_span_slot_budget(probed):
    _, records, spans = probed["loop"]
    disp = [s for s in spans if s["kind"] == "dispatch"]
    assert all(s["slot_budget"] == 8000 and s["impl"] == "torch"
               for s in disp)
    assert max(s["slots_run"] for s in disp) == \
        int(max(r["cct_acked"] for r in records))
    assert 0 < disp[0]["slot_fill"] <= 1.0


def test_report_renders_trace_and_probes(probed):
    _, records, spans = probed["fast"]
    text = render_report(spans, records, top=2)
    assert text == ref_report.render_report(spans, records, top=2)
    assert "dispatch timeline" in text and "padding:" in text
    assert "top queue trajectories" in text
    no_probe = render_report(spans, [
        {k: v for k, v in r.items() if not k.startswith("probe_")}
        for r in records])
    assert "no probe series" in no_probe


def test_summarize_tolerates_extra_and_foreign_records(probed):
    _, records, _ = probed["fast"]
    base = sweep.summarize(records)
    assert base == ref_sweep.summarize(records)
    mixed = [dict(r, future_key="x") for r in records] + \
        [{"kind": "note"}, {"campaign": "obs"}]
    assert sweep.summarize(mixed) == base


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    recs, _ = _port_run(_fast(sweep, schemes=("host_pkt",), seeds=(0,)),
                        profile_dir=tmp_path / "prof")
    assert len(recs) == 1
    files = list((tmp_path / "prof").glob("*.json"))
    assert files and "traceEvents" in json.loads(files[0].read_text())


def test_compile_cache_points_the_kernel_build_dir(tmp_path, monkeypatch):
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(compile_cache, "_enabled_dir", None)
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    assert compile_cache.enable(None) is None
    d = str(tmp_path / "kc")
    assert compile_cache.enable(d) == d == compile_cache.active_dir()
    assert _build.lib_path("lindley").parent == tmp_path / "kc"
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "env"))
    monkeypatch.setattr(compile_cache, "_enabled_dir", None)
    assert compile_cache.enable(None) == str(tmp_path / "env")
