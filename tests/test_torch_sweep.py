"""The campaign pipeline of the PyTorch port (``repro_torch.sweep``) against
the JAX reference (``repro.sweep``): presets and the JSON spec format, the
heuristic and cost-modeled plans of every preset, byte-identical
``results.jsonl`` on a fast, a loop (fault schedules, ``rho="auto"``) and a
collective-phase preset, ``--resume``, traces equal after ``strip_timing``
apart from the slot-step ``impl``, the report, the retry/degrade ladder, the
CLI, and the card golden ``tests/torch_golden/sweep_k8.json``.

Campaigns run at k = 4; the port on the CPU (``device="cpu"``), the
reference on one JAX device (the suite's conftest splits the CPU in two,
and the port's CPU runs count one device)."""
import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro import sweep as ref_sweep
from repro.obs import TraceWriter as RefTraceWriter
from repro.obs import render_report as ref_render_report

from repro_torch import sweep
from repro_torch.obs import (TIMING_KEYS, TraceWriter, render_report,
                             strip_timing)
from repro_torch.sweep import runner as runner_mod

from _torch_compare import one_jax_device

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
SWEEP_GOLDEN = ROOT / "tests" / "torch_golden" / "sweep_k8.json"
# One fast, one loop (static and flapping failures, rho='auto') and one
# collective-phase preset, all at their k = 4 trees.
RUNS = {"layer_balance": dict(trees=(4,)), "flap": {}, "train_iter": {}}
IMPL_RE = re.compile(r"impl='[a-z]+'")


def port_campaign(ref_campaign):
    """The port's campaign of a reference one, through the JSON spec."""
    return sweep.Campaign.from_dict(json.loads(json.dumps(
        ref_campaign.to_dict())))


def run_ref(campaign, out: Path, **kw):
    store = ref_sweep.ResultStore(out / "results.jsonl")
    trace = RefTraceWriter(out / "trace.jsonl")
    with one_jax_device():
        ref_sweep.run_campaign(campaign, store=store, trace=trace,
                               compile_cache_dir=False, **kw)
    store.close()
    trace.close()
    return out


def run_port(campaign, out: Path, **kw):
    store = sweep.ResultStore(out / "results.jsonl",
                              overwrite=not kw.get("resume"))
    trace = TraceWriter(out / "trace.jsonl")
    sweep.run_campaign(campaign, store=store, trace=trace,
                       compile_cache_dir=False, device="cpu", **kw)
    store.close()
    trace.close()
    return out


def stripped(path: Path, impl=True):
    """A trace's spans after ``strip_timing``; ``impl=False`` also drops
    the slot-step ``impl`` (``"lax"`` in the reference, ``"torch"`` here)
    and the ``impl=`` inside a loop key's ``LoopConfig``."""
    spans = [strip_timing(json.loads(l)) for l in path.read_text().splitlines()]
    if not impl:
        for s in spans:
            s.pop("impl", None)
            if "key" in s:
                s["key"] = IMPL_RE.sub("impl=_", s["key"])
    return spans


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{preset: (reference out dir, port out dir)}, one run each."""
    out = {}
    for name, kw in RUNS.items():
        base = tmp_path_factory.mktemp(name)
        c = ref_sweep.preset(name, **kw)
        out[name] = (run_ref(c, base / "ref"),
                     run_port(port_campaign(c), base / "port"))
    return out


# ---- specs and plans -------------------------------------------------------

def _member(b):
    return (b.campaign, b.k, dataclasses.asdict(b.load),
            b.failure.label() if b.failure else None, b.scheme, b.seeds,
            b.g_converge, b.timing,
            b.phase.label() if b.phase is not None else None)


def assert_same_plan(pr, pp):
    assert pr.describe() == pp.describe()
    assert (pr.n_points, pr.n_dispatches, pr.n_shapes) == \
        (pp.n_points, pp.n_dispatches, pp.n_shapes)
    assert pp.n_dispatches == pp.n_shapes
    assert [_member(b) for b in pr.batches] == [_member(b) for b in pp.batches]
    assert len(pr.megabatches) == len(pp.megabatches)
    for mr, mp in zip(pr.megabatches, pp.megabatches):
        assert IMPL_RE.sub("", repr(mr.key)) == IMPL_RE.sub("", repr(mp.key))
        assert (mr.engine, mr.k_pad, mr.npk_pad, mr.n_points) == \
            (mp.engine, mp.k_pad, mp.npk_pad, mp.n_points)
        assert [_member(b) for b in mr.members] == \
            [_member(b) for b in mp.members]
    assert (pr.policy is None) == (pp.policy is None)
    if pr.policy is not None:
        assert (pr.policy.label, pr.policy.kmap, pr.policy.pkt_exact) == \
            (pp.policy.label, pp.policy.kmap, pp.policy.pkt_exact)
        assert pr.cost.as_dict() == pp.cost.as_dict()
        assert pr.alternatives == pp.alternatives


@pytest.mark.parametrize("name", sorted(ref_sweep.PRESETS))
def test_preset_specs_match_reference(name):
    r, p = ref_sweep.preset(name), sweep.preset(name)
    assert json.dumps(r.to_dict(), sort_keys=True) == \
        json.dumps(p.to_dict(), sort_keys=True)
    assert p == port_campaign(r)
    assert p.n_points == r.n_points
    assert [pt.point_id() for pt in p.points()] == \
        [pt.point_id() for pt in r.points()]


@pytest.mark.parametrize("name", sorted(ref_sweep.PRESETS))
def test_plan_matches_reference(name):
    assert_same_plan(ref_sweep.plan(ref_sweep.preset(name)),
                     sweep.plan(sweep.preset(name)))


def _cost_cases():
    """tests/test_costmodel.py's cost-mode campaigns: every preset, the
    mixed-k all_to_all the model splits, and a loop timing sweep."""
    cases = {f"preset-{n}": dataclasses.replace(ref_sweep.preset(n),
                                                planner="cost")
             for n in sorted(ref_sweep.PRESETS)}
    cases["mixed_a2a"] = ref_sweep.Campaign(
        name="cm_a2a", schemes=("host_pkt", "simple_rr"),
        loads=(ref_sweep.WorkloadSpec("all_to_all", 64),),
        trees=(4, 6, 8), seeds=(0, 1), planner="cost")
    cases["timings"] = ref_sweep.Campaign(
        name="cm", schemes=("jsq",), trees=(4,), seeds=(0, 1),
        loads=(ref_sweep.WorkloadSpec("permutation", 16,
                                      inter_pod_only=True),),
        engine="loop", max_slots=3000, planner="cost",
        timings=((9, 33), (12, 40), (3, 5)))
    return cases


@pytest.mark.parametrize("case", sorted(_cost_cases()))
def test_cost_plan_matches_reference(case):
    c = _cost_cases()[case]
    assert_same_plan(ref_sweep.plan(c), sweep.plan(port_campaign(c)))


def test_backend_strings_map_to_the_engine_switch():
    from repro_torch.sweep.spec import engine_backend
    assert [engine_backend(b) for b in ("auto", "pallas", "xla")] == \
        ["auto", "auto", "torch"]
    with pytest.raises(ValueError):
        engine_backend("torch")
    c = sweep.Campaign(name="i", schemes=("host_pkt",), engine="loop",
                       loads=(sweep.WorkloadSpec("permutation", 8),),
                       loop_opts=(("impl", "pallas"),))
    assert c.loop_config().impl == "auto"
    assert dataclasses.replace(
        c, loop_opts=(("impl", "torch"),)).loop_config().impl == "torch"


# ---- runs: records, traces, report, resume ---------------------------------

@pytest.mark.parametrize("name", sorted(RUNS))
def test_results_byte_identical_to_reference(runs, name):
    ref, port = runs[name]
    got = (port / "results.jsonl").read_bytes()
    assert got == (ref / "results.jsonl").read_bytes()
    assert got.count(b"\n") == ref_sweep.preset(name, **RUNS[name]).n_points


@pytest.mark.parametrize("name", sorted(RUNS))
def test_traces_match_reference_apart_from_impl(runs, name):
    ref, port = runs[name]
    a = stripped(ref / "trace.jsonl", impl=False)
    b = stripped(port / "trace.jsonl", impl=False)
    assert a == b
    kinds = [s["kind"] for s in b]
    assert kinds[0] == "plan" and kinds[-1] == "campaign"
    loop = [s for s in stripped(port / "trace.jsonl")
            if s["kind"] == "dispatch" and s["engine"] == "loop"]
    assert all(s["impl"] == "torch" for s in loop)
    assert bool(loop) == (name == "flap")


@pytest.mark.parametrize("name", sorted(RUNS))
def test_report_text_matches_reference(runs, name):
    ref, port = runs[name]
    for out in (ref, port):
        spans = [json.loads(l) for l in
                 (out / "trace.jsonl").read_text().splitlines()]
        recs = [json.loads(l) for l in
                (out / "results.jsonl").read_text().splitlines()]
        text = render_report(spans, recs)
        assert text == ref_render_report(spans, recs)
        assert "dispatch timeline" in text and "padding:" in text
    if name == "train_iter":
        assert "iteration time" in text


@pytest.mark.parametrize("cut", [0, 3, -1])
def test_resume_after_truncated_results_byte_identical(runs, tmp_path, cut):
    """A torn results file (a half line after ``cut`` whole ones) resumed
    by the port reproduces the reference's uninterrupted bytes."""
    name = "train_iter"
    golden = (runs[name][0] / "results.jsonl").read_bytes()
    lines = golden.decode().splitlines(keepends=True)
    cut = cut % len(lines)
    (tmp_path / "results.jsonl").write_text(
        "".join(lines[:cut]) + lines[cut][: len(lines[cut]) // 2])
    run_port(port_campaign(ref_sweep.preset(name)), tmp_path, resume=True)
    assert (tmp_path / "results.jsonl").read_bytes() == golden
    spans = [json.loads(l) for l in
             (tmp_path / "trace.jsonl").read_text().splitlines()]
    resume = [s for s in spans if s["kind"] == "resume"]
    assert len(resume) == 1 and resume[0]["records_kept"] <= cut


def test_resume_noop_when_complete(runs, tmp_path):
    src = runs["layer_balance"][1] / "results.jsonl"
    (tmp_path / "results.jsonl").write_bytes(src.read_bytes())
    store = sweep.ResultStore(tmp_path / "results.jsonl", overwrite=False)
    trace = TraceWriter(None)
    recs, _ = sweep.run_campaign(sweep.preset("layer_balance", trees=(4,)),
                                 store=store, trace=trace, resume=True,
                                 compile_cache_dir=False, device="cpu")
    store.close()
    assert recs == []
    assert (tmp_path / "results.jsonl").read_bytes() == src.read_bytes()
    span = next(s for s in trace.spans if s["kind"] == "resume")
    assert span["records_kept"] == 5


# ---- the retry / degradation ladder ----------------------------------------

def _mixed():
    """tests/test_faults.py's MIXED campaign: clean, static-failure and
    flapping rows on the fast engine, 18 points."""
    from repro.faults import FaultSchedule
    flap = FaultSchedule.flap(layer="ea", pod=0, i=0, j=1, t0=40, period=80,
                              cycles=1, host_react=8, switch_react=24)
    return ref_sweep.Campaign(
        name="faults-mixed", schemes=("host_pkt", "simple_rr", "ofan"),
        loads=(ref_sweep.WorkloadSpec("permutation", 24,
                                      inter_pod_only=True),),
        trees=(4,), seeds=(0, 1),
        failures=(None, ref_sweep.FailureSpec(0.08, 42), flap),
        engine="fast", shard="off")


@pytest.fixture(scope="module")
def mixed_ref():
    with one_jax_device():
        recs, _ = ref_sweep.run_campaign(_mixed(), compile_cache_dir=False)
    return recs


def test_runner_retry_recovers_transient(monkeypatch, mixed_ref):
    real = runner_mod._run_fast_mega
    calls = {"n": 0}

    def flaky(mega, campaign, cache):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected transient")
        return real(mega, campaign, cache)

    monkeypatch.setattr(runner_mod, "_run_fast_mega", flaky)
    trace, slept = TraceWriter(None), []
    recs, _ = sweep.run_campaign(port_campaign(_mixed()), trace=trace,
                                 compile_cache_dir=False, retry=2,
                                 backoff_s=0.25, sleep=slept.append,
                                 device="cpu")
    assert recs == mixed_ref               # nothing lost, same records
    retries = [s for s in trace.spans if s["kind"] == "retry"]
    assert len(retries) == 1 and retries[0]["stage"] == "megabatch"
    assert slept == [0.25]
    assert not any(s["kind"] == "error" for s in trace.spans)


def test_runner_degrades_and_reports(monkeypatch, mixed_ref):
    """A poisoned member exhausts its budget, the dispatch degrades member
    -> serial, only the poisoned points are lost, every other record is the
    reference's, and the report surfaces all of it."""
    real = runner_mod._run_fast_mega

    def poison(mega, campaign, cache):
        if any(b.scheme == "ofan" and 1 in b.seeds for b in mega.members):
            raise RuntimeError("poisoned member")
        return real(mega, campaign, cache)

    monkeypatch.setattr(runner_mod, "_run_fast_mega", poison)
    trace = TraceWriter(None)
    recs, _ = sweep.run_campaign(port_campaign(_mixed()), trace=trace,
                                 compile_cache_dir=False, retry=0,
                                 sleep=lambda s: None, device="cpu")
    want = [r for r in mixed_ref
            if not (r["scheme"] == "ofan" and r["seed"] == 1)]
    assert recs == want and len(recs) == 15
    kinds = [s["kind"] for s in trace.spans]
    assert "error" in kinds and "degrade" in kinds
    point_errors = [s for s in trace.spans
                    if s["kind"] == "error" and s.get("stage") == "point"]
    assert len(point_errors) == 3
    # every ofan member holds seed 1, so each goes serial
    degrades = [s for s in trace.spans if s["kind"] == "degrade"]
    assert [(s["stage"], s["scheme"], s["failed"]) for s in degrades] == \
        [("serial", "ofan", 1)] * 3
    rep = render_report(trace.spans, recs)
    assert rep == ref_render_report(trace.spans, recs)
    assert "robustness" in rep and "LOST point" in rep and "degraded" in rep


# ---- device ----------------------------------------------------------------

def test_run_campaign_runs_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device works")
    c = sweep.preset("layer_balance", trees=(4,))
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.run_campaign(c)
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.run_campaign(c, device="cuda")


# ---- the CLI ---------------------------------------------------------------

def _cli(*args, check=True):
    """The port's CLI in a subprocess."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-m", "repro_torch.sweep", *args],
                         env=env, capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    if check:
        assert out.returncode == 0, out.stderr
    return out


def _main_stdout(main, args, capsys) -> str:
    capsys.readouterr()
    assert main(list(args)) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("args", [
    ("presets",),
    ("plan", "--preset", "theory", "--k", "4", "--seeds", "0:2"),
    ("plan", "--preset", "fig1", "--plan", "cost"),
    ("plan", "--preset", "flap"),
], ids=["presets", "plan_theory", "plan_fig1_cost", "plan_flap"])
def test_cli_presets_and_plan_match_reference(args, capsys):
    from repro.sweep.__main__ import main as ref_main
    from repro_torch.sweep.__main__ import main
    assert _main_stdout(main, args, capsys) == \
        _main_stdout(ref_main, args, capsys)


def test_cli_in_a_subprocess_on_cpu(runs, tmp_path, capsys):
    """``presets``, ``run --device cpu``, ``summarize`` and ``report`` of
    the port's CLI, each in a process of its own."""
    from repro.sweep.__main__ import main as ref_main
    assert _cli("presets").stdout == _main_stdout(ref_main, ("presets",),
                                                  capsys)
    out = tmp_path / "lb"
    res = _cli("run", "--preset", "layer_balance", "--k", "4", "--device",
               "cpu", "--out", str(out))
    assert "wrote" in res.stdout and "[4/4]" in res.stdout
    ref = runs["layer_balance"][0]
    assert (out / "results.jsonl").read_bytes() == \
        (ref / "results.jsonl").read_bytes()
    assert stripped(out / "trace.jsonl") == stripped(ref / "trace.jsonl")
    args = ("summarize", "--results", str(out / "results.jsonl"))
    assert _cli(*args).stdout == _main_stdout(ref_main, args, capsys)
    rep = _cli("report", "--trace", str(out / "trace.jsonl"), "--results",
               str(out / "results.jsonl")).stdout
    assert "campaign 'layer_balance'" in rep and "dispatch timeline" in rep
    if not torch.cuda.is_available():
        bad = _cli("run", "--preset", "layer_balance", "--k", "4",
                   check=False)
        assert bad.returncode != 0 and "CUDA" in bad.stderr


# ---- the card golden -------------------------------------------------------

def test_sweep_golden_is_consistent_with_the_port():
    """``sweep_k8.json`` (CPU JAX, ``make_sweep_golden.py``): each file's
    sha256 is its text's, its records are its campaign's grid in plan
    order, and its dispatch spans carry the port's plan keys."""
    golden = json.loads(SWEEP_GOLDEN.read_text())
    assert set(golden["campaigns"]) == {"table2", "fig12"}
    for name, g in golden["campaigns"].items():
        text = g["results"]
        assert hashlib.sha256(text.encode()).hexdigest() == g["sha256"]
        c = sweep.Campaign.from_dict(g["spec"])
        assert c == sweep.preset(name, trees=tuple(g["argv_k"]),
                                 seeds=tuple(g["argv_seeds"]))
        p = sweep.plan(c)
        recs = [json.loads(l) for l in text.splitlines()]
        assert [(r["scheme"], r["seed"]) for r in recs] == \
            [(b.scheme, s) for b in p.batches for s in b.seeds]
        disp = [s for s in g["trace"] if s["kind"] == "dispatch"]
        assert [IMPL_RE.sub("", s["key"]) for s in disp] == \
            [IMPL_RE.sub("", repr(m.key)) for m in p.megabatches]
        assert all(not TIMING_KEYS & set(s) for s in g["trace"])
