"""The port's serving-plane stress drills (``rbg_tpu_torch/stress``)
against ``rbg_tpu``'s: the overload and prefixcache drills run once each
in both packages at ``tiny`` (the reference builds its engines at seed 0;
the port takes those weights through ``params_from_numpy``), and every
invariant must hold in both, with the same invariant names. prefixcache's
greedy outputs per prompt and its hierarchy counts (radix and host-tier
hit tokens, pages spilled, promoted and evicted) must be equal. Also the
obs helpers the drills read (``Registry.quantile``, ``trace.complete``,
``trace.hop_coverage``) against the reference's on the same inputs, and
the command line: exit 0 on the CPU with every invariant true (tracing
and the lock-order detector armed), 1 when a drill reports a false
invariant, and an HTML report.

prefixcache's TTFT target: the reference's 0.6 s lies above what its own
engine's gate predicts for the drill's warm requests and below what it
predicts for the burst's tail, on an idle machine. The port's engine on
this CPU is faster (at 0.6 its gate never acts) and the reference's, on a
loaded machine, slower (its warm requests are shed), so both run the rule
the constant follows: the gate's own prediction for one of the next prefix
group's prompts with one request ahead, read on the burst's service after
its warm requests (the port's ``slo_ttft_s=None``; on the reference's
service set the same way through ``_gate_after_warm``)."""

import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from rbg_tpu.engine import engine as j_engine
from rbg_tpu.engine import service as j_service
from rbg_tpu.models import get_config as j_get_config, init_params as j_init
from rbg_tpu.obs import metrics as j_metrics
from rbg_tpu.obs import trace as j_trace
from rbg_tpu.stress import harness as j_harness
from rbg_tpu_torch.engine import engine as t_engine
from rbg_tpu_torch.models.config import get_config
from rbg_tpu_torch.models.convert import params_from_numpy
from rbg_tpu_torch.obs import metrics as t_metrics
from rbg_tpu_torch.obs import names
from rbg_tpu_torch.obs import trace as t_trace
from rbg_tpu_torch.stress import harness

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_overload_drain.py's config of the reference's overload drill.
OVERLOAD = dict(clients=4, requests_per_client=3, max_queue=2, max_batch=2,
                max_new_tokens=16, timeout_s=60.0)


@pytest.fixture(scope="module")
def tiny_params():
    jp = j_init(j_get_config("tiny"), jax.random.key(0))
    return params_from_numpy(jax.tree.map(np.asarray, jp), get_config("tiny"), "cpu")


def _recording(cls, log):
    """Wrap ``cls.generate`` to log every (prompt, output) pair."""
    inner = cls.generate

    def generate(self, prompts, sampling=None):
        outs = inner(self, prompts, sampling)
        log.extend((tuple(p), list(o)) for p, o in zip(prompts, outs))
        return outs
    return generate


def _gate_after_warm(cls, prompts):
    """Wrap ``cls.submit``: a service built with an infinite TTFT target
    gets its early-reject gate, after its fourth sequential request (the
    drill's warm requests), at its own prediction for the next prefix
    group's prompts with one request ahead: the port's
    ``PrefixCacheConfig(slo_ttft_s=None)`` on the reference's service."""
    inner = cls.submit

    def submit(self, prompt, sampling, *a, **kw):
        out = inner(self, prompt, sampling, *a, **kw)
        self._warm_n = getattr(self, "_warm_n", 0) + 1
        if self._warm_n == 4 and math.isinf(self._er_gate_s):
            pred = sorted(self.predicted_ttft_s(p, depth=1) or 0.0 for p in prompts[4:7])
            self._er_gate_s = pred[1] * self.engine.cfg.early_reject_factor
        return out
    return submit


@pytest.fixture(scope="module")
def overload(tiny_params):
    ref = j_harness.run_serving_overload(j_harness.OverloadConfig(**OVERLOAD))
    port = harness.run_serving_overload(harness.OverloadConfig(**OVERLOAD),
                                        params=tiny_params, device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def prefixcache(tiny_params):
    mp = pytest.MonkeyPatch()
    logs = {"ref": [], "port": []}
    try:
        mp.setattr(j_engine.Engine, "generate",
                   _recording(j_engine.Engine, logs["ref"]))
        mp.setattr(t_engine.Engine, "generate",
                   _recording(t_engine.Engine, logs["port"]))
        prompts = harness.prefix_cache_prompts(harness.PrefixCacheConfig(),
                                               get_config("tiny").vocab_size)
        mp.setattr(j_service.EngineService, "submit",
                   _gate_after_warm(j_service.EngineService, prompts))
        ref = j_harness.run_prefix_cache(
            j_harness.PrefixCacheConfig(slo_ttft_s=float("inf")))
        port = harness.run_prefix_cache(
            harness.PrefixCacheConfig(slo_ttft_s=None), params=tiny_params,
            device="cpu")
    finally:
        mp.undo()
    return ref, port, logs


# ---- overload ----------------------------------------------------------------


def test_overload_invariants_hold_in_both(overload):
    ref, port = overload
    assert set(port["invariants"]) == set(ref["invariants"])
    assert all(ref["invariants"].values()), ref["invariants"]
    assert all(port["invariants"].values()), port["invariants"]
    assert port["outcomes"]["error"] == 0
    assert sum(port["outcomes"].values()) == OVERLOAD["clients"] * OVERLOAD[
        "requests_per_client"]
    assert port["max_queue_depth_observed"] <= OVERLOAD["max_queue"]


def test_overload_report_keys_equal_reference(overload):
    ref, port = overload
    assert set(port) == set(ref)
    for k in ("outcomes", "continuous_batching", "slo", "goodput_vs_throughput",
              "admitted_latency_ms"):
        assert set(port[k]) == set(ref[k]), k
    assert port["config"] == ref["config"]
    # Every admitted request's latency sits inside its deadline budget.
    assert port["admitted_latency_ms"]["n"] == port["outcomes"]["ok"]
    assert port["admitted_latency_ms"].get("p99", 0) <= OVERLOAD["timeout_s"] * 1000
    assert port["slo"]["judged"] == port["outcomes"]["ok"]


# ---- prefixcache -------------------------------------------------------------


def test_prefixcache_invariants_hold_in_both(prefixcache):
    ref, port, _ = prefixcache
    assert set(port["invariants"]) == set(ref["invariants"])
    assert all(ref["invariants"].values()), ref["invariants"]
    assert all(port["invariants"].values()), (port["invariants"], port["burst"])
    assert port["config"]["slo_ttft_s"] is None and port["burst"]["slo_ttft_s"] >= 0
    assert port["burst"]["early_rejects"] > 0 and port["burst"]["completed"] > 0
    assert port["bit_identical"] and ref["bit_identical"]


def test_prefixcache_outputs_equal_reference(prefixcache):
    """Every prompt's greedy tokens: the cold probe's, the tiered engine's
    and the burst's all equal in each package (bit_identical), and the
    outputs equal across packages."""
    _, _, logs = prefixcache
    ref, port = dict(logs["ref"]), dict(logs["port"])
    prompts = harness.prefix_cache_prompts(harness.PrefixCacheConfig(),
                                           get_config("tiny").vocab_size)
    assert set(ref) == set(port) == {tuple(p) for p in prompts}
    for p in prompts:
        assert port[tuple(p)] == ref[tuple(p)]


def test_prefixcache_hierarchy_counts_equal_reference(prefixcache):
    ref, port, _ = prefixcache
    rh, ph = ref["hierarchy"], port["hierarchy"]
    for k in ("requests", "radix_hit_tokens", "host_hit_tokens",
              "device_tier_pages"):
        assert ph[k] == rh[k], k
    for k in ("spilled_pages", "promoted_pages", "evicted_pages", "hits",
              "misses", "hit_tokens", "pages", "bytes"):
        assert ph["host_tier"][k] == rh["host_tier"][k], k
    assert ph["host_tier"]["spilled_pages"] > 0
    assert ph["host_tier"]["promoted_pages"] > 0
    assert ph["directory"] == rh["directory"]
    assert set(port["burst"]) == set(ref["burst"]) | {"slo_ttft_s"}


# ---- obs helpers -------------------------------------------------------------


@pytest.mark.parametrize("values", [
    [0.0003], [0.002, 0.004, 0.03, 0.2, 0.2, 0.7], [12.0, 30.0],
    [0.001, 0.0025, 0.0025, 7.5, 11.0, 0.05, 0.05, 0.05]],
    ids=["one", "spread", "overflow", "edges"])
def test_registry_quantile_equals_reference(values):
    port, ref = t_metrics.Registry(), j_metrics.Registry()
    for r in (port, ref):
        assert r.quantile("h", 0.5) is None
        for v in values:
            r.observe("h", v, kind="x")
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert port.quantile("h", q, kind="x") == ref.quantile("h", q, kind="x")
    assert port.quantile("h", 0.5, kind="y") is None


def _span(sid, parent, start, dur):
    return {"name": "s", "span_id": sid, "parent_id": parent,
            "start_ms": start, "duration_ms": dur, "attrs": {}}


RECORDS = {
    "overlapping": {"duration_ms": 10.0, "complete": True, "spans": [
        _span("r", None, 0.0, 10.0), _span("a", "r", 0.5, 3.0),
        _span("b", "r", 2.0, 4.0), _span("c", "r", 8.0, 1.5),
        _span("d", "a", 0.0, 10.0)]},
    "no_children": {"duration_ms": 4.0, "complete": True,
                    "spans": [_span("r", None, 0.0, 4.0)]},
    "unfinished_child": {"duration_ms": 4.0, "complete": False, "spans": [
        _span("r", None, 0.0, 4.0), _span("a", "r", 1.0, None),
        _span("b", "r", 1.0, 2.0)]},
    "zero_root": {"duration_ms": 0, "complete": True,
                  "spans": [_span("r", None, 0.0, 0.0)]},
    "open_root": {"duration_ms": None, "spans": []},
}


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_trace_complete_and_hop_coverage_equal_reference(name):
    rec = RECORDS[name]
    assert t_trace.hop_coverage(rec) == j_trace.hop_coverage(rec)
    assert t_trace.complete(rec) == j_trace.complete(rec)


def test_hop_coverage_of_a_served_trace_equals_reference(monkeypatch):
    """A real trace of the port's sink (a root, two overlapping hops, one
    nested): the reference's functions read the same record alike. The
    sink's clock is stepped here (the record is 0.0-0.006 s and 0.005-0.009
    s of hops in an 0.011 s root): with real sleeps a loaded host's
    scheduler moved the spans' ends enough to take the coverage out of
    its range."""
    import types

    now = [100.0]
    monkeypatch.setattr(t_trace, "time", types.SimpleNamespace(monotonic=lambda: now[0]))

    def sleep(s):
        now[0] += s

    t_trace.configure(enabled=True, sample=1.0)
    try:
        root = t_trace.start_trace(names.SPAN_STRESS_REQUEST, sample=True)
        a = root.child(names.SPAN_SERVICE_QUEUE_WAIT)
        sleep(0.005)
        b = root.child(names.SPAN_SERVICE_SCAN)
        b.child(names.SPAN_ENGINE_OP).end()
        sleep(0.001)
        a.end()
        sleep(0.003)
        b.end()
        sleep(0.002)
        root.end()
        rec = next(r for r in t_trace.SINK.recent(64)
                   if r["trace_id"] == root.trace_id)
    finally:
        t_trace.configure(enabled=False)
    assert t_trace.complete(rec) and j_trace.complete(rec)
    cov = t_trace.hop_coverage(rec)
    assert cov == j_trace.hop_coverage(rec) and 0.5 < cov < 1.0


# ---- command line ------------------------------------------------------------


def test_cli_exits_zero_with_tracing_and_locktrace(tmp_path):
    """The overload drill through the command line on the CPU: every
    invariant true, the trace and lock-order invariants among them, and
    the JSON and HTML reports written."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out, page = tmp_path / "r.json", tmp_path / "r.html"
    r = subprocess.run(
        [sys.executable, "-m", "rbg_tpu_torch.stress.harness", "--scenario",
         "overload", "--device", "cpu", "--json", "--trace", "--locktrace",
         "--json-out", str(out), "--html", str(page)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    report = json.loads(r.stdout.strip().splitlines()[-1])
    inv = report["invariants"]
    assert {"trace_complete", "trace_hops_cover_root", "lock_order_acyclic",
            "queue_bounded", "slo_accounted"} <= set(inv)
    assert all(inv.values()), inv
    assert json.loads(out.read_text())["invariants"] == inv
    assert report["trace"]["waterfall"] and report["locktrace"]["inversions"] == []
    html = page.read_text()
    assert "continuous batching" in html and "slowest-request waterfall" in html


@pytest.mark.parametrize("ok", [True, False], ids=["true", "false"])
def test_cli_exit_code_follows_the_invariants(ok, tmp_path, capsys):
    seen = []

    def stub(args):
        seen.append(args.scenario)
        return {"scenario": args.scenario, "config": {},
                "invariants": {"held": True, "second": ok}}
    page = tmp_path / "r.html"
    rc = harness.main(["--scenario", "kvstream", "--device", "cpu", "--json",
                       "--html", str(page)], run=stub)
    assert rc == (0 if ok else 1) and seen == ["kvstream"]
    report = json.loads(capsys.readouterr().out.strip())
    assert report["invariants"] == {"held": True, "second": ok}
    assert ("FAIL" in page.read_text()) is (not ok)
