"""The port's transfer-plane drills and chaos plane against ``rbg_tpu``'s:
the kvstream (at the command line's 0.02 s a frame) and partition drills
run once each in both packages at ``tiny`` (the reference's engines at seed 0, the port's on those weights
through ``params_from_numpy``). Every invariant holds in both with the same
names, except the partition lease leg's two (``leader_self_demoted_before_ttl``
and ``recovery_bounded_lease``: the leader lease is the control plane's,
which the port does not carry). Every request's greedy tokens through the
PD pair (kvstream's and the corruption leg's) equal across packages, and
the corruption leg counts the same faults and detections.
``ChaosTransport`` under one seeded ``FaultSchedule`` corrupts, drops and
delays the same frames and counts the same faults as the reference's;
``SkewedClock`` and ``directory_fault`` read alike. A prefill worker
publishes to a pool store in its own process, as the kvstream drill's
does."""

import jax
import numpy as np
import pytest

from rbg_tpu import chaos as j_chaos
from rbg_tpu.engine import EngineConfig as JConfig
from rbg_tpu.engine import SamplingParams as JSampling
from rbg_tpu.engine import kvpool as j_kvpool
from rbg_tpu.engine import pd as j_pd
from rbg_tpu.kvtransfer import chunks as j_chunks
from rbg_tpu.kvtransfer import transport as j_transport
from rbg_tpu.models import get_config as j_get_config, init_params as j_init
from rbg_tpu.obs import names as j_names
from rbg_tpu.obs.metrics import REGISTRY as J_REGISTRY
from rbg_tpu.stress import harness as j_harness
from rbg_tpu_torch import chaos
from rbg_tpu_torch.engine import kvpool
from rbg_tpu_torch.engine import pd
from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams
from rbg_tpu_torch.kvtransfer import chunks, transport
from rbg_tpu_torch.models.config import get_config
from rbg_tpu_torch.models.convert import params_from_numpy
from rbg_tpu_torch.obs import names
from rbg_tpu_torch.obs.metrics import REGISTRY
from rbg_tpu_torch.stress import harness

LEASE_INVARIANTS = {"leader_self_demoted_before_ttl", "recovery_bounded_lease"}


@pytest.fixture(scope="module")
def weights():
    jp = j_init(j_get_config("tiny"), jax.random.key(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), get_config("tiny"),
                                 "cpu")


def _recording(cls, log):
    """Wrap ``cls.generate_one`` to log (prompt, tokens, retries)."""
    inner = cls.generate_one

    def generate_one(self, prompt, *a, **kw):
        r = inner(self, prompt, *a, **kw)
        log.append((list(prompt), list(r["tokens"]), r["retries"]))
        return r
    return generate_one


def _both(run_ref, run_port):
    """Run a drill in each package, logging every PD request of each."""
    mp = pytest.MonkeyPatch()
    logs = {"ref": [], "port": []}
    try:
        mp.setattr(j_pd.PDStreamPair, "generate_one",
                   _recording(j_pd.PDStreamPair, logs["ref"]))
        mp.setattr(pd.PDStreamPair, "generate_one",
                   _recording(pd.PDStreamPair, logs["port"]))
        return run_ref(), run_port(), logs
    finally:
        mp.undo()


# The command line's kvstream config (``--scenario kvstream``: 0.02 s a
# frame; the config field's default is 0.05).
KVSTREAM = dict(slow_link_delay_s=0.02)


@pytest.fixture(scope="module")
def kvstream(weights):
    return _both(lambda: j_harness.run_kv_stream(j_harness.KVStreamConfig(**KVSTREAM)),
                 lambda: harness.run_kv_stream(harness.KVStreamConfig(**KVSTREAM),
                                               params=weights[1], device="cpu"))


@pytest.fixture(scope="module")
def partition(weights):
    return _both(lambda: j_harness.run_partition(j_harness.PartitionConfig()),
                 lambda: harness.run_partition(harness.PartitionConfig(),
                                               params=weights[1], device="cpu"))


# ---- kvstream ----------------------------------------------------------------


def test_kvstream_invariants_hold_in_both(kvstream):
    ref, port, _ = kvstream
    assert set(port["invariants"]) == set(ref["invariants"])
    assert all(ref["invariants"].values()), ref["invariants"]
    assert all(port["invariants"].values()), (port["invariants"], port["requests"])
    assert port["bit_identical"] and ref["bit_identical"]
    assert port["requests"]["completed"] == port["requests"]["total"] == 6
    assert port["requests"]["stream_retries"] >= 1
    assert port["transfer"]["overlap_requests"] == 6


def test_kvstream_tokens_and_bytes_equal_reference(kvstream):
    """Warm passes and drill requests alike, in order: the same prompts and
    the same greedy tokens in both packages, and the same wire bytes."""
    ref, port, logs = kvstream
    assert len(logs["port"]) == len(logs["ref"]) == 8
    for (rp, rt, _), (pp, pt, _) in zip(logs["ref"], logs["port"]):
        assert pp == rp and pt == rt
    assert port["transfer"]["bytes_per_request"] == ref["transfer"]["bytes_per_request"]
    assert set(port) == set(ref) and set(port["transfer"]) == set(ref["transfer"])
    assert port["directory"]["keys"] == ref["directory"]["keys"] == 0


# ---- partition ---------------------------------------------------------------


def test_partition_invariants_hold_in_both(partition):
    ref, port, _ = partition
    assert set(port["invariants"]) == set(ref["invariants"]) - LEASE_INVARIANTS
    assert LEASE_INVARIANTS <= set(ref["invariants"])
    assert all(ref["invariants"].values()), ref["invariants"]
    assert all(port["invariants"].values()), (port["invariants"], port["corruption"])
    assert set(port) == set(ref) - {"lease"}


def test_partition_corruption_leg_equals_reference(partition):
    ref, port, logs = partition
    rc, pc = ref["corruption"], port["corruption"]
    for k in ("requests", "completed", "corrupted_chunks_injected",
              "integrity_failures_detected", "stream_retries", "bit_identical",
              "failures"):
        assert pc[k] == rc[k], k
    assert pc["integrity_failures_detected"] == 2.0 and pc["stream_retries"] >= 1
    assert len(logs["port"]) == len(logs["ref"]) == 6
    for (rp, rt, rr), (pp, pt, pr) in zip(logs["ref"], logs["port"]):
        assert (pp, pt, pr) == (rp, rt, rr)


def test_partition_faults_counted_like_reference(partition):
    ref, port, _ = partition
    rf, pf = ref["faults_injected"], port["faults_injected"]
    assert set(pf) == {"partition", "corrupt", "brownout"}
    assert pf["corrupt"] == rf["corrupt"] == 2.0
    assert pf["brownout"] == rf["brownout"] > 0
    assert pf["partition"] >= 1.0 and rf["partition"] >= 1.0
    assert port["peer_staleness"] == ref["peer_staleness"]
    assert port["directory"]["breaker_opens"] >= 1.0
    assert "error" not in port["directory"]


# ---- the chaos plane ---------------------------------------------------------


class _Sink:
    """Records every frame the wrapped transport delivers."""

    def __init__(self, base):
        base.__init__(self)
        self.sent = []

    def send_one(self, peer, frame):
        self.sent.append(frame)


class PortSink(_Sink, transport.Transport):
    def __init__(self):
        _Sink.__init__(self, transport.Transport)


class RefSink(_Sink, j_transport.Transport):
    def __init__(self):
        _Sink.__init__(self, j_transport.Transport)


def _frames(mod, n_chunks=12):
    rng = np.random.RandomState(5)
    out = [mod.StreamMeta(stream_id="s", prompt=[1, 2, 3], n_pages=2,
                          k_page_shape=(8, 2, 4), v_page_shape=(8, 2, 4),
                          dtype="float32", layers=2, page_size=8)]
    for i in range(n_chunks):
        k = rng.bytes(64 + 8 * i)
        v = rng.bytes(64)
        out.append(mod.KVChunk(stream_id="s", seq=i, layer_lo=i % 2,
                               layer_hi=i % 2 + 1, page_lo=0, page_hi=1,
                               k_bytes=k, v_bytes=v,
                               checksum=mod.payload_checksum(k, v)))
    out += [mod.StreamFirstToken("s", 7), mod.StreamFin("s", n_chunks=n_chunks)]
    return out


def _drive(ch, sink_cls, mod, registry, metric, seed, partition_dead):
    """One scripted run: the clock steps 1.0 per frame; returns what was
    delivered and the faults counted by kind."""
    clock = ch.ChaosClock(t0=0.0)
    sched = ch.FaultSchedule(
        [ch.FaultWindow(ch.CORRUPT, 1.0, 11.0, params={"rate": 0.5, "max_faults": 3}),
         ch.FaultWindow(ch.PARTITION, 4.0, 6.0, params={"dead": partition_dead}),
         ch.FaultWindow(ch.BROWNOUT, 2.0, 4.0, params={"delay_s": 0.001})],
        clock=clock, seed=seed)
    before = {k: registry.counter(metric, kind=k) for k in ch.KINDS}
    sink = sink_cls()
    link = ch.ChaosTransport(sink, sched)
    for f in _frames(mod):
        link.send_one("peer", f)
        clock.advance(1.0)
    faults = {k: registry.counter(metric, kind=k) - before[k] for k in ch.KINDS}
    return ([(type(f).__name__, getattr(f, "seq", None),
              getattr(f, "k_bytes", None)) for f in sink.sent], faults)


@pytest.mark.parametrize("seed", [0, 23, 99])
@pytest.mark.parametrize("dead", [["prefill->decode"], ["decode->prefill"]],
                         ids=["cut", "other_direction"])
def test_chaos_transport_faults_equal_reference(seed, dead):
    got, got_faults = _drive(chaos, PortSink, chunks, REGISTRY,
                             names.CHAOS_FAULTS_INJECTED_TOTAL, seed, dead)
    want, want_faults = _drive(j_chaos, RefSink, j_chunks, J_REGISTRY,
                               j_names.CHAOS_FAULTS_INJECTED_TOTAL, seed, dead)
    assert got == want
    assert got_faults == want_faults
    assert got_faults["brownout"] == 2.0 and got_faults["corrupt"] >= 1.0
    assert got_faults["partition"] == (2.0 if dead == ["prefill->decode"] else 0.0)
    corrupted = [c for c in (f for f in _frames(chunks) if isinstance(f, chunks.KVChunk))
                 if any(g[1] == c.seq and g[2] != c.k_bytes for g in got)]
    assert len(corrupted) == got_faults["corrupt"]


def test_skewed_clock_and_directory_fault_equal_reference():
    def run(ch, registry, metric):
        clock = ch.ChaosClock(t0=0.0)
        sched = ch.FaultSchedule(
            [ch.FaultWindow(ch.SKEW, 1.0, 3.0, params={"offsets": {"p": 0.5}}),
             ch.FaultWindow(ch.PARTITION, 2.0, 4.0,
                            params={"dead": ["router->directory"]})],
            clock=clock, seed=3)
        before = {k: registry.counter(metric, kind=k) for k in ch.KINDS}
        sk, other = ch.SkewedClock(clock, sched, "p"), ch.SkewedClock(clock, sched, "q")
        hook = ch.directory_fault(sched)
        reads = []
        for t in (0.0, 1.0, 1.5, 2.5, 3.0, 3.5, 4.0):
            clock.set(t)
            try:
                hook()
                raised = False
            except OSError:
                raised = True
            reads.append((sk(), sk(), other(), raised))
        clock.skew(0.25)
        reads.append((clock(), clock.advance(1.0)))
        return reads, {k: registry.counter(metric, kind=k) - before[k]
                       for k in ch.KINDS}

    got = run(chaos, REGISTRY, names.CHAOS_FAULTS_INJECTED_TOTAL)
    want = run(j_chaos, J_REGISTRY, j_names.CHAOS_FAULTS_INJECTED_TOTAL)
    assert got == want
    assert got[1]["skew"] == 1.0 and got[1]["partition"] == 3.0


# ---- a pool store in the prefill worker's process ----------------------------


def test_prefill_worker_publishes_to_an_in_process_store(weights):
    """The kvstream drill hands its prefill worker a ``KVPoolStore`` (no
    server): the worker publishes the prompt's pages with their wire dtype
    and the second request takes them as a pool hit, as the reference's
    does."""
    jp, tp = weights
    base = dict(model="tiny", page_size=8, num_pages=64, max_batch=4,
                max_seq_len=128, prefill_chunk=16)
    prompt = list(range(3, 43))
    runs = []
    for make, cfg, params, sp, store in (
            (pd.PrefillWorker, EngineConfig(device="cpu", **base), tp,
             SamplingParams(max_new_tokens=4), kvpool.KVPoolStore(8)),
            (j_pd.PrefillWorker, JConfig(use_pallas="never", **base), jp,
             JSampling(max_new_tokens=4), j_kvpool.KVPoolStore(8))):
        w = make(cfg, params=params, pool=store)
        firsts = [w.prefill(prompt, sp).first_token for _ in range(2)]
        runs.append((firsts, w.metrics["pool_exports"], w.metrics["pool_hits"],
                     w.metrics["pool_hit_tokens"], w.metrics.get("pool_errors", 0),
                     store.match(prompt)[0]))
    assert runs[0] == runs[1]
    assert runs[0][1:] == (2, 1, 32, 0, 40)
