"""Serving loops over a tp 2 mesh in a gloo world of 2 CPU processes
(tests/torch_tp_service_worker.py, one spawn for the file), against
rbg_tpu's services on a tp 2 mesh of the conftest's host devices
(use_pallas="never"), float32, on the same weights:

* a two-rank ``EngineService`` (rank 0 leads, rank 1 replays its plans) on
  tiny and tiny-moe, against the reference's ``EngineService(mesh=...)``;
* a two-rank ``DecodeService`` on the reference's own bundles (and one of
  them again as a chunk stream), against its ``DecodeService(mesh=...)``;
* ``PDStreamPair(admit_layers=1)`` over paced links, rank 0 deciding each
  admission's coverage, against its ``PDStreamPair(mesh=...,
  admit_layers=1)``;
* ``Engine(host_tier_bytes=...)`` at tp 2 on a spill-then-promote script,
  against its ``Engine(mesh=..., host_tier_bytes=...)``: tokens and the
  tier's page counts.

Greedy and seeded tokens must be identical on both ranks and to the
reference. Port-only: a follower's submit raises; a replayed request id
that is not the leader's raises on both ranks; a fault on either rank
ends the other's loop within FAULT_S, and a silent leader is an error on
the follower when the plan group's timeout runs out; stop() ends both
loops; a cancelled and a
deadline-aborted request leave no row on either rank; the two ranks'
engine metrics are equal; chip_smoke's kept-expert recorder gives equal
masks at tp 2 and unsharded. Last, two servers under the control plane's
multi-process contract form a world and each answers a generate.
"""

import json
import os
import re
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from rbg_tpu.engine import EngineConfig as JConfig
from rbg_tpu.engine import SamplingParams as JSampling
from rbg_tpu.engine.engine import Engine as JEngine
from rbg_tpu.engine.pd import PDPair as JPDPair
from rbg_tpu.engine.pd import PDStreamPair as JPDStreamPair
from rbg_tpu.engine.service import DecodeService as JDecodeService
from rbg_tpu.engine.service import EngineService as JEngineService
from rbg_tpu.models import get_config as j_get_config, init_params as j_init
from rbg_tpu.parallel.mesh import make_mesh as j_make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_tp_service_worker.py")
MODELS = ("tiny", "tiny-moe")
BASE = dict(page_size=8, num_pages=64, max_batch=4, max_seq_len=128, prefill_chunk=16,
            enable_radix_cache=False)
GREEDY = dict(max_new_tokens=8)
SEEDED = dict(max_new_tokens=8, temperature=0.9, top_k=40, seed=5)
# The service's rows: the third is seeded (the worker's order).
SERVICE_SAMPLINGS = [GREEDY, GREEDY, SEEDED, GREEDY, GREEDY, GREEDY]
# One whole tiny page, K and V, float32 (2 layers, page 8, KV 2, hd 32):
# the tier's budget is 8 of them, so pass 1 spills, the budget evicts and
# pass 2 promotes.
TIER_PAGE = 2 * 2 * 8 * 2 * 32 * 4
TIER_BUDGET = 8 * TIER_PAGE
# Rank 0's stop() ends both loops within this (the follower leaves on the
# leader's last plan, one broadcast).
STOP_S = 5.0
# A fault on one rank ends the other's loop within this: the leader's
# "fault" plan, or the follower's "no" to the plan it could not replay,
# reaches the other rank at once (an idle leader plans every 2 s).
FAULT_S = 5.0


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "MASTER_ADDR", "MASTER_PORT", "RANK",
                        "WORLD_SIZE", "LOCAL_RANK")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", **extra)
    return env


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    params = {m: j_init(j_get_config(m), jax.random.key(0)) for m in MODELS}
    flat = {}
    for m, tree in params.items():
        for k, v in tree.items():
            if k == "blocks":
                flat.update({f"{m}/blocks.{n}": np.asarray(w) for n, w in v.items()})
            else:
                flat[f"{m}/{k}"] = np.asarray(v)
    prompts = [rng.randint(0, 256, n).tolist() for n in (5, 19, 11, 23, 30, 9)]
    tier_rng = np.random.RandomState(7)
    tier_prompts = [tier_rng.randint(1, 250, 40).tolist() for _ in range(5)]
    pair = JPDPair(JConfig(model="tiny", use_pallas="never", **BASE), params=params["tiny"])
    bundles = [pair.prefill.prefill(p, JSampling(**GREEDY)) for p in prompts[1:3]]
    for i, b in enumerate(bundles):
        flat[f"bundle{i}/k"] = np.asarray(b.k_data, np.float32)
        flat[f"bundle{i}/v"] = np.asarray(b.v_data, np.float32)
        flat[f"bundle{i}/first"] = np.array(b.first_token)
        flat[f"bundle{i}/prompt"] = np.array(json.dumps(list(b.prompt)))
    flat["prompts"] = np.array(json.dumps(prompts))
    flat["tier_prompts"] = np.array(json.dumps(tier_prompts))
    flat["tier_budget"] = np.array(TIER_BUDGET)
    return params, flat, prompts, tier_prompts, bundles


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Each rank's results (one spawn of the world for the file)."""
    tmp = str(tmp_path_factory.mktemp("tp_service"))
    path, out = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
    np.savez(path, **inputs[1])
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, WORKER, "2", str(r), str(port), path, out],
                              cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0].decode()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return json.loads(str(np.load(out)["results"]))


def _jmesh():
    return j_make_mesh(tp=2)


def _service_reference(params, model, prompts):
    svc = JEngineService(JConfig(model=model, use_pallas="never", multi_step=4, **BASE),
                         params=params[model], mesh=_jmesh())
    try:
        return ([svc.submit(p, JSampling(**s))[0] for p, s in zip(prompts, SERVICE_SAMPLINGS)],
                svc.embed(prompts[0]))
    finally:
        svc.stop()


@pytest.mark.parametrize("model", MODELS)
def test_two_rank_engine_service_matches_reference(model, inputs, ranks):
    """Rows submitted from threads on rank 0 (max_batch 4: the queue
    forms) give the reference service's greedy and seeded tokens; both
    ranks ran the same steps, joins and decode windows. tiny's embedding
    (the loop thread runs it on every rank) within 1e-4 of the
    reference's."""
    params, _, prompts, _, _ = inputs
    want, embed = _service_reference(params, model, prompts)
    assert ranks[0][f"svc/{model}"] == want
    if model == "tiny":
        np.testing.assert_allclose(ranks[0]["svc/tiny/embed"], np.asarray(embed), rtol=0,
                                   atol=1e-4)
    states = [r[f"svc/{model}/state"] for r in ranks]
    assert states[0]["metrics"] == states[1]["metrics"]
    assert states[0]["metrics"]["joins"] >= len(prompts)
    assert all(s["fault"] is None for s in states), states


def test_cancel_and_deadline_leave_no_row_on_either_rank(ranks):
    """A request cancelled while it runs and one whose deadline runs out
    while it runs: both end on rank 0, and after stop() neither rank holds
    a running, waiting or unfinished request or a page."""
    assert ranks[0]["svc/tiny/deadline"].startswith("DeadlineExceeded")
    assert 0 < ranks[0]["svc/tiny/cancelled_tokens"] < 100
    for r in ranks:
        s = r["svc/tiny/state"]
        assert (s["running"], s["waiting"], s["requests_live"]) == (0, 0, 0)
        assert s["free_pages"] == BASE["num_pages"] - 1
    assert ranks[0]["svc/tiny/state"]["metrics"] == ranks[1]["svc/tiny/state"]["metrics"]


def test_stop_ends_both_loops(ranks):
    """Rank 0's stop() ends its loop and, through its last plan, the
    follower's, within STOP_S."""
    for tag in ("svc/tiny", "svc/tiny-moe", "decode"):
        states = [r[f"{tag}/state"] for r in ranks]
        assert not any(s["alive"] for s in states), tag
    for tag in ("svc/tiny", "svc/tiny-moe"):
        t0 = ranks[0][f"{tag}/t_stop"][0]
        ended = max(r[f"{tag}/state"]["ended"] for r in ranks)
        assert 0 <= ended - t0 < STOP_S, (tag, ended - t0)


def test_follower_submit_raises(ranks):
    msg = ranks[1]["follower_submit"]
    assert msg is not None and "rank 0" in msg, msg


def test_replayed_id_mismatch_raises(ranks):
    """A plan whose admission names another request id than the follower's
    replay gives ends the follower's loop with a LockstepError."""
    m = ranks[1]["mismatch"]
    assert m["lockstep_error"] and not m["alive"], m
    assert "-7" in m["fault"], m


def test_mismatch_is_heard_by_the_leader(ranks):
    """The follower's answer to the plan it could not replay reaches rank
    0 before any step."""
    assert ranks[0]["mismatch_heard"] is True


def test_leader_fault_raises_on_the_follower(ranks):
    """Rank 0's pump faults with a row admitted: its loop ends, the row and
    later submissions fail, and its "fault" plan ends the follower's loop
    with a LockstepError naming the fault, within FAULT_S."""
    lead, follow = ranks[0]["fault/leader"], ranks[1]["fault/leader"]
    assert "injected leader fault" in lead["submit"], lead
    assert "stopped on a fault" in lead["later_submit"], lead
    assert not lead["alive"] and not follow["alive"], (lead, follow)
    assert follow["fault"].startswith("LockstepError") and "injected leader fault" \
        in follow["fault"], follow
    assert 0 <= follow["ended"] - lead["t_fault"] < FAULT_S, (lead, follow)


def test_follower_fault_raises_on_the_leader(ranks):
    """Rank 1's replay of an admission faults: it answers no to the plan,
    so neither rank steps; rank 0's loop ends with a LockstepError, its row
    fails and later submissions raise, within FAULT_S."""
    lead, follow = ranks[0]["fault/follower"], ranks[1]["fault/follower"]
    assert "injected follower fault" in follow["fault"], follow
    assert lead["fault"].startswith("LockstepError"), lead
    assert "could not apply" in lead["submit"], lead
    assert "stopped on a fault" in lead["later_submit"], lead
    assert not lead["alive"] and not follow["alive"], (lead, follow)
    assert 0 <= lead["ended"] - follow["t_fault"] < FAULT_S, (lead, follow)


def test_silent_leader_is_an_error_on_the_follower(ranks):
    """A plan group's timeout bounds a follower's wait: a leader that never
    sends (2 s timeout) is an error there, not a wedge."""
    got = ranks[1]["silent"]
    assert got["raised"] is not None and 1.5 <= got["seconds"] < 2.0 + FAULT_S, got


def test_request_ids_stay_in_step(ranks):
    assert ranks[0]["request_ids_next"] == ranks[1]["request_ids_next"]


def test_two_rank_decode_service_matches_reference(inputs, ranks):
    """The reference's bundles, decoded by a two-rank DecodeService (rank 0
    takes them, the plans carry them whole, each rank keeps its heads),
    give its DecodeService(mesh=...)'s tokens; the first bundle's KV again
    as a chunk stream gives the same tokens."""
    params, _, _, _, bundles = inputs
    svc = JDecodeService(JConfig(model="tiny", use_pallas="never", **BASE),
                         params=params["tiny"], mesh=_jmesh())
    try:
        want = [svc.submit_bundle(b, JSampling(**GREEDY)) for b in bundles]
    finally:
        svc.stop()
    assert ranks[0]["decode/bundles"] == want
    assert ranks[0]["decode/stream"] == want[0]
    states = [r["decode/state"] for r in ranks]
    assert states[0]["metrics"] == states[1]["metrics"]
    assert all(s["running"] == 0 and s["free_pages"] == BASE["num_pages"] - 1
               for s in states), states


def test_layer_sliced_pd_pair_matches_reference(inputs, ranks):
    """PDStreamPair(admit_layers=1) at tp 2 over paced links: identical
    greedy and seeded tokens on both ranks and to the reference's pair on a
    tp 2 mesh; the layer-sliced admission engaged (rank 0 decided it, every
    rank took it)."""
    params, _, prompts, _, _ = inputs
    pair = JPDStreamPair(JConfig(model="tiny", use_pallas="never", **BASE),
                         params=params["tiny"], mesh=_jmesh(), layer_split=1,
                         admit_layers=1)
    want = [pair.generate_one(p, JSampling(**s))["tokens"]
            for p, s in zip(prompts, [GREEDY, SEEDED, GREEDY])]
    for r in ranks:
        assert r["pd_layers"] == want
    assert ranks[0]["pd_layers/at_admit"] == ranks[1]["pd_layers/at_admit"]
    assert any(a is not None for a in ranks[0]["pd_layers/at_admit"])


def test_host_tier_at_tp2_matches_reference(inputs, ranks):
    """Two passes of a spill-then-promote script: tokens, spilled,
    promoted, evicted and resident page counts and host hit tokens equal
    the reference's tier of whole pages under the whole budget; each rank
    holds its heads' half of the bytes under half the budget."""
    params, _, _, tier_prompts, _ = inputs
    eng = JEngine(JConfig(model="tiny", use_pallas="never",
                          **{**BASE, "num_pages": 24, "enable_radix_cache": True},
                          host_tier_bytes=TIER_BUDGET), params=params["tiny"], mesh=_jmesh())
    want = [[eng.generate([p], JSampling(max_new_tokens=6))[0] for p in tier_prompts]
            for _ in range(2)]
    s = eng.host_tier.stats()
    assert s["spilled_pages"] > 0 and s["promoted_pages"] > 0 and s["evicted_pages"] > 0
    for r in ranks:
        assert r["tier"] == want
        got = r["tier/stats"]
        for k in ("spilled_pages", "promoted_pages", "evicted_pages", "pages"):
            assert got[k] == s[k], (k, got[k], s[k])
        assert (got["bytes"] * 2, got["max_bytes"] * 2) == (s["bytes"], s["max_bytes"])
        assert r["tier/hits"] == {"host_hit_tokens": eng.metrics["host_hit_tokens"],
                                  "radix_hit_tokens": eng.metrics["radix_hit_tokens"]}
        assert r["tier/closes"]


def test_moe_mask_recorder_agrees_at_tp2(ranks):
    """chip_smoke.moe_masks on tiny-moe's first step (float32): the kept
    experts at tp 2 equal the unsharded engine's in every layer."""
    for r in ranks:
        m = r["masks"]
        assert m["equal"] and m["shape"][0] == j_get_config("tiny-moe").num_layers, m
        assert m["kept"] >= m["shape"][0] * m["shape"][1] * 2


def test_servers_form_the_contract_world(inputs):
    """Two ``python -m rbg_tpu_torch.engine.server --device cpu`` processes
    under the control plane's contract (RBG_DISTRIBUTED=1,
    RBG_JAX_NUM_PROCESSES=2, a coordinator, a process id) form a gloo
    world, report ready with their rank, and each answers a generate with
    an unsharded port engine's tokens."""
    from rbg_tpu_torch.engine.config import SamplingParams
    from rbg_tpu_torch.engine.engine import Engine
    from rbg_tpu_torch.engine.protocol import request_once
    from rbg_tpu_torch.engine.server import build_config, parse_args

    _, _, prompts, _, _ = inputs
    coordinator = f"127.0.0.1:{_free_port()}"
    args = ["--device", "cpu", "--model", "tiny", "--port", "0", "--num-pages", "64"]
    procs = []
    try:
        for pid in range(2):
            env = _env(RBG_DISTRIBUTED="1", RBG_JAX_NUM_PROCESSES="2",
                       RBG_JAX_COORDINATOR_ADDRESS=coordinator,
                       RBG_JAX_PROCESS_ID=str(pid))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "rbg_tpu_torch.engine.server", *args],
                cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        addrs = []
        for p in procs:
            deadline = time.monotonic() + 60
            line = ""
            while time.monotonic() < deadline and "engine ready" not in line:
                line = p.stdout.readline()
                assert line or p.poll() is None, "server exited"
            m = re.search(r"addr=(\S+) world=(\d+)/2", line)
            assert m, line
            addrs.append((m.group(1), int(m.group(2))))
        assert sorted(w for _, w in addrs) == [0, 1]
        want = Engine(build_config(parse_args(args))).generate(
            [prompts[3]], SamplingParams(max_new_tokens=6))[0]
        for addr, _ in addrs:
            obj, _, _ = request_once(addr, {"op": "generate", "prompt": prompts[3],
                                            "max_new_tokens": 6})
            assert obj.get("tokens") == want, obj
    finally:
        for p in procs:
            p.kill()
            p.wait()
