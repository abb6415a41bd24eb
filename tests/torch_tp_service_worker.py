"""One rank of a gloo world on the CPU for tests/test_torch_tp_service.py.

    python tests/torch_tp_service_worker.py WORLD RANK PORT INPUTS.npz OUT.npz

Every rank builds the same services over ``make_mesh(tp=WORLD)``: rank 0
leads (it takes the submissions, from threads), every other rank replays
its plans. Each case's tokens, each rank's engine metrics and rows left,
the host tier's counts, the refusals and the stop times are gathered; rank
0 writes them to OUT.npz, which the test holds against rbg_tpu's services
on a tp 2 mesh. Imports no JAX.
"""

import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke  # noqa: E402
from rbg_tpu_torch.engine.config import EngineConfig, SamplingParams  # noqa: E402
from rbg_tpu_torch.engine.engine import Engine, Request  # noqa: E402
from rbg_tpu_torch.engine.lockstep import Lockstep, LockstepError, Plan  # noqa: E402
from rbg_tpu_torch.engine.pd import KVBundle, PDStreamPair  # noqa: E402
from rbg_tpu_torch.engine.protocol import DeadlineExceeded  # noqa: E402
from rbg_tpu_torch.engine.service import DecodeService, EngineService  # noqa: E402
from rbg_tpu_torch.kvtransfer.chunks import StreamMeta, bundle_to_frames  # noqa: E402
from rbg_tpu_torch.models.config import get_config  # noqa: E402
from rbg_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from rbg_tpu_torch.parallel import make_mesh  # noqa: E402
from torch_pd_links import HeldTailLink, hold_tail  # noqa: E402

BASE = dict(page_size=8, num_pages=64, max_batch=4, max_seq_len=128,
            prefill_chunk=16, enable_radix_cache=False, device="cpu")
GREEDY = SamplingParams(max_new_tokens=8)
SEEDED = SamplingParams(max_new_tokens=8, temperature=0.9, top_k=40, seed=5)
METRICS = ("steps", "joins", "decode_windows", "preemptions", "unified_steps",
           "prefill_tokens", "decode_tokens")
RESULTS = {}


def tree_of(inp, model):
    flat = {}
    for key in inp.files:
        m, _, name = key.partition("/")
        if m == model:
            flat[name] = inp[key]
    tree = {k: v for k, v in flat.items() if not k.startswith("blocks.")}
    tree["blocks"] = {k[7:]: v for k, v in flat.items() if k.startswith("blocks.")}
    return params_from_numpy(tree, get_config(model), "cpu")


def on_threads(fns):
    """Run each callable on its own thread, started 20 ms apart (the queue
    forms); their results in order."""
    out = [None] * len(fns)

    def run(i):
        try:
            out[i] = fns[i]()
        except Exception as e:  # noqa: BLE001 — recorded, the test reads it
            out[i] = f"{type(e).__name__}: {e}"
    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in threads:
        t.start()
        time.sleep(0.02)
    for t in threads:
        t.join(120)
    return out


def settle(tag, svc, rank, t_stop):
    """Stop the service (the leader's stop ends every loop) and record its
    rank's engine state and the wall time its loop ended."""
    if rank == 0:
        t_stop.append(time.time())
    svc.stop(timeout=300)
    eng = svc.engine
    RESULTS[f"{tag}/state"] = {
        "alive": svc._thread.is_alive(), "ended": time.time(),
        "fault": None if svc.fault is None else str(svc.fault),
        "metrics": {k: eng.metrics[k] for k in METRICS},
        "running": len(eng.running), "waiting": len(eng.waiting),
        "requests_live": sum(r.state != "finished" for r in eng.requests.values()),
        "free_pages": eng.allocator.free_pages,
        "plans": svc._lockstep.stats()}


def service_case(tag, model, trees, mesh, prompts, rank):
    """tiny / tiny-moe through a two-rank EngineService: greedy rows and a
    seeded row from threads on rank 0, then a cancelled and a deadline row
    mid-run (tiny), with max_batch 4 so the queue forms."""
    svc = EngineService(EngineConfig(model=model, **{**BASE, "multi_step": 4}),
                        params=trees[model], mesh=mesh)
    t_stop = []
    if rank == 0:
        sps = [GREEDY, GREEDY, SEEDED] + [GREEDY] * (len(prompts) - 3)
        got = on_threads([lambda p=p, s=s: svc.submit(p, s)[0] for p, s in zip(prompts, sps)])
        RESULTS[tag] = got
        if model == "tiny":
            RESULTS[f"{tag}/embed"] = svc.embed(prompts[0])
            long = SamplingParams(max_new_tokens=100)
            p = svc.submit_async(prompts[0], long)
            while not p.tokens:
                time.sleep(0.005)
            svc.cancel(p)
            p.done.wait(30)
            d = svc.submit_async(prompts[1], long, deadline=time.monotonic() + 0.3)
            try:
                svc.wait(d, 30)
                RESULTS[f"{tag}/deadline"] = "finished"
            except DeadlineExceeded as e:
                RESULTS[f"{tag}/deadline"] = f"DeadlineExceeded: {e}"
            RESULTS[f"{tag}/cancelled_tokens"] = len(p.tokens)
    else:
        try:
            svc.submit(prompts[0], GREEDY)
            RESULTS["follower_submit"] = None
        except ValueError as e:
            RESULTS["follower_submit"] = str(e)
    # No collective on this thread while a loop runs: the follower waits in
    # stop() for the leader's last plan.
    settle(tag, svc, rank, t_stop)
    RESULTS[f"{tag}/t_stop"] = t_stop


def decode_case(inp, trees, mesh, rank):
    """A two-rank DecodeService: two bundles from threads on rank 0, then
    the first bundle's KV again as a chunk stream fed on rank 0 (its
    chunks reach the follower in the plans)."""
    svc = DecodeService(EngineConfig(model="tiny", **BASE), params=trees["tiny"], mesh=mesh)
    bundles = [KVBundle(prompt=json.loads(str(inp[f"bundle{i}/prompt"])),
                        first_token=int(inp[f"bundle{i}/first"]),
                        k_data=inp[f"bundle{i}/k"], v_data=inp[f"bundle{i}/v"],
                        dtype="float32") for i in range(2)]
    t_stop = []
    if rank == 0:
        RESULTS["decode/bundles"] = on_threads(
            [lambda b=b: svc.submit_bundle(b, GREEDY) for b in bundles])
        b = bundles[0]
        meta = StreamMeta(stream_id="s0", prompt=b.prompt, n_pages=b.k_data.shape[1],
                          k_page_shape=b.k_data.shape[2:], v_page_shape=b.v_data.shape[2:],
                          dtype="float32", layers=b.k_data.shape[0],
                          page_size=BASE["page_size"])
        rx = svc.kv_streams.get_or_create("s0")
        svc.watch_stream(rx)
        for frame in bundle_to_frames(meta, b.k_data, b.v_data, b.first_token, 1):
            rx.feed(frame)
            time.sleep(0.002)
        rx.wait_ready(30)
        p = svc.submit_stream(rx, GREEDY)
        svc.wait(p, 60)
        RESULTS["decode/stream"] = [b.first_token] + p.tokens
    settle("decode", svc, rank, t_stop)


def pd_case(trees, mesh, prompts):
    """PDStreamPair(admit_layers=1) at tp 2, every rank on its own paced
    link that holds each stream's tail until the pair admits it
    (tests/torch_pd_links.py): rank 0 decides each admission's coverage."""
    link = HeldTailLink(admit_layers=1)
    pair = hold_tail(PDStreamPair(EngineConfig(model="tiny", **BASE), params=trees["tiny"],
                                  mesh=mesh, transport=link, layer_split=1,
                                  admit_layers=1), link)
    runs = [pair.generate_one(p, s) for p, s in zip(prompts, [GREEDY, SEEDED, GREEDY])]
    RESULTS["pd_layers"] = [r["tokens"] for r in runs]
    RESULTS["pd_layers/at_admit"] = [r["layers_at_admit"] for r in runs]
    RESULTS["pd_layers/plans"] = pair.lockstep.stats()


def tier_case(trees, mesh, tier_prompts, budget):
    """A spill-then-promote script (two passes over the prompts, one at a
    time) through a tp 2 engine with a host tier."""
    eng = Engine(EngineConfig(model="tiny", **{**BASE, "num_pages": 24,
                                               "enable_radix_cache": True,
                                               "host_tier_bytes": budget}),
                 params=trees["tiny"], mesh=mesh)
    toks = []
    for _ in range(2):
        toks.append([eng.generate([p], SamplingParams(max_new_tokens=6))[0]
                     for p in tier_prompts])
    s = eng.host_tier.stats()
    RESULTS["tier"] = toks
    RESULTS["tier/stats"] = {k: s[k] for k in ("spilled_pages", "promoted_pages",
                                               "evicted_pages", "pages", "bytes",
                                               "max_bytes")}
    RESULTS["tier/hits"] = {k: eng.metrics[k] for k in ("host_hit_tokens",
                                                        "radix_hit_tokens")}
    RESULTS["tier/closes"] = eng.host_tier.accounting_closes()


def masks_case(trees, mesh, prompts):
    """The kept-expert masks of tiny-moe's first step, tp 2 against the
    unsharded engine (float32), through chip_smoke's recorder."""
    prompt = prompts[3]
    got = {}
    for name, m in (("tp", mesh), ("one", None)):
        eng = Engine(EngineConfig(model="tiny-moe", **BASE), params=trees["tiny-moe"], mesh=m)
        with chip_smoke.moe_masks(torch) as rec:
            chip_smoke.first_step_logits(torch, eng, prompt)
        got[name] = np.stack(rec["masks"])
    RESULTS["masks"] = {"equal": bool(np.array_equal(got["tp"], got["one"])),
                        "shape": list(got["tp"].shape),
                        "kept": int(got["tp"].sum())}


def mismatch_case(trees, mesh, prompts, rank):
    """A plan whose admission names another request id than the
    follower's replay gives: the follower raises and stops following."""
    if rank == 0:
        svc = None
        lock = Lockstep(mesh)
        lock.send(Plan(ops=[("admit", prompts[0], GREEDY, -7)]))
        RESULTS["mismatch_heard"] = not lock.agree(True)
    else:
        svc = EngineService(EngineConfig(model="tiny", **BASE), params=trees["tiny"],
                            mesh=mesh)
        svc._thread.join(30)
        RESULTS["mismatch"] = {"alive": svc._thread.is_alive(),
                               "fault": repr(svc.fault),
                               "lockstep_error": isinstance(svc.fault, LockstepError)}
    return svc


def fault_case(trees, mesh, prompts, rank, where):
    """A fault on one rank of a two-rank EngineService: "leader" (rank 0's
    pump raises after a submission) or "follower" (rank 1's replay of the
    admission raises). The other rank must raise too; each rank records
    when its loop ended and why, rank 0 also when the fault began."""
    svc = EngineService(EngineConfig(model="tiny", **BASE), params=trees["tiny"], mesh=mesh)
    out = RESULTS[f"fault/{where}"] = {}

    def injected(*_a, **_k):
        out["t_fault"] = time.time()
        raise RuntimeError(f"injected {where} fault")
    if where == "leader" and rank == 0:
        svc._pump = lambda: injected() if svc._pending else None
    if where == "follower" and rank == 1:
        svc.engine.add_request = injected
    if rank == 0:
        out["t_submit"] = time.time()
        try:
            svc.submit(prompts[0], GREEDY, timeout=60)
            out["submit"] = "finished"
        except Exception as e:  # noqa: BLE001 — recorded, the test reads it
            out["submit"] = f"{type(e).__name__}: {e}"
        try:
            svc.submit(prompts[1], GREEDY, timeout=60)
            out["later_submit"] = "finished"
        except Exception as e:  # noqa: BLE001
            out["later_submit"] = f"{type(e).__name__}: {e}"
    svc._thread.join(60)
    out.update(alive=svc._thread.is_alive(), ended=time.time(),
               fault=None if svc.fault is None else f"{type(svc.fault).__name__}: {svc.fault}")


def silent_leader_case(mesh, rank):
    """A plan group of a 2 s timeout whose leader never sends: the
    follower's wait raises when the timeout runs out."""
    lock = Lockstep(mesh, timeout=2.0)
    if rank == 1:
        t0 = time.time()
        try:
            lock.recv()
            RESULTS["silent"] = {"raised": None}
        except RuntimeError as e:
            RESULTS["silent"] = {"raised": type(e).__name__, "seconds": time.time() - t0}


def main():
    world, rank, port = (int(x) for x in sys.argv[1:4])
    inp = np.load(sys.argv[4])
    torch.manual_seed(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    trees = {m: tree_of(inp, m) for m in ("tiny", "tiny-moe")}
    prompts = json.loads(str(inp["prompts"]))
    mesh = make_mesh(tp=world, device="cpu")
    service_case("svc/tiny", "tiny", trees, mesh, prompts, rank)
    service_case("svc/tiny-moe", "tiny-moe", trees, mesh, prompts, rank)
    decode_case(inp, trees, mesh, rank)
    pd_case(trees, mesh, prompts)
    tier_case(trees, mesh, json.loads(str(inp["tier_prompts"])), int(inp["tier_budget"]))
    masks_case(trees, mesh, prompts)
    RESULTS["request_ids_next"] = next(Request._ids)
    mismatch_case(trees, mesh, prompts, rank)
    fault_case(trees, mesh, prompts, rank, "leader")
    fault_case(trees, mesh, prompts, rank, "follower")
    silent_leader_case(mesh, rank)
    gathered = [None] * world
    dist.all_gather_object(gathered, RESULTS)
    if rank == 0:
        np.savez(sys.argv[5], results=np.array(json.dumps(gathered)))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
