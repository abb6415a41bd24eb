"""Rendezvous check worker (``rbg_tpu/engine/rendezvous_check.py``): prove
that the control plane's injected distributed-init contract forms a
working multi-process ``torch.distributed`` world.

    python -m rbg_tpu_torch.engine.rendezvous_check [--device cpu]

Runs as a leaderWorker role's pod. It reads the names the control plane
injects (``RBG_JAX_COORDINATOR_ADDRESS`` / ``RBG_JAX_NUM_PROCESSES`` /
``RBG_JAX_PROCESS_ID``, unchanged), forms the world with
``init_process_group`` on a TCP store at the coordinator address, has rank
0 broadcast the group identity (the reference's ``broadcast_one_to_all``)
and writes the result to ``RBG_RENDEZVOUS_OUT.<pid>``. It serves the
standard health op over the port's protocol (port ``RBG_SERVE_PORT``) so
the executor's readiness probe passes, until terminated.

The backend is ``nccl`` on the card (one device per process) and ``gloo``
when ``--device cpu`` asks for the CPU; without a card and without that
request it exits with an error. Local-mode address resolution: with a
registry path present the coordinator's host part resolves to 127.0.0.1
(same-host processes), as the reference's does.
"""

from __future__ import annotations

import argparse
import json
import os
import socketserver
import sys
import threading


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rbg-tpu-torch-rendezvous-check")
    ap.add_argument("--device", default=None,
                    help="cpu forms a gloo world; default: the card (nccl)")
    args = ap.parse_args(argv)

    port = int(os.environ.get("RBG_SERVE_PORT", "9400"))
    state = {"ok": False, "detail": "initializing"}

    from rbg_tpu_torch.engine.protocol import recv_msg, send_msg

    class Handler(socketserver.BaseRequestHandler):
        def handle(self):
            while True:
                try:
                    obj, _, _ = recv_msg(self.request)
                except Exception:
                    return
                if obj is None:
                    return
                send_msg(self.request, {"ok": True, "rendezvous": dict(state)})

    import torch
    import torch.distributed as dist

    from rbg_tpu_torch.parallel.mesh import contract_world, device_type, init_world

    device_type(args.device)   # no card and no --device cpu: fail before binding
    srv = socketserver.ThreadingTCPServer(("127.0.0.1", port), Handler)
    srv.allow_reuse_address = True
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    print(f"rendezvous-check listening on {port}", flush=True)

    coordinator, num, pid = contract_world()
    dev = init_world(coordinator, num, pid, args.device)

    # The leader broadcasts the group identity; everyone counts the devices.
    group = os.environ.get("RBG_GROUP_NAME", "")
    payload = torch.tensor([float(len(group)), float(pid)], device=dev)
    dist.broadcast(payload, src=0)
    result = {
        "process_id": pid,
        "num_processes": num,
        "global_devices": dist.get_world_size(),
        "leader_group_len": int(payload[0]),
        "leader_pid": int(payload[1]),
    }
    state.update(ok=True, detail="rendezvous complete", **result)
    out = os.environ.get("RBG_RENDEZVOUS_OUT")
    if out:
        with open(f"{out}.{pid}", "w") as f:
            json.dump(result, f)
    print(f"rendezvous ok: {result}", flush=True)
    threading.Event().wait()  # serve health until terminated
    return 0


if __name__ == "__main__":
    sys.exit(main())
