"""The port's parallel plane (rbg_tpu_torch/parallel) in gloo worlds of 2
and 4 CPU processes against rbg_tpu on the 8-device CPU mesh: ring
attention over sp, loss and gradients over dp × sp × tp (with remat), tp
on tiny-mla, ep (and ep × tp) on tiny-moe, three train steps over
dp × tp, the GPipe pipeline over pp, the sharding rules, and the
rendezvous check as two processes.

Each world is one spawn (tests/torch_parallel_worker.py, a free TCP port,
a timeout) that runs all its checks and writes an .npz; the tests compare
it here with JAX. Float32 throughout: values within 1e-5 relative."""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from rbg_tpu.models import get_config as j_get_config, init_params as j_init
from rbg_tpu.models.config import list_presets
from rbg_tpu.models.llama import forward_train as j_forward_train
from rbg_tpu.models.training import next_token_loss as j_loss, train_n_steps
from rbg_tpu.ops.attention import gqa_attention as j_gqa
from rbg_tpu.parallel import make_mesh as j_make_mesh, param_specs as j_param_specs
from rbg_tpu.parallel.ring import ring_attention as j_ring
from rbg_tpu_torch.models.config import get_config
from rbg_tpu_torch.parallel import param_specs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
MODELS = ("tiny", "tiny-mla", "tiny-moe")
RTOL, ATOL = 1e-5, 1e-6


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "MASTER_ADDR", "MASTER_PORT", "RANK",
                        "WORLD_SIZE", "LOCAL_RANK")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
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
    tokens = rng.randint(0, 256, (4, 16)).astype(np.int32)
    mask = np.ones((4, 16), bool)
    mask[1, 10:] = False
    mask[3, 5:] = False
    B, S, H, KV, hd = 2, 16, 4, 2, 8
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    kv_mask = np.ones((B, S), bool)
    kv_mask[1, 11:] = False
    ring = {"rq": rng.randn(B, S, H, hd).astype(np.float32),
            "rk": rng.randn(B, S, KV, hd).astype(np.float32),
            "rv": rng.randn(B, S, KV, hd).astype(np.float32),
            "rpos": pos, "rkvpos": np.where(kv_mask, pos, 1 << 30).astype(np.int32),
            "rcot": rng.randn(B, S, H, hd).astype(np.float32)}
    return params, {**flat, "tokens": tokens, "mask": mask, **ring}, kv_mask


def _spawn(world, inp, tmp):
    path = os.path.join(tmp, f"in{world}.npz")
    out = os.path.join(tmp, f"out{world}.npz")
    np.savez(path, **inp)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, WORKER, str(world), str(r), str(port),
                               path, out], cwd=ROOT, env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
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
    return dict(np.load(out))


@pytest.fixture(scope="module")
def world2(inputs, tmp_path_factory):
    return _spawn(2, inputs[1], str(tmp_path_factory.mktemp("w2")))


@pytest.fixture(scope="module")
def world4(inputs, tmp_path_factory):
    return _spawn(4, inputs[1], str(tmp_path_factory.mktemp("w4")))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=max(ATOL, RTOL * float(np.abs(want).max())))


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "blocks"}
    out.update({f"blocks.{k}": v for k, v in tree["blocks"].items()})
    return out


def _check_loss_grads(out, tag, jp, model, tokens, mask):
    loss, grads = jax.value_and_grad(j_loss)(jp, j_get_config(model),
                                              jnp.asarray(tokens),
                                              None if mask is None else jnp.asarray(mask))
    _close(out[f"{tag}/loss"], loss)
    names = _flat(grads)
    assert sorted(k for k in out if k.startswith(f"{tag}/grad/")) == sorted(
        f"{tag}/grad/{k}" for k in names)
    for name, g in names.items():
        _close(out[f"{tag}/grad/{name}"], g)


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_matches_reference_and_dense(sp, inputs, request):
    """Forward and the gradients of q, k, v: the port's ring over a gloo
    world equals rbg_tpu's ring over an sp mesh of the CPU devices, and
    dense attention."""
    out = request.getfixturevalue(f"world{sp}")
    _, inp, kv_mask = inputs
    q, k, v, pos, kvpos, cot = (jnp.asarray(inp[n]) for n in
                                ("rq", "rk", "rv", "rpos", "rkvpos", "rcot"))
    mesh = j_make_mesh(sp=sp, devices=jax.devices()[:sp])

    def ring_loss(q, k, v):
        return jnp.sum(j_ring(q, k, v, pos, kvpos, mesh) * cot)

    def dense_loss(q, k, v):
        return jnp.sum(j_gqa(q, k, v, pos, jnp.asarray(kv_mask)) * cot)

    want = jax.jit(lambda q, k, v: j_ring(q, k, v, pos, kvpos, mesh))(q, k, v)
    _close(out[f"ring{sp}/out"], want)
    _close(out[f"ring{sp}/out"], j_gqa(q, k, v, pos, jnp.asarray(kv_mask)))
    g_ring = jax.jit(jax.grad(ring_loss, argnums=(0, 1, 2)))(q, k, v)
    g_dense = jax.grad(dense_loss, argnums=(0, 1, 2))(q, k, v)
    for name, a, b in zip(("dq", "dk", "dv"), g_ring, g_dense):
        _close(out[f"ring{sp}/{name}"], a)
        _close(out[f"ring{sp}/{name}"], b)


@pytest.mark.parametrize("tag,world,model,masked", [
    ("dp2", 2, "tiny", True),
    ("sp2_remat", 2, "tiny", True),
    ("sp2tp2", 4, "tiny", False),
    ("sp2tp2_remat", 4, "tiny", True),
    ("dp2tp2", 4, "tiny", True),
    ("mla_tp2", 2, "tiny-mla", True),
    ("moe_ep2", 2, "tiny-moe", True),
    ("moe_ep2tp2", 4, "tiny-moe", True),
])
def test_sharded_loss_and_grads_match_single_device(tag, world, model, masked, inputs,
                                                   request):
    """dp × sp × tp (ring attention over sp, remat), tp on tiny-mla, ep and
    ep × tp on tiny-moe: the global loss (rows with different numbers of
    unmasked targets under dp) and every leaf's gradient equal single-device
    jax.value_and_grad."""
    out = request.getfixturevalue(f"world{world}")
    params, inp, _ = inputs
    _check_loss_grads(out, tag, params[model], model, inp["tokens"],
                      inp["mask"] if masked else None)


@pytest.mark.parametrize("tag,model", [("mla_tp2", "tiny-mla"), ("moe_ep2", "tiny-moe")])
def test_sharded_forward_matches_single_device(tag, model, inputs, world2):
    params, inp, _ = inputs
    want = j_forward_train(params[model], j_get_config(model),
                           jnp.asarray(inp["tokens"]), jnp.asarray(inp["mask"]))
    _close(world2[f"{tag}/logits"], want)


def test_train_steps_over_dp_tp_match_reference(inputs, world4):
    """Three make_train_step steps over dp 2 × tp 2 against rbg_tpu's
    train_n_steps on one device: the last loss within 1e-5, and the
    parameters within 1e-5 but for a few elements. Adam normalises each
    element's gradient, so an element whose gradient is at float32
    rounding noise (another summation order over dp and tp moves it) may
    step anywhere within ±lr; such elements (at most 1e-4 of each leaf)
    are held within the 3 · lr that three steps can move any element."""
    params, inp, _ = inputs
    jp, loss = train_n_steps(j_get_config("tiny"), j_make_mesh(devices=jax.devices()[:1]),
                             params["tiny"], jnp.asarray(inp["tokens"]), 3)
    _close(world4["train_dp2tp2/loss"], loss)
    for name, w in _flat(jp).items():
        got, want = world4[f"train_dp2tp2/param/{name}"], np.asarray(w)
        off = np.abs(got - want) > 1e-5 + 1e-5 * np.abs(want)
        assert off.mean() <= 1e-4, (name, int(off.sum()))
        np.testing.assert_allclose(got, want, rtol=0, atol=3 * 3e-4)


def _pp_mesh(pp):
    return Mesh(np.asarray(jax.devices()[:pp]).reshape(pp), ("pp",))


@pytest.mark.parametrize("case", ["micro4", "micro2", "masked"])
def test_pipeline_matches_dense(case, inputs, world2):
    """pp = 2 (tests/test_pipeline.py's cases): microbatches 4 and 2, and 4
    with a pad mask, equal the dense forward."""
    params, inp, _ = inputs
    mask = jnp.asarray(inp["mask"]) if case == "masked" else None
    dense = j_forward_train(params["tiny"], j_get_config("tiny"),
                            jnp.asarray(inp["tokens"]), mask)
    _close(world2[f"pp/{case}"], dense)


def test_pipeline_grads_match_dense(inputs, world2):
    params, inp, _ = inputs
    cfg, tokens = j_get_config("tiny"), jnp.asarray(inp["tokens"])

    def loss_dense(p):
        return jnp.mean(j_forward_train(p, cfg, tokens).astype(jnp.float32) ** 2)

    for name, g in _flat(jax.grad(loss_dense)(params["tiny"])).items():
        _close(world2[f"pp/grad/{name}"], g)


@pytest.mark.parametrize("name", list_presets())
def test_param_specs_match_reference(name):
    """Entry for entry on every preset, and with the Qwen2 biases."""
    def as_tuples(tree):
        return {k: (as_tuples(v) if isinstance(v, dict) else tuple(v))
                for k, v in tree.items()}

    assert param_specs(get_config(name)) == as_tuples(j_param_specs(j_get_config(name)))
    with_bias = {"blocks": {"bq": None}}
    assert param_specs(get_config(name), with_bias) == as_tuples(
        j_param_specs(j_get_config(name), with_bias))


def test_rendezvous_check_two_processes(tmp_path):
    """rbg_tpu_torch.engine.rendezvous_check as two processes on the CPU:
    the world forms over the coordinator address, rank 0's broadcast
    reaches both, and each writes the reference's JSON fields; the health
    op answers while it serves."""
    from rbg_tpu_torch.engine.protocol import request_obj

    coord, out = _free_port(), str(tmp_path / "rdv")
    ports = [_free_port() for _ in range(2)]
    procs = []
    for pid in range(2):
        env = {**_env(), "RBG_JAX_COORDINATOR_ADDRESS": f"leader-0.svc:{coord}",
               "RBG_JAX_NUM_PROCESSES": "2", "RBG_JAX_PROCESS_ID": str(pid),
               "RBG_REGISTRY_PATH": str(tmp_path / "registry"),
               "RBG_GROUP_NAME": "grp-abc", "RBG_RENDEZVOUS_OUT": out,
               "RBG_SERVE_PORT": str(ports[pid])}
        procs.append(subprocess.Popen([sys.executable, "-m",
                                       "rbg_tpu_torch.engine.rendezvous_check", "--device", "cpu"],
                                      cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    try:
        import time
        deadline = time.monotonic() + 120
        while not all(os.path.exists(f"{out}.{pid}") for pid in range(2)):
            assert time.monotonic() < deadline and all(p.poll() is None for p in procs), \
                [p.stdout.read1().decode() if p.poll() is not None else "" for p in procs]
            time.sleep(0.2)
        time.sleep(0.2)
        for pid in range(2):
            with open(f"{out}.{pid}") as f:
                got = json.load(f)
            assert got == {"process_id": pid, "num_processes": 2, "global_devices": 2,
                           "leader_group_len": len("grp-abc"), "leader_pid": 0}
            health = request_obj(f"127.0.0.1:{ports[pid]}", {"op": "health"})
            assert health["ok"] and health["rendezvous"]["ok"]
            assert health["rendezvous"]["process_id"] == pid
    finally:
        for p in procs:
            p.terminate()
            p.wait(timeout=30)
