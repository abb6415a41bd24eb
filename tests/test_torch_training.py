"""The port's training half (rbg_tpu_torch/models/training.py and
forward_train in models/llama.py) against rbg_tpu's on the same weights
(the JAX init converted by the weight bridge), float32 on the CPU:
forward_train, next_token_loss and every gradient, remat, three AdamW
steps against optax, and the Qwen2 attention biases through every forward
of the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rbg_tpu.models import KVCache as JKVCache, forward as j_forward
from rbg_tpu.models import get_config as j_get_config, init_params as j_init
from rbg_tpu.models.llama import (encode_hidden as j_encode_hidden,
                                  forward_paged as j_forward_paged,
                                  forward_ragged as j_forward_ragged,
                                  forward_train as j_forward_train)
from rbg_tpu.models.training import next_token_loss as j_loss, train_n_steps as j_train
from rbg_tpu.parallel import make_mesh as j_make_mesh
from rbg_tpu_torch.models.config import get_config
from rbg_tpu_torch.models.convert import params_from_numpy
from rbg_tpu_torch.models.llama import (KVCache, encode_hidden, forward, forward_paged,
                                        forward_ragged, forward_train)
from rbg_tpu_torch.models.training import (make_train_step, next_token_loss,
                                           param_leaves, stack_params, train_n_steps)

MODELS = ("tiny", "tiny-mla", "tiny-moe")
RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    """Within rtol of the reference's largest magnitude, element by element."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def weights():
    out = {}
    for m in MODELS:
        jp = j_init(j_get_config(m), jax.random.key(0))
        out[m] = (jp, jax.tree.map(np.asarray, jp))
    return out


def _torch(npp, model, grad=False):
    tp = params_from_numpy(npp, get_config(model), "cpu")
    if grad:
        for t in [v for k, v in tp.items() if k != "blocks"] + list(tp["blocks"].values()):
            t.requires_grad_()
    return tp


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "blocks"}
    out.update({f"blocks.{k}": v for k, v in tree["blocks"].items()})
    return out


def _batch(seed=0, B=3, T=16):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, 256, (B, T)).astype(np.int32)
    mask = np.ones((B, T), bool)
    mask[1, T - 5:] = False
    mask[B - 1, 6:] = False
    return tokens, mask


@pytest.mark.parametrize("masked", [False, True], ids=["full", "pads"])
@pytest.mark.parametrize("model", MODELS)
def test_forward_train_matches_reference(weights, model, masked):
    jp, npp = weights[model]
    tokens, mask = _batch()
    m = mask if masked else None
    want = j_forward_train(jp, j_get_config(model), jnp.asarray(tokens),
                           None if m is None else jnp.asarray(m))
    got = forward_train(_torch(npp, model), get_config(model), torch.from_numpy(tokens),
                        None if m is None else torch.from_numpy(m))
    assert got.dtype == torch.float32 and got.requires_grad is False
    _close(got.numpy(), want)


@pytest.mark.parametrize("model", MODELS)
def test_loss_and_every_gradient_match_value_and_grad(weights, model):
    """next_token_loss and the gradient of every leaf equal
    jax.value_and_grad's, with pads (rows with different target counts)."""
    jp, npp = weights[model]
    tokens, mask = _batch(1)
    loss, grads = jax.value_and_grad(j_loss)(jp, j_get_config(model), jnp.asarray(tokens),
                                             jnp.asarray(mask))
    tp = _torch(npp, model, grad=True)
    got = next_token_loss(tp, get_config(model), torch.from_numpy(tokens),
                          torch.from_numpy(mask))
    got.backward()
    _close(got.detach().numpy(), loss)
    want = _flat(grads)
    assert sorted(_flat(tp)) == sorted(want)
    for name, t in _flat(tp).items():
        _close(t.grad.numpy(), want[name])


@pytest.mark.parametrize("model", MODELS)
def test_remat_grads_equal_plain_grads(weights, model):
    """Recomputing each block in the backward changes memory, not math."""
    _, npp = weights[model]
    tokens, mask = _batch(2)
    grads = []
    for remat in (False, True):
        tp = _torch(npp, model, grad=True)
        next_token_loss(tp, get_config(model), torch.from_numpy(tokens),
                        torch.from_numpy(mask), remat=remat).backward()
        grads.append({k: t.grad.numpy() for k, t in _flat(tp).items()})
    for name in grads[0]:
        _close(grads[1][name], grads[0][name], rtol=1e-6)


@pytest.mark.parametrize("remat", [False, True])
def test_three_adamw_steps_match_train_n_steps(weights, remat):
    """Three make_train_step steps equal rbg_tpu's train_n_steps (optax
    adamw(3e-4)) on a one-device mesh, in the last loss and every
    parameter: the AdamW constants are optax's. The caller's tree is left
    as it was."""
    jp, npp = weights["tiny"]
    tokens, _ = _batch(3, B=4)
    want_p, want_loss = j_train(j_get_config("tiny"), j_make_mesh(devices=jax.devices()[:1]),
                                jp, jnp.asarray(tokens), 3)
    cfg = get_config("tiny")
    tp = _torch(npp, "tiny")
    before = {k: v.clone() for k, v in _flat(tp).items()}
    init_fn, step = make_train_step(cfg, None, remat=remat, device="cpu")
    params, opt = init_fn(tp)
    losses = []
    for _ in range(3):
        params, opt, loss = step(params, opt, torch.from_numpy(tokens))
        losses.append(float(loss))
    assert losses[2] < losses[0]
    _close(losses[2], want_loss)
    got = _flat(stack_params(params))
    for name, w in _flat(jax.tree.map(np.asarray, want_p)).items():
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-5, atol=1e-5)
    for name, t in _flat(tp).items():
        assert torch.equal(t, before[name]), name
    g = opt.param_groups[0]
    assert (g["lr"], g["betas"], g["eps"], g["weight_decay"]) == (3e-4, (0.9, 0.999),
                                                                  1e-8, 1e-4)


def test_trainer_holds_per_layer_leaves(weights):
    """init_fn splits the stacked tree into one leaf per layer and weight;
    stack_params gives the reference's layout back; train_n_steps returns
    it."""
    _, npp = weights["tiny"]
    cfg = get_config("tiny")
    tp = _torch(npp, "tiny")
    params, opt = make_train_step(cfg, device="cpu")[0](tp)
    assert isinstance(params["blocks"], list) and len(params["blocks"]) == cfg.num_layers
    leaves = param_leaves(params)
    assert all(t.is_leaf and t.requires_grad for t in leaves)
    assert len(leaves) == len(opt.param_groups[0]["params"])
    back = _flat(stack_params(params))
    for name, t in _flat(tp).items():
        assert torch.equal(back[name], t), name
    tokens, _ = _batch(4)
    out, loss = train_n_steps(cfg, None, tp, torch.from_numpy(tokens), 1, device="cpu")
    assert sorted(_flat(out)) == sorted(_flat(tp)) and np.isfinite(float(loss))


# ---- the Qwen2 attention biases through every forward ----

@pytest.fixture(scope="module")
def biased():
    """tiny with random bq/bk/bv (scale 0.5) beside its weights."""
    jcfg = j_get_config("tiny")
    tree = jax.tree.map(np.asarray, j_init(jcfg, jax.random.key(5)))
    rng = np.random.RandomState(5)
    L, h, kv, hd = jcfg.num_layers, jcfg.num_heads, jcfg.num_kv_heads, jcfg.head_dim_
    for name, width in (("bq", h * hd), ("bk", kv * hd), ("bv", kv * hd)):
        tree["blocks"][name] = (0.5 * rng.randn(L, width)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    return jp, params_from_numpy(tree, get_config("tiny"), "cpu")


def test_biases_reach_forward_and_encode_hidden(biased):
    jp, tp = biased
    cfg, jcfg = get_config("tiny"), j_get_config("tiny")
    tokens, mask = _batch(6, B=2, T=12)
    want, _ = j_forward(jp, jcfg, jnp.asarray(tokens), JKVCache.create(jcfg, 2, 16))
    got, _ = forward(tp, cfg, torch.from_numpy(tokens), KVCache.create(cfg, 2, 16))
    _close(got.numpy(), want)
    want = j_encode_hidden(jp, jcfg, jnp.asarray(tokens), jnp.asarray(mask))
    got = encode_hidden(tp, cfg, torch.from_numpy(tokens), torch.from_numpy(mask))
    _close(got.numpy()[mask], np.asarray(want)[mask])
    want = j_forward_train(jp, jcfg, jnp.asarray(tokens), jnp.asarray(mask))
    _close(forward_train(tp, cfg, torch.from_numpy(tokens),
                         torch.from_numpy(mask)).detach().numpy(), want)


def test_biases_reach_the_paged_forwards(biased):
    """forward_paged (a decode step and a block with a pad) and
    forward_ragged (a pack of prefill chunks and a decode token) over a
    pool holding earlier context: logits and pools equal the reference's."""
    jp, tp = biased
    cfg, jcfg = get_config("tiny"), j_get_config("tiny")
    rng = np.random.RandomState(7)
    page, P = 8, 4
    shape = (cfg.num_layers, 3 * P + 1, page, cfg.num_kv_heads, cfg.head_dim_)
    kp, vp = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
    table = (np.arange(2 * P) + 1).reshape(2, P).astype(np.int32)
    for T in (1, 4):
        tok = rng.randint(0, cfg.vocab_size, (2, T)).astype(np.int32)
        pos = (np.asarray([[9], [20]], np.int32) + np.arange(T)[None]).astype(np.int32)
        mask = np.ones((2, T), bool)
        mask[1, -1] = False
        kvl = (pos[:, 0] + mask.sum(1)).astype(np.int32)
        jl, jk, jv, _, _ = j_forward_paged(
            jp, jcfg, *map(jnp.asarray, (tok, pos, mask, kvl, table, kp, vp)),
            use_pallas="never")
        tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
        tl = forward_paged(tp, cfg, *map(torch.from_numpy, (tok, pos, mask, kvl, table)),
                           tk, tv)
        _close(tl.numpy()[mask], np.asarray(jl)[mask])
        _close(tk.numpy(), jk)
        _close(tv.numpy(), jv)
    table = (np.arange(3 * P) + 1).reshape(3, P).astype(np.int32)
    rows = np.asarray([0] * 5 + [1] + [2] * 6 + [0] * 4, np.int32)
    pos = np.asarray([list(range(5)) + [17] + list(range(8, 14)) + [-1] * 4], np.int32)
    mask = pos >= 0
    kvl = np.asarray([5, 18, 14], np.int32)
    tok = rng.randint(0, cfg.vocab_size, (1, rows.shape[0])).astype(np.int32)
    jl, jk, jv, _, _ = j_forward_ragged(
        jp, jcfg, *map(jnp.asarray, (tok, pos, mask, rows, kvl, table, kp, vp)),
        use_pallas="never", max_q_len=8)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tl = forward_ragged(tp, cfg, *map(torch.from_numpy, (tok, pos, mask, rows, kvl, table)),
                        tk, tv, max_q_len=8)
    _close(tl.numpy()[mask], np.asarray(jl)[mask])
    _close(tk.numpy(), jk)
    _close(tv.numpy(), jv)
