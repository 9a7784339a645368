"""The port's training path (ray_tpu_torch.models.transformer losses,
ray_tpu_torch.train.step) against the JAX package's (ray_tpu.models.
transformer, ray_tpu.train.step) on the CPU, at f32 on `tiny_test`, with
one set of weights for both sides (tests/torch_port_util.py).

On the CPU the JAX model runs its reference attention and the port its
plain attention through the same autograd.Function the card uses (plain
forward and backward)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import configs as jconfigs
from ray_tpu.models import transformer as jtr
from ray_tpu.parallel import ParallelPlan
from ray_tpu.parallel.mesh import make_mesh
from ray_tpu.train import step as jstep
from ray_tpu_torch.convert import params_from_numpy
from ray_tpu_torch.models import configs
from ray_tpu_torch.models import transformer as ttr
from ray_tpu_torch.train import step as tstep
from torch_port_util import numpy_params

# Loss values and grads: both sides compute the same f32 arithmetic in
# another order, so they agree to a few f32 ulps of the largest term;
# 5e-4 is the tests/test_ops.py grad bound the port's parity tests use.
GRAD_TOL = 5e-4
LOSS_TOL = 1e-5

B, S = 2, 32
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=6)


def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    mask = (rng.rand(B, S) > 0.25).astype(np.float32)
    return tokens, targets, mask


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_flat(params):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update({f"['{k}']['{n}']": w.detach().numpy()
                        for n, w in v.items()})
        else:
            out[f"['{k}']"] = v.detach().numpy()
    return out


def _assert_tree_close(got, want, atol, rtol):
    g, w = _port_flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=rtol,
                                   err_msg=k)


@pytest.fixture(scope="module")
def tiny():
    """(JAX cfg, port cfg, numpy weights, batch) shared by the module."""
    cfg_j, cfg_t = jconfigs.tiny_test(), configs.tiny_test()
    return cfg_j, cfg_t, numpy_params(cfg_j, seed=3, gain=1.0), _batch(cfg_j)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_token_cross_entropy_matches_jax(masked):
    rng = np.random.RandomState(1)
    logits = (3 * rng.standard_normal((B, S, 64))).astype(np.float32)
    targets = rng.randint(0, 64, size=(B, S)).astype(np.int32)
    mask = (rng.rand(B, S) > 0.3).astype(np.float32) if masked else None
    aux = np.float32(0.25)
    _, want = jtr.token_cross_entropy(
        jnp.asarray(logits), jnp.asarray(targets),
        None if mask is None else jnp.asarray(mask), jnp.asarray(aux))
    _, got = ttr.token_cross_entropy(
        _t(logits), _t(targets), None if mask is None else _t(mask),
        torch.tensor(aux))
    assert sorted(got) == sorted(want) == ["aux", "ce", "loss", "tokens"]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=k)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_chunked_cross_entropy_matches_jax(tiny, masked):
    """Values and the grad through the hidden states (each chunk's
    logits recomputed in the backward)."""
    cfg_j, cfg_t, tree, (_, targets, mask) = tiny
    rng = np.random.RandomState(2)
    x = rng.standard_normal((B, S, cfg_j.d_model)).astype(np.float32)
    mask = mask if masked else None
    aux = jnp.zeros((), jnp.float32)

    def jloss(x):
        return jtr.chunked_cross_entropy(
            cfg_j, jax.tree_util.tree_map(jnp.asarray, tree), x,
            jnp.asarray(targets), None if mask is None else
            jnp.asarray(mask), aux, 8)

    (_, want), want_dx = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(x))
    params = params_from_numpy(cfg_t, tree, device="cpu",
                               master_weights=True)
    xt = _t(x).requires_grad_()
    total, got = ttr.chunked_cross_entropy(
        cfg_t, params, xt, _t(targets), None if mask is None else _t(mask),
        torch.zeros(()), 8)
    total.backward()
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=LOSS_TOL,
                                   atol=LOSS_TOL, err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               atol=GRAD_TOL, rtol=GRAD_TOL)


def test_chunked_loss_refuses_a_chunk_that_does_not_divide_s(tiny):
    _, cfg_t, tree, (tokens, targets, _) = tiny
    cfg = dataclasses.replace(cfg_t, ce_chunk=12)
    params = params_from_numpy(cfg, tree, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        ttr.loss_fn(cfg, params, _t(tokens), _t(targets))


@pytest.fixture(scope="module")
def jax_loss_grads(tiny):
    cfg_j, _, tree, (tokens, targets, mask) = tiny
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    (_, metrics), grads = jax.value_and_grad(
        lambda p: jtr.loss_fn(cfg_j, p, jnp.asarray(tokens),
                              jnp.asarray(targets), jnp.asarray(mask)),
        has_aux=True)(params)
    return metrics, grads


def _port_loss_grads(cfg, tree, batch):
    tokens, targets, mask = batch
    params = params_from_numpy(cfg, tree, device="cpu", master_weights=True)
    leaves = tstep._leaves(params)
    for p in leaves:
        p.requires_grad_()
    total, metrics = ttr.loss_fn(cfg, params, _t(tokens), _t(targets),
                                 _t(mask))
    total.backward()
    grads = tstep._rebuild(params, [p.grad for p in leaves])
    return metrics, grads


@pytest.mark.parametrize("remat", [False, True], ids=["noremat", "remat"])
def test_loss_fn_grads_match_jax(tiny, jax_loss_grads, remat):
    _, cfg_t, tree, batch = tiny
    want_m, want_g = jax_loss_grads
    got_m, got_g = _port_loss_grads(
        dataclasses.replace(cfg_t, remat=remat), tree, batch)
    for k in want_m:
        np.testing.assert_allclose(got_m[k].detach().numpy(),
                                   np.asarray(want_m[k]), rtol=LOSS_TOL,
                                   atol=LOSS_TOL, err_msg=k)
    _assert_tree_close(got_g, want_g, GRAD_TOL, GRAD_TOL)


def test_remat_gives_the_same_grads_and_recomputes_attention(tiny,
                                                            monkeypatch):
    """Checkpointing recomputes each layer (the attention forward runs
    twice per layer: forward and recompute) and changes no grad: the
    recompute does the same CPU arithmetic, so the grads are equal."""
    _, cfg_t, tree, batch = tiny
    calls = []
    fwd = ttr.flash_attention

    def counted(*a, **kw):
        calls.append(1)
        return fwd(*a, **kw)

    monkeypatch.setattr(ttr, "flash_attention", counted)
    _, plain = _port_loss_grads(cfg_t, tree, batch)
    n_plain = len(calls)
    _, remat = _port_loss_grads(dataclasses.replace(cfg_t, remat=True),
                                tree, batch)
    assert n_plain == cfg_t.n_layers
    assert len(calls) - n_plain == 2 * cfg_t.n_layers
    for a, b in zip(tstep._leaves(plain), tstep._leaves(remat)):
        assert torch.equal(a, b)


def test_remat_dots_policy_is_refused_when_training(tiny):
    _, cfg_t, tree, (tokens, targets, _) = tiny
    cfg = dataclasses.replace(cfg_t, remat=True, remat_policy="dots")
    params = params_from_numpy(cfg, tree, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttr.loss_fn(cfg, params, _t(tokens), _t(targets))
    with torch.no_grad():   # serving never checkpoints: nothing to refuse
        ttr.forward(cfg, params, _t(tokens))


def test_serving_forward_records_no_graph(tiny):
    _, cfg_t, tree, (tokens, _, _) = tiny
    params = params_from_numpy(cfg_t, tree, device="cpu")
    with torch.no_grad():
        logits, _ = ttr.forward(cfg_t, params, _t(tokens))
    assert logits.grad_fn is None


@pytest.mark.parametrize("master", [False, True], ids=["serve", "master"])
def test_master_weights_storage(master):
    cfg = dataclasses.replace(configs.tiny_test(), dtype=torch.bfloat16,
                              tie_embeddings=False)
    params = ttr.init_params(cfg, 0, device="cpu", master_weights=master)
    want = torch.float32 if master else torch.bfloat16
    assert params["embed"].dtype == params["lm_head"].dtype == want
    assert params["layers"]["wq"].dtype == want
    assert params["layers"]["attn_norm"].dtype == torch.float32


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad_scale", [0.01, 10.0],
                         ids=["unclipped", "clipped"])
def test_optimizer_matches_optax(grad_scale):
    """Five updates on seeded grads: params and moments against optax's
    chain from ray_tpu.train.step.make_optimizer. The first update uses
    lr 0 and moves nothing (weight decay included). f32 on both sides;
    the schedule's lr is a host double here and f32 in optax, so values
    agree to a few f32 ulps (1e-6 relative)."""
    rng = np.random.RandomState(4)
    tree = {"embed": rng.standard_normal((16, 8)).astype(np.float32),
            "layers": {"w": rng.standard_normal((2, 8, 8)).astype(
                np.float32),
                "attn_norm": (1 + 0.1 * rng.standard_normal((2, 8))).astype(
                    np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda a: (grad_scale * rng.standard_normal(a.shape)).astype(
            np.float32), tree) for _ in range(5)]
    jopt = jstep.make_optimizer(**OPT)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init(jp)
    topt = tstep.make_optimizer(**OPT)
    tp = {"embed": _t(tree["embed"]).clone(),
          "layers": {k: _t(v).clone() for k, v in tree["layers"].items()}}
    tstate = topt.init(tp)
    leaves = tstep._leaves(tp)
    for i, g in enumerate(grads):
        upd, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                  jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tg = [_t(a).clone() for a in tstep._leaves(g)]
        gnorm = topt.global_norm(tg)
        np.testing.assert_allclose(gnorm.item(), float(optax.global_norm(g)),
                                   rtol=1e-6)
        assert (gnorm.item() >= 1.0) == (grad_scale > 1)
        tstate = topt.update_(tg, tstate, leaves, gnorm)
        if i == 0:
            for a, b in zip(leaves, tstep._leaves(tree)):
                assert torch.equal(a, _t(b))
        _assert_tree_close(tp, jp, atol=1e-6, rtol=1e-6)
    jmu, jnu = jstate[1][0].mu, jstate[1][0].nu
    for got, want in ((tstate.mu, jmu), (tstate.nu, jnu)):
        _assert_tree_close(tstep._rebuild(tp, got), want, atol=1e-7,
                           rtol=1e-6)
    assert tstate.count == 5 == int(jstate[1][0].count)


def test_schedule_matches_optax():
    for warmup, total in ((2, 6), (3, 3), (0, 10)):
        kw = dict(lr=3e-4, warmup_steps=warmup, total_steps=total)
        want = optax.warmup_cosine_decay_schedule(
            0.0, 3e-4, warmup, max(total, warmup + 1), 3e-5)
        opt = tstep.make_optimizer(**kw)
        for c in range(total + 3):
            np.testing.assert_allclose(opt.schedule(c), float(want(c)),
                                       rtol=1e-6, atol=1e-12)
    assert tstep.make_optimizer(**OPT).schedule(0) == 0.0


# ---------------------------------------------------------------------------
# Train and eval steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_trajectory(tiny):
    """Five steps of the JAX package's make_train_step on a one-device
    mesh: per-step metrics and the final params."""
    cfg_j, _, tree, (tokens, targets, mask) = tiny
    opt = jstep.make_optimizer(**OPT)
    mesh = make_mesh(ParallelPlan(), devices=jax.devices()[:1])
    with jax.sharding.set_mesh(mesh):
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        state = jstep.TrainState(step=jnp.zeros((), jnp.int32),
                                 params=params, opt_state=opt.init(params))
        step = jstep.make_train_step(cfg_j, opt)
        history = []
        for _ in range(5):
            state, m = step(state, jnp.asarray(tokens), jnp.asarray(targets),
                            jnp.asarray(mask))
            history.append({k: float(v) for k, v in m.items()})
        return history, jax.tree_util.tree_map(np.asarray, state.params)


def test_train_step_matches_jax(tiny, jax_trajectory):
    """Per-step loss, ce, tokens and grad_norm (to 1e-5 relative: f32
    sums in another order), and the params after five steps (lr 1e-2,
    warmup 2, clip 1.0). The grads agree to ~2e-8 absolute, but Adam's
    mu / sqrt(nu) turns an absolute grad error d into a relative update
    error of about d / |g|, so a param whose grad is ~1e-4 of the largest
    moves by up to ~1e-3 of lr differently: 1e-5 here (5.2e-6 seen)."""
    _, cfg_t, tree, (tokens, targets, mask) = tiny
    want_hist, want_params = jax_trajectory
    opt = tstep.make_optimizer(**OPT)
    params = params_from_numpy(cfg_t, tree, device="cpu", master_weights=True)
    state = tstep.TrainState(0, params, opt.init(params))
    step = tstep.make_train_step(cfg_t, opt)
    for want in want_hist:
        state, got = step(state, _t(tokens), _t(targets), _t(mask))
        assert sorted(got) == sorted(want)
        for k in ("loss", "ce", "tokens", "grad_norm"):
            np.testing.assert_allclose(got[k].item(), want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    assert state.step == 5 and state.opt_state.count == 5
    assert want_hist[-1]["loss"] < want_hist[0]["loss"]
    _assert_tree_close(state.params, want_params, atol=1e-5, rtol=1e-5)


def test_init_state_is_master_weights_with_zero_moments():
    cfg = dataclasses.replace(configs.tiny_test(), dtype=torch.bfloat16)
    opt = tstep.make_optimizer()
    state = tstep.init_state(cfg, opt, seed=0, device="cpu")
    leaves = tstep._leaves(state.params)
    assert state.step == 0 and state.opt_state.count == 0
    assert all(p.dtype == torch.float32 and not p.requires_grad
               for p in leaves)
    assert all(not m.any() for m in state.opt_state.mu + state.opt_state.nu)


def test_init_state_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstep.init_state(configs.tiny_test(), tstep.make_optimizer())


def test_eval_step_matches_jax(tiny):
    cfg_j, cfg_t, tree, (tokens, targets, mask) = tiny
    want = jstep.make_eval_step(cfg_j)(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(tokens),
        jnp.asarray(targets), jnp.asarray(mask))
    params = params_from_numpy(cfg_t, tree, device="cpu", master_weights=True)
    got = tstep.make_eval_step(cfg_t)(params, _t(tokens), _t(targets),
                                      _t(mask))
    for k in want:
        assert got[k].grad_fn is None
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=k)
