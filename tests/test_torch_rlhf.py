"""The port's GRPO RLHF modules (ray_tpu_torch.rlhf) against the JAX
package's (ray_tpu.rlhf) on the CPU, at f32 on the tiny config of
tests/test_rlhf.py, with one set of weights for both sides: the GRPO
update over several steps, a learner state carried across, the weight
blocks, greedy rollouts and their captured log-probs, the engine's own
copy of a refreshed policy, and the in-process loop's reward gate.

The JAX learner runs on a one-device mesh (conftest.py forces 8 CPU
devices). Sampling draws different random numbers in the two frameworks,
so rollouts are compared token for token only at temperature 0."""

import os
import sys
import time

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models.transformer import TransformerConfig as JaxConfig
from ray_tpu.rlhf import GRPOLearner as JaxLearner
from ray_tpu.rlhf import GRPOLearnerConfig as JaxLearnerConfig
from ray_tpu.rlhf import RolloutWorker as JaxWorker
from ray_tpu_torch.convert import learner_state_from_numpy
from ray_tpu_torch.models.configs import TransformerConfig
from ray_tpu_torch.models.transformer import init_params
from ray_tpu_torch.rlhf import (
    GRPOLearner,
    GRPOLearnerConfig,
    RolloutWorker,
    learner_inputs,
)
from ray_tpu_torch.rlhf.learner import sequence_logp
from ray_tpu_torch.serve.llm import LLMEngine
from ray_tpu_torch.train.step import _leaves

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_util import numpy_params  # noqa: E402

# The train step's tolerances (PERF.md §3): both sides compute the same
# f32 arithmetic in another order.
METRIC_RTOL = 1e-5
PARAM_ATOL = 1e-5
# Captured log-probs against a full forward (tests/test_rlhf.py's 2e-4
# for JAX against itself; the port's engine tests hold 1e-4).
LOGP_ATOL = 1e-4

G = 4
TINY = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=4, n_kv_heads=4,
            d_ff=64, max_seq_len=64, remat=False)


def _cfgs():
    import jax.numpy as jnp

    return (JaxConfig(dtype=jnp.float32, param_dtype=jnp.float32, **TINY),
            TransformerConfig(dtype=torch.float32,
                              param_dtype=torch.float32, **TINY))


def _learners(**opt):
    """(JAX learner on one device, port learner on the CPU holding the
    JAX learner's initial state)."""
    cfg_j, cfg_t = _cfgs()
    kw = dict(group_size=G, lr=1e-3, warmup_steps=1, total_steps=20, **opt)
    jl = JaxLearner(JaxLearnerConfig(model=cfg_j, **kw),
                    devices=jax.devices()[:1])
    tl = GRPOLearner(GRPOLearnerConfig(model=cfg_t, seed=7, **kw),
                     device="cpu")
    tl.set_state(learner_state_from_numpy(cfg_t, jl.get_state()))
    return jl, tl


def _batch(seed, N=12, S=24, P=12):
    """The batch of tests/test_rlhf.py's learner test, with old log-probs
    spread across the clip range, ragged completions, one row with no
    completion token, one group whose rewards are all equal (advantage 0)
    and groups whose unbiased std differs from the population std."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, TINY["vocab_size"], (N, S)).astype(np.int32)
    comp_mask = np.zeros((N, S - 1), np.float32)
    lengths = rng.integers(1, S - P + 1, N)
    lengths[5] = 0
    for i, L in enumerate(lengths):
        comp_mask[i, P - 1:P - 1 + L] = 1.0
    old_logp = ((-4.2 + 0.3 * rng.standard_normal((N, S - 1)))
                * comp_mask).astype(np.float32)
    rewards = rng.normal(size=N).astype(np.float32)
    rewards[:G] = 0.5
    return tokens, old_logp, rewards, comp_mask


def _assert_params_close(tl, jl):
    got = [t.numpy() for t in _leaves(tl.state.params)]
    want = jax.tree.leaves(jl.params_host())
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                   atol=PARAM_ATOL, err_msg=f"leaf {i}")


def test_batch_has_the_cases_the_step_must_handle():
    tokens, old_logp, rewards, comp_mask = _batch(0)
    groups = rewards.reshape(-1, G)
    assert np.all(groups[0] == groups[0, 0])
    assert not comp_mask[5].any()
    assert np.all(groups[1:].std(1, ddof=1) > 1.1 * groups[1:].std(1))


def test_grpo_step_matches_jax_over_three_updates():
    jl, tl = _learners()
    for step in range(3):
        batch = _batch(step)
        mj, mt = jl.update(*batch), tl.update(*batch)
        assert sorted(mt) == sorted(mj) == [
            "grad_norm", "kl", "loss", "pg_loss", "reward_mean"]
        for k in mj:
            np.testing.assert_allclose(mt[k], mj[k], rtol=METRIC_RTOL,
                                       err_msg=f"update {step}: {k}")
        _assert_params_close(tl, jl)
    assert tl.step_count == jl.step_count == 3


def test_grpo_step_uses_population_std():
    """The loss equals a numpy recomputation whose advantages divide by
    the population std (np.std's default), and not the one with torch's
    default unbiased std, which shrinks them by sqrt((G-1)/G)."""
    _, tl = _learners()
    tokens, old_logp, rewards, comp_mask = _batch(0)
    groups = rewards.reshape(-1, G)
    mean = groups.mean(1, keepdims=True)
    lp = sequence_logp(tl.cfg.model, tl.state.params,
                       torch.from_numpy(tokens)).detach().numpy()
    ratio = np.exp(lp - old_logp)
    log_r = old_logp - lp
    kl = np.exp(log_r) - log_r - 1.0
    denom = max(comp_mask.sum(), 1.0)

    def loss(std):
        a = ((groups - mean) / (std + 1e-6)).reshape(-1)[:, None]
        pg = np.minimum(ratio * a, np.clip(ratio, 0.8, 1.2) * a)
        return (-(pg - 0.02 * kl) * comp_mask).sum() / denom

    want = loss(groups.std(1, keepdims=True))
    unbiased = loss(groups.std(1, ddof=1, keepdims=True))
    m = tl.update(tokens, old_logp, rewards, comp_mask)
    np.testing.assert_allclose(m["loss"], want, rtol=METRIC_RTOL)
    assert abs(m["loss"] - unbiased) > 1e3 * METRIC_RTOL * abs(want)
    np.testing.assert_allclose(m["kl"], (kl * comp_mask).sum() / denom,
                               rtol=METRIC_RTOL)


def test_update_refuses_a_batch_that_is_not_whole_groups():
    _, tl = _learners()
    tokens, old_logp, rewards, comp_mask = _batch(0, N=6)
    with pytest.raises(ValueError, match="multiple of group_size"):
        tl.update(tokens, old_logp, rewards, comp_mask)


def test_learner_state_carried_from_jax_continues_identically():
    """The JAX learner's state after one update, carried into a fresh
    port learner, gives the same next update. The moments are mapped by
    the leaf order of jax.tree.leaves."""
    jl, _ = _learners()
    jl.update(*_batch(0))
    state = jl.get_state()
    cfg_t = _cfgs()[1]
    got = learner_state_from_numpy(cfg_t, state)
    leaves = jax.tree.leaves(state["opt_state"])
    n = len(jax.tree.leaves(state["params"]))
    assert got["step"] == 1 and got["opt_state"].count == int(leaves[0]) == 1
    for mine, theirs in ((got["opt_state"].mu, leaves[1:n + 1]),
                         (got["opt_state"].nu, leaves[n + 1:2 * n + 1])):
        assert len(mine) == n
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a, np.asarray(b))

    tl = GRPOLearner(GRPOLearnerConfig(model=cfg_t, group_size=G, lr=1e-3,
                                       warmup_steps=1, total_steps=20),
                     device="cpu")
    tl.set_state(got)
    assert tl.step_count == 1
    batch = _batch(1)
    mj, mt = jl.update(*batch), tl.update(*batch)
    for k in mj:
        np.testing.assert_allclose(mt[k], mj[k], rtol=METRIC_RTOL, err_msg=k)
    _assert_params_close(tl, jl)


def test_learner_state_from_numpy_refuses_a_foreign_state():
    jl, _ = _learners()
    state = jl.get_state()
    leaves = jax.tree.leaves(state["opt_state"])
    with pytest.raises(ValueError, match="leaves"):
        learner_state_from_numpy(_cfgs()[1], dict(state,
                                                  opt_state=leaves[:-2]))


def test_port_get_state_set_state_round_trip():
    _, a = _learners()
    a.update(*_batch(0))
    b = GRPOLearner(GRPOLearnerConfig(model=_cfgs()[1], group_size=G,
                                      lr=1e-3, warmup_steps=1,
                                      total_steps=20, seed=3), device="cpu")
    b.set_state(a.get_state())
    assert b.step_count == a.step_count == 1
    batch = _batch(1)
    assert a.update(*batch) == b.update(*batch)
    for x, y in zip(_leaves(a.state.params), _leaves(b.state.params)):
        assert torch.equal(x, y)
    for x, y in zip(a.state.opt_state.nu, b.state.opt_state.nu):
        assert torch.equal(x, y)


def test_param_blocks_cover_balance_and_follow_jax_leaf_order():
    jl, tl = _learners()
    blocks = tl.param_blocks(4)
    want = jax.tree.leaves(jl.params_host())
    idxs = sorted(i for b in blocks for i, _ in b)
    assert idxs == list(range(len(want)))
    assert 1 <= len(blocks) <= 4
    assert [[i for i, _ in b] for b in blocks] == \
        [[i for i, _ in b] for b in jl.param_blocks(4)]
    for b in blocks:
        for i, arr in b:
            np.testing.assert_array_equal(arr, np.asarray(want[i]))


# -- rollout ------------------------------------------------------------


def _blocks_of(tree, parts=2):
    """A numpy parameter tree as (leaf index, array) blocks in
    jax.tree.leaves' order."""
    pairs = list(enumerate(jax.tree.leaves(tree)))
    step = -(-len(pairs) // parts)
    return [pairs[i:i + step] for i in range(0, len(pairs), step)]


def test_rollout_buffers_and_alignment():
    """tests/test_rlhf.py's buffer checks: fixed shapes, group-major rows,
    log-probs zero past each completion and at most 0 within it."""
    w = RolloutWorker(_cfgs()[1], num_slots=4, seed=1, device="cpu")
    prompts = np.arange(8, dtype=np.int32).reshape(2, 4) % TINY["vocab_size"]
    out = w.rollout(prompts, group_size=3, max_new_tokens=6,
                    temperature=1.0)
    N = 2 * 3
    assert out["seqs"].shape == (N, 4 + 6)
    assert out["logprobs"].shape == (N, 6)
    assert out["prompt_len"] == 4 and out["version"] == -1
    assert out["gen_s"] > 0 and out["tokens"] == int(out["lengths"].sum())
    assert (out["lengths"] >= 1).all() and (out["lengths"] <= 6).all()
    for i in range(N):
        L = int(out["lengths"][i])
        assert np.all(out["logprobs"][i, L:] == 0.0)
        assert np.all(out["logprobs"][i, :L] <= 1e-6)
    assert np.array_equal(out["seqs"][:3, :4], np.tile(prompts[0], (3, 1)))
    assert w.stats()["tokens_out"] == out["tokens"]


def test_greedy_rollout_matches_jax_worker():
    """The same weights refreshed into both workers: at temperature 0 the
    tokens are equal and the captured log-probs agree."""
    cfg_j, cfg_t = _cfgs()
    blocks = _blocks_of(numpy_params(cfg_j, seed=5, gain=8.0))
    jw = JaxWorker(cfg_j, num_slots=4, seed=1)
    tw = RolloutWorker(cfg_t, num_slots=4, seed=2, device="cpu")
    rj, rt = jw.refresh_weights(0, *blocks), tw.refresh_weights(0, *blocks)
    assert rt["version"] == rj["version"] == 0
    assert rt["bytes"] == rj["bytes"] > 0
    prompts = np.random.default_rng(3).integers(
        0, cfg_t.vocab_size, (3, 5)).astype(np.int32)
    kw = dict(group_size=2, max_new_tokens=8, temperature=0.0)
    oj, ot = jw.rollout(prompts, **kw), tw.rollout(prompts, **kw)
    np.testing.assert_array_equal(ot["seqs"], oj["seqs"])
    np.testing.assert_array_equal(ot["lengths"], oj["lengths"])
    np.testing.assert_allclose(ot["logprobs"], oj["logprobs"], rtol=0,
                               atol=LOGP_ATOL)
    assert tw.weight_version() == jw.weight_version() == 0


def test_captured_logprobs_equal_the_learners_recomputed_logp():
    """Sampled rollouts from the learner's refreshed policy: the engine's
    sampling-time log-probs equal the learner's full-forward log-probs at
    the shifted positions (the GRPO ratio is 1 before the update)."""
    cfg_t = _cfgs()[1]
    learner = GRPOLearner(GRPOLearnerConfig(model=cfg_t, group_size=G),
                          device="cpu")
    w = RolloutWorker(cfg_t, num_slots=4, seed=4, device="cpu")
    w.refresh_weights(0, *learner.param_blocks(3))
    prompts = np.random.default_rng(4).integers(
        0, cfg_t.vocab_size, (2, 6)).astype(np.int32)
    out = w.rollout(prompts, group_size=G, max_new_tokens=8,
                    temperature=1.0)
    old_logp, comp_mask = learner_inputs(out)
    with torch.no_grad():
        lp = sequence_logp(cfg_t, learner.state.params,
                           torch.from_numpy(out["seqs"])).numpy()
    on = comp_mask > 0
    assert on.sum() == out["tokens"]
    np.testing.assert_allclose(lp[on], old_logp[on], rtol=0, atol=LOGP_ATOL)


def test_learner_inputs_put_token_t_at_p_plus_t_minus_1():
    """The learner scores position s + 1 from position s: generated token
    t (at P + t) has its log-prob and mask at index P + t - 1, and only
    the tokens within each completion's length are masked in."""
    P, T = 3, 4
    out = {"seqs": np.arange(2 * (P + T), dtype=np.int32).reshape(2, P + T),
           "logprobs": -np.arange(1, 2 * T + 1, dtype=np.float32
                                  ).reshape(2, T),
           "lengths": np.array([4, 2], np.int32), "prompt_len": P}
    out["logprobs"][1, 2:] = 0.0          # zero past the completion
    old_logp, comp_mask = learner_inputs(out)
    want_lp = np.zeros((2, P + T - 1), np.float32)
    want_mask = np.zeros((2, P + T - 1), np.float32)
    for i, L in enumerate(out["lengths"]):
        for t in range(L):
            want_lp[i, P + t - 1] = out["logprobs"][i, t]
            want_mask[i, P + t - 1] = 1.0
    np.testing.assert_array_equal(old_logp, want_lp)
    np.testing.assert_array_equal(comp_mask, want_mask)
    assert old_logp.dtype == comp_mask.dtype == np.float32


def test_system_prompt_is_served_from_its_prefix_after_a_refresh():
    """A worker with a registered system prompt recomputes its KV at each
    refresh: greedy rollouts equal those of a worker without it."""
    cfg_j, cfg_t = _cfgs()
    blocks = _blocks_of(numpy_params(cfg_j, seed=6, gain=8.0), 3)
    system = [3, 1, 4, 1, 5, 9, 2, 6]
    with_sys = RolloutWorker(cfg_t, seed=1, system_prompt=system,
                             device="cpu")
    plain = RolloutWorker(cfg_t, seed=1, device="cpu")
    for w in (with_sys, plain):
        w.refresh_weights(0, *blocks)
    body = np.random.default_rng(6).integers(0, cfg_t.vocab_size, (2, 4))
    prompts = np.concatenate([np.tile(system, (2, 1)), body], 1)
    kw = dict(group_size=2, max_new_tokens=6, temperature=0.0)
    a, b = with_sys.rollout(prompts, **kw), plain.rollout(prompts, **kw)
    np.testing.assert_array_equal(a["seqs"], b["seqs"])
    np.testing.assert_allclose(a["logprobs"], b["logprobs"], rtol=0,
                               atol=LOGP_ATOL)
    assert with_sys.stats()["prefix_hits"] > 0
    assert plain.stats()["prefix_hits"] == 0


def test_refresh_refuses_a_policy_with_other_leaves():
    w = RolloutWorker(_cfgs()[1], device="cpu")
    blocks = _blocks_of(numpy_params(_cfgs()[0], seed=0))
    with pytest.raises(ValueError, match="leaves"):
        w.refresh_weights(1, blocks[0])
    assert w.weight_version() == -1


def test_inject_fault_delays_rollouts():
    w = RolloutWorker(_cfgs()[1], device="cpu")
    w.inject_fault("rollout_delay_s", 0.2)
    prompts = np.zeros((1, 3), np.int32)
    t0 = time.perf_counter()
    w.rollout(prompts, max_new_tokens=1)
    assert time.perf_counter() - t0 >= 0.2
    with pytest.raises(ValueError, match="unknown fault"):
        w.inject_fault("drop_weights", 1)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    cfg_t = _cfgs()[1]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GRPOLearner(GRPOLearnerConfig(model=cfg_t))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RolloutWorker(cfg_t)


# -- the refresh installs the engine's own copy ------------------------


def test_learner_update_after_a_refresh_leaves_the_engine_unchanged():
    """The learner updates its masters in place; an engine refreshed from
    them holds tensors of its own, bit-equal across later updates until
    the next refresh installs the new policy."""
    cfg_t = _cfgs()[1]
    learner = GRPOLearner(GRPOLearnerConfig(model=cfg_t, group_size=G,
                                            lr=1e-2, warmup_steps=1),
                          device="cpu")
    w = RolloutWorker(cfg_t, seed=1, device="cpu")
    w.refresh_weights(0, *learner.param_blocks())
    installed = [t.clone() for t in _leaves(w.engine.params)]
    masters = [t.clone() for t in _leaves(learner.state.params)]
    for step in range(2):      # the first update's lr is 0
        learner.update(*_batch(step))
    assert any(not torch.equal(a, b)
               for a, b in zip(masters, _leaves(learner.state.params)))
    for a, b in zip(installed, _leaves(w.engine.params)):
        assert torch.equal(a, b)
    ptrs = {t.data_ptr() for t in _leaves(learner.state.params)}
    assert not ptrs & {t.data_ptr() for t in _leaves(w.engine.params)}
    w.refresh_weights(1, *learner.param_blocks())
    for a, b in zip(_leaves(learner.state.params), _leaves(w.engine.params)):
        assert torch.equal(a, b)


def test_installed_f32_masters_serve_as_cast_at_each_use():
    """bf16 compute over f32 masters: the constructor and set_params
    install the same copy (matmul weights and the embedding in bf16, norm
    scales in f32, no tensor shared with the caller), and it serves
    exactly what an engine that holds the f32 masters themselves and
    casts them at each use (the JAX engine's way) serves."""
    cfg = TransformerConfig(dtype=torch.bfloat16, param_dtype=torch.float32,
                            **TINY)
    masters = init_params(cfg, 3, device="cpu", master_weights=True)
    built = LLMEngine(cfg, masters, device="cpu", capture_logprobs=True)
    installs = LLMEngine(cfg, init_params(cfg, 9, device="cpu"),
                         device="cpu", capture_logprobs=True)
    installs.set_params(masters)
    keeps = LLMEngine(cfg, masters, device="cpu", capture_logprobs=True)
    keeps.params = masters
    ptrs = {t.data_ptr() for t in _leaves(masters)}
    for eng in (built, installs):
        assert eng.params["layers"]["wq"].dtype == torch.bfloat16
        assert eng.params["embed"].dtype == torch.bfloat16
        assert eng.params["final_norm"].dtype == torch.float32
        assert not ptrs & {t.data_ptr() for t in _leaves(eng.params)}
    for a, b in zip(_leaves(built.params), _leaves(installs.params)):
        assert torch.equal(a, b)
    prompts = np.random.default_rng(8).integers(0, cfg.vocab_size, (3, 7))
    outs = []
    for eng in (keeps, built, installs):
        reqs = [eng.submit(p.tolist(), max_new_tokens=6) for p in prompts]
        while eng.step():
            pass
        outs.append(([r.tokens for r in reqs], [r.logprobs for r in reqs]))
    for toks, lps in outs[1:]:
        assert toks == outs[0][0]
        np.testing.assert_array_equal(np.asarray(lps),
                                      np.asarray(outs[0][1]))


# -- the in-process loop ------------------------------------------------


def _iteration(learner, workers, rng, *, num_prompts, prompt_len,
               group_size, max_new, version):
    """One rollout -> reward -> update -> refresh iteration, the JAX
    pipeline's train_iteration without actors."""
    prompts = rng.integers(0, learner.cfg.model.vocab_size,
                           size=(num_prompts, prompt_len), dtype=np.int64)
    per = num_prompts // len(workers)
    outs = [w.rollout(prompts[i * per:(i + 1) * per].astype(np.int32),
                      group_size=group_size, max_new_tokens=max_new,
                      temperature=1.0) for i, w in enumerate(workers)]
    out = {k: np.concatenate([o[k] for o in outs])
           for k in ("seqs", "logprobs", "lengths")}
    out["prompt_len"] = prompt_len
    rewards = (out["seqs"][:, prompt_len:] == 7).mean(axis=1)
    old_logp, comp_mask = learner_inputs(out)
    metrics = learner.update(out["seqs"], old_logp, rewards, comp_mask)
    blocks = learner.param_blocks(4)
    for w in workers:
        w.refresh_weights(version, *blocks)
    return metrics


def test_loop_reward_improves():
    """tests/test_rlhf.py's 30-iteration gate, in process: GRPO on 'emit
    token 7' lifts the mean reward, and every iteration refreshes the
    workers to the next version."""
    cfg_t = _cfgs()[1]
    learner = GRPOLearner(GRPOLearnerConfig(
        model=cfg_t, group_size=4, lr=5e-3, warmup_steps=2,
        total_steps=60, seed=0), device="cpu")
    workers = [RolloutWorker(cfg_t, num_slots=4, seed=1000 + i,
                             decode_block=16, device="cpu")
               for i in range(2)]
    blocks = learner.param_blocks(4)
    for w in workers:
        w.refresh_weights(0, *blocks)
    rng = np.random.default_rng(0)
    hist = [_iteration(learner, workers, rng, num_prompts=4, prompt_len=4,
                       group_size=4, max_new=8, version=v + 1)
            for v in range(30)]
    rewards = [h["reward_mean"] for h in hist]
    first, last = np.mean(rewards[:5]), np.mean(rewards[-5:])
    assert last > first + 0.02, (
        f"no reward improvement: first5={first:.4f} last5={last:.4f}")
    assert all(np.isfinite(list(h.values())).all() for h in hist)
    assert [w.weight_version() for w in workers] == [30, 30]
    assert learner.step_count == 30
