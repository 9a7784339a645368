"""The port's serving engine (ray_tpu_torch.serve.llm) on the CPU: ports
of the tests/test_llm.py engine tests, and the port's LLMEngine against
the JAX package's LLMEngine on the same prompts and weights (greedy
tokens exactly, with and without a registered prefix)."""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from ray_tpu.models import configs as jax_configs
from ray_tpu.serve.llm import LLMEngine as JaxEngine
from ray_tpu_torch.models import configs
from ray_tpu_torch.models.generate import greedy_generate
from ray_tpu_torch.serve.llm import LLMEngine, LLMServer, default_buckets

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_util import both_params  # noqa: E402


@pytest.fixture(scope="module")
def shared():
    cfg_j, cfg = jax_configs.tiny_test(), configs.tiny_test()
    pj, pt = both_params(cfg_j, cfg, seed=1)
    return cfg_j, cfg, pj, pt


@pytest.fixture(scope="module")
def tiny_model(shared):
    return shared[1], shared[3]


def engine(cfg, params, **kw):
    return LLMEngine(cfg, params, device="cpu", **kw)


def greedy(cfg, params, prompt, n):
    return greedy_generate(cfg, params, prompt, n, device="cpu").tolist()


def drain(eng):
    while eng.step():
        pass


def test_continuous_batching_matches_single_seq(tiny_model):
    """More requests than slots, mixed prompt lengths: every request's
    output equals its standalone greedy generation."""
    cfg, params = tiny_model
    eng = engine(cfg, params, num_slots=3, max_seq_len=64)
    rng = np.random.RandomState(0)
    prompts = [list(rng.randint(0, cfg.vocab_size, size=n))
               for n in (5, 11, 7, 20, 3)]
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    drain(eng)
    for p, r in zip(prompts, reqs):
        assert r.result(timeout=1) == greedy(cfg, params, p, 6)
    st = eng.stats()
    assert st["finished"] == 5 and st["tokens_out"] == 30


@pytest.mark.parametrize("with_prefix", [False, True],
                         ids=["full_prefill", "registered_prefix"])
def test_engine_matches_jax_engine(shared, with_prefix):
    """The port's engine and the JAX engine, same weights and prompts,
    give the same greedy tokens and (captured) log-probabilities."""
    cfg_j, cfg, pj, pt = shared
    rng = np.random.RandomState(11)
    prefix = [int(t) for t in rng.randint(0, cfg.vocab_size, 13)]
    prompts = [prefix + [int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in (4, 9, 1)]
    prompts += [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
                for n in (8, 17)]
    outs = []
    for make in (lambda: JaxEngine(cfg_j, pj, num_slots=3, max_seq_len=64,
                                   capture_logprobs=True),
                 lambda: engine(cfg, pt, num_slots=3, max_seq_len=64,
                                capture_logprobs=True)):
        eng = make()
        if with_prefix:
            eng.register_prefix(prefix)
        reqs = [eng.submit(p, max_new_tokens=4) for p in prompts]
        drain(eng)
        outs.append(([r.result(timeout=5) for r in reqs],
                     [r.logprobs for r in reqs], eng.stats()))
    (jt, jl, js), (tt, tl, ts) = outs
    assert tt == jt
    np.testing.assert_allclose(np.asarray(tl), np.asarray(jl), atol=1e-4)
    assert ts["prefix_hits"] == js["prefix_hits"]
    assert (ts["prefix_hits"] > 0) == with_prefix


def test_engine_slot_reuse_after_finish(tiny_model):
    """A slot freed by one request serves a later request correctly
    (decode overwrites stale KV, never accumulates)."""
    cfg, params = tiny_model
    eng = engine(cfg, params, num_slots=1, max_seq_len=64)
    p1, p2 = [1, 2, 3, 4, 5, 6, 7, 8], [9, 8, 7]
    r1 = eng.submit(p1, max_new_tokens=4)
    r2 = eng.submit(p2, max_new_tokens=4)
    drain(eng)
    assert r1.result(timeout=1) == greedy(cfg, params, p1, 4)
    assert r2.result(timeout=1) == greedy(cfg, params, p2, 4)


def test_engine_eos_and_streaming(tiny_model):
    cfg, params = tiny_model
    eng = engine(cfg, params, num_slots=2, max_seq_len=64)
    eng.start()
    try:
        eos = greedy(cfg, params, [1, 2, 3], 3)[2]
        r = eng.submit([1, 2, 3], max_new_tokens=50, eos_token=eos)
        toks = list(iter(r))
        assert toks[-1] == eos and len(toks) < 50
        r2 = eng.submit([4, 5], max_new_tokens=5, temperature=0.7)
        assert len(r2.result(timeout=30)) == 5
    finally:
        eng.stop()


def test_engine_failure_unblocks_clients(tiny_model, monkeypatch):
    """If a device step raises, waiting clients get the error instead of
    hanging."""
    cfg, params = tiny_model
    eng = engine(cfg, params, num_slots=1, max_seq_len=64)

    def boom(*a, **k):
        raise RuntimeError("synthetic device OOM")

    monkeypatch.setattr("ray_tpu_torch.serve.llm.prefill_sample_batch", boom)
    r = eng.submit([1, 2, 3], max_new_tokens=4)
    t = eng.start()
    t.join(timeout=10)
    assert not t.is_alive()
    with pytest.raises(RuntimeError, match="synthetic device OOM"):
        r.result(timeout=5)
    with pytest.raises(RuntimeError, match="stopped"):
        eng.submit([4, 5])


def test_prompt_too_long_rejected(tiny_model):
    cfg, params = tiny_model
    eng = engine(cfg, params, num_slots=1, max_seq_len=32)
    with pytest.raises(ValueError):
        eng.submit(list(range(32)))
    with pytest.raises(ValueError, match="empty"):
        eng.submit([])


def test_default_buckets():
    assert default_buckets(100) == [16, 32, 64, 100]
    assert default_buckets(16) == [16]


@pytest.mark.parametrize("mode", ["result_twice", "stream_then_result",
                                  "result_then_iterate"])
def test_result_and_iteration_are_replayable(tiny_model, mode):
    """result() and iteration after the stream was drained return the
    cached tokens instead of blocking."""
    cfg, params = tiny_model
    eng = engine(cfg, params, num_slots=2, max_seq_len=64)
    eng.start()
    try:
        req = eng.submit(list(range(1, 9)), max_new_tokens=5)
        if mode == "result_twice":
            first = req.result(timeout=60)
            assert req.result(timeout=1) == first and len(first) == 5
        elif mode == "stream_then_result":
            streamed = list(req)
            assert len(streamed) == 5
            assert req.result(timeout=1) == streamed
        else:
            toks = req.result(timeout=60)
            assert list(req) == toks
    finally:
        eng.stop()


def test_oversubscribed_burst_first_tokens_before_slots_free(tiny_model):
    """Queued requests get a first token while every slot is busy, and
    full results still equal their standalone generations."""
    cfg, params = tiny_model
    eng = engine(cfg, params, num_slots=2, max_seq_len=64)
    prompts = [[1 + i, 2, 3] for i in range(6)]
    reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
    for _ in range(200):
        if all(r.finish_ts for r in reqs):
            break
        eng.step()
    for p, r in zip(prompts, reqs):
        assert r.result(timeout=10) == greedy(cfg, params, p, 8)
        assert r.first_token_ts > 0 and r.queue_s >= 0 and r.decode_s > 0


def test_generate_synchronous_and_logprobs_guard(tiny_model):
    cfg, params = tiny_model
    eng = engine(cfg, params, num_slots=2, max_seq_len=64)
    out = eng.generate([3, 1, 4], max_new_tokens=4)
    assert out["tokens"] == greedy(cfg, params, [3, 1, 4], 4)
    assert out["ttft_s"] >= 0 and out["latency_s"] >= out["ttft_s"]
    with pytest.raises(ValueError, match="capture_logprobs"):
        eng.generate([3, 1, 4], max_new_tokens=2, return_logprobs=True)
    assert eng.serve_routing_stats()["engine_queue"] == 0


def test_llm_server_background_loop(tiny_model):
    cfg, params = tiny_model
    server = LLMServer(cfg, params, num_slots=2, max_seq_len=64,
                       device="cpu")
    try:
        results = [None] * 4

        def call(i):
            results[i] = server.generate([1 + i, 2, 3], max_new_tokens=4)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for i, out in enumerate(results):
            assert out["tokens"] == greedy(cfg, params, [1 + i, 2, 3], 4)
        assert server.stats()["finished"] == 4
    finally:
        server.stop()


def test_entry_points_default_to_cuda(tiny_model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    cfg, params = tiny_model
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LLMEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LLMServer(cfg, params)


class TestPrefixCaching:
    """Registered-prefix KV reuse: admission copies the prefix KV and
    prefills only the suffix; outputs equal the full-prefill path."""

    def test_outputs_match_full_prefill_exactly(self, tiny_model):
        cfg, params = tiny_model
        rng = np.random.RandomState(1)
        prefix = list(rng.randint(0, cfg.vocab_size, size=13))
        prompts = [prefix + list(rng.randint(0, cfg.vocab_size, size=n))
                   for n in (4, 9, 1, 6)]
        prompts.append(list(rng.randint(0, cfg.vocab_size, size=8)))

        base = engine(cfg, params, num_slots=3, max_seq_len=64)
        base_reqs = [base.submit(p, max_new_tokens=5) for p in prompts]
        drain(base)
        expected = [r.result(timeout=5) for r in base_reqs]

        eng = engine(cfg, params, num_slots=3, max_seq_len=64)
        eng.register_prefix(prefix)
        reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
        drain(eng)
        for exp, r in zip(expected, reqs):
            assert r.result(timeout=5) == exp
        st = eng.stats()
        assert st["prefix_hits"] >= 4
        assert st["prefix_tokens_saved"] >= 4 * len(prefix)
        assert st["cached_prefixes"] == 1

    def test_exact_prefix_prompt_uses_full_path(self, tiny_model):
        cfg, params = tiny_model
        prefix = list(np.random.RandomState(2).randint(0, cfg.vocab_size,
                                                       size=10))
        eng = engine(cfg, params, num_slots=2, max_seq_len=64)
        eng.register_prefix(prefix)
        r = eng.submit(prefix, max_new_tokens=4)
        drain(eng)
        assert r.result(timeout=5) == greedy(cfg, params, prefix, 4)
        assert eng.stats()["prefix_hits"] == 0

    def test_longest_prefix_wins_and_lru_caps(self, tiny_model):
        cfg, params = tiny_model
        rng = np.random.RandomState(3)
        p_short = list(rng.randint(0, cfg.vocab_size, size=6))
        p_long = p_short + list(rng.randint(0, cfg.vocab_size, size=6))
        eng = engine(cfg, params, num_slots=2, max_seq_len=64)
        eng.register_prefix(p_short)
        eng.register_prefix(p_long)
        r = eng.submit(p_long + [1, 2, 3], max_new_tokens=3)
        drain(eng)
        r.result(timeout=5)
        assert eng.prefix_tokens_saved % len(p_long) == 0
        assert eng.prefix_tokens_saved >= len(p_long)
        eng.max_cached_prefixes = 2
        eng.register_prefix([5] * 4)
        assert eng.stats()["cached_prefixes"] == 2

    def test_register_validation(self, tiny_model):
        cfg, params = tiny_model
        eng = engine(cfg, params, num_slots=1, max_seq_len=32)
        with pytest.raises(ValueError, match="empty"):
            eng.register_prefix([])
        with pytest.raises(ValueError, match="room"):
            eng.register_prefix([1] * 40)

    def test_auto_capture_registers_hot_prefixes(self, tiny_model):
        cfg, params = tiny_model
        rng = np.random.RandomState(6)
        hot = list(rng.randint(0, cfg.vocab_size, size=8))
        prompts = [hot + list(rng.randint(0, cfg.vocab_size, size=n))
                   for n in (3, 5, 2, 7, 4)]
        expected = [greedy(cfg, params, p, 4) for p in prompts]
        eng = engine(cfg, params, num_slots=2, max_seq_len=64,
                     auto_prefix_min_hits=2, auto_prefix_lens=(8,))
        got = []
        for p in prompts:
            r = eng.submit(p, max_new_tokens=4)
            drain(eng)
            got.append(r.result(timeout=5))
        assert got == expected
        st = eng.stats()
        assert st["cached_prefixes"] == 1
        assert st["prefix_hits"] >= 2

    def test_auto_capture_divergent_continuations(self, tiny_model):
        """A hot SHORT prefix followed by varied content is captured at
        the short length."""
        cfg, params = tiny_model
        rng = np.random.RandomState(8)
        hot = list(rng.randint(0, cfg.vocab_size, size=8))
        eng = engine(cfg, params, num_slots=2, max_seq_len=64,
                     auto_prefix_min_hits=2, auto_prefix_lens=(8, 16))
        for _ in range(4):
            user = list(rng.randint(0, cfg.vocab_size, size=12))
            r = eng.submit(hot + user, max_new_tokens=2)
            drain(eng)
            r.result(timeout=5)
        st = eng.stats()
        assert tuple(hot) in eng._prefixes
        assert st["prefix_hits"] >= 1

    def test_auto_capture_burst_dedup(self, tiny_model):
        cfg, params = tiny_model
        eng = engine(cfg, params, num_slots=2, max_seq_len=64,
                     auto_prefix_min_hits=2, auto_prefix_lens=(8,))
        hot = list(range(1, 9))
        reqs = [eng.submit(hot + [10 + i], max_new_tokens=2)
                for i in range(10)]
        assert len(eng._auto_pending) == 1
        drain(eng)
        for r in reqs:
            r.result(timeout=5)
        assert eng.stats()["cached_prefixes"] == 1
        assert not eng._auto_pending and not eng._auto_inflight

    def test_auto_capture_off_by_default(self, tiny_model):
        cfg, params = tiny_model
        eng = engine(cfg, params, num_slots=1, max_seq_len=64)
        for _ in range(3):
            r = eng.submit([1, 2, 3, 4, 5, 6, 7, 8, 9], max_new_tokens=2)
            drain(eng)
            r.result(timeout=5)
        assert eng.stats()["cached_prefixes"] == 0

    def test_temperature_rides_suffix_path(self, tiny_model):
        cfg, params = tiny_model
        prefix = list(np.random.RandomState(4).randint(0, cfg.vocab_size,
                                                       size=8))
        eng = engine(cfg, params, num_slots=2, max_seq_len=64)
        eng.register_prefix(prefix)
        reqs = [eng.submit(prefix + [7, 8], max_new_tokens=4,
                           temperature=0.8) for _ in range(3)]
        drain(eng)
        for r in reqs:
            toks = r.result(timeout=5)
            assert len(toks) == 4
            assert all(0 <= t < cfg.vocab_size for t in toks)
        assert eng.stats()["prefix_hits"] >= 3

    def test_set_params_recomputes_prefixes(self, tiny_model):
        """New weights re-register every prefix, so prefix-path outputs
        follow the new weights."""
        cfg, params = tiny_model
        prefix = [5, 6, 7, 8, 9, 10]
        new = {k: v for k, v in params.items()}
        new["final_norm"] = params["final_norm"] * 2.0 + 0.3
        new["embed"] = params["embed"].flip(0)
        eng = engine(cfg, params, num_slots=2, max_seq_len=64)
        eng.register_prefix(prefix)
        eng.set_params(new)
        r = eng.submit(prefix + [1, 2], max_new_tokens=4)
        drain(eng)
        assert r.result(timeout=5) == greedy(cfg, new, prefix + [1, 2], 4)
        assert eng.stats()["prefix_hits"] >= 1

