"""The port's generation path (ray_tpu_torch.models.generate) against the
JAX package's, on the CPU with shared weights: prefill+decode logits,
greedy tokens (exactly), prefix-suffix prefill, padding-row drop and the
sampler's semantics. Sampled tokens are checked by their distribution:
the two frameworks draw different random numbers."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import configs as jax_configs
from ray_tpu.models import generate as jg
from ray_tpu_torch.models import configs
from ray_tpu_torch.models import generate as tg
from ray_tpu_torch.models.transformer import forward

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_util import both_params  # noqa: E402

ATOL, RTOL = 2e-5, 2e-4


@pytest.fixture(scope="module")
def model():
    cfg_j, cfg_t = jax_configs.tiny_test(), configs.tiny_test()
    pj, pt = both_params(cfg_j, cfg_t, seed=0)
    return cfg_j, cfg_t, pj, pt


def test_decode_logits_match_full_forward(model):
    """Prefill + decode reproduce the full forward's logits (the
    tests/test_llm.py:30 shape), and JAX's prefill/decode logits."""
    cfg_j, cfg, pj, pt = model
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, 14)
    cache = tg.init_kv_cache(cfg, 1, 32, device="cpu")
    padded = torch.zeros((1, 16), dtype=torch.long)
    padded[0, :10] = torch.from_numpy(toks[:10])
    cache, l0 = tg.prefill(cfg, pt, cache, padded, 10, 0)
    inc = [l0]
    for i in range(10, 14):
        cache, lg = tg.decode_step(cfg, pt, cache, torch.tensor([toks[i]]))
        inc.append(lg[0])
    full = forward(cfg, pt, torch.from_numpy(toks)[None])[0][0]
    for step, (a, i) in enumerate(zip(inc, range(9, 14))):
        np.testing.assert_allclose(a.numpy(), full[i].numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=f"step {step}")

    jcache = jg.init_kv_cache(cfg_j, 1, 32)
    jcache, jl = jg.prefill(cfg_j, pj, jcache,
                            jnp.asarray(padded.numpy(), jnp.int32),
                            jnp.int32(10), jnp.int32(0))
    jinc = [np.asarray(jl)]
    for i in range(10, 14):
        jcache, lg = jg.decode_step(cfg_j, pj, jcache,
                                    jnp.asarray([toks[i]], jnp.int32))
        jinc.append(np.asarray(lg[0]))
    for a, b in zip(inc, jinc):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(cache.k.numpy()[:, :, :14],
                               np.asarray(jcache.k)[:, :, :14],
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("prompt_len", [5, 20])
def test_greedy_generate_equals_jax(model, prompt_len):
    cfg_j, cfg, pj, pt = model
    prompt = np.random.RandomState(prompt_len).randint(0, cfg.vocab_size,
                                                       prompt_len)
    want = np.asarray(jg.greedy_generate(cfg_j, pj,
                                         jnp.asarray(prompt, jnp.int32), 10))
    got = tg.greedy_generate(cfg, pt, prompt, 10, device="cpu")
    assert got.tolist() == want.tolist()
    assert len(set(got.tolist())) > 1        # a real continuation


def test_decode_multi_greedy_equals_jax(model):
    """Four slots at different lengths, 5 fused greedy ticks."""
    cfg_j, cfg, pj, pt = model
    rng = np.random.RandomState(7)
    W, S = 4, 16
    lens = np.array([5, 16, 9, 1])
    tokens = np.zeros((W, S), np.int64)
    for j, n in enumerate(lens):
        tokens[j, :n] = rng.randint(0, cfg.vocab_size, n)
    slots = np.arange(W)
    temps = np.zeros(W, np.float32)

    cache = tg.init_kv_cache(cfg, W, 32, device="cpu")
    cache, first = tg.prefill_sample_batch(cfg, pt, cache, tokens, lens,
                                           slots, 0, temps)
    cache, toks = tg.decode_multi(cfg, pt, cache, first, torch.zeros(W), 5,
                                  0)

    jcache = jg.init_kv_cache(cfg_j, W, 32)
    jcache, jfirst = jg.prefill_sample_batch(
        cfg_j, pj, jcache, jnp.asarray(tokens, jnp.int32),
        jnp.asarray(lens, jnp.int32), jnp.asarray(slots, jnp.int32), 0,
        jnp.asarray(temps), jax.random.key(0))
    jcache, jtoks = jg.decode_multi(cfg_j, pj, jcache, jfirst,
                                    jnp.zeros(W), 5, 0, jax.random.key(1))
    assert first.tolist() == np.asarray(jfirst).tolist()
    assert toks.tolist() == np.asarray(jtoks).tolist()
    assert cache.seq_lens.tolist() == np.asarray(jcache.seq_lens).tolist()


def test_suffix_prefill_matches_full_prefill(model):
    """A registered prefix's KV + suffix-only prefill writes the same
    cache rows and gives the same last-token logits as prefilling the
    whole prompt, and agrees with JAX's suffix path."""
    cfg_j, cfg, pj, pt = model
    rng = np.random.RandomState(3)
    prefix = rng.randint(0, cfg.vocab_size, 13).tolist()
    suffixes = [rng.randint(0, cfg.vocab_size, n).tolist() for n in (4, 9)]
    W, Sq = 2, 16
    buf = np.zeros((W, Sq), np.int64)
    full = np.zeros((W, 32), np.int64)
    for j, s in enumerate(suffixes):
        buf[j, :len(s)] = s
        full[j, :13 + len(s)] = prefix + s
    lens = np.array([len(s) for s in suffixes])

    pk, pv = tg.compute_prefix_kv(cfg, pt, prefix)
    c_suf = tg.init_kv_cache(cfg, W, 40, device="cpu")
    c_suf, logits_suf = tg._prefill_suffix_core(cfg, pt, c_suf, pk, pv, buf,
                                                lens, np.arange(W))
    c_full = tg.init_kv_cache(cfg, W, 40, device="cpu")
    c_full, logits_full = tg._prefill_batch_core(cfg, pt, c_full, full,
                                                 lens + 13, np.arange(W))
    np.testing.assert_allclose(logits_suf.numpy(), logits_full.numpy(),
                               atol=ATOL, rtol=RTOL)
    assert c_suf.seq_lens.tolist() == (lens + 13).tolist()
    for j, n in enumerate(lens + 13):
        np.testing.assert_allclose(c_suf.k[:, j, :n].numpy(),
                                   c_full.k[:, j, :n].numpy(),
                                   atol=ATOL, rtol=RTOL)

    jpk, jpv = jg.compute_prefix_kv(cfg_j, pj, prefix)
    np.testing.assert_allclose(pk.numpy(), np.asarray(jpk), atol=ATOL,
                               rtol=RTOL)
    jtoks = jg.first_token_suffix_sample(
        cfg_j, pj, jpk, jpv, jnp.asarray(buf, jnp.int32),
        jnp.asarray(lens, jnp.int32), jnp.zeros(W), 0, jax.random.key(0))
    toks = tg.first_token_suffix_sample(cfg, pt, pk, pv, buf, lens,
                                        torch.zeros(W), 0)
    assert toks.tolist() == np.asarray(jtoks).tolist()
    assert toks.tolist() == logits_full.argmax(-1).tolist()


def test_padding_rows_are_dropped(model):
    """Rows whose slot is num_slots (the tile's padding) write nothing:
    no wrap-around into slot 0, no error."""
    _, cfg, _, pt = model
    cache = tg.init_kv_cache(cfg, 3, 32, device="cpu")
    tokens = np.random.RandomState(0).randint(1, cfg.vocab_size, (4, 16))
    slots = np.array([1, 3, 3, 3])
    cache, toks = tg.prefill_sample_batch(cfg, pt, cache, tokens,
                                          np.array([16, 5, 5, 5]), slots, 0,
                                          np.zeros(4, np.float32))
    assert toks.shape == (4,)
    assert cache.seq_lens.tolist() == [0, 16, 0]
    assert cache.k[:, 0].abs().sum() == 0 and cache.k[:, 2].abs().sum() == 0
    assert cache.k[:, 1, :16].abs().sum() > 0

    pk, pv = tg.compute_prefix_kv(cfg, pt, [1, 2, 3])
    cache, _ = tg.prefill_suffix_batch(cfg, pt, cache, pk, pv, tokens[:, :8],
                                       np.full(4, 8), np.array([3, 2, 3, 3]),
                                       0, np.zeros(4, np.float32))
    assert cache.seq_lens.tolist() == [0, 16, 11]
    assert cache.k[:, 0].abs().sum() == 0


def test_idle_slot_past_cache_end_writes_nothing(model):
    """An idle slot keeps advancing; once past the cache end its decode
    write is dropped (JAX drops out-of-bounds scatter updates)."""
    cfg_j, cfg, pj, pt = model
    cache = tg.init_kv_cache(cfg, 2, 8, device="cpu")
    cache.seq_lens[:] = torch.tensor([3, 8])
    before = cache.k[:, 1].clone()
    cache, logits = tg.decode_step(cfg, pt, cache, torch.tensor([5, 6]))
    assert torch.equal(cache.k[:, 1], before)
    assert cache.seq_lens.tolist() == [4, 9]
    jc = jg.init_kv_cache(cfg_j, 2, 8)._replace(
        seq_lens=jnp.asarray([3, 8], jnp.int32))
    _, jl = jg.decode_step(cfg_j, pj, jc, jnp.asarray([5, 6], jnp.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)


def test_first_token_sample_matches_prefill_path(model):
    """The cache-free queue-side first token equals the prefill path's
    greedy token with non-unit final-norm gains (a double norm would
    diverge)."""
    cfg_j, cfg, pj, pt = model
    pt = dict(pt, final_norm=pt["final_norm"] * 3.0 + 0.5)
    prompt = np.random.RandomState(1).randint(0, cfg.vocab_size, 24)
    padded = np.zeros((1, 32), np.int64)
    padded[0, :24] = prompt
    cache = tg.init_kv_cache(cfg, 2, 64, device="cpu")
    _, tok = tg.prefill_sample(cfg, pt, cache, padded, 24, 0, 0, 0.0)
    toks = tg.first_token_sample(cfg, pt, np.repeat(padded, 4, 0),
                                 np.full(4, 24), torch.zeros(4), 0)
    assert toks.tolist() == [int(tok)] * 4


def test_top_k_keeps_ties_at_the_threshold():
    logits = torch.tensor([[5.0, 3.0, 3.0, 0.0, -1.0]]).repeat(3000, 1)
    gen = torch.Generator().manual_seed(0)
    toks = tg.sample(logits, gen, temperature=100.0, top_k=2)
    counts = np.bincount(toks.numpy(), minlength=5)
    # kth largest = 3.0, so both 3.0s survive; nothing below does.
    assert counts[3] == counts[4] == 0
    assert min(counts[:3]) > 800
    jtoks = jg.sample(jnp.asarray(logits.numpy()), jax.random.key(0),
                      temperature=100.0, top_k=2)
    assert set(np.asarray(jtoks).tolist()) == {0, 1, 2}


def test_greedy_rows_and_sampled_rows_mix():
    logits = torch.tensor([[0.0, 2.0, 1.0]] * 4)
    gen = torch.Generator().manual_seed(1)
    temps = torch.tensor([0.0, -1.0, 1.0, 0.0])
    for _ in range(20):
        toks = tg.sample(logits, gen, temperature=temps)
        assert toks[[0, 1, 3]].tolist() == [1, 1, 1]


def test_sampled_tokens_follow_the_softmax():
    """Temperature sampling draws from softmax(logits / T): check the
    frequencies of 40000 draws (5 sigma bound) and JAX's likewise."""
    p = np.array([0.5, 0.25, 0.15, 0.1])
    T = 0.7
    logits = np.log(p) * T                     # softmax(logits/T) == p
    n = 40000
    gen = torch.Generator().manual_seed(2)
    toks = tg.sample(torch.tensor(logits, dtype=torch.float32).repeat(n, 1),
                     gen, temperature=T)
    jtoks = np.asarray(jg.sample(
        jnp.asarray(np.tile(logits, (n, 1)), jnp.float32),
        jax.random.key(2), temperature=T))
    sigma = np.sqrt(p * (1 - p) / n)
    for draws in (toks.numpy(), jtoks):
        freq = np.bincount(draws, minlength=4) / n
        assert np.all(np.abs(freq - p) < 5 * sigma), freq


def test_token_logp_matches_jax():
    rng = np.random.RandomState(0)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 3
    toks = rng.randint(0, 50, (3, 7))
    np.testing.assert_allclose(
        tg.token_logp(torch.from_numpy(logits), torch.from_numpy(toks)),
        np.asarray(jg.token_logp(jnp.asarray(logits), jnp.asarray(toks))),
        atol=ATOL, rtol=RTOL)


def test_generate_defaults_to_cuda(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    _, cfg, _, pt = model
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tg.greedy_generate(cfg, pt, [1, 2, 3], 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tg.init_kv_cache(cfg, 2)
