"""Prefill/decode disaggregation in the port against the reference, on CPU
``tiny`` and ``tiny-gqa`` in f32 (the counterpart of
``tests/test_disagg.py``'s engine layer):

- the JAX engine's ``prefill_detached`` goes through the reference's
  ``kv_transfer.pack`` (with the meta the reference's prefill server
  sends), the port's ``unpack`` and the port's decode engine; greedy,
  seeded, guided and logprob streams equal the JAX unified engine's on
  both schedulers (mixed on the paged pool, legacy on the slot cache);
- the port's own ``prefill_detached`` gives the reference's first token,
  seed, guide row and logprob entry, and its K/V within f32 rounding;
- an oversize prompt raises ``ContextLengthExceededError``, a too-long
  prefilled request is aborted, a logprob request without a first-token
  entry fails with ``logprobs_unavailable``, and the transferred prompt's
  pages enter the device index and the host tier."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arks_tpu.engine import EngineConfig as JaxEngineConfig
from arks_tpu.engine import InferenceEngine as JaxEngine
from arks_tpu.engine import Request as JaxRequest
from arks_tpu.engine import SamplingParams as JaxSamplingParams
from arks_tpu.engine import kv_transfer as jkv
from arks_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from arks_tpu.models import get_config as jax_get_config
from arks_tpu.models import transformer as jtf
from arks_tpu_torch.engine import EngineConfig, InferenceEngine, Request, \
    SamplingParams
from arks_tpu_torch.engine import kv_transfer
from arks_tpu_torch.engine.engine import ContextLengthExceededError
from arks_tpu_torch.engine.paged import chain_digests
from arks_tpu_torch.engine.tokenizer import ByteTokenizer
from arks_tpu_torch.models import get_config
from arks_tpu_torch.models.weights import params_from_numpy
from arks_tpu_torch.server.disagg import prefill_meta, prefilled_state

torch.set_num_threads(2)

MODELS = ["tiny", "tiny-gqa"]
KW = dict(num_slots=2, max_cache_len=64, prefill_buckets=(8, 16, 32),
          steps_per_dispatch=4, prefill_chunk=16, dtype="float32",
          prefix_cache_mb=0)
# (prompt, sampling params) per case; prompts stay inside the one-shot
# limit (the largest bucket, 32).
CASES = {
    "greedy": ([(3 * i + 5) % 200 + 40 for i in range(27)],
               dict(max_tokens=8, temperature=0.0, ignore_eos=True)),
    "seeded": ([(7 * i + 2) % 190 + 50 for i in range(19)],
               dict(max_tokens=8, temperature=0.9, top_p=0.95, seed=21,
                    ignore_eos=True)),
    "guided": ([(5 * i + 1) % 90 + 97 for i in range(30)],
               dict(max_tokens=6, temperature=0.0,
                    guide=("regex", "[a-d]{4}x"))),
    "logprobs": ([(11 * i + 3) % 150 + 60 for i in range(23)],
                 dict(max_tokens=6, temperature=0.0, ignore_eos=True,
                      logprobs=2)),
}
SCHEDS = {"mixed": dict(kv_layout="paged"), "legacy": dict(kv_layout="slot")}
# The guide and logprob cases ride ``tiny`` alone (each costs the JAX
# engines a compile of its own).
CASES_OF = {"tiny": tuple(CASES), "tiny-gqa": ("greedy", "seeded")}


def _drain(eng, req, steps=4000):
    """Step ``eng`` from this thread until ``req`` finishes; (token ids,
    logprob entries, finish reason)."""
    toks, lps = [], []
    for _ in range(steps):
        eng.step(block_s=0.005)
        while not req.outputs.empty():
            out = req.outputs.get_nowait()
            toks += out.token_ids
            lps += out.logprobs or []
            if out.finished:
                return toks, lps, out.finish_reason
    raise AssertionError(f"{req.request_id} did not finish")


@pytest.fixture(scope="module", params=MODELS)
def model(request):
    """(name, JAX params, port params, the JAX results): per case the AKV1
    message of the JAX prefill server's answer and the JAX detached state,
    and per scheduler the JAX unified engine's streams."""
    name = request.param
    jparams = jtf.init_params(jax_get_config(name), jax.random.PRNGKey(7),
                              jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                get_config(name), "cpu")
    mp = pytest.MonkeyPatch()
    mp.setenv("ARKS_PIPELINE_DEPTH", "0")
    try:
        pre = JaxEngine(jax_get_config(name), JaxEngineConfig(
            model=name, **KW), JaxByteTokenizer(), params=jparams)
        wire, states = {}, {}
        for case in CASES_OF[name]:
            ids, p = CASES[case]
            pf = pre.prefill_detached(ids, JaxSamplingParams(**p))
            states[case] = pf
            wire[case] = jkv.pack(prefill_meta(pf),
                                  [np.asarray(pf.k), np.asarray(pf.v)])
        unified = {}
        for sched, extra in SCHEDS.items():
            eng = JaxEngine(jax_get_config(name), JaxEngineConfig(
                model=name, **KW, **extra), JaxByteTokenizer(),
                params=jparams)
            unified[sched] = {}
            for case in CASES_OF[name]:
                ids, p = CASES[case]
                req = JaxRequest(f"u-{case}", list(ids),
                                 JaxSamplingParams(**p))
                eng.add_request(req)
                unified[sched][case] = _drain(eng, req)
    finally:
        mp.undo()
    return name, tparams, wire, states, unified


def _engine(name, tparams, **kw):
    return InferenceEngine(get_config(name), EngineConfig(
        model=name, **{**KW, **kw}), ByteTokenizer(), params=tparams,
        device="cpu")


def _lp_close(got, want):
    assert len(got) == len(want)
    for (c1, top1), (c2, top2) in zip(got, want):
        assert [i for i, _ in top1] == [i for i, _ in top2]
        np.testing.assert_allclose([c1] + [x for _, x in top1],
                                   [c2] + [x for _, x in top2], atol=2e-5)


@pytest.mark.parametrize("sched", list(SCHEDS))
def test_jax_prefilled_port_decoded_streams_equal_the_jax_unified(
        model, monkeypatch, sched):
    """The reference's wire bytes, unpacked by the port and decoded by the
    port's engine: every stream is the JAX unified engine's, token for
    token (logprobs within f32 rounding)."""
    name, tparams, wire, _, unified = model
    monkeypatch.setenv("ARKS_PIPELINE_DEPTH", "0")
    eng = _engine(name, tparams, **SCHEDS[sched])
    for case in CASES_OF[name]:
        ids, p = CASES[case]
        meta, (k, v) = kv_transfer.unpack(wire[case])
        assert k.dtype == torch.float32 and k.shape[2] == 32
        req = Request(f"d-{case}", [], SamplingParams(**p),
                      prefilled=prefilled_state(meta, k, v))
        eng.add_request(req)
        toks, lps, fin = _drain(eng, req)
        want_toks, want_lps, want_fin = unified[sched][case]
        assert (toks, fin) == (want_toks, want_fin), case
        _lp_close(lps, want_lps)
    if sched == "mixed":
        # Every transferred prompt's full pages were published: in the
        # device index and spilled to the host tier.
        eng._resolve_spills()
        prompts = [CASES[c][0] for c in CASES_OF[name]]
        for ids in prompts:
            for d in chain_digests(ids, 16, len(ids) // 16):
                assert d in eng._alloc._index and eng._host.has(d)


def test_port_detached_prefill_equals_the_references(model, monkeypatch):
    """The port's ``prefill_detached`` on the same prompts: the same first
    token, seed, guide row and logprob ids (values within f32 rounding),
    and K/V within f32 rounding at the same bucket shape."""
    name, tparams, _, states, _ = model
    monkeypatch.setenv("ARKS_PIPELINE_DEPTH", "0")
    eng = _engine(name, tparams)
    for case in CASES_OF[name]:
        ids, p = CASES[case]
        got = eng.prefill_detached(ids, SamplingParams(**p))
        want = states[case]
        assert (got.first_token, got.num_prompt, got.seed, got.guide_row,
                got.prompt_ids) == (want.first_token, want.num_prompt,
                                    want.seed, want.guide_row,
                                    list(want.prompt_ids)), case
        assert tuple(got.k.shape) == np.asarray(want.k).shape
        np.testing.assert_allclose(got.k.numpy(), np.asarray(want.k),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v),
                                   atol=1e-5, rtol=1e-5)
        if want.first_lp is None:
            assert got.first_lp is None
        else:
            _lp_close([got.first_lp], [want.first_lp])
    with pytest.raises(ContextLengthExceededError):
        eng.prefill_detached(list(range(40)), SamplingParams())


def _prefilled(num_prompt, t=16, first_lp=None, cfg=None):
    cfg = cfg or get_config("tiny")
    shape = (cfg.num_layers, 1, t, cfg.num_kv_heads, cfg.head_dim)
    from arks_tpu_torch.engine.types import PrefilledState
    return PrefilledState(first_token=1, num_prompt=num_prompt, seed=0,
                          k=torch.zeros(shape), v=torch.zeros(shape),
                          first_lp=first_lp)


@pytest.mark.parametrize("sched", list(SCHEDS))
def test_unservable_prefilled_requests_end_cleanly(monkeypatch, sched):
    """A prompt past the decode window is aborted; a logprob request
    whose state carries no first-token entry fails with
    ``logprobs_unavailable`` (never a partial logprob stream); the engine
    serves on."""
    monkeypatch.setenv("ARKS_PIPELINE_DEPTH", "0")
    eng = InferenceEngine(get_config("tiny"), EngineConfig(
        model="tiny", **{**KW, **SCHEDS[sched]}), ByteTokenizer(),
        device="cpu")
    big = Request("big", [], SamplingParams(),
                  prefilled=_prefilled(100))
    eng.add_request(big)
    assert _drain(eng, big)[2] == "abort"
    lp = Request("lp", [], SamplingParams(logprobs=1),
                 prefilled=_prefilled(5))
    eng.add_request(lp)
    assert _drain(eng, lp)[2] == "error"
    ok = Request("ok", [], SamplingParams(max_tokens=3, ignore_eos=True,
                                          temperature=0.0),
                 prefilled=_prefilled(5, first_lp=(-1.0, [(1, -1.0)])))
    eng.add_request(ok)
    toks, _, fin = _drain(eng, ok)
    assert len(toks) == 3 and fin == "length"
    assert not eng._slots and len(eng._free) == KW["num_slots"]


def test_logprobs_unavailable_is_an_error(monkeypatch):
    monkeypatch.setenv("ARKS_PIPELINE_DEPTH", "0")
    eng = InferenceEngine(get_config("tiny"), EngineConfig(
        model="tiny", **KW), ByteTokenizer(), device="cpu")
    req = Request("lp", [], SamplingParams(logprobs=1),
                  prefilled=_prefilled(5))
    eng.add_request(req)
    eng.step(block_s=0.005)
    out = req.outputs.get(timeout=5)
    assert out.finished and out.finish_reason == "error"
    assert out.error == "logprobs_unavailable"
