"""The port's metrics against the reference's: the stdlib registry renders
byte-identical text for the same operations (hostile label values
included), and the same request script, driven step by step through both
engines on f32 ``tiny``, gives equal deterministic counters and equal
histogram sample counts (times differ; they are not compared)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arks_tpu.engine import EngineConfig as JaxEngineConfig
from arks_tpu.engine import InferenceEngine as JaxEngine
from arks_tpu.engine import Request as JaxRequest
from arks_tpu.engine import SamplingParams as JaxSamplingParams
from arks_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from arks_tpu.models import get_config as jax_get_config
from arks_tpu.models import transformer as jtf
from arks_tpu.utils import metrics as ref_prom
from arks_tpu_torch.engine import EngineConfig, InferenceEngine, Request, \
    SamplingParams
from arks_tpu_torch.engine.metrics import EngineMetrics
from arks_tpu_torch.engine.tokenizer import ByteTokenizer
from arks_tpu_torch.models import get_config
from arks_tpu_torch.models.weights import params_from_numpy
from arks_tpu_torch.utils import metrics as port_prom

torch.set_num_threads(2)

HOSTILE = ['plain', 'quo"te', 'back\\slash', 'new\nline', 'all\\"\n3',
           'ünïcode', '', '{}=,']


def _drive_registry(mod) -> str:
    r = mod.Registry()
    c = r.counter("reqs_total", "Requests by tenant")
    g = r.gauge("depth", "Queue depth")
    h = r.histogram("lat_seconds", "Latency", buckets=[0.5, 0.01, 1, 2.5])
    d = r.histogram("default_buckets")
    for i, v in enumerate(HOSTILE):
        c.inc(tenant=v)
        c.inc(0.25 * i, tenant=v, tier="t" + v)
        g.set(i * 1.5, who=v)
        g.inc(-0.5, who=v)
        h.observe(0.003 * i, path=v)
        h.observe(7.0, path=v)
        d.observe(i * 3.3)
    c.inc(3)
    with pytest.raises(ValueError):
        r.counter("depth")
    assert c.total() == c.get() + sum(c.get(tenant=v) + c.get(
        tenant=v, tier="t" + v) for v in HOSTILE)
    return r.render()


def test_registry_renders_byte_identical():
    want, got = _drive_registry(ref_prom), _drive_registry(port_prom)
    assert got == want
    assert 'tenant="quo\\"te"' in got and 'new\\nline' in got


def test_engine_metric_families_are_the_references():
    """Every family the port registers is the reference's, with its help
    text, type and buckets, in the reference's order."""
    from arks_tpu.engine.engine import EngineMetrics as RefMetrics
    ref = {f.name: f for f in RefMetrics().registry.families()}
    port = EngineMetrics().registry.families()
    names = [f.name for f in port]
    assert names == [n for n in ref if n in set(names)]
    for f in port:
        r = ref[f.name]
        assert (f.help, f.type, getattr(f, "buckets", None)) == \
            (r.help, r.type, getattr(r, "buckets", None)), f.name
    left_out = set(ref) - set(names)
    assert all(n.startswith(("spec_", "residency_", "model_", "engine_f",
                             "engine_s", "engine_r", "requests_rec",
                             "requests_q", "requests_pre", "resize",
                             "scale_", "preempt", "prefix_disk",
                             "prefix_peer")) for n in left_out), left_out


def _samples(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


# Deterministic families (counts, not seconds): their every sample, and
# the sample counts of the timing histograms.
COUNTERS = ("request_success_total", "prompt_tokens_total",
            "generation_tokens_total", "prefix_cache_query_tokens_total",
            "prefix_cache_hit_tokens_total", "mixed_chunk_tokens_total",
            "mixed_grid_steps_total", "mixed_grid_steps_ideal_total",
            "sampler_fused_dispatch_total", "requests_shed_total",
            "mixed_batch_tokens")
COUNTED = ("time_to_first_token_seconds_count",
           "time_per_output_token_seconds_count",
           "e2e_request_latency_seconds_count", "ttft_seconds_count",
           "tpot_seconds_count", "pipeline_depth_occupancy_count")


def _deterministic(text: str) -> dict:
    return {k: v for k, v in _samples(text).items()
            if k.split("{")[0] in COUNTERS
            or k.split("{")[0].startswith(tuple(c + "_" for c in COUNTERS))
            or k.split("{")[0] in COUNTED}


def _drive(engine, busy, n_steps=800):
    for _ in range(n_steps):
        engine.step(block_s=0.01)
        if not busy(engine):
            return
    raise AssertionError("engine did not drain")


def _script(vocab):
    """Prompts that share a 32-token prefix (two pages of 16), one longer
    than a chunk, greedy and seeded, one stopped by max_tokens early."""
    rng = np.random.default_rng(11)
    shared = [int(x) for x in rng.integers(2, vocab, 32)]
    prompts = [shared + [int(x) for x in rng.integers(2, vocab, n)]
               for n in (3, 9)]
    prompts += [[int(x) for x in rng.integers(2, vocab, n)]
                for n in (5, 40)]
    prompts.append(list(prompts[0]))
    sp = [dict(max_tokens=6, temperature=0.0, ignore_eos=True),
          dict(max_tokens=9, temperature=0.8, top_k=20, seed=5,
               ignore_eos=True),
          dict(max_tokens=3, temperature=0.0, ignore_eos=True),
          dict(max_tokens=7, temperature=0.0, ignore_eos=True),
          dict(max_tokens=5, temperature=0.0, ignore_eos=True)]
    return prompts, sp


@pytest.mark.parametrize("layout", ["paged", "slot"])
def test_engine_counters_equal_reference(layout, monkeypatch):
    """The same script through both engines, one step at a time from one
    thread: equal counters (success by reason, prompt and generated
    tokens, prefix queries and hits by tier, mixed batch and chunk tokens,
    grid steps) and equal sample counts of TTFT, TPOT and e2e."""
    name = "tiny"
    kw = dict(num_slots=2, max_cache_len=64, steps_per_dispatch=4,
              prefill_chunk=16, dtype="float32")
    jparams = jtf.init_params(jax_get_config(name), jax.random.PRNGKey(2),
                              jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                get_config(name), "cpu")
    prompts, sp = _script(get_config(name).vocab_size)
    monkeypatch.setenv("ARKS_MIXED_STEP", "1")
    # The reference fuses its depth-0 steady step only once its pipe
    # programs have compiled ahead of time; both engines take the classic
    # mixed step here, one dispatch per step.
    monkeypatch.setenv("ARKS_SAMPLER_FUSE", "0")
    jeng = JaxEngine(jax_get_config(name), JaxEngineConfig(
        model=name, prefill_buckets=(8, 16, 32), kv_layout=layout, **kw),
        JaxByteTokenizer(), params=jparams)
    teng = InferenceEngine(get_config(name), EngineConfig(
        model=name, kv_layout=layout, **kw), ByteTokenizer(),
        params=tparams, device="cpu")
    for i, (p, s) in enumerate(zip(prompts, sp)):
        # One request at a time: the prefix hits need the earlier pages.
        jr = JaxRequest(f"r{i}", p, JaxSamplingParams(**s))
        tr = Request(f"r{i}", p, SamplingParams(**s))
        jeng.add_request(jr)
        teng.add_request(tr)
        _drive(jeng, lambda e: e.num_running or not e._queue.empty()
               or e._prefilling)
        _drive(teng, lambda e: not e.idle)
    want = _deterministic(jeng.metrics.registry.render())
    got = _deterministic(teng.metrics.registry.render())
    assert got == want
    assert got['request_success_total{reason="length"}'] == len(prompts)
    assert got["prompt_tokens_total"] == sum(map(len, prompts))
    assert got["prefix_cache_query_tokens_total"] > 0
