"""SLO-tiered preemptive KV swap: the port (``ARKS_PREEMPT``, the
engine's preemption section, ``SwapStore``) against the reference's
(``arks_tpu/engine/engine.py``, ``tests/test_preempt.py``).

The reference's scenarios (``_run_scenario``: a one-slot engine admits a
batch-tier victim, decodes a few steps, then a latency-tier request
arrives and seizes the slot; once per victim) run through the JAX engine
and the port's on the same f32 ``tiny`` weights, in swap mode (a paged
pool with the host tier) at pipeline depths 0 and 2 with greedy, seeded
and guided victims, on an int4 pool, in replay mode (the host tier off,
the slot layout on the legacy scheduler, a full host budget), with a
``preempt`` fault at each of its sites, an abort while swapped out, and the
swap sharing the host tier's budget.  Every port stream equals its own
preemption-off run and the JAX engine's (ids and finish reasons), with
equal preemption counts and SwapStore bytes.  The engines are driven step
by step from one thread through the engine thread's step/recover
contract.  The JAX engine of each configuration is built once and serves
every scenario of it (request ids carry the scenario).
"""

import contextlib
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from arks_tpu.engine import EngineConfig as JaxEngineConfig
from arks_tpu.engine import InferenceEngine as JaxEngine
from arks_tpu.engine import Request as JaxRequest
from arks_tpu.engine import SamplingParams as JaxSamplingParams
from arks_tpu.engine import engine as jengine_mod
from arks_tpu.engine import faults as ref_faults
from arks_tpu.engine import prefix_cache as jprefix
from arks_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from arks_tpu.models import get_config as jax_get_config
from arks_tpu.models import transformer as jtf
from arks_tpu_torch.engine import (EngineConfig, InferenceEngine, Request,
                                   SamplingParams)
from arks_tpu_torch.engine import engine as engine_mod
from arks_tpu_torch.engine import faults
from arks_tpu_torch.engine import prefix_cache as tprefix
from arks_tpu_torch.engine import sampler as sampler_mod
from arks_tpu_torch.engine.tokenizer import ByteTokenizer
from arks_tpu_torch.models import get_config
from arks_tpu_torch.models.weights import params_from_numpy

torch.set_num_threads(2)

NAME = "tiny"
CHUNK = 16
KW = dict(model=NAME, num_slots=1, max_cache_len=64,
          prefill_buckets=(8, 16, 32), steps_per_dispatch=1,
          prefill_chunk=CHUNK, prefix_cache_mb=0, dtype="float32")
TIERS = "latency:ttft_ms=300,batch:"
ENV = ("ARKS_MIXED_STEP", "ARKS_PIPELINE_DEPTH", "ARKS_PREFIX_HOST_MB",
       "ARKS_PREEMPT", "ARKS_SLO_TIERS", "ARKS_FAULT_INJECT",
       "ARKS_PREEMPT_MAX_INFLIGHT", "ARKS_PREEMPT_COOLDOWN_S",
       "ARKS_OVERLAP_DECODE")


@contextlib.contextmanager
def _env(**kv):
    old = {k: os.environ.get(k) for k in ENV}
    try:
        for k in ENV:
            os.environ.pop(k, None)
        os.environ.update({k: str(v) for k, v in kv.items()})
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def weights():
    jparams = jtf.init_params(jax_get_config(NAME), jax.random.PRNGKey(3),
                              jax.numpy.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                get_config(NAME), "cpu")
    return jparams, tparams


# (layout, ARKS_MIXED_STEP, depth, host MB, kv cache dtype) per
# configuration; the reference's _mk_engine is ("paged", "auto", depth,
# 64, "auto").
CONFIGS = {
    "swap-0": ("paged", "auto", 0, 64, "auto"),
    "swap-2": ("paged", "auto", 2, 64, "auto"),
    "int4": ("paged", "auto", 0, 64, "int4"),
    "host-off": ("paged", "auto", 0, 0, "auto"),
    "slot": ("slot", "0", 0, 0, "auto"),
    "legacy-paged": ("paged", "0", 2, 64, "auto"),
}


def _config_env(key, preempt=True):
    layout, mixed, depth, host, _ = CONFIGS[key]
    return dict(ARKS_MIXED_STEP=mixed, ARKS_PIPELINE_DEPTH=depth,
                ARKS_PREFIX_HOST_MB=host, ARKS_PREEMPT=int(preempt),
                ARKS_SLO_TIERS=TIERS, ARKS_OVERLAP_DECODE="0")


def _ecfg(cls, key):
    layout, _, _, _, kv = CONFIGS[key]
    return cls(kv_layout=layout, kv_cache_dtype=kv, **KW)


def port_engine(weights, key, preempt=True):
    with _env(**_config_env(key, preempt)):
        return InferenceEngine(get_config(NAME), _ecfg(EngineConfig, key),
                               ByteTokenizer(), params=weights[1],
                               device="cpu")


_JAX: dict = {}


def jax_engine(weights, key):
    """The JAX engine of a configuration, built once for the module."""
    if key not in _JAX:
        with _env(**_config_env(key)):
            eng = JaxEngine(jax_get_config(NAME),
                            _ecfg(JaxEngineConfig, key), JaxByteTokenizer(),
                            params=weights[0])
            if CONFIGS[key][2]:
                assert eng._pipe_warm_wait(300) == "ready"
        _JAX[key] = eng
    return _JAX[key]


def _step(eng):
    try:
        eng.step(block_s=0.005)
    except Exception as e:  # noqa: BLE001 — routed like the run loop
        eng._recover_from_fault(e)


def _drive(eng, n_steps=4000):
    for _ in range(n_steps):
        _step(eng)
        if eng.idle and eng.state == "serving":
            return
    raise AssertionError("engine did not drain")


def _observed(hist) -> int:
    return sum(n for _, _, n in hist._data.values())


def _collect(req):
    ids = []
    while True:
        out = req.outputs.get(timeout=60)
        ids.extend(out.token_ids)
        if out.finished:
            return ids, out.finish_reason


def _victims(rq, sp, tag, guided):
    """The reference's low-tier victims (priority 1): greedy, seeded and
    optionally guided long decodes."""
    reqs = [rq(f"{tag}-bt-greedy", [5, 6, 7], sp(
                max_tokens=20, temperature=0.0, ignore_eos=True, priority=1)),
            rq(f"{tag}-bt-seeded", [9] * 5, sp(
                max_tokens=20, temperature=0.9, top_p=0.9, top_k=40, seed=21,
                ignore_eos=True, priority=1))]
    if guided:
        reqs.append(rq(f"{tag}-bt-guided", [8, 3, 4], sp(
            max_tokens=24, temperature=0.9, seed=33, ignore_eos=True,
            priority=1, guide=("regex", "[a-f]+"))))
    return reqs


def _latency(rq, sp, tag, i, max_tokens=4):
    return rq(f"{tag}-lt-{i}", [2, 2, 2, 3 + i], sp(
        max_tokens=max_tokens, temperature=0.0, ignore_eos=True, priority=0))


def _counts(eng):
    m = eng.metrics
    return (m.requests_preempted_total.total(), m.engine_faults_total.total(),
            m.requests_quarantined_total.total())


def _run_scenario(eng, rq, sp, tag, guided=False, inject=None,
                  fault_cls=None):
    """One victim at a time: admit it, step 14 times, land a latency-tier
    arrival, drain; streams by request name, and the metric deltas."""
    if inject is not None:
        eng._faults = fault_cls(inject)
        eng._consec_faults = 0
    before = _counts(eng)
    outs = {}
    for i, victim in enumerate(_victims(rq, sp, tag, guided)):
        eng.add_request(victim)
        for _ in range(14):
            _step(eng)
        lat = _latency(rq, sp, tag, i)
        eng.add_request(lat)
        _drive(eng)
        for r in (victim, lat):
            outs[r.request_id.split("-", 1)[1]] = _collect(r)
    if inject is not None:
        eng._faults = fault_cls("")
    return outs, [a - b for a, b in zip(_counts(eng), before)]


def _clean(eng):
    """Nothing swapped out, no reserved host bytes, no parked victim."""
    swap = eng._swap
    assert swap is None or (len(swap) == 0 and swap.bytes_used == 0)
    assert eng._host is None or eng._host.reserved == 0
    assert eng.metrics.requests_parked.get(reason="preempt") == 0


def _compare(weights, key, tag, guided=False, inject=None):
    """The scenario on the JAX engine and the port's, preemption on, and
    on the port's with it off: equal streams and counts."""
    want, jcounts = _run_scenario(
        jax_engine(weights, key), JaxRequest, JaxSamplingParams, tag,
        guided, inject, ref_faults.FaultInjector)
    base, _ = _run_scenario(port_engine(weights, key, preempt=False),
                            Request, SamplingParams, tag, guided)
    eng = port_engine(weights, key)
    got, counts = _run_scenario(eng, Request, SamplingParams, tag, guided,
                                inject, faults.FaultInjector)
    assert got == base, (tag, got, base)
    assert got == want, (tag, got, want)
    assert counts == jcounts, (tag, counts, jcounts)
    assert counts[2] == 0
    if inject is None:
        # Every victim preempted once.
        assert counts[0] == len(got) // 2
    assert eng.state == "serving"
    _clean(eng)
    _clean(jax_engine(weights, key))
    return eng


# ---------------------------------------------------------------------------
# Streams against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", ["swap-0", "swap-2", "legacy-paged"])
def test_preempt_swap_streams_equal_reference(weights, key):
    """Swap mode on a paged pool with the host tier: greedy, seeded and
    guided victims are swapped out and resumed, and every stream (the
    victims' and the arrivals') equals the preemption-off run's and the
    JAX engine's, at depths 0 and 2 on the mixed scheduler and at depth 2
    on the legacy one."""
    eng = _compare(weights, key, f"swap-{key}", guided=True)
    assert eng.resolved_config["preempt"] == "swap"
    assert _observed(eng.metrics.preempt_swap_seconds) == 6


def test_preempt_swap_int4_pool_restores_the_packed_pages(weights,
                                                          monkeypatch):
    """An int4 pool: the swap takes the raw nibble pairs and scale
    stripes, so each victim's pages come back exactly as they were when
    it was preempted, and the streams equal the reference's."""
    taken, back = {}, {}
    real_issue = engine_mod.InferenceEngine._issue_preempt_swap
    real_finish = engine_mod.InferenceEngine._finish_resume

    def pages_of(eng, pages):
        return [[t[:, p].clone() for t in eng.cache if t is not None]
                for p in pages]

    def issue(self, slot):
        n = -(-int(self._lengths[slot]) // self._page)
        taken[self._slots[slot].request.request_id] = pages_of(
            self, self._slot_pages[slot][:n])
        return real_issue(self, slot)

    def finish(self, res):
        back[res.request.request_id] = pages_of(self, res.pages)
        return real_finish(self, res)

    monkeypatch.setattr(engine_mod.InferenceEngine, "_issue_preempt_swap",
                        issue)
    monkeypatch.setattr(engine_mod.InferenceEngine, "_finish_resume", finish)
    eng = _compare(weights, "int4", "int4")
    assert eng.kv_bits == 4 and eng.cache.k.dtype == torch.int8
    assert eng.resolved_config["preempt"] == "swap"
    assert set(taken) == set(back) and len(taken) == 2
    for rid, pages in taken.items():
        assert len(pages) == len(back[rid])
        for a, b in zip(pages, back[rid]):
            assert all(torch.equal(x, y) for x, y in zip(a, b)), rid


@pytest.mark.parametrize("key", ["host-off", "slot"])
def test_preempt_replay_fallback_streams_equal_reference(weights, key):
    """Replay mode where there is no host tier (a paged pool with
    ``ARKS_PREFIX_HOST_MB=0``, the slot layout on the legacy scheduler):
    the victim re-queues behind a replay gate and re-runs, and every
    stream equals the preemption-off run's and the JAX engine's."""
    eng = _compare(weights, key, f"replay-{key}")
    assert eng.resolved_config["preempt"] == "replay"
    assert eng._swap is None and not eng._resuming
    assert _observed(eng.metrics.preempt_swap_seconds) == 0


def test_replay_victim_reuses_no_prefix_its_original_did_not(weights,
                                                             monkeypatch):
    """On the slot cache with its host prefix cache, a replay-mode victim
    whose original was a one-shot admission (its full block harvested into
    the prefix cache) re-prefills one-shot, not chunked after its own
    cached block: a prefill in other shapes than the original's would
    change its later tokens' bits on the card.  Its stream equals the
    preemption-off run's."""
    seen = {}
    real = engine_mod.InferenceEngine._register_slot

    def spy(self, req, slot, first, num_prompt, first_lp=None, shape=None):
        seen.setdefault(req.request_id, []).append(shape)
        return real(self, req, slot, first, num_prompt, first_lp, shape)

    monkeypatch.setattr(engine_mod.InferenceEngine, "_register_slot", spy)
    outs = {}
    for preempt in (False, True):
        with _env(**_config_env("slot", preempt)):
            eng = InferenceEngine(get_config(NAME), EngineConfig(
                kv_layout="slot", **dict(KW, prefix_cache_mb=64)),
                ByteTokenizer(), params=weights[1], device="cpu")
        victim = Request(f"pfx-{preempt}-v", list(range(3, 23)),
                         SamplingParams(max_tokens=12, temperature=0.0,
                                        ignore_eos=True, priority=1))
        eng.add_request(victim)
        for _ in range(6):
            _step(eng)
        lat = _latency(Request, SamplingParams, f"pfx-{preempt}", 0)
        eng.add_request(lat)
        _drive(eng)
        outs[preempt] = (_collect(victim), _collect(lat))
        assert eng.metrics.requests_preempted_total.total() == int(preempt)
    assert outs[True] == outs[False]
    first, again = seen["pfx-True-v"]
    assert first.admit_m and again == first


def test_full_host_budget_falls_back_to_replay(weights):
    """A swap the host budget cannot hold is refused, and the victim
    preempts in replay mode instead: the streams still equal the
    reference's (its budget cut alike)."""
    jeng = jax_engine(weights, "swap-0")
    cap = jeng._host.capacity
    jeng._host.capacity = 1024
    try:
        want, jcounts = _run_scenario(jeng, JaxRequest, JaxSamplingParams,
                                      "full")
    finally:
        jeng._host.capacity = cap
    eng = port_engine(weights, "swap-0")
    eng._host.capacity = 1024
    got, counts = _run_scenario(eng, Request, SamplingParams, "full")
    assert got == want and counts == jcounts and counts[0] == 2
    assert _observed(eng.metrics.preempt_swap_seconds) == 0
    assert not eng._swap and not eng._resuming
    _clean(eng)


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("nth,where", [(1, "spill-issue"), (2, "harvest"),
                                       (3, "resume")],
                         ids=["spill-issue", "harvest", "resume"])
def test_preempt_fault_recovers_like_the_reference(weights, depth, nth,
                                                   where):
    """A ``preempt`` fault at its spill issue (1st fire), harvest (2nd)
    or resume (3rd) faults that attempt alone: the victim replays and
    every stream equals the fault-free one and the JAX engine's, with one
    fault and no quarantine, at depths 0 and 2."""
    eng = _compare(weights, f"swap-{depth}", f"f{nth}-{depth}", guided=True,
                   inject=f"preempt:{nth}:runtime")
    assert eng.metrics.engine_faults_total.get(phase="preempt",
                                               kind="injected") == 1


# ---------------------------------------------------------------------------
# Host bytes: an abort while swapped out, the shared budget
# ---------------------------------------------------------------------------


def _swap_out(eng, rq, sp, tag):
    """A 40-token victim and a 30-token arrival that seizes its slot,
    stepped until the victim sits in the SwapStore."""
    victim = rq(f"{tag}-victim", [5, 6, 7], sp(
        max_tokens=40, temperature=0.0, ignore_eos=True, priority=1))
    eng.add_request(victim)
    for _ in range(14):
        _step(eng)
    lat = _latency(rq, sp, tag, 0, max_tokens=30)
    eng.add_request(lat)
    for _ in range(400):
        _step(eng)
        if victim.request_id in eng._swapped and \
                victim.request_id in eng._swap:
            return victim, lat
    raise AssertionError("the victim never reached the SwapStore")


def test_abort_while_swapped_releases_the_host_bytes(weights):
    """An abort while the victim's state sits in host RAM ends it as an
    abort and gives the SwapStore bytes and the tier's reservation back;
    the parked gauge ends at zero.  The same bytes and outcomes as the
    reference's."""
    seen = []
    for eng, rq, sp in ((jax_engine(weights, "swap-0"), JaxRequest,
                         JaxSamplingParams),
                        (port_engine(weights, "swap-0"), Request,
                         SamplingParams)):
        victim, lat = _swap_out(eng, rq, sp, "abort")
        swapped = (eng._swap.bytes_used, eng._host.reserved,
                   eng.metrics.requests_parked.get(reason="preempt"))
        eng.abort(victim.request_id)
        _drive(eng)
        seen.append((swapped, _collect(victim)[1], _collect(lat)))
        _clean(eng)
    assert eng.metrics.num_requests_waiting.get() == 0
    (jsw, jfin, jlat), (sw, fin, lat) = seen
    assert sw == jsw and sw[0] > 0 and sw[0] == sw[1] and sw[2] == 1
    assert fin == jfin == "abort" and lat == jlat


def test_abort_mid_resume_leaves_no_shaping_in_the_slot(weights):
    """A penalized, biased victim aborted while its resume's scatter is in
    flight gives its slot back with the shaping columns the resume wrote
    at their identity values: the request without shaping that takes the
    slot next, beside a penalized and biased stream (so the penalty and
    bias passes run),
    streams as it does on a preemption-off engine, and so does the
    penalized bystander."""
    two = dict(KW, num_slots=2)
    bystander = dict(max_tokens=50, temperature=0.0, ignore_eos=True,
                     priority=1, presence_penalty=1.5, frequency_penalty=1.0,
                     logit_bias=[(3, 0.5)])

    def engine(preempt):
        with _env(**_config_env("swap-0", preempt)):
            return InferenceEngine(get_config(NAME), EngineConfig(
                kv_layout="paged", **two), ByteTokenizer(),
                params=weights[1], device="cpu")

    def clean_slot(eng, slot):
        st = eng._sampling
        return (not st.presence[slot].any() and not st.frequency[slot].any()
                and bool((st.bias_ids[slot] == -1).all())
                and int(st.guide[slot]) == -1)

    eng = engine(True)
    pen = Request("mid-pen", [4, 4, 4], SamplingParams(**bystander))
    victim = Request("mid-victim", [5, 6, 7], SamplingParams(
        max_tokens=40, temperature=0.0, ignore_eos=True, priority=1,
        presence_penalty=2.0, frequency_penalty=2.0, logit_bias=[(77, 100.0)]))
    eng.add_request(pen)
    for _ in range(2):
        _step(eng)
    eng.add_request(victim)
    for _ in range(10):
        _step(eng)
    lat = _latency(Request, SamplingParams, "mid", 0)
    eng.add_request(lat)
    for _ in range(400):
        _step(eng)
        resuming = [r for r in eng._awaiting_restore
                    if isinstance(r, engine_mod._ResumeState)]
        if resuming:
            break
    else:
        raise AssertionError("the victim never resumed")
    (res,) = resuming
    assert res.rec.request is victim
    assert not clean_slot(eng, res.slot)    # the resume wrote its row
    eng.abort(victim.request_id)
    _step(eng)
    assert res.slot in eng._free and clean_slot(eng, res.slot)
    plain = Request("mid-plain", [9, 8, 7, 6], SamplingParams(
        max_tokens=8, temperature=0.0, ignore_eos=True, priority=1))
    eng.add_request(plain)
    _drive(eng)
    assert _collect(victim)[1] == "abort"
    assert eng.metrics.requests_preempted_total.total() == 1
    got = (_collect(pen), _collect(plain))
    _clean(eng)

    ref = engine(False)
    pen = Request("mid-pen", [4, 4, 4], SamplingParams(**bystander))
    ref.add_request(pen)
    for _ in range(2):
        _step(ref)
    plain = Request("mid-plain", [9, 8, 7, 6], SamplingParams(
        max_tokens=8, temperature=0.0, ignore_eos=True, priority=1))
    ref.add_request(plain)
    _drive(ref)
    assert got == (_collect(pen), _collect(plain))


def test_swap_shares_the_host_tier_budget(weights):
    """The SwapStore's bytes are the host tier's reservation, and prefix
    blocks plus reservations stay inside the budget; after the drain the
    reservation is back to zero."""
    seen = []
    for eng, rq, sp in ((jax_engine(weights, "swap-0"), JaxRequest,
                         JaxSamplingParams),
                        (port_engine(weights, "swap-0"), Request,
                         SamplingParams)):
        _swap_out(eng, rq, sp, "share")
        t = eng._host
        assert t.reserved == eng._swap.bytes_used > 0
        assert t._bytes + t.reserved <= t.capacity
        seen.append(t.reserved)
        _drive(eng)
        _clean(eng)
    assert seen[0] == seen[1]


# ---------------------------------------------------------------------------
# Units: the SwapStore, the victim order, the knobs and the sampler row
# ---------------------------------------------------------------------------


def _entry(rng, n_blocks, vocab=64):
    blocks = [{"k": rng.standard_normal((2, 4, 8, 8)).astype(np.float32),
               "v": rng.standard_normal((2, 4, 8, 8)).astype(np.float32)}
              for _ in range(n_blocks)]
    return {"blocks": blocks, "key": np.array([1, 2], np.uint32),
            "counts": np.zeros((vocab,), np.int32), "guide_row": 0}


def _torch_entry(entry):
    return dict(entry, blocks=[{k: torch.from_numpy(v) for k, v in b.items()}
                               for b in entry["blocks"]],
                counts=torch.from_numpy(entry["counts"]))


def test_swap_store_matches_the_reference():
    """The same put/pop/discard/clear sequence on both stores, each over a
    host tier holding prefix blocks: the same refusals, entries, bytes,
    reservations and prefix-block evictions."""
    rng = np.random.default_rng(5)
    blk = _entry(rng, 1)["blocks"][0]
    blk_bytes = sum(a.nbytes for a in blk.values())
    cap = 10 * blk_bytes
    jt, tt = jprefix.HostPrefixTier(8, cap), tprefix.HostPrefixTier(8, cap)
    js, ts = jprefix.SwapStore(jt), tprefix.SwapStore(tt)
    digs = [bytes([i]) * 20 for i in range(8)]
    for d in digs:
        jt.put(d, blk)
        tt.put(d, {k: torch.from_numpy(v) for k, v in blk.items()})
    entries = {f"r{i}": _entry(rng, n) for i, n in enumerate((3, 2, 6, 1))}
    ops = [("put", "r0"), ("put", "r1"), ("put", "r0"), ("put", "r2"),
           ("pop", "r1"), ("put", "r2"), ("discard", "r9"), ("put", "r3"),
           ("discard", "r0"), ("pop", "r3"), ("put", "r1"), ("clear", None)]
    for op, rid in ops:
        if op == "put":
            got = (ts.put(rid, _torch_entry(entries[rid])),
                   js.put(rid, entries[rid]))
        elif op == "clear":
            got = (ts.clear(), js.clear())
        else:
            a, b = getattr(ts, op)(rid), getattr(js, op)(rid)
            got = (a is None, b is None) if op == "pop" else (a, b)
        assert got[0] == got[1], (op, rid)
        assert (ts.bytes_used, len(ts), tt.reserved, tt.bytes_used,
                list(tt._blocks)) == (js.bytes_used, len(js), jt.reserved,
                                      jt.bytes_used, list(jt._blocks))
        assert all((r in ts) == (r in js) for r in entries)


class _St:
    def __init__(self, rid, prio, n_gen, arrival):
        self.request = JaxRequest(rid, [1], JaxSamplingParams(
            priority=prio))
        self.request.arrival_time = arrival
        self.generated = [0] * n_gen


def test_victim_order_matches_the_reference():
    """``_preempt_victims`` on the same slot table, queue head, replaying
    and resuming sets and cooldowns: the same slots in the same order."""
    slots = {0: ("a", 2, 5, 1.0), 1: ("b", 1, 3, 2.0), 2: ("c", 2, 5, 3.0),
             3: ("d", 2, 9, 0.5), 4: ("e", 0, 1, 0.1), 5: ("f", 1, 1, 4.0),
             6: ("g", 2, 2, 5.0), 7: ("h", 3, 7, 6.0), 8: ("i", 3, 8, 7.0),
             9: ("j", 2, 5, 9.0)}
    got = []
    for cls in (engine_mod.InferenceEngine, jengine_mod.InferenceEngine):
        eng = cls.__new__(cls)

        class _Q:
            @staticmethod
            def head_prio():
                return 1

        eng._queue = _Q()
        eng._slots = {s: _St(*v) for s, v in slots.items()}
        eng._replaying, eng._resuming = {"g"}, {"h"}
        eng._preempt_cooldown_s = 2.0
        import time
        eng._preempt_last = {"c": time.monotonic()}
        eng._residency = None
        got.append(cls._preempt_victims(eng))
    assert got[0] == got[1] == [8, 9, 0, 3]


def test_preempt_knobs_and_modes(weights):
    """``ARKS_PREEMPT=1`` is served, no longer refused; the startup config
    reads off, swap or replay; the budget knobs validate as the
    reference's."""
    assert port_engine(weights, "swap-0", preempt=False).resolved_config[
        "preempt"] == "off"
    assert port_engine(weights, "swap-0").resolved_config["preempt"] == \
        "swap"
    assert port_engine(weights, "slot").resolved_config["preempt"] == \
        "replay"
    for knob, bad in (("ARKS_PREEMPT_MAX_INFLIGHT", "0"),
                      ("ARKS_PREEMPT_COOLDOWN_S", "-1")):
        with _env(**_config_env("swap-0"), **{knob: bad}):
            with pytest.raises(ValueError, match=knob):
                InferenceEngine(get_config(NAME), _ecfg(EngineConfig,
                                                         "swap-0"),
                                ByteTokenizer(), params=weights[1],
                                device="cpu")


def test_sampler_row_round_trip():
    """A slot's sampler row taken out and put back: the key and the DFA
    row through ``set_slots``, the counts restored after it (``set_slots``
    zeroes them)."""
    st = sampler_mod.init_sampling_state(3, 7, 16, "cpu")
    st.counts[1, 4] = 3
    st.guide_row[1] = 5
    key, counts, grow = sampler_mod.slot_row(st, 1)
    st.counts[1].zero_()
    st.key[1] = 0
    sampler_mod.set_slots(st, [2], [0.5], [1.0], [0], key[None],
                          guide_row=[int(grow)])
    sampler_mod.restore_counts(st, 2, counts)
    assert torch.equal(st.key[2], key) and int(st.guide_row[2]) == 5
    assert int(st.counts[2, 4]) == 3 and int(st.counts[2].sum()) == 3


def test_a_guide_that_publishes_mid_prefill_moves_every_chunk_cut(weights):
    """Why a harness that compares rounds of separate engines compiles
    their guides first (``chip_smoke.py``'s ``_pre_round``): a guided
    request admitted before its compile has published parks and joins the
    chunked prefill later, so the even quota (the chunk budget over the
    prompts prefilling) cuts every other prompt elsewhere, and on the card
    a row's bits depend on those cuts (``_ReplayShape``).  When the guide
    publishes depends on the compile's thread; compiled first, the cuts
    are the same in every run."""
    guide = ("regex", "[a-f]+")

    def run(gate=None):
        with _env(ARKS_MIXED_STEP="1", ARKS_PIPELINE_DEPTH="0"):
            eng = InferenceEngine(
                get_config(NAME),
                EngineConfig(**dict(KW, num_slots=4), kv_layout="paged"),
                ByteTokenizer(), params=weights[1], device="cpu")
        shapes = {}
        real = eng._register_slot

        def register(req, slot, first, num_prompt, first_lp=None,
                     shape=None):
            shapes.setdefault(req.request_id, shape)
            return real(req, slot, first, num_prompt, first_lp, shape)

        eng._register_slot = register
        if gate is None:
            eng.guides.compile(*guide)
        else:
            build = eng.guides._build

            def gated(rx):
                assert gate.wait(60)
                return build(rx)

            eng.guides._build = gated
        reqs = [Request(f"p{i}", [10 + i] * 24, SamplingParams(
                    max_tokens=2, temperature=0.0, ignore_eos=True))
                for i in range(3)]
        reqs.append(Request("g", [20] * 24, SamplingParams(
            max_tokens=2, temperature=0.0, ignore_eos=True, guide=guide)))
        for r in reqs:
            eng.add_request(r)
        if gate is not None:
            for _ in range(2):
                _step(eng)
            assert eng._awaiting_guide and 3 == len(eng._prefilling)
            gate.set()
            deadline = time.monotonic() + 60
            while eng.guides.lookup(*guide) is None:
                assert time.monotonic() < deadline
                time.sleep(0.01)
        _drive(eng)
        del eng._register_slot
        return {r.request_id: (_collect(r), shapes[r.request_id])
                for r in reqs}

    first, again = run(), run()
    assert first == again
    late = run(threading.Event())
    cuts = {k: (first[k][1].takes, late[k][1].takes) for k in first}
    assert cuts["p0"][0] == (4, 4, 4, 4, 4, 4)    # a quarter of 16 each
    assert all(a != b for a, b in cuts.values()), cuts
