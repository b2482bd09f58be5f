"""The port's tenant-fair admission queue against the reference's: the same
scripted puts, picks, aging ticks and clock moves give the same pick
order, the same ``QueueFullError`` (scope, tenant, depth, limit,
``retry_after``) and the same saturation reports, over several tenants
and tiers, weights, both bounds, the urgent heap and ``ARKS_FAIR=0``; with
one tenant the order is ``queue.PriorityQueue``'s.  Also the copies of the
SLO ladder and the tenant labels."""

import queue
import types

import numpy as np
import pytest

from arks_tpu import slo as ref_slo
from arks_tpu import tenancy as ref_tenancy
from arks_tpu.engine import fairqueue as ref_fq
from arks_tpu_torch import slo as port_slo
from arks_tpu_torch import tenancy as port_tenancy
from arks_tpu_torch.engine import fairqueue as port_fq


class _Clock:
    def __init__(self) -> None:
        self.now = 1000.0

    def monotonic(self) -> float:
        return self.now


def _request(rng, clock, tenants, tiers):
    return types.SimpleNamespace(
        tenant=tenants[int(rng.integers(len(tenants)))],
        prompt_ids=[0] * int(rng.integers(1, 600)),
        params=types.SimpleNamespace(
            max_tokens=int(rng.integers(1, 900)),
            priority=int(rng.choice(tiers))),
        arrival_time=clock.now)


def _run(mod, clock, script, **kw):
    """Replay ``script`` on one module's FairQueue; every observable result
    in order."""
    q = mod.FairQueue(**kw)
    out = []
    for op in script:
        kind = op[0]
        if kind == "tick":
            clock.now += op[1]
        elif kind == "put":
            _, item, bounded = op
            try:
                q.put(item, bounded=bounded)
                out.append(("put", None))
            except mod.QueueFullError as e:
                out.append(("full", e.scope, e.tenant, e.depth, e.limit,
                            e.retry_after))
        elif kind == "get":
            try:
                prio, seq, _ = q.get_nowait()
                out.append(("get", prio, seq))
            except queue.Empty:
                out.append(("empty",))
        elif kind == "age":
            q.age_tick(clock.now, op[1])
        out.append(("state", q.qsize(), q.head_prio(), q.retry_after(),
                    tuple(sorted(q.saturation().items()))))
    return out


def _script(seed, clock_start, tenants, tiers, n=400, urgent=True):
    """Puts (bounded from callers, unbounded re-queues, urgent replays),
    picks, aging ticks and clock moves, from ``seed``."""
    rng = np.random.default_rng(seed)
    clock = _Clock()
    clock.now = clock_start
    script, seq = [], 0
    for _ in range(n):
        r = rng.random()
        if r < 0.5:
            seq += 1
            req = _request(rng, clock, tenants, tiers)
            prio = req.params.priority
            if urgent and rng.random() < 0.05:
                prio -= 2 ** 20
            script.append(("put", (prio, seq, req), rng.random() < 0.8))
        elif r < 0.85:
            script.append(("get",))
        elif r < 0.93:
            dt = float(rng.choice([0.01, 0.3, 2.0, 7.5]))
            clock.now += dt
            script.append(("tick", dt))
        else:
            script.append(("age", float(rng.choice([0.0, 1.0, 5.0]))))
    return script


CONFIGS = {
    "fair": dict(fair=True, quantum=512, weights={}, max_total=0,
                 max_tenant=0),
    "weighted": dict(fair=True, quantum=300,
                     weights={"ns/a": 3.0, "ns/b": 0.5}, max_total=0,
                     max_tenant=0),
    "bounded": dict(fair=True, quantum=512, weights={"ns/a": 2.0},
                    max_total=12, max_tenant=5),
    "flat": dict(fair=False, quantum=512, weights={}, max_total=10,
                 max_tenant=4),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_scripted_sequences_equal_reference(config, seed, monkeypatch):
    """Several tenants (``None`` = the default lane) and tiers: identical
    picks, refusals, Retry-After values and saturation reports, on one
    fake clock that both modules read."""
    tenants = ["ns/a", "ns/b", "ns/c", None]
    script = _script(seed, 1000.0, tenants, tiers=[0, 1, 2])
    results = []
    for mod in (ref_fq, port_fq):
        clock = _Clock()
        monkeypatch.setattr(mod, "time", clock)
        results.append(_run(mod, clock, script, **CONFIGS[config]))
    assert results[0] == results[1]
    kinds = {r[0] for r in results[0]}
    assert "get" in kinds
    if CONFIGS[config]["max_total"]:
        assert any(r[0] == "full" and r[1] == "tenant" for r in results[0])


def test_single_tenant_order_is_the_priority_queue(monkeypatch):
    """One tenant: the fair queue pops in ``queue.PriorityQueue``'s
    priority-then-FIFO order (the reference's invariance contract)."""
    clock = _Clock()
    monkeypatch.setattr(port_fq, "time", clock)
    rng = np.random.default_rng(4)
    fq, pq = port_fq.FairQueue(fair=True, quantum=64, weights={},
                               max_total=0, max_tenant=0), \
        queue.PriorityQueue()
    got, want = [], []
    seq = 0
    for step in range(300):
        if rng.random() < 0.6:
            seq += 1
            req = _request(rng, clock, ["only"], [0, 1, 2, 3])
            item = (req.params.priority, seq, req)
            fq.put(item, bounded=True)
            pq.put(item)
        elif not pq.empty():
            got.append(fq.get_nowait()[1])
            want.append(pq.get_nowait()[1])
    while not pq.empty():
        got.append(fq.get_nowait()[1])
        want.append(pq.get_nowait()[1])
    assert got == want and fq.empty()


def test_settings_and_copies_match_reference(monkeypatch):
    """The local settings reader's defaults are the reference registry's;
    the SLO ladder and tenant labels behave as the reference's."""
    from arks_tpu.utils import knobs as ref_knobs
    from arks_tpu_torch import knobs
    for name, default in knobs.DEFAULTS.items():
        assert ref_knobs.REGISTRY[name].default == default, name
    spec = "latency:ttft_ms=300;tpot_ms=50,interactive:ttft_ms=1500,batch:"
    a, b = ref_slo.parse_tiers(spec), port_slo.parse_tiers(spec)
    assert [vars(t) for t in a.tiers] == [vars(t) for t in b.tiers]
    for p in (-(2 ** 20), 0, 1, 2, 9):
        assert a.tier_of(p) == b.tier_of(p)
    for bad in ("x:ttft_ms=-1", "a,a", "a:foo=1", "b@d"):
        with pytest.raises(ValueError):
            ref_slo.parse_tiers(bad)
        with pytest.raises(ValueError):
            port_slo.parse_tiers(bad)
    ra, pa = ref_tenancy.TenantLabels(cap=3), port_tenancy.TenantLabels(cap=3)
    seq = ["t1", None, "t2", "t3", "t4", "t1", "t9"]
    assert [ra.label(t) for t in seq] == [pa.label(t) for t in seq]
    assert ref_tenancy.parse_weights("a/b:2,c:0.5") == \
        port_tenancy.parse_weights("a/b:2,c:0.5")
    monkeypatch.setenv("ARKS_FAIR", "0")
    monkeypatch.setenv("ARKS_QUEUE_TENANT_MAX", "3")
    q = port_fq.FairQueue()
    assert not q.fair and q.max_tenant == 3 and q.quantum == 512
