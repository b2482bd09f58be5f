"""The port's operator held against the reference's (``arks_tpu.control``):
the same manifests through both ``build_manager`` stacks over their fake
gang drivers settle into the same objects, workloads and routes; the pure
functions, the store's events and the autoscaler decide alike; and the
port refuses what it does not deploy (``runtime: jax``, TPU accelerators,
Orbax conversion, a DisaggregatedApplication it cannot serve)."""

import copy
import glob
import itertools
import os
import sys
import time

import pytest
import yaml

from arks_tpu.control import autoscaler as ref_autoscaler
from arks_tpu.control import resources as ref_res
from arks_tpu.control import store as ref_store
from arks_tpu.control import workloads as ref_workloads
from arks_tpu.control.__main__ import apply_manifests as ref_apply
from arks_tpu.control.manager import build_manager as ref_build
from arks_tpu_torch.control import autoscaler as port_autoscaler
from arks_tpu_torch.control import resources as res
from arks_tpu_torch.control import store as port_store
from arks_tpu_torch.control import workloads
from arks_tpu_torch.control.__main__ import apply_manifests
from arks_tpu_torch.control.manager import build_manager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFESTS = sorted(
    p for p in glob.glob(os.path.join(REPO, "examples", "samples", "*.yaml"))
    if not p.endswith("disaggregated.yaml")) + [
    os.path.join(REPO, "examples", "quickstart", "quickstart.yaml")]


def wait_for(predicate, timeout=15.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = predicate()
        if v:
            return v
        time.sleep(interval)
    raise AssertionError("condition not met within timeout")


def _docs():
    """Every document of the parity manifests.  ``convertOrbax`` is
    dropped for both operators: the port refuses it (its own test below),
    and the reference would convert an empty download."""
    docs = []
    for path in MANIFESTS:
        for d in yaml.safe_load_all(open(path)):
            if d:
                d.get("spec", {}).pop("convertOrbax", None)
                docs.append(d)
    return docs


def _port_doc(doc):
    """The port's form of a reference manifest: ``runtime: jax`` is
    ``torch`` and a TPU accelerator is dropped."""
    doc = copy.deepcopy(doc)
    spec = doc.get("spec", {})
    if doc["kind"] == "Application":
        if spec.get("runtime", "jax") == "jax":
            spec["runtime"] = "torch"
        if str(spec.get("accelerator", "")).startswith("tpu-"):
            del spec["accelerator"]
    return doc


def _write(tmp_path, name, docs):
    path = tmp_path / name
    path.write_text(yaml.safe_dump_all(docs))
    return str(path)


def _no_download(model, dest):
    os.makedirs(dest, exist_ok=True)


def _settle(mgr, store, res_mod, apps):
    assert mgr.wait_idle(timeout=30)
    for ns, name in apps:
        wait_for(lambda: store.get(res_mod.Application, name, ns).status.get(
            "phase") == res_mod.PHASE_RUNNING)
    assert mgr.wait_idle(timeout=30)


def _strip_times(obj):
    if isinstance(obj, dict):
        return {k: _strip_times(v) for k, v in obj.items()
                if k not in ("last_transition_time", "lastUpdateTime")}
    if isinstance(obj, list):
        return [_strip_times(v) for v in obj]
    return obj


def _objects(store, res_mod):
    out = {}
    for cls in res_mod.ALL_KINDS:
        for o in store.list(cls):
            out[(o.KIND, o.namespace, o.name)] = dict(
                labels=o.labels, owner_refs=o.owner_refs,
                finalizers=sorted(o.finalizers),
                status=_strip_times(o.status))
    return out


def _port_argv(argv):
    """The reference's serve command as the port's: ``-m arks_tpu.server``
    -> ``-m arks_tpu_torch.server`` and ``--platform`` -> ``--device``."""
    return ["arks_tpu_torch.server" if a == "arks_tpu.server" else
            "--device" if a == "--platform" else a for a in argv]


def test_controllers_settle_like_the_reference(tmp_path):
    docs = _docs()
    ref_mgr = ref_build(models_root=str(tmp_path / "models"),
                        driver=ref_workloads.FakeGangDriver(),
                        fetcher=_no_download, local_platform="cpu")
    mgr = build_manager(models_root=str(tmp_path / "models"),
                        driver=workloads.FakeGangDriver(),
                        fetcher=_no_download, local_device="cpu")
    apps = [(d["metadata"].get("namespace", "default"), d["metadata"]["name"])
            for d in docs if d["kind"] == "Application"]
    assert len(apps) == 2
    ref_mgr.start()
    mgr.start()
    try:
        ref_apply(ref_mgr.store, _write(tmp_path, "ref.yaml", docs))
        apply_manifests(mgr.store, _write(
            tmp_path, "port.yaml", [_port_doc(d) for d in docs]))
        _settle(ref_mgr, ref_mgr.store, ref_res, apps)
        _settle(mgr, mgr.store, res, apps)
        # Level-triggered controllers: poll until both stores rest alike
        # (a watch event may still be on its way under load).
        try:
            wait_for(lambda: _objects(mgr.store, res)
                     == _objects(ref_mgr.store, ref_res))
        except AssertionError:
            pass                      # the comparisons below say where
        want = _objects(ref_mgr.store, ref_res)
        got = _objects(mgr.store, res)
        assert set(got) == set(want)
        assert {k[0] for k in got} == {"Model", "Application", "Endpoint",
                                       "Token", "Quota", "GangSet",
                                       "Service"}
        for key in want:
            assert got[key] == want[key], key
        for ns, name in apps:
            rg = ref_mgr.store.get(ref_res.GangSet, name, ns).spec
            pg = mgr.store.get(res.GangSet, name, ns).spec
            assert pg["runtime"] == "torch" and rg["runtime"] == "jax"
            assert pg["image"] == "arks-tpu-torch/engine:latest"
            assert pg["accelerator"] == "cpu"
            for role in ("leader", "worker"):
                argv = pg[role]["command"]
                assert argv[:3] == [sys.executable, "-m",
                                    "arks_tpu_torch.server"]
                assert argv[argv.index("--device") + 1] == "cpu"
                assert argv == _port_argv(rg[role]["command"])
                assert pg[role]["env"] == rg[role]["env"]
            skip = {"leader", "worker", "runtime", "image", "accelerator"}
            assert {k: v for k, v in pg.items() if k not in skip} == \
                {k: v for k, v in rg.items() if k not in skip}
        for ep in ref_mgr.store.list(ref_res.Endpoint):
            assert ep.status["routes"]
            assert mgr.store.get(res.Endpoint, ep.name, ep.namespace).status \
                == ep.status
    finally:
        ref_mgr.stop()
        mgr.stop()


def test_serve_command_is_the_references_with_device():
    for kw in (dict(), dict(model_path="/models/x", context_parallel=4,
                            num_slices=2), dict(model_path="/m")):
        for dev in (None, "cpu"):
            want = ref_workloads.jax_serve_command(
                "qwen2.5-7b", "served", "$(PORT)", 2, 1, ["--seed", "3"],
                platform=dev, **kw)
            got = workloads.torch_serve_command(
                "qwen2.5-7b", "served", "$(PORT)", 2, 1, ["--seed", "3"],
                device=dev, **kw)
            assert got == _port_argv(want)
            assert ("--device" in got) == (dev is not None)
    for rt in ("vllm", "sglang", "dynamo"):
        assert workloads.gpu_runtime_command(rt, "/m", "s", 2, 3, ["-x"]) == \
            ref_workloads.gpu_runtime_command(rt, "/m", "s", 2, 3, ["-x"])
        assert workloads.default_runtime_image(rt) == \
            ref_workloads.default_runtime_image(rt)


def test_pick_rolling_restart_and_spec_hash_agree():
    n = 0
    for hashes in itertools.product(("old", "new"), repeat=3):
        for ready in itertools.product((False, True), repeat=3):
            h = dict(enumerate(hashes))
            r = dict(enumerate(ready))
            assert workloads.pick_rolling_restart(h, "new", r) == \
                ref_workloads.pick_rolling_restart(h, "new", r), (h, r)
            n += 1
    assert n == 64
    specs = [{}, {"size": 2, "leader": {"command": ["a", "b"], "env": {}},
                  "replicas": 3},
             {"size": 1, "ports": {"http": 8080}, "runtime": "torch",
              "image": "i", "accelerator": "cpu", "modelPvc": "models",
              "replicas": 1}]
    for spec in specs:
        assert workloads.spec_hash(res.GangSet(name="g", spec=spec)) == \
            ref_workloads.spec_hash(ref_res.GangSet(name="g", spec=spec))
    # replicas is left out of the hash, in both.
    a = workloads.spec_hash(res.GangSet(name="g", spec=specs[2]))
    b = workloads.spec_hash(res.GangSet(name="g", spec=dict(
        specs[2], replicas=5)))
    assert a == b


def _events(q):
    out = []
    while not q.empty():
        ev, o = q.get_nowait()
        out.append((ev, o.KIND, o.name, o.resource_version,
                    o.deletion_requested, tuple(o.finalizers)))
    return out


def _store_script(store_mod, res_mod):
    s = store_mod.Store()
    s.create(res_mod.Model(name="pre"))
    qs = {k: s.watch(k) for k in (res_mod.Model, res_mod.Application,
                                  res_mod.GangSet)}
    errors = []
    m = s.get(res_mod.Model, "pre")
    m.spec["model"] = "x"
    s.update(m)
    try:
        s.update(m)                       # stale resourceVersion
    except store_mod.Conflict:
        errors.append("conflict")
    app = s.create(res_mod.Application(name="a1"))
    s.add_finalizer(app, "test/fin")
    s.create(res_mod.GangSet(name="g1", owner_refs=[("Application", "a1")]))
    s.update_status(res_mod.Application(name="a1", status={"phase": "x"}))
    s.delete(res_mod.Application, "a1")   # held by the finalizer
    s.delete(res_mod.Application, "a1")   # already marked: no event
    s.strip_finalizer(s.get(res_mod.Application, "a1"), "test/fin")
    try:
        s.get(res_mod.GangSet, "g1")
    except store_mod.NotFound:
        errors.append("cascaded")
    s.delete(res_mod.Model, "pre")
    return {k.KIND: _events(q) for k, q in qs.items()}, errors


def test_store_events_and_finalizers_agree():
    want = _store_script(ref_store, ref_res)
    got = _store_script(port_store, res)
    assert got == want
    assert want[1] == ["conflict", "cascaded"]
    # add_finalizer notifies no one; status, the deletion mark and the
    # finalizer's strip do.
    assert [e[0] for e in want[0]["Application"]] == [
        "ADDED", "MODIFIED", "MODIFIED", "MODIFIED", "DELETED"]


class _Clock:
    """A module's ``time`` with a scripted monotonic clock."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


def _autoscale_run(mod, store_mod, res_mod, monkeypatch, signals):
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    store = store_mod.Store()
    store.create(res_mod.Application(name="auto", spec={
        "replicas": 1, "model": {"name": "m"}, "servedModelName": "s",
        "autoscale": {"minReplicas": 1, "maxReplicas": 4,
                      "targetRPMPerReplica": 100,
                      "scaleDownStabilizationSeconds": 5}},
        status={"readyReplicas": 1}))
    step = {"rpm": 0.0, "sig": None}
    ctl = mod.AutoscalerController(
        store, rate_source=lambda ns, m: step["rpm"],
        signals_source=(lambda ns, m: step["sig"]) if signals else None)
    seq = ([(250.0, None), (420.0, None), (90.0, None), (90.0, None),
            (10.0, None), (10.0, None), (0.0, None), (300.0, None)]
           if not signals else
           [(0, {"burn": 2.0, "saturation": 0.1}),
            (0, {"burn": 2.0, "saturation": 0.1}),
            (0, {"burn": 0.5, "saturation": 0.95}),
            (0, None),
            (0, {"burn": 0.1, "saturation": 0.1}),
            (0, {"burn": 0.1, "saturation": 0.1}),
            (0, {"burn": 0.1, "saturation": 0.1}),
            (0, {"burn": 0.6, "saturation": 0.5})])
    decisions = []
    for rpm, sig in seq:
        step["rpm"], step["sig"] = rpm, sig
        ctl.reconcile(store.get(res_mod.Application, "auto"))
        app = store.get(res_mod.Application, "auto")
        decisions.append((app.spec["replicas"],
                          app.status.get("autoscale")))
        clock.now += 20.0
    return decisions


@pytest.mark.parametrize("signals", [False, True], ids=["rpm", "signals"])
def test_autoscaler_decides_like_the_reference(monkeypatch, signals):
    want = _autoscale_run(ref_autoscaler, ref_store, ref_res, monkeypatch,
                          signals)
    got = _autoscale_run(port_autoscaler, port_store, res, monkeypatch,
                         signals)
    assert got == want
    reps = [1] + [d[0] for d in want]
    steps = list(zip(reps, reps[1:]))
    assert any(b > a for a, b in steps) and any(b < a for a, b in steps)


@pytest.fixture()
def stack(tmp_path):
    mgr = build_manager(models_root=str(tmp_path / "models"),
                        driver=workloads.FakeGangDriver(),
                        fetcher=_no_download, local_device="cpu")
    mgr.start()
    yield mgr, mgr.store
    mgr.stop()


def _phase(store, name, phase):
    return wait_for(lambda: (lambda a: a.phase == phase and a)(
        store.get(res.Application, name)))


def _cond(obj, typ):
    return {c["type"]: c for c in obj.status["conditions"]}[typ]


def test_runtime_defaults_to_torch_and_jax_is_refused(stack):
    mgr, store = stack
    store.create(res.Model(name="m", spec={"model": "org/m"}))
    store.create(res.Application(name="plain", spec={
        "model": {"name": "m"}, "modelConfig": "tiny"}))
    store.create(res.Application(name="jax-app", spec={
        "runtime": "jax", "model": {"name": "m"}, "modelConfig": "tiny"}))
    gs = wait_for(lambda: store.try_get(res.GangSet, "plain"))
    _phase(store, "jax-app", res.PHASE_FAILED)
    assert mgr.wait_idle()
    assert gs.spec["runtime"] == "torch"
    assert "arks_tpu_torch.server" in gs.spec["leader"]["command"]
    app = store.get(res.Application, "jax-app")
    assert app.status["phase"] == res.PHASE_FAILED
    c = _cond(app, res.COND_PRECHECK)
    assert (c["status"], c["reason"]) == ("False", "InvalidRuntime")
    assert "'jax'" in c["message"]
    assert store.try_get(res.GangSet, "jax-app") is None


@pytest.mark.parametrize("accel", ["tpu-v5e-16", "tpu-v5p-16x2", "tpu-v5e-8"])
def test_tpu_accelerator_is_refused(stack, accel):
    mgr, store = stack
    store.create(res.Model(name="m", spec={"model": "org/m"}))
    store.create(res.Application(name="a", spec={
        "model": {"name": "m"}, "modelConfig": "tiny",
        "accelerator": accel}))
    app = _phase(store, "a", res.PHASE_FAILED)
    assert mgr.wait_idle()
    assert app.status["phase"] == res.PHASE_FAILED
    c = _cond(app, res.COND_PRECHECK)
    assert (c["status"], c["reason"]) == ("False", "InvalidSpec")
    assert accel in c["message"] and "TPU" in c["message"]
    assert store.try_get(res.GangSet, "a") is None


def test_gpu_accelerator_and_size_shape_the_gang(stack):
    mgr, store = stack
    store.create(res.Model(name="m", spec={"model": "org/m"}))
    store.create(res.Application(name="a", spec={
        "model": {"name": "m"}, "modelConfig": "tiny", "size": 2,
        "accelerator": "nvidia-h100-80gb", "contextParallel": 2}))
    store.create(res.Application(name="b", spec={
        "model": {"name": "m"}, "modelConfig": "tiny"}))
    ga = wait_for(lambda: store.try_get(res.GangSet, "a")).spec
    assert ga["size"] == 2 and ga["accelerator"] == "nvidia-h100-80gb"
    assert "--context-parallel-size" in ga["leader"]["command"]
    assert wait_for(lambda: store.try_get(res.GangSet, "b")).spec[
        "size"] == 1


@pytest.mark.parametrize("how", ["spec", "env"])
def test_orbax_conversion_fails_the_model(stack, monkeypatch, how):
    mgr, store = stack
    spec = {"model": "org/m", "source": {"local": {"path": "/nowhere"}}}
    if how == "spec":
        spec["convertOrbax"] = True
    else:
        monkeypatch.setenv("ARKS_CONVERT_ORBAX", "1")
    store.create(res.Model(name="m", spec=spec))
    store.create(res.Application(name="a", spec={
        "model": {"name": "m"}, "modelConfig": "tiny"}))
    m = wait_for(lambda: (lambda m: m.phase == res.MODEL_PHASE_FAILED and m)(
        store.get(res.Model, "m")))
    _phase(store, "a", res.PHASE_LOADING)
    assert mgr.wait_idle()
    c = _cond(m, res.COND_MODEL_LOADED)
    assert (c["status"], c["reason"]) == ("False", "OrbaxUnsupported")
    assert "jax" in c["message"]
    assert store.get(res.Application, "a").status["phase"] == \
        res.PHASE_LOADING


def test_disaggregated_application_is_refused_and_nothing_applied(tmp_path):
    """The reference's sample DisaggregatedApplication applies and fails
    its precheck with the stated reason, and deploys nothing: as it is
    (``runtime: jax``), ``InvalidRuntime``; as the port's runtime, its TPU
    accelerators, then its ``contextParallel: 4``, ``InvalidSpec``.  An
    unknown kind raises and nothing of its file is applied."""
    mgr = build_manager(models_root=str(tmp_path / "models"),
                        driver=workloads.FakeGangDriver(),
                        fetcher=_no_download)
    store = mgr.store
    sample = [d for d in yaml.safe_load_all(open(os.path.join(
        REPO, "examples", "samples", "disaggregated.yaml"))) if d]
    (app,) = sample
    assert (app["spec"]["runtime"], app["spec"]["prefill"][
        "contextParallel"]) == ("jax", 4)
    torch_rt = copy.deepcopy(app)
    torch_rt["metadata"]["name"] = "qwen-pd-torch"
    torch_rt["spec"]["runtime"] = "torch"
    gpu = copy.deepcopy(torch_rt)
    gpu["metadata"]["name"] = "qwen-pd-gpu"
    for tier in ("prefill", "decode"):
        gpu["spec"][tier]["accelerator"] = "nvidia-h100"
    docs = [{"kind": "Model", "metadata": {"name": "qwen2.5-7b",
                                           "namespace": "team-a"},
             "spec": {}}, app, torch_rt, gpu]
    mgr.start()
    try:
        objs = apply_manifests(store, _write(tmp_path, "d.yaml", docs))
        assert [o.KIND for o in objs] == ["Model"] + [
            "DisaggregatedApplication"] * 3
        want = {"qwen-pd": ("InvalidRuntime",
                            "requires runtime 'torch', got 'jax'"),
                "qwen-pd-torch": ("InvalidSpec",
                                  "'tpu-v5e-8' is a TPU topology"),
                "qwen-pd-gpu": ("InvalidSpec",
                                "prefill.contextParallel=4: the port's "
                                "server runs one device per process")}
        for name, (reason, message) in want.items():
            a = wait_for(lambda: (lambda a: a.phase == res.PHASE_FAILED
                                  and a)(store.get(
                res.DisaggregatedApplication, name, "team-a")))
            c = _cond(a, res.COND_PRECHECK)
            assert (c["status"], c["reason"]) == ("False", reason)
            assert message in c["message"], c["message"]
        assert mgr.wait_idle()
        assert store.list(res.GangSet) == []
        assert store.list(res.Service) == []
    finally:
        mgr.stop()
    empty = port_store.Store()
    with pytest.raises(ValueError, match="unknown kind"):
        apply_manifests(empty, _write(tmp_path, "u.yaml", [
            {"kind": "Model", "metadata": {"name": "x"}, "spec": {}},
            {"kind": "Widget", "metadata": {"name": "w"}}]))
    assert empty.list(res.Model) == []


def test_apply_manifests_updates_a_spec(tmp_path):
    store = port_store.Store()
    doc = {"kind": "Token", "metadata": {"name": "t"},
           "spec": {"token": "a"}}
    apply_manifests(store, _write(tmp_path, "t1.yaml", [doc]))
    doc["spec"]["token"] = "b"
    apply_manifests(store, _write(tmp_path, "t2.yaml", [doc]))
    assert store.get(res.Token, "t").spec == {"token": "b"}


def test_port_quickstart_manifest(tmp_path):
    """The port's quickstart deploys two torch replicas of Qwen2.5-7B
    behind a token whose RPM limit the chip check crosses."""
    mgr = build_manager(models_root=str(tmp_path / "models"),
                        driver=workloads.FakeGangDriver(),
                        fetcher=_no_download)
    mgr.start()
    try:
        objs = apply_manifests(mgr.store, os.path.join(
            REPO, "examples", "quickstart", "quickstart_torch.yaml"))
        assert sorted(o.KIND for o in objs) == [
            "Application", "Endpoint", "Model", "Quota", "Token"]
        wait_for(lambda: mgr.store.get(res.Application, "qwen2.5-app")
                 .status.get("phase") == res.PHASE_RUNNING)
        cmd = mgr.store.get(res.GangSet, "qwen2.5-app").spec["leader"][
            "command"]
        assert cmd[2] == "arks_tpu_torch.server" and "--device" not in cmd
        assert cmd[cmd.index("--model") + 1] == "qwen2.5-7b"
        ep = wait_for(lambda: mgr.store.get(res.Endpoint, "qwen2.5")
                      .status.get("routes"))
        assert len(ep[0]["backend"]["addresses"]) == 2
    finally:
        mgr.stop()


def _environ(pid):
    with open(f"/proc/{pid}/environ", "rb") as f:
        return dict(kv.split("=", 1) for kv in
                    f.read().decode(errors="replace").split("\0") if "=" in kv)


def _gang_env(driver, gs):
    driver.ensure(gs)
    try:
        (group,) = driver._groups[gs.key].values()
        envs = [_environ(p.pid) for p in group.procs]
        port = group.port
    finally:
        driver.teardown(gs)
    return [{k: v for k, v in e.items() if k.startswith("ARKS_")}
            for e in envs], port


def test_local_driver_env_contract_matches_the_reference(tmp_path):
    """A size-2 group: every member gets the reference's variables (the
    gang's, the rendezvous the same for both members, the drain fitted to
    the driver's stop window), and from both drivers alike."""
    spec = {"replicas": 1, "size": 2, "leader": {"command": [
        sys.executable, "-c", "import time; time.sleep(60)"],
        "env": {"ARKS_TRACE": "0"}}}
    want, wport = _gang_env(ref_workloads.LocalProcessDriver(
        str(tmp_path / "ref")), ref_res.GangSet(name="g", spec=spec))
    got, port = _gang_env(workloads.LocalProcessDriver(
        str(tmp_path / "port")), res.GangSet(name="g", spec=spec))
    for env, lport in ((want, wport), (got, port)):
        assert [e["ARKS_PROCESS_ID"] for e in env] == ["0", "1"]
        assert [e["ARKS_GANG_WORKER_INDEX"] for e in env] == ["0", "1"]
        for e in env:
            assert e["ARKS_GANG_SIZE"] == e["ARKS_NUM_PROCESSES"] == "2"
            assert e["ARKS_GANG_LEADER_ADDRESS"] == f"127.0.0.1:{lport}"
            assert e["ARKS_DRAIN_TIMEOUT"] == "8" and e["ARKS_TRACE"] == "0"
        for k in ("ARKS_COORDINATOR_ADDRESS", "ARKS_DISPATCH_ADDRESS",
                  "ARKS_GANG_SECRET"):
            assert env[0][k] == env[1][k]
    mine = lambda env: [{k: v for k, v in e.items() if k not in (
        "ARKS_COORDINATOR_ADDRESS", "ARKS_DISPATCH_ADDRESS",
        "ARKS_GANG_SECRET", "ARKS_GANG_LEADER_ADDRESS")} for e in env]
    assert mine(got) == mine(want)

