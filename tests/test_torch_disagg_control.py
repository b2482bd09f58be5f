"""The port's DisaggregatedApplication controller held against the
reference's (``arks_tpu.control.disaggregated_controller``): the same
manifests through both ``build_manager`` stacks over their fake gang
drivers settle into the same GangSets (argv mapped ``arks_tpu.* ->
arks_tpu_torch.*``, ``--platform -> --device``), discovery files, router
Service, phases, conditions and status; the port's refusals (``runtime:
jax``, TPU accelerators, tensor or context parallelism, Kubernetes router
discovery); and ``python -m arks_tpu_torch.control`` deploying a tiny
DisaggregatedApplication as subprocesses behind the gateway."""

import copy
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

import pytest
import yaml

from arks_tpu.control import resources as ref_res
from arks_tpu.control import workloads as ref_workloads
from arks_tpu.control.__main__ import apply_manifests as ref_apply
from arks_tpu.control.manager import build_manager as ref_build
from arks_tpu_torch.control import resources as res
from arks_tpu_torch.control import workloads
from arks_tpu_torch.control.__main__ import apply_manifests
from arks_tpu_torch.control.disaggregated_controller import (
    DisaggregatedApplicationController,
)
from arks_tpu_torch.control.manager import build_manager
from arks_tpu_torch.control.store import Store

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def wait_for(predicate, timeout=15.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = predicate()
        if v:
            return v
        time.sleep(interval)
    raise AssertionError("condition not met within timeout")


def _no_download(model, dest):
    os.makedirs(dest, exist_ok=True)


def _strip_times(obj):
    if isinstance(obj, dict):
        return {k: _strip_times(v) for k, v in obj.items()
                if k not in ("last_transition_time", "lastUpdateTime")}
    if isinstance(obj, list):
        return [_strip_times(v) for v in obj]
    return obj


def _objects(store, res_mod, prefix):
    out = {}
    for cls in res_mod.ALL_KINDS:
        for o in store.list(cls):
            if not o.name.startswith(prefix):
                continue
            out[(o.KIND, o.namespace, o.name)] = dict(
                labels=o.labels, owner_refs=o.owner_refs,
                finalizers=sorted(o.finalizers),
                status=_strip_times(o.status))
    return out


def _write(tmp_path, name, docs):
    path = tmp_path / name
    path.write_text(yaml.safe_dump_all(docs))
    return str(path)


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    """(reference manager, port manager, their fake drivers, the directory
    that holds both discovery directories), shared by this file's cases:
    each names its own applications."""
    root = tmp_path_factory.mktemp("stacks")
    saved = tempfile.tempdir
    tempfile.tempdir = str(root)
    try:
        rd, pd = ref_workloads.FakeGangDriver(), workloads.FakeGangDriver()
        ref = ref_build(models_root=str(root / "models"), driver=rd,
                        fetcher=_no_download, local_platform="cpu")
        port = build_manager(models_root=str(root / "models"), driver=pd,
                             fetcher=_no_download, local_device="cpu")
    finally:
        tempfile.tempdir = saved
    ref.start()
    port.start()
    yield ref, port, rd, pd, root
    ref.stop()
    port.stop()


def _docs(name, mode):
    spec = {
        "model": {"name": f"{name}-model"}, "servedModelName": name,
        "modelConfig": "tiny", "mode": mode,
        "runtimeCommonArgs": ["--num-slots", "2", "--seed", "3"],
        "router": {"replicas": 1, "routerArgs": ["--policy", "cache_aware"]},
        "prefill": {"replicas": 1, "tensorParallel": 1,
                    "instanceSpec": {"env": [{"name": "X", "value": "1"}]}},
        "decode": {"replicas": 2, "runtimeImage": "img:decode",
                   "runtimeCommonArgs": ["--num-slots", "4"]},
    }
    if mode == "unified":
        spec["podGroupPolicy"] = {"kubeScheduling": {}}
    return [{"kind": "Model", "metadata": {"name": f"{name}-model"},
             "spec": {"model": "test/tiny"}},
            {"kind": "DisaggregatedApplication", "metadata": {"name": name},
             "spec": spec},
            {"kind": "Endpoint", "metadata": {"name": name},
             "spec": {"defaultWeight": 1}}]


def _port_docs(docs):
    docs = copy.deepcopy(docs)
    for d in docs:
        if d["kind"] == "DisaggregatedApplication":
            d["spec"]["runtime"] = "torch"
    return docs


def _port_argv(argv, ref_disc, port_disc):
    """The reference's command as the port's: ``-m arks_tpu.X`` -> ``-m
    arks_tpu_torch.X``, ``--platform`` -> ``--device``, its discovery file
    -> the port's."""
    return [a.replace("arks_tpu.", "arks_tpu_torch.") if
            a.startswith("arks_tpu.") else "--device" if a == "--platform"
            else port_disc if a == ref_disc else a for a in argv]


@pytest.mark.parametrize("mode", ["legacy", "unified"])
def test_controllers_settle_like_the_reference(stacks, tmp_path, mode):
    ref, port, rd, pd, root = stacks
    name = f"pd-{mode}"
    docs = _docs(name, mode)
    ref_apply(ref.store, _write(tmp_path, "ref.yaml", docs))
    apply_manifests(port.store, _write(tmp_path, "port.yaml",
                                       _port_docs(docs)))
    for mgr, r in ((ref, ref_res), (port, res)):
        wait_for(lambda: mgr.store.get(r.DisaggregatedApplication, name)
                 .status.get("phase") == r.PHASE_RUNNING)
        wait_for(lambda: mgr.store.get(r.Endpoint, name).status.get(
            "routes"))
        assert mgr.wait_idle(timeout=30)
    try:
        wait_for(lambda: _objects(port.store, res, name)
                 == _objects(ref.store, ref_res, name))
    except AssertionError:
        pass                      # the comparisons below say where
    want = _objects(ref.store, ref_res, name)
    got = _objects(port.store, res, name)
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], key
    assert {k[0] for k in got} == {"Model", "DisaggregatedApplication",
                                   "Endpoint", "GangSet", "Service"}
    disc = {}
    for tag, d in (("ref", "arks-tpu-discovery"),
                   ("port", "arks-tpu-torch-discovery")):
        disc[tag] = str(root / d / f"default-{name}.json")
    with open(disc["ref"]) as f, open(disc["port"]) as g:
        files = json.load(f), json.load(g)
    assert files[0] == files[1] == {
        "prefill": [f"fake-{name}-prefill-0:8080"],
        "decode": [f"fake-{name}-decode-{i}:8080" for i in range(2)]}
    for comp in ("router", "prefill", "decode"):
        rg = ref.store.get(ref_res.GangSet, f"{name}-{comp}").spec
        pg = port.store.get(res.GangSet, f"{name}-{comp}").spec
        for role in ("leader", "worker"):
            argv = pg[role]["command"]
            assert argv[:3] == [sys.executable, "-m",
                                f"arks_tpu_torch.{'router' if comp == 'router' else 'server'}"]
            assert argv == _port_argv(rg[role]["command"], disc["ref"],
                                      disc["port"])
            if comp != "router":
                assert argv[argv.index("--device") + 1] == "cpu"
                assert argv[argv.index("--disaggregation-mode") + 1] == comp
        assert pg["runtime"] == ("router" if comp == "router" else "torch")
        want_img = {"decode": "img:decode"}.get(
            comp, "arks-tpu-torch/engine:latest")
        assert pg["image"] == want_img
        skip = {"leader", "worker", "runtime", "image"}
        assert {k: v for k, v in pg.items() if k not in skip} == \
            {k: v for k, v in rg.items() if k not in skip}
    if mode == "unified":
        assert pg["podGroupUnit"] == {"name": f"arks-{name}", "minMember": 4}
    ep = port.store.get(res.Endpoint, name).status["routes"]
    assert ep[0]["backend"]["service"] == f"{name}-router-svc"
    assert ep == ref.store.get(ref_res.Endpoint, name).status["routes"]

    # A component failing flips readiness off alike; deleting the app
    # cascades its workloads and removes its discovery file.
    rd.fail_group(("default", f"{name}-decode"), 0)
    pd.fail_group(("default", f"{name}-decode"), 0)
    for mgr, r in ((ref, ref_res), (port, res)):
        wait_for(lambda: not mgr.store.get(r.DisaggregatedApplication,
                                           name).ready())
        assert mgr.wait_idle(timeout=30)
    want = _objects(ref.store, ref_res, name)
    got = _objects(port.store, res, name)
    key = ("DisaggregatedApplication", "default", name)
    assert got[key] == want[key]
    assert {c["type"]: c["reason"] for c in got[key]["status"][
        "conditions"]}["Ready"] == "WaitingForComponents"
    with open(disc["port"]) as f:
        assert json.load(f)["decode"] == [f"fake-{name}-decode-1:8080"]
    for mgr, r in ((ref, ref_res), (port, res)):
        mgr.store.delete(r.DisaggregatedApplication, name)
        wait_for(lambda: mgr.store.try_get(r.GangSet, f"{name}-router")
                 is None and mgr.store.try_get(r.Service,
                                               f"{name}-router-svc") is None)
    wait_for(lambda: not os.path.exists(disc["port"]))
    assert not os.path.exists(disc["ref"])


def _failed(store, name):
    app = wait_for(lambda: (lambda a: a.status.get("phase")
                            == res.PHASE_FAILED and a)(
        store.get(res.DisaggregatedApplication, name)))
    (cond,) = [c for c in app.status["conditions"]
               if c["type"] == res.COND_PRECHECK]
    return cond["reason"], cond["message"]


@pytest.mark.parametrize("case", [
    "jax", "vllm", "tpu", "tp-prefill", "cp-decode", "tp-app", "mode",
    "volume"])
def test_precheck_refusals(stacks, case):
    """The port refuses what its server would refuse at launch, with the
    reason in the precheck condition; where the reference refuses too
    (another runtime, a bad mode, a reserved volume) it refuses alike."""
    ref, port, _, _, _ = stacks
    spec = {"model": {"name": "m"}, "runtime": "torch",
            "prefill": {"replicas": 1}, "decode": {"replicas": 1}}
    want = {
        "jax": ("InvalidRuntime", "requires runtime 'torch', got 'jax'"),
        "vllm": ("InvalidRuntime", "got 'vllm'"),
        "tpu": ("InvalidSpec", "'tpu-v5e-8' is a TPU topology"),
        "tp-prefill": ("InvalidSpec", "prefill.tensorParallel=2"),
        "cp-decode": ("InvalidSpec", "decode.contextParallel=4"),
        "tp-app": ("InvalidSpec", "prefill.tensorParallel=8"),
        "mode": ("InvalidSpec", "spec.mode must be one of"),
        "volume": ("InvalidSpec", "is reserved for the model mount"),
    }[case]
    if case in ("jax", "vllm"):
        spec["runtime"] = case
    elif case == "tpu":
        spec["decode"]["accelerator"] = "tpu-v5e-8"
    elif case == "tp-prefill":
        spec["prefill"]["tensorParallel"] = 2
    elif case == "cp-decode":
        spec["decode"]["contextParallel"] = 4
    elif case == "tp-app":
        spec["tensorParallel"] = 8
    elif case == "mode":
        spec["mode"] = "sideways"
    else:
        spec["router"] = {"instanceSpec": {"volumes": [{"name": "models"}]}}
    port.store.create(res.DisaggregatedApplication(name=f"bad-{case}",
                                                   spec=spec))
    reason, message = _failed(port.store, f"bad-{case}")
    assert reason == want[0] and want[1] in message, message
    if case in ("vllm", "mode", "volume"):
        ref.store.create(ref_res.DisaggregatedApplication(
            name=f"bad-{case}", spec=dict(spec, runtime="jax"
                                          if case != "vllm" else "vllm")))
        app = wait_for(lambda: (lambda a: a.status.get("phase")
                                == ref_res.PHASE_FAILED and a)(
            ref.store.get(ref_res.DisaggregatedApplication, f"bad-{case}")))
        (cond,) = [c for c in app.status["conditions"]
                   if c["type"] == ref_res.COND_PRECHECK]
        assert cond["reason"] == reason
        if case != "vllm":
            assert cond["message"] == message
    assert port.wait_idle(timeout=30)
    assert [g.name for g in port.store.list(res.GangSet)
            if g.name.startswith(f"bad-{case}")] == []


def test_kubernetes_router_discovery_is_refused(tmp_path):
    with pytest.raises(NotImplementedError, match="5.3"):
        DisaggregatedApplicationController(Store(), router_discovery=
                                           "kubernetes")
    with pytest.raises(NotImplementedError, match="Kubernetes client"):
        build_manager(models_root=str(tmp_path), router_discovery=
                      "kubernetes")
    with pytest.raises(ValueError):
        DisaggregatedApplicationController(Store(), router_discovery="dns")


def test_port_disaggregated_quickstart_manifest(stacks):
    """The port's disaggregated quickstart: Qwen2.5-7B as one prefill and
    two decode replicas behind one cache-aware router, with a token and a
    quota for the gateway; it settles Running over the fake driver."""
    _, port, _, _, _ = stacks
    objs = apply_manifests(port.store, os.path.join(
        REPO, "examples", "quickstart", "disaggregated_torch.yaml"))
    assert sorted(o.KIND for o in objs) == [
        "DisaggregatedApplication", "Endpoint", "Model", "Quota", "Token"]
    app = wait_for(lambda: (lambda a: a.phase == res.PHASE_RUNNING and a)(
        port.store.get(res.DisaggregatedApplication, "qwen2.5-pd-app")))
    assert app.spec["modelConfig"] == "qwen2.5-7b"
    assert app.status["decode"] == {"replicas": 2, "readyReplicas": 2}
    rtr = port.store.get(res.GangSet, "qwen2.5-pd-app-router").spec
    assert rtr["leader"]["command"][-2:] == ["--policy", "cache_aware"]
    dec = port.store.get(res.GangSet, "qwen2.5-pd-app-decode").spec
    argv = dec["leader"]["command"]
    assert argv[argv.index("--max-model-len") + 1] == "1024"
    assert argv[argv.index("--seed") + 1] == "0"


# ---------------------------------------------------------------------------
# The operator's entry point, with real subprocesses
# ---------------------------------------------------------------------------

def _post(port, path, body, token=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json",
                 **({"Authorization": f"Bearer {token}"} if token else {})})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.load(r)


def test_operator_deploys_a_disaggregated_application(tmp_path):
    """``python -m arks_tpu_torch.control --manifests ... --local-device
    cpu`` deploys the disaggregated quickstart cut to ``tiny`` (a prefill
    replica, a decode replica and the router, each a subprocess); a chat
    request through the gateway equals the same request sent straight to
    the decode replica, but for its id and timestamp; SIGTERM stops the
    operator and every child."""
    docs = [d for d in yaml.safe_load_all(open(os.path.join(
        REPO, "examples", "quickstart", "disaggregated_torch.yaml"))) if d]
    for d in docs:
        if d["kind"] == "DisaggregatedApplication":
            d["spec"].update(modelConfig="tiny", runtimeCommonArgs=[
                "--num-slots", "2", "--max-model-len", "64",
                "--dtype", "float32"])
            d["spec"]["decode"]["replicas"] = 1
    manifest = tmp_path / "pd.yaml"
    manifest.write_text(yaml.safe_dump_all(docs))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, TMPDIR=str(tmp_path))
    op = subprocess.Popen(
        [sys.executable, "-m", "arks_tpu_torch.control", "--manifests",
         str(manifest), "--local-device", "cpu", "--gateway-port",
         str(port), "--models-root", str(tmp_path / "models")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    chat = {"model": "qwen2.5-pd", "max_tokens": 5, "temperature": 0,
            "ignore_eos": True,
            "messages": [{"role": "user", "content": "hello there"}]}

    def answered():
        try:
            return _post(port, "/v1/chat/completions", chat,
                         token="sk-pd-quickstart")
        except (urllib.error.HTTPError, OSError):
            return None

    try:
        data = wait_for(answered, timeout=120, interval=0.25)
        with open(tmp_path / "arks-tpu-torch-discovery"
                  / "default-qwen2.5-pd-app.json") as f:
            disc = json.load(f)
        (decode,) = disc["decode"]
        direct = _post(int(decode.rpartition(":")[2]),
                       "/v1/chat/completions", chat)
        assert data["usage"]["completion_tokens"] == 5
        assert ({k: v for k, v in data.items() if k not in ("id", "created")}
                == {k: v for k, v in direct.items()
                    if k not in ("id", "created")})
    finally:
        op.send_signal(signal.SIGTERM)
        out = op.communicate(timeout=60)[0].decode(errors="replace")
    assert op.returncode == 0, out
    children = [int(line.rsplit("(port ", 1)[1].rstrip(")"))
                for line in out.splitlines()
                if "member 0" in line and "(port " in line]
    assert len(children) == 3, out
    joined = "\n".join(line for line in out.splitlines()
                       if "member 0" in line)
    assert "arks_tpu_torch.router" in joined
    assert "--disaggregation-mode prefill" in joined
    for child in children:            # every replica stopped with it
        with pytest.raises(OSError):
            socket.create_connection(("127.0.0.1", child), timeout=5).close()
