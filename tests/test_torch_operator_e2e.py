"""The port's quickstart end to end on the CPU (the counterpart of
``tests/test_e2e_local.py``): manifests -> the port's controllers -> its
``LocalProcessDriver`` spawns ``python -m arks_tpu_torch.server --model tiny
--device cpu`` -> the Endpoint discovers it -> a client calls the port's
gateway with a token and gets the replica's completion, byte for byte as
the replica answers it directly, with metered usage."""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from arks_tpu_torch.control import resources as res
from arks_tpu_torch.control.manager import build_manager
from arks_tpu_torch.control.workloads import LocalProcessDriver
from arks_tpu_torch.gateway.server import Gateway

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def wait_for(predicate, timeout=120.0, interval=0.1):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = predicate()
        if v:
            return v
        time.sleep(interval)
    raise AssertionError("condition not met within timeout")


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e")
    driver = LocalProcessDriver(log_dir=str(root / "logs"))
    mgr = build_manager(models_root=str(root / "models"), driver=driver,
                        local_device="cpu")
    mgr.start()
    gw = Gateway(mgr.store, host="127.0.0.1", port=0, quota_sync_s=0.5)
    gw.start(background=True)
    yield mgr, gw, driver
    gw.stop()
    mgr.stop()
    driver.teardown_all()


def _post(port, path, body, token=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json",
                 **({"Authorization": f"Bearer {token}"} if token else {})})
    with urllib.request.urlopen(req, timeout=120) as r:
        if not body.get("stream"):
            return json.load(r)
        return [line.decode().strip()[6:] for line in r
                if line.decode().startswith("data: ")]


def _same(a, b):
    """Equal but for the id and creation time each response mints."""
    drop = ("id", "created")
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, str):
        if a == "[DONE]" or b == "[DONE]":
            return a == b
        a, b = json.loads(a), json.loads(b)
    return ({k: v for k, v in a.items() if k not in drop}
            == {k: v for k, v in b.items() if k not in drop})


def test_quickstart_end_to_end(stack):
    mgr, gw, driver = stack
    store = mgr.store
    store.create(res.Model(name="tiny-model", spec={"model": "test/tiny"}))
    store.create(res.Application(name="tiny-app", spec={
        "replicas": 1, "size": 1, "model": {"name": "tiny-model"},
        "servedModelName": "tiny-served", "tensorParallel": 1,
        "modelConfig": "tiny",
        "runtimeCommonArgs": ["--num-slots", "2", "--max-model-len", "64",
                              "--dtype", "float32"],
    }))
    store.create(res.Endpoint(name="tiny-served", spec={"defaultWeight": 1}))
    store.create(res.Token(name="e2e-user", spec={
        "token": "sk-e2e",
        "qos": [{"endpoint": {"name": "tiny-served"},
                 "rateLimits": [{"type": "rpm", "value": 50}],
                 "quota": {"name": "e2e-quota"}}]}))
    store.create(res.Quota(name="e2e-quota", spec={
        "quotas": [{"type": "total", "value": 100000}]}))

    wait_for(lambda: store.get(res.Application, "tiny-app").status.get(
        "phase") == res.PHASE_RUNNING)
    routes = wait_for(lambda: store.get(res.Endpoint, "tiny-served").status
                      .get("routes"), timeout=30)
    (addr,) = routes[0]["backend"]["addresses"]
    port = int(addr.rpartition(":")[2])
    wait_for(lambda: gw.qos.token_known("sk-e2e"), timeout=10)

    # The replica is the port's server, on the CPU, in the driver's process.
    with urllib.request.urlopen(f"http://{addr}/v1/device", timeout=30) as r:
        dev = json.load(r)
    (group,) = driver._groups[("default", "tiny-app")].values()
    assert dev["pid"] == group.proc.pid and dev["device"] == "cpu"
    assert group.proc.args[2] == "arks_tpu_torch.server"
    with open(f"/proc/{dev['pid']}/environ", "rb") as f:
        env = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0")
                   if b"=" in kv)
    assert (env[b"ARKS_GANG_SIZE"], env[b"ARKS_DRAIN_TIMEOUT"],
            env[b"ARKS_GANG_LEADER_ADDRESS"]) == (b"1", b"8", addr.encode())
    assert set(dev["kernel_launches"].values()) == {0}

    chat = {"model": "tiny-served",
            "messages": [{"role": "user", "content": "hello"}],
            "max_tokens": 5, "temperature": 0, "ignore_eos": True}
    data = _post(gw.port, "/v1/chat/completions", chat, token="sk-e2e")
    assert data["object"] == "chat.completion"
    assert data["usage"]["completion_tokens"] == 5
    assert data["choices"][0]["finish_reason"] == "length"
    assert _same(data, _post(port, "/v1/chat/completions", chat))
    total = data["usage"]["total_tokens"]
    assert gw.quota.get_usage("default", "e2e-quota")["total"] == total

    stream = dict(chat, messages=[{"role": "user", "content": "again"}],
                  max_tokens=4, stream=True,
                  stream_options={"include_usage": True})
    frames = _post(gw.port, "/v1/chat/completions", stream, token="sk-e2e")
    assert frames[-1] == "[DONE]"
    assert _same(frames, _post(port, "/v1/chat/completions", stream))
    usage = json.loads(frames[-2])["usage"]
    assert usage["completion_tokens"] == 4
    wait_for(lambda: gw.quota.get_usage("default", "e2e-quota")["total"]
             == total + usage["total_tokens"], timeout=10)
    wait_for(lambda: [s["used"] for s in store.get(
        res.Quota, "e2e-quota").status.get("quotaStatus", [])
        if s["type"] == "total"] == [total + usage["total_tokens"]],
        timeout=10)

    # Deleting the Application stops its replica.
    proc = group.proc
    store.delete(res.Application, "tiny-app")
    wait_for(lambda: proc.poll() is not None, timeout=30)
    assert store.try_get(res.GangSet, "tiny-app") is None


def test_server_refuses_a_gang_of_more_than_one(monkeypatch):
    from arks_tpu_torch.server.__main__ import build_engine, parse_args
    args = parse_args(["--model", "tiny", "--device", "cpu"])
    for name in ("ARKS_GANG_SIZE", "ARKS_NUM_PROCESSES"):
        with monkeypatch.context() as m:
            m.setenv(name, "2")
            with pytest.raises(NotImplementedError, match="gang of 2"):
                build_engine(args)


def test_operator_entry_point_deploys_and_stops(tmp_path):
    """``python -m arks_tpu_torch.control --manifests ... --local-device
    cpu``: the port's quickstart, cut to the tiny model, answers through
    the embedded gateway; SIGTERM stops the operator and its replica."""
    import yaml
    docs = [d for d in yaml.safe_load_all(open(os.path.join(
        REPO, "examples", "quickstart", "quickstart_torch.yaml"))) if d]
    for d in docs:
        if d["kind"] == "Application":
            d["spec"].update(replicas=1, modelConfig="tiny",
                             runtimeCommonArgs=["--num-slots", "2",
                                                "--max-model-len", "64"])
    manifest = tmp_path / "quickstart.yaml"
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
    body = {"model": "qwen2.5", "prompt": "hi", "max_tokens": 3,
            "temperature": 0}

    def answered():
        try:
            return _post(port, "/v1/completions", body, token="sk-quickstart")
        except (urllib.error.HTTPError, OSError):
            return None

    try:
        data = wait_for(answered, timeout=120, interval=0.25)
        assert data["usage"]["completion_tokens"] == 3
    finally:
        op.send_signal(signal.SIGTERM)
        out = op.communicate(timeout=60)[0].decode(errors="replace")
    assert op.returncode == 0, out
    (line,) = [line for line in out.splitlines()
               if "arks_tpu_torch.server" in line and "member 0" in line]
    replica = int(line.rsplit("(port ", 1)[1].rstrip(")"))
    with pytest.raises(OSError):        # the replica stopped with it
        socket.create_connection(("127.0.0.1", replica), timeout=5).close()
