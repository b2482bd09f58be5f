"""Gang workloads: spec generation + drivers (a copy of
``arks_tpu/control/workloads.py`` that launches the port's server).

The reference delegates gang semantics to external operators (LWS v0.7.0 /
RBGS — SURVEY.md §1) and only generates their specs.  Here GangSet is a
first-class resource with pluggable drivers:

- FakeGangDriver — test double; readiness is script-controlled (the "fake
  gang-status driver" the reference lacks, SURVEY.md §4).
- LocalProcessDriver — real subprocesses on this host (single-node demo and
  e2e tests): spawns the leader command per replica group, readiness-probes
  its HTTP port, restarts the whole group on exit (the LWS
  RecreateGroupOnPodRestart semantic, arksapplication_controller.go:581-584).

Env contract injected into every member (the LWS env contract translated —
reference :560-569):
  ARKS_GANG_LEADER_ADDRESS, ARKS_GANG_SIZE, ARKS_GANG_WORKER_INDEX
and, for a gang of more than one process, the rendezvous variables
(ARKS_COORDINATOR_ADDRESS / ARKS_NUM_PROCESSES / ARKS_PROCESS_ID), the same
for every member of a group.  The port's server serves gangs of one process
and refuses a larger one (``arks_tpu_torch.server.__main__``).

``torch_serve_command`` is the command of the native ``torch`` runtime:
``python -m arks_tpu_torch.server`` with the reference's flags, ``--device``
in the place of ``--platform``.
"""

from __future__ import annotations

import logging
import os
import shlex
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from typing import Protocol

from arks_tpu_torch.control.resources import GangSet
from arks_tpu_torch import knobs
from arks_tpu_torch.utils.swallow import swallowed

log = logging.getLogger("arks_tpu_torch.workloads")


class GangDriver(Protocol):
    def ensure(self, gs: GangSet) -> None: ...
    def status(self, gs: GangSet) -> dict: ...
    def teardown(self, gs: GangSet) -> None: ...


def stable_hash(obj) -> str:
    """Short deterministic content hash for revision stamps (shared by the
    gang drivers and the k8s renderer so 'outdated' means the same thing
    everywhere)."""
    import hashlib
    import json

    return hashlib.sha256(
        json.dumps(obj, sort_keys=True, default=str).encode()
    ).hexdigest()[:12]


def spec_hash(gs: GangSet) -> str:
    """Hash of the spec fields that require a group restart to apply.

    Stamped onto every launched group; a mismatch marks the group outdated
    for the rolling update.  ``replicas`` is deliberately excluded — scaling
    must not restart existing groups."""
    return stable_hash({k: gs.spec.get(k)
                        for k in ("size", "leader", "worker", "ports",
                                  "runtime", "image", "accelerator",
                                  "modelPvc")})


def pick_rolling_restart(hashes: dict[int, str], want_hash: str,
                         ready: dict[int, bool]) -> int | None:
    """maxUnavailable=1 / maxSurge=0 rolling update (the reference's RBGS
    RollingUpdate strategy, arksapplication_controller.go:867-874).

    Unready outdated groups roll first — restarting a group that serves no
    traffic cannot reduce availability, and without this a revision that
    hangs (alive but never ready) would wedge the corrective rollout
    forever.  A READY outdated group only rolls when every other group is
    ready, so the endpoint's backend list never goes empty mid-rollout and
    a stuck new revision halts the rollout instead of cascading."""
    outdated = sorted(i for i, h in hashes.items() if h != want_hash)
    if not outdated:
        return None
    for i in outdated:
        if not ready.get(i, False):
            return i
    cand = outdated[0]
    if all(ready.get(i, False) for i in hashes if i != cand):
        return cand
    return None


# ---------------------------------------------------------------------------
# Fake driver (tests)
# ---------------------------------------------------------------------------


class FakeGangDriver:
    """Marks each group Running after ``ready_after`` ensure() calls (0 =
    ready from the first ensure); tests can fail groups explicitly.  Applies
    the same rolling-update semantics as the real drivers (spec-hash stamp,
    one restart at a time gated on the others' readiness) and records each
    rolling restart in ``restarts`` for assertions."""

    def __init__(self, ready_after: int = 0):
        self.ready_after = ready_after
        # gs.key -> index -> {"hash": str, "ensures": int}
        self._groups: dict[tuple, dict[int, dict]] = {}
        self._failed: set[tuple] = set()
        self.torn_down: list[tuple] = []
        self.restarts: list[tuple] = []  # (gs.key, index) rolling restarts

    def fail_group(self, gs_key: tuple, index: int) -> None:
        self._failed.add((gs_key, index))

    def recover_group(self, gs_key: tuple, index: int) -> None:
        self._failed.discard((gs_key, index))

    def _is_ready(self, key: tuple, index: int, g: dict) -> bool:
        return (key, index) not in self._failed and g["ensures"] > self.ready_after

    def ensure(self, gs: GangSet) -> None:
        want = spec_hash(gs)
        groups = self._groups.setdefault(gs.key, {})
        replicas = gs.spec.get("replicas", 1)
        for idx in range(replicas):
            groups.setdefault(idx, {"hash": want, "ensures": 0})
        for idx in [i for i in groups if i >= replicas]:
            del groups[idx]
        for g in groups.values():
            g["ensures"] += 1
        ready = {i: self._is_ready(gs.key, i, g) for i, g in groups.items()}
        cand = pick_rolling_restart(
            {i: g["hash"] for i, g in groups.items()}, want, ready)
        if cand is not None:
            groups[cand] = {"hash": want, "ensures": 0}
            self.restarts.append((gs.key, cand))

    def status(self, gs: GangSet) -> dict:
        replicas = gs.spec.get("replicas", 1)
        groups = self._groups.get(gs.key, {})
        out = []
        for i in range(replicas):
            g = groups.get(i)
            if (gs.key, i) in self._failed:
                phase = "Failed"
            elif g is not None and g["ensures"] > self.ready_after:
                phase = "Running"
            else:
                phase = "Pending"
            out.append({"index": i, "phase": phase,
                        "leaderAddr": f"fake-{gs.name}-{i}:8080"})
        ready = sum(1 for g in out if g["phase"] == "Running")
        return {"replicas": replicas, "readyReplicas": ready, "groups": out}

    def teardown(self, gs: GangSet) -> None:
        self.torn_down.append(gs.key)
        self._groups.pop(gs.key, None)


# ---------------------------------------------------------------------------
# Local process driver (single-node demo / e2e)
# ---------------------------------------------------------------------------


class _Group:
    """One replica group: the leader plus ``size - 1`` worker processes.

    ``procs[0]`` is the leader (serves HTTP on ``port``); gang semantics
    are all-or-nothing — any member dying recreates the whole group."""

    def __init__(self, procs: list[subprocess.Popen], port: int,
                 spec_hash: str):
        self.procs = procs
        self.port = port
        self.spec_hash = spec_hash  # revision stamp for rolling updates
        self.started = time.monotonic()

    @property
    def proc(self) -> subprocess.Popen:  # leader, for probes/logs
        return self.procs[0]

    def poll_any_dead(self):
        """Returncode of the first dead member, else None."""
        for p in self.procs:
            rc = p.poll()
            if rc is not None:
                return rc
        return None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class LocalProcessDriver:
    """Runs each replica group as local subprocesses — ALL ``size`` members,
    leader + workers, wired with the rendezvous env
    (ARKS_COORDINATOR_ADDRESS / ARKS_NUM_PROCESSES / ARKS_PROCESS_ID).
    ``log_dir`` defaults to ``arks-tpu-torch-logs`` under the system's
    temporary directory."""

    def __init__(self, log_dir: str | None = None):
        import atexit

        self.log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                               "arks-tpu-torch-logs")
        os.makedirs(self.log_dir, exist_ok=True)
        self._groups: dict[tuple, dict[int, _Group]] = {}
        self._lock = threading.Lock()
        # Unlike k8s pods (which rightly outlive their operator), local
        # subprocesses must die with this process or they leak.
        atexit.register(self.teardown_all)

    def teardown_all(self) -> None:
        with self._lock:
            groups = [g for d in self._groups.values() for g in d.values()]
            self._groups.clear()
        for g in groups:
            self._stop_group(g)

    def ensure(self, gs: GangSet) -> None:
        want = spec_hash(gs)
        # Groups to finish stopping OUTSIDE the lock: waiting for a member
        # stuck in a native collective (up to 10s each) must not block
        # status() and every other gang's reconcile.
        to_reap: list[_Group] = []
        with self._lock:
            groups = self._groups.setdefault(gs.key, {})
            replicas = gs.spec.get("replicas", 1)
            # Reap groups with ANY dead member → restart whole group
            # (RecreateGroupOnPodRestart).  Relaunches pick up the CURRENT
            # spec, so a crashed outdated group rolls forward for free.
            for idx, g in list(groups.items()):
                rc = g.poll_any_dead()
                if rc is not None:
                    log.warning("gang %s group %d member exited rc=%s; "
                                "restarting group", gs.name, idx, rc)
                    self._signal_stop(g)
                    to_reap.append(g)
                    del groups[idx]
            for idx in range(replicas):
                if idx in groups:
                    continue
                groups[idx] = self._launch(gs, idx)
            # Scale down.
            for idx in [i for i in groups if i >= replicas]:
                g = groups.pop(idx)
                self._signal_stop(g)
                to_reap.append(g)
            # Rolling update: restart at most ONE outdated group per ensure,
            # gated on every other group being ready (maxUnavailable=1).
            # Probe only when a rollout is actually pending — probing every
            # group (2s timeout each) under the driver lock on every ensure
            # would stall status() and every other gang's reconcile.
            hashes = {i: g.spec_hash for i, g in groups.items()}
            rolling = not all(h == want for h in hashes.values())
            if rolling:
                ready = {i: self._probe(g.port) for i, g in groups.items()}
                cand = pick_rolling_restart(hashes, want, ready)
                if cand is not None:
                    log.info("gang %s/%s group %d: rolling restart to "
                             "revision %s", gs.namespace, gs.name, cand, want)
                    g = groups.pop(cand)
                    self._signal_stop(g)
                    to_reap.append(g)
                    groups[cand] = self._launch(gs, cand)
        for g in to_reap:
            self._reap_stop(g)

    def _launch(self, gs: GangSet, index: int) -> _Group:
        import secrets

        revision = spec_hash(gs)
        size = gs.spec.get("size", 1)
        leader_port = _free_port()
        coord_port = _free_port() if size > 1 else 0
        # Explicitly allocated (not derived from coord_port) — derived ports
        # collide with other allocations on a shared host.
        dispatch_port = _free_port() if size > 1 else 0
        gang_secret = secrets.token_hex(16)
        procs: list[subprocess.Popen] = []
        for member in range(size):
            role = "leader" if member == 0 else "worker"
            spec = gs.spec.get(role) or gs.spec["leader"]
            port = leader_port if member == 0 else _free_port()
            cmd = [c.replace("$(PORT)", str(port)) for c in spec["command"]]
            env = dict(os.environ)
            env.update(spec.get("env", {}))
            env.update({
                "ARKS_GANG_LEADER_ADDRESS": f"127.0.0.1:{leader_port}",
                "ARKS_GANG_SIZE": str(size),
                "ARKS_GANG_WORKER_INDEX": str(member),
                # Fit the graceful drain inside THIS driver's 10s
                # SIGTERM->SIGKILL window.  Env-default only: an explicit
                # --drain-timeout flag wins, and K8s-rendered pods (30s
                # grace) keep the server's own 20s default.
                "ARKS_DRAIN_TIMEOUT": env.get("ARKS_DRAIN_TIMEOUT", "8"),
            })
            if size > 1:
                # The rendezvous (the LWS env contract translated —
                # reference :560-569) and the authenticated dispatch
                # channel of a multi-process gang, as the reference sets
                # them: identical for every member of the group.
                env.update({
                    "ARKS_COORDINATOR_ADDRESS": f"127.0.0.1:{coord_port}",
                    "ARKS_NUM_PROCESSES": str(size),
                    "ARKS_PROCESS_ID": str(member),
                    "ARKS_DISPATCH_ADDRESS": f"127.0.0.1:{dispatch_port}",
                    "ARKS_GANG_SECRET": gang_secret,
                })
            log.info("gang %s/%s group %d member %d: %s (port %d)",
                     gs.namespace, gs.name, index, member,
                     shlex.join(cmd), port)
            # The child keeps its own descriptor of the log.
            with open(os.path.join(
                    self.log_dir,
                    f"{gs.namespace}-{gs.name}-{index}-{member}.log"),
                    "ab") as logf:
                procs.append(subprocess.Popen(cmd, env=env, stdout=logf,
                                              stderr=logf))
        return _Group(procs, leader_port, revision)

    def status(self, gs: GangSet) -> dict:
        with self._lock:
            groups = dict(self._groups.get(gs.key, {}))
        replicas = gs.spec.get("replicas", 1)
        out = []
        for i in range(replicas):
            g = groups.get(i)
            if g is None or g.poll_any_dead() is not None:
                out.append({"index": i, "phase": "Pending", "leaderAddr": ""})
                continue
            phase = "Running" if self._probe(g.port) else "Starting"
            out.append({"index": i, "phase": phase,
                        "leaderAddr": f"127.0.0.1:{g.port}"})
        ready = sum(1 for g in out if g["phase"] == "Running")
        return {"replicas": replicas, "readyReplicas": ready, "groups": out}

    def _probe(self, port: int) -> bool:
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/readiness", timeout=2) as r:
                return r.status == 200
        except Exception as e:
            # A failed probe IS the signal (not-ready); expected while a
            # member is still booting.
            swallowed("workloads.readiness-probe", e)
            return False

    def _signal_stop(self, g: _Group) -> None:
        """Fast half of a group stop: deliver SIGTERM to every member."""
        for p in g.procs:
            if p.poll() is None:
                p.terminate()

    def _reap_stop(self, g: _Group) -> None:
        """Slow half: wait for exits, escalate to SIGKILL.  Call WITHOUT the
        driver lock — a member wedged in a native collective ignores
        SIGTERM until the call returns."""
        for p in g.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                try:
                    p.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    pass

    def _stop_group(self, g: _Group) -> None:
        self._signal_stop(g)
        self._reap_stop(g)

    def teardown(self, gs: GangSet) -> None:
        with self._lock:
            groups = self._groups.pop(gs.key, {})
        for g in groups.values():
            self._stop_group(g)


# ---------------------------------------------------------------------------
# Runtime command generation (the generateLeaderCommand analogue,
# reference arksapplication_controller.go:941-1014)
# ---------------------------------------------------------------------------


def torch_serve_command(model_arg: str, served_model_name: str,
                        port_token: str, tensor_parallel: int, size: int,
                        common_args: list[str],
                        model_path: str | None = None,
                        device: str | None = None,
                        context_parallel: int = 1,
                        num_slices: int = 1) -> list[str]:
    """The reference's ``jax_serve_command`` for the port's server: the same
    flags, ``--device D`` for ``--platform P``.  Without ``device`` the
    server takes its own default, the CUDA device."""
    cmd = [sys.executable, "-m", "arks_tpu_torch.server",
           "--model", model_arg,
           "--served-model-name", served_model_name,
           "--port", port_token,
           "--tensor-parallel-size", str(tensor_parallel)]
    if context_parallel > 1:
        cmd += ["--context-parallel-size", str(context_parallel)]
    if num_slices > 1:
        cmd += ["--num-slices", str(num_slices)]
    if model_path:
        cmd += ["--model-path", model_path]
    if device:
        cmd += ["--device", device]
    cmd += list(common_args)
    return cmd


def default_runtime_image(runtime: str) -> str:
    """Per-runtime default image with env escape hatches — same contract
    as the reference (ARKS_RUNTIME_DEFAULT_{VLLM,SGLANG,DYNAMO}_IMAGE,
    arksapplication_controller.go:907-939).  Spec.runtimeImage always
    wins; env beats the built-in default.  The native torch runtime has
    no escape hatch: its image is the port's engine image."""
    name = f"ARKS_RUNTIME_DEFAULT_{runtime.upper()}_IMAGE"
    env = knobs.get_str(name) if name in knobs.DEFAULTS else None
    if env:
        return env
    return {
        "vllm": "vllm/vllm-openai:v0.8.2",
        "sglang": "lmsysorg/sglang:v0.4.5-cu124",
        "dynamo": "scitixai/k8s/dynamo:vllm",
    }.get(runtime, "arks-tpu-torch/engine:latest")


def gpu_runtime_command(runtime: str, model_path: str, served_model_name: str,
                        tensor_parallel: int, size: int,
                        common_args: list[str]) -> list[str]:
    """Command lines for the GPU runtimes the reference launches, kept for
    mixed-fleet parity (semantics per arksapplication_controller.go:941-1014;
    these run in their own container images, never on this host)."""
    if runtime == "vllm":
        return (["python3", "-m", "vllm.entrypoints.openai.api_server",
                 "--host", "0.0.0.0", "--port", "8080",
                 "--model", model_path,
                 "--served-model-name", served_model_name,
                 "--tensor-parallel-size", str(tensor_parallel)]
                + list(common_args))
    if runtime == "sglang":
        return (["python3", "-m", "sglang.launch_server",
                 "--host", "0.0.0.0", "--port", "8080",
                 "--model-path", model_path,
                 "--served-model-name", served_model_name,
                 "--tp", str(tensor_parallel),
                 "--dist-init-addr", "$(ARKS_GANG_LEADER_ADDRESS)",
                 "--nnodes", str(size),
                 "--node-rank", "$(ARKS_GANG_WORKER_INDEX)",
                 "--enable-metrics"]
                + list(common_args))
    if runtime == "dynamo":
        return (["dynamo", "run", "in=http", f"out=dyn://{served_model_name}",
                 "--model-path", model_path] + list(common_args))
    raise ValueError(f"unknown runtime {runtime!r}")
