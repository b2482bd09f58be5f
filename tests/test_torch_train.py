"""The port's trainer (``arks_tpu_torch/train/``) against the reference's
(``arks_tpu/train/``) on the CPU, in f32.

- First step: the same numpy params (seeded) bridged into both packages;
  the loss and every gradient leaf against ``jax.value_and_grad`` of the
  reference's ``loss_fn`` on tiny-gqa, tiny-gqa with tied embeddings and
  tiny-moe at B * T >= 64 (the grouped route with the shared expert),
  with a loss mask that zeroes some positions.  Tolerances: the loss
  within 1e-5 relative, each gradient leaf within 1e-4 of its largest
  |value| (plus 1e-8): the two sum their f32 products in other orders.
- Four AdamW steps against ``make_train_step(cfg, optax.adamw(1e-3))``:
  losses within 1e-5 relative, final params within 1e-4 absolute: 2.5% of
  the most four updates can move a weight (4 x lr).  Adam divides by
  sqrt(nu), so an element whose gradient is a rounding away from zero
  moves by a visible share of lr however close the gradients (1.3e-5 on
  tiny-gqa's embedding rows, the largest seen).
- ``ARKS_MOE_KERNEL=pallas`` refuses a gradient in both packages.
- Checkpoints: resume equals the uninterrupted run bit for bit (losses,
  params, moments, counts), retention and ``latest_step``, the async
  snapshot, a failed write leaving no step, a bf16 state restoring as
  bf16, a restore that draws no random init, Orbax directories refused.
- The CLI on ``--device cpu`` (``python -m``, then in process): train,
  resume, the final state equal to an uninterrupted run's; the resume
  fence; no GPU without ``--device cpu``.
"""

import dataclasses
import json
import logging
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from arks_tpu.models import get_config as ref_config
from arks_tpu.train import sft as ref_sft
from arks_tpu_torch.models import get_config, quant
from arks_tpu_torch.models import moe
from arks_tpu_torch.models import transformer as tf
from arks_tpu_torch.models.weights import params_from_numpy
from arks_tpu_torch.train import checkpoint as ckpt
from arks_tpu_torch.train import sft
from arks_tpu_torch.train.__main__ import main as train_main

REPO = Path(__file__).resolve().parent.parent

# case -> (B, T): tiny-moe's 4 x 32 = 128 tokens take the grouped route.
CASES = {"tiny-gqa": (2, 16), "tiny-gqa-tied": (2, 16), "tiny-moe": (4, 32)}
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-4
LR = 1e-3


def _configs(case):
    name = case.removesuffix("-tied")
    rc, pc = ref_config(name), get_config(name)
    if case.endswith("-tied"):
        rc = dataclasses.replace(rc, tie_word_embeddings=True)
        pc = dataclasses.replace(pc, tie_word_embeddings=True)
    return rc, pc


def _batch(cfg, b, t, seed):
    """Tokens, targets and a loss mask with about a third zeroed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    tgts = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    mask = (rng.random((b, t)) > 0.3).astype(np.float32)
    return toks, tgts, mask


def _torch(batch):
    return tuple(torch.from_numpy(a) for a in batch)


@pytest.fixture(scope="module")
def bridged():
    """case -> (reference config, port config, numpy params) from one
    seeded init per case (the port's, read back as numpy)."""
    out = {}
    for case in CASES:
        rc, pc = _configs(case)
        params = tf.init_params(pc, 3, torch.float32, "cpu")
        tree = {k: ({n: w.numpy() for n, w in v.items()}
                    if isinstance(v, dict) else v.numpy())
                for k, v in params.items()}
        assert ("lm_head" in tree) == (not rc.tie_word_embeddings)
        out[case] = (rc, pc, tree)
    return out


def _leaf(tree, name):
    for key in name.split("/"):
        tree = tree[key]
    return np.asarray(tree)


def _close(got, want, rtol, what):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    tol = rtol * np.abs(want).max() + 1e-8
    assert err <= tol, f"{what}: max |diff| {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("case", list(CASES))
def test_first_step_loss_and_grads_match_reference(case, bridged,
                                                   monkeypatch):
    rc, pc, tree = bridged[case]
    batch = _batch(rc, *CASES[case], seed=1)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_sft.loss_fn(p, rc, *batch)))(
            jax.tree.map(jnp.asarray, tree))
    grouped = []
    real = moe.moe_ffn_grouped
    monkeypatch.setattr(moe, "moe_ffn_grouped",
                        lambda *a, **k: grouped.append(1) or real(*a, **k))
    params = params_from_numpy(tree, pc, "cpu", torch.float32)
    opt_state = sft.adamw(LR).init(params)
    loss = sft.loss_fn(params, pc, *_torch(batch))
    loss.backward()
    assert len(grouped) == (pc.num_layers if pc.num_experts else 0)
    _close(loss.item(), ref_loss, LOSS_RTOL, "loss")
    names = [n for n, _ in sft.named_leaves(params)]
    assert len(names) == len(jax.tree.leaves(ref_grads))
    for name, leaf in sft.named_leaves(params):
        assert leaf.grad is not None and leaf.grad.abs().max() > 0, name
        _close(leaf.grad.numpy(), _leaf(ref_grads, name), GRAD_RTOL, name)
    assert list(opt_state.mu) == list(opt_state.nu) == names


@pytest.mark.parametrize("case", ["tiny-gqa", "tiny-moe"])
def test_adamw_steps_match_reference(case, bridged):
    rc, pc, tree = bridged[case]
    b, t = CASES[case]
    batches = [_batch(rc, b, t, seed=10 + i) for i in range(4)]
    optimizer = optax.adamw(LR)
    params = jax.tree.map(jnp.asarray, tree)
    ref_state = ref_sft.TrainState(params, optimizer.init(params),
                                   jnp.zeros((), jnp.int32))
    ref_step = ref_sft.make_train_step(rc, optimizer)
    state = sft.TrainState(params_from_numpy(tree, pc, "cpu",
                                             torch.float32), None, 0)
    state = state._replace(opt_state=sft.adamw(LR).init(state.params))
    step = sft.make_train_step(pc, sft.adamw(LR))
    for i, batch in enumerate(batches):
        ref_state, ref_loss = ref_step(ref_state, *batch)
        state, loss = step(state, *_torch(batch))
        _close(loss.item(), ref_loss, LOSS_RTOL, f"loss {i}")
    assert state.step == int(ref_state.step) == 4
    for name, leaf in sft.named_leaves(state.params):
        err = np.abs(leaf.detach().numpy()
                     - _leaf(ref_state.params, name)).max()
        assert err <= PARAM_ATOL, (name, err)
        assert leaf.grad is None          # dropped after the update


def test_pallas_route_refuses_training_as_the_reference(bridged,
                                                        monkeypatch):
    rc, pc, tree = bridged["tiny-moe"]
    batch = _batch(rc, *CASES["tiny-moe"], seed=2)
    monkeypatch.setenv("ARKS_MOE_KERNEL", "pallas")
    optimizer = optax.adamw(LR)
    params = jax.tree.map(jnp.asarray, tree)
    with pytest.raises(NotImplementedError):
        ref_sft.make_train_step(rc, optimizer)(
            ref_sft.TrainState(params, optimizer.init(params),
                               jnp.zeros((), jnp.int32)), *batch)
    state = sft.train_init(pc, 0, sft.adamw(LR), "cpu")
    with pytest.raises(NotImplementedError, match="no backward"):
        sft.make_train_step(pc, sft.adamw(LR))(state, *_torch(batch))
    # Without a gradient the grouped kernel's route still serves.
    with torch.no_grad():
        assert torch.isfinite(sft.forward_train(
            state.params, pc, _torch(batch)[0])).all()


def test_quantized_params_refuse_training():
    params = quant.quantize_params(
        tf.init_params(get_config("tiny"), 0, torch.float32, "cpu"), 8)
    with pytest.raises(ValueError, match="quantized"):
        sft.adamw(LR).init(params)


def test_forward_train_logits_match_serving_prefill():
    cfg = get_config("tiny-gqa")
    params = tf.init_params(cfg, 4, torch.float32, "cpu")
    toks = torch.from_numpy(_batch(cfg, 2, 16, seed=4)[0])
    with torch.no_grad():
        logits = sft.forward_train(params, cfg, toks)
        want, _, _ = tf.prefill(params, cfg, toks,
                                torch.full((2,), 16, dtype=torch.int32))
    _close(logits[:, -1].numpy(), want.numpy(), 1e-5, "last logits")


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    view = ints[a.element_size()]
    return torch.equal(a.detach().contiguous().view(view),
                       b.detach().contiguous().view(view))


def _snapshot(state):
    return {k: t.detach().clone() for k, t in
            ckpt.state_tensors(state).items()}


def _assert_same_state(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert _same_bits(got[k], want[k]), k


def _steps(cfg, n, b=2, t=16):
    return [_torch(_batch(cfg, b, t, seed=20 + i)) for i in range(n)]


@pytest.mark.parametrize("name", ["tiny-gqa", "tiny-moe"])
def test_resume_matches_uninterrupted_bit_for_bit(tmp_path, name):
    """4 x 32 tokens of a 512-token vocabulary repeat tokens (and route
    each tiny-moe token to 2 experts): the gathers' backward adds
    repeated rows, which must come out the same in every run."""
    cfg = get_config(name)
    opt = sft.adamw(LR)
    batches = _steps(cfg, 4, b=4, t=32)
    step = sft.make_train_step(cfg, opt)

    state = sft.train_init(cfg, 1, opt, "cpu")
    ref_losses = []
    for batch in batches:
        state, loss = step(state, *batch)
        ref_losses.append(loss.item())
    want = _snapshot(state)
    assert "opt_state/mu/layers/wq" in want

    state = sft.train_init(cfg, 1, opt, "cpu")
    for i in range(2):
        state, loss = step(state, *batches[i])
        assert loss.item() == ref_losses[i]
    mgr = ckpt.make_manager(str(tmp_path / "ckpt"))
    assert ckpt.save_train_state(mgr, state) == 2
    resumed = ckpt.restore_train_state(
        ckpt.make_manager(str(tmp_path / "ckpt")), cfg, opt, "cpu")
    assert resumed.step == 2
    _assert_same_state(_snapshot(resumed), _snapshot(state))
    for i in (2, 3):
        resumed, loss = step(resumed, *batches[i])
        assert loss.item() == ref_losses[i]          # exact, not approx
    _assert_same_state(_snapshot(resumed), want)


def test_retention_latest_and_repeated_step(tmp_path):
    cfg = get_config("tiny")
    opt = sft.adamw(1e-2)
    step = sft.make_train_step(cfg, opt)
    state = sft.train_init(cfg, 0, opt, "cpu")
    mgr = ckpt.make_manager(str(tmp_path / "c"), max_to_keep=2)
    for batch in _steps(cfg, 4, t=8):
        state, _ = step(state, *batch)
        ckpt.save_train_state(mgr, state)
    assert mgr.latest_step() == 4
    assert mgr.all_steps() == [3, 4]
    assert not [n for n in os.listdir(mgr.directory) if n.startswith(".")]
    assert mgr.save(4, ckpt.state_tensors(state)) is False
    assert ckpt.restore_train_state(mgr, cfg, opt, "cpu", step=3).step == 3
    with pytest.raises(FileNotFoundError):
        ckpt.restore_train_state(ckpt.make_manager(str(tmp_path / "e")),
                                 cfg, opt, "cpu")


def test_async_save_writes_the_snapshot_and_a_failed_write_no_step(
        tmp_path, monkeypatch):
    cfg = get_config("tiny")
    opt = sft.adamw(LR)
    step = sft.make_train_step(cfg, opt)
    batches = _steps(cfg, 2, t=8)
    state, _ = step(sft.train_init(cfg, 0, opt, "cpu"), *batches[0])
    mgr = ckpt.make_manager(str(tmp_path / "a"))
    want = _snapshot(state)
    assert ckpt.save_train_state(mgr, state, wait=False) == 1
    state, _ = step(state, *batches[1])     # updates the leaves in place
    mgr.wait_until_finished()
    _assert_same_state(torch.load(mgr.step_path(1), weights_only=True),
                       want)

    def torn(tensors, path):
        with open(path, "wb") as f:
            f.write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.torch, "save", torn)
    ckpt.save_train_state(mgr, state, wait=False)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait_until_finished()
    assert mgr.all_steps() == [1]


def test_restore_honors_stored_dtype_and_draws_no_random_init(
        tmp_path, monkeypatch):
    cfg = get_config("tiny")
    opt = sft.adamw(LR)
    state = sft.train_init(cfg, 0, opt, "cpu", dtype=torch.bfloat16)
    state, _ = sft.make_train_step(cfg, opt)(state, *_steps(cfg, 1, t=8)[0])
    mgr = ckpt.make_manager(str(tmp_path / "bf"))
    ckpt.save_train_state(mgr, state)

    def no_draw(*a, **k):
        raise AssertionError("the restore drew a random init")

    monkeypatch.setattr(tf, "init_params", no_draw)
    monkeypatch.setattr(torch, "randn", no_draw)
    monkeypatch.setattr(torch.Tensor, "normal_", no_draw)
    restored = ckpt.restore_train_state(
        ckpt.make_manager(str(tmp_path / "bf")), cfg, opt, "cpu")
    assert restored.params["embed"].dtype == torch.bfloat16
    _assert_same_state(_snapshot(restored), _snapshot(state))
    as_f32 = ckpt.restore_train_state(mgr, cfg, opt, "cpu",
                                      dtype="float32")
    assert as_f32.params["embed"].dtype == torch.float32


@pytest.mark.parametrize("layout", ["orbax-step", "arks_orbax"])
def test_orbax_directory_is_refused(tmp_path, layout):
    if layout == "orbax-step":
        (tmp_path / "5" / "default").mkdir(parents=True)
        (tmp_path / "5" / "_CHECKPOINT_METADATA").write_text("{}")
    else:
        (tmp_path / "arks_orbax").mkdir()
    with pytest.raises(NotImplementedError, match="Orbax"):
        ckpt.make_manager(str(tmp_path))


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def _corpus(path, n=24):
    path.write_text("\n".join(json.dumps(
        {"text": f"document number {i} " + "x" * (i % 17)})
        for i in range(n)) + "\n")
    return str(path)


def _cli(data, ckpt_dir, steps, *extra):
    return ["--model", "tiny", "--data", data, "--seq-len", "32",
            "--batch-size", "4", "--steps", str(steps), "--lr", "3e-3",
            "--ckpt-dir", ckpt_dir, "--ckpt-every", "5", "--log-every",
            "5", *extra]


def test_trainer_cli_end_to_end_with_resume(tmp_path, caplog):
    """python -m arks_tpu_torch.train: N steps with checkpoints, then a
    second invocation (in process) resumes from the latest step and
    reaches the target; its final state equals an uninterrupted run's bit
    for bit."""
    data = _corpus(tmp_path / "corpus.jsonl")
    run_dir = str(tmp_path / "run")
    r = subprocess.run(
        [sys.executable, "-m", "arks_tpu_torch.train",
         *_cli(data, run_dir, 10, "--device", "cpu")],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert r.returncode == 0, r.stderr[-2000:]
    out1 = r.stderr                  # logging goes to stderr
    assert "step 10 loss" in out1
    assert "final checkpoint at step 10" in out1
    caplog.set_level(logging.INFO, logger="arks_tpu_torch.train")
    train_main(_cli(data, run_dir, 20, "--device", "cpu"))
    out2 = caplog.text
    assert "resumed from step 10" in out2
    assert "final checkpoint at step 20" in out2
    losses = [float(m) for m in re.findall(r"loss (\d+\.\d+)", out1 + out2)]
    assert len(losses) >= 4 and losses[-1] < losses[0]

    straight = str(tmp_path / "straight")
    train_main(_cli(data, straight, 20, "--device", "cpu"))
    _assert_same_state(
        torch.load(os.path.join(run_dir, "20", ckpt.STATE_FILE),
                   weights_only=True),
        torch.load(os.path.join(straight, "20", ckpt.STATE_FILE),
                   weights_only=True))


def test_trainer_cli_resume_fence_rejects_changed_shape(tmp_path):
    data = _corpus(tmp_path / "c.jsonl")
    run_dir = str(tmp_path / "run")
    train_main(_cli(data, run_dir, 2, "--device", "cpu"))
    with pytest.raises(SystemExit,
                       match="different data-shaping args.*batch_size"):
        train_main(_cli(data, run_dir, 4, "--device", "cpu")
                   + ["--batch-size", "8"])
    train_main(_cli(data, run_dir, 4, "--device", "cpu"))
    assert ckpt.make_manager(run_dir).latest_step() == 4


def test_trainer_cli_needs_a_gpu_unless_cpu_and_refuses_parallel(
        tmp_path, monkeypatch):
    data = _corpus(tmp_path / "c.jsonl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main(_cli(data, str(tmp_path / "r"), 2))
    cfg, opt = get_config("tiny"), sft.adamw(LR)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sft.train_init(cfg, 0, opt)
    mgr = ckpt.make_manager(str(tmp_path / "m"))
    ckpt.save_train_state(mgr, sft.train_init(cfg, 0, opt, "cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ckpt.restore_train_state(mgr, cfg, opt)
    with pytest.raises(NotImplementedError, match="parallelism"):
        train_main(_cli(data, str(tmp_path / "r"), 2, "--device", "cpu",
                        "--tensor-parallel", "2"))


_IMPORT_TRAIN = """
import sys
import arks_tpu_torch.train, arks_tpu_torch.train.__main__
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "optax", "arks_tpu",
                                    "orbax"))
print(bad)
"""


def test_train_package_imports_no_jax_optax_or_reference():
    out = subprocess.run([sys.executable, "-c", _IMPORT_TRAIN],
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip()
    assert out == "[]"
