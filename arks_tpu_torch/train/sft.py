"""SFT / fine-tune step over the serving model — the port of
``arks_tpu/train/sft.py``.

Training and serving share one layer body: ``forward_hidden`` runs
``transformer.prefill_layer`` over every layer, so the two can never drift
apart.  Autograd differentiates the plain math that the reference's XLA
computes (f32 attention scores, the grouped MoE route's ragged products);
no hand-written kernel runs here.  The one kernel an FFN could reach, the
grouped matmul under ``ARKS_MOE_KERNEL=pallas``, has no backward and raises
``NotImplementedError``, as ``pallas_call`` does under the reference's
``jax.value_and_grad``.

The optimizer is AdamW with ``optax.adamw``'s semantics (``adamw``): b1
0.9, b2 0.999, eps 1e-8 outside the square root, bias correction by the
update count, and decoupled weight decay on every leaf (optax's ``mask`` is
None, so norms and biases decay too); its state is optax's (``count``,
``mu``, ``nu``), keyed by leaf name (``named_leaves``).  The update runs
leaf by leaf in place, so it holds two temporaries of one leaf, not of the
whole tree (``torch.optim.AdamW``'s foreach path holds a tree-sized one,
and constructing it imports ``torch._dynamo``: 7 s of a trainer's start
on the card's machine).  It orders its f32 operations unlike XLA's fused
update, so the two agree to rounding, not bit for bit.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from arks_tpu_torch.models import transformer as tf
from arks_tpu_torch.models.config import ModelConfig
from arks_tpu_torch.models.quant import is_quantized
from arks_tpu_torch.ops.norms import rms_norm
from arks_tpu_torch.ops.rope import rope_cos_sin

Params = dict[str, Any]


def named_leaves(params: Params) -> list[tuple[str, torch.Tensor]]:
    """(name, leaf) pairs of a params tree sorted by name ("embed",
    "layers/wq", ...): the optimizer's parameter order and the
    checkpoint's keys.  Raises on a quantized leaf, which cannot train."""
    out = []

    def walk(prefix: str, node: dict) -> None:
        for key, leaf in node.items():
            name = prefix + key
            if is_quantized(leaf):
                raise ValueError(f"{name} is quantized: a quantized params "
                                 "tree cannot be trained")
            if isinstance(leaf, dict):
                walk(name + "/", leaf)
            else:
                out.append((name, leaf))

    walk("", params)
    return sorted(out, key=lambda item: item[0])


class AdamWState(NamedTuple):
    """optax's ``ScaleByAdamState``: the update count and the moments."""
    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


def trainable(params: Params) -> list[tuple[str, torch.Tensor]]:
    """``named_leaves(params)``, each made trainable in place."""
    leaves = named_leaves(params)
    for _, leaf in leaves:
        leaf.requires_grad_(True)
    return leaves


class AdamW(NamedTuple):
    """``optax.adamw``'s hyperparameters (eps_root 0, no mask)."""
    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def init(self, params: Params) -> AdamWState:
        """Zero moments for ``params``' leaves, which become trainable."""
        leaves = trainable(params)
        return AdamWState(0, {n: torch.zeros_like(p) for n, p in leaves},
                          {n: torch.zeros_like(p) for n, p in leaves})

    @torch.no_grad()
    def update(self, params: Params, state: AdamWState) -> AdamWState:
        """One update from the leaves' gradients, in place, which then
        drops them: ``scale_by_adam``, ``add_decayed_weights`` and
        ``scale_by_learning_rate``, one leaf at a time."""
        count = state.count + 1
        bc1, bc2 = 1 - self.b1 ** count, 1 - self.b2 ** count
        for name, p in named_leaves(params):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            mu, nu = state.mu[name], state.nu[name]
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.grad = None
            del g
            step = torch.div(mu, bc1).div_(
                torch.div(nu, bc2).sqrt_().add_(self.eps))
            p.add_(step.add_(p, alpha=self.weight_decay),
                   alpha=-self.learning_rate)
        return AdamWState(count, state.mu, state.nu)


# optax's spelling: ``adamw(learning_rate, b1, b2, eps, weight_decay=...)``.
adamw = AdamW


class TrainState(NamedTuple):
    params: Params                   # leaf tensors with requires_grad
    opt_state: AdamWState
    step: int


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """``optax.softmax_cross_entropy_with_integer_labels``: the log of the
    summed exponentials less the label's logit, both shifted by the
    (gradient-free) row max."""
    with torch.no_grad():
        top = logits.amax(dim=-1, keepdim=True)
    shifted = logits - top
    label = shifted.gather(-1, labels.long()[..., None])[..., 0]
    return torch.log(torch.exp(shifted).sum(dim=-1)) - label


def _logits(params: Params, cfg: ModelConfig,
            h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    table = params["embed"].T if cfg.tie_word_embeddings else \
        params["lm_head"]
    return torch.einsum("bte,ev->btv", h, table).float()


def head_loss(params: Params, cfg: ModelConfig, h: torch.Tensor,
              targets: torch.Tensor, loss_mask: torch.Tensor) -> torch.Tensor:
    """Final norm + unembed + masked mean CE on hidden states [B, T, E].

    The single definition of the loss: the dense trainer and (later) the
    pipeline-parallel trainer both end here.  The denominator is
    ``max(sum(mask), 1)``."""
    ce = softmax_cross_entropy(_logits(params, cfg, h), targets)
    mask = loss_mask.float()
    return (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _layers(params: Params) -> list[Params]:
    """Each layer's leaves as views of the stacked [L, ...] leaves.  One
    ``unbind`` per leaf: its backward stacks the layers' gradients once,
    where indexing layer by layer would add a zero-filled full-size
    gradient per layer."""
    names = list(params["layers"])
    per_leaf = [params["layers"][name].unbind(0) for name in names]
    return [dict(zip(names, leaves)) for leaves in zip(*per_leaf)]


def forward_hidden(params: Params, cfg: ModelConfig,
                   tokens: torch.Tensor) -> torch.Tensor:
    """Pre-final-norm hidden states [B, T, E]: the serving prefill's
    layer body (``transformer.prefill_layer``, whose MoE FFN takes the
    grouped route once B * T >= 64, as the reference's auto rule), its
    per-layer K/V unused."""
    b, t = tokens.shape
    positions = torch.arange(t, device=tokens.device).expand(b, t)
    rope = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    # The embedding gather's backward adds repeated tokens' rows in a
    # fixed order on the CPU and the card (indexing's does not on the
    # CPU): training steps repeat bit for bit.
    h = torch.nn.functional.embedding(tokens.long(), params["embed"])
    for lp in _layers(params):
        h, _, _ = tf.prefill_layer(h, lp, cfg, rope)
    return h


def forward_train(params: Params, cfg: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence logits [B, T, V] (float32)."""
    return _logits(params, cfg, forward_hidden(params, cfg, tokens))


def loss_fn(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            targets: torch.Tensor, loss_mask: torch.Tensor) -> torch.Tensor:
    return head_loss(params, cfg, forward_hidden(params, cfg, tokens),
                     targets, loss_mask)


def make_step_fn(loss: Callable[..., torch.Tensor], optimizer: AdamW):
    """Backward + optimizer update around any (params, tokens, targets,
    loss_mask) -> scalar loss.  Shared by the dense and (later) pipeline
    trainers.  The step updates the state's tensors in place (the
    reference donates its state) and drops the gradients in the update,
    so they never sit beside the next step's activations."""
    def step(state: TrainState, tokens: torch.Tensor, targets: torch.Tensor,
             loss_mask: torch.Tensor) -> tuple[TrainState, torch.Tensor]:
        loss_val = loss(state.params, tokens, targets, loss_mask)
        loss_val.backward()
        opt_state = optimizer.update(state.params, state.opt_state)
        return (TrainState(state.params, opt_state, state.step + 1),
                loss_val.detach())
    return step


def train_init(cfg: ModelConfig, seed: int, optimizer: AdamW,
               device: torch.device | str | None = None,
               dtype=torch.float32) -> TrainState:
    """Random weights from ``seed`` (``transformer.init_params``) on
    ``device`` (CUDA unless the caller passes "cpu"), at step 0."""
    params = tf.init_params(cfg, seed, dtype, device)
    return TrainState(params, optimizer.init(params), 0)


def make_train_step(cfg: ModelConfig, optimizer: AdamW):
    """The dense trainer's step: ``loss_fn`` under ``make_step_fn``."""
    return make_step_fn(
        lambda params, tokens, targets, loss_mask: loss_fn(
            params, cfg, tokens, targets, loss_mask), optimizer)
